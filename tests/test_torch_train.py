"""The port's train step against the reference's on the CPU, for every
``ASSIGNED`` architecture's smoke config in float32 (``dataclasses.replace``
of the dtypes), from one state: the reference's ``make_train_state``,
carried across by ``nn.train_state_from_numpy``, and the same numpy batch
(tokens and labels; patch embeddings for a VLM; frame embeddings for the
encoder-decoder), with the reference test's settings (``peak_lr=0.1``,
``warmup=1``, 2 microbatches; ``tests/test_arch_smoke.py::test_train_step``):

  * ``loss_fn``'s loss within 1e-4 of the reference's, and every gradient
    leaf within 1e-3 relative Frobenius of ``jax.value_and_grad``'s;
  * one ``make_train_step``: the reference test's assertions (a finite
    loss above 0.5, the parameters changed), the loss metric within 1e-4,
    and the parameters against the reference's step (``assert_step_close``):
    within 1e-5 wherever the step's clipped gradient is at least 1e-6
    (``UPDATE_FLOOR``), and elsewhere within what the measured gradient
    gap explains. AdamW's first step moves an element by lr g / (|g| +
    eps), eps = 1e-8, so a gap dg between the two frameworks' gradients
    (float32 summation, ~1e-11) moves it by at most lr |dg| / (min |g| +
    eps): up to 1e-4 at this rate where g is near 0. The share of elements
    held to that bound is printed (``-s``);
  * the port's ``adamw_update`` fed the reference's step gradients: every
    parameter within 1e-5 of the reference's step, no element left out.

Plus ``chunked_softmax_xent`` against ``cross_entropy``, two microbatches
against one, Adafactor with two-level remat and the "dots" policy against
the reference, and a step that raises leaving the state bitwise as it
was."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import steps as jax_steps  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.models import nn, steps  # noqa: E402
from repro_torch.optim.adamw import adamw_update  # noqa: E402

B, S = 2, 32
LR = 0.1
UPDATE_FLOOR = 1e-6
ADAM_EPS = 1e-8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, **policy):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32, **policy)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32, **policy)
    return jcfg, cfg


def make_batch(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out, n = {}, S
    if cfg.encdec:
        out["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    elif cfg.vlm is not None:
        p = cfg.vlm.num_patch_tokens
        out["patch_embeds"] = rng.standard_normal((B, p, cfg.d_model)).astype(
            np.float32)
        n = S - p
    out["tokens"] = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    return out


@contextlib.contextmanager
def recording(module, seen: list):
    """``module``'s optimizers append the gradients they are handed to
    ``seen``: what a train step's optimizer really saw."""
    names = ("adamw_update", "adafactor_update")
    real = {n: getattr(module, n) for n in names}
    for n, f in real.items():
        def rec(g, *a, _f=f, **kw):
            seen.append(g)
            return _f(g, *a, **kw)
        setattr(module, n, rec)
    try:
        yield
    finally:
        for n, f in real.items():
            setattr(module, n, f)


def reference(jcfg, batch, microbatches=2):
    """(state as numpy, loss, grads as numpy, post-step state as numpy,
    step metrics, the gradients the step's optimizer was handed, as numpy)
    from the reference, in one jit."""
    state = jax.jit(lambda k: jax_steps.make_train_state(jcfg, k))(
        jax.random.PRNGKey(0))
    seen = []

    def both(st, b):
        grad = jax.value_and_grad(lambda p: jax_steps.loss_fn(p, jcfg, b),
                                  has_aux=True)(st["params"])
        step = jax_steps.make_train_step(jcfg, num_microbatches=microbatches,
                                         peak_lr=LR, warmup=1)
        return grad, step(st, b), seen[-1]     # step(...) appends first

    with recording(jax_steps, seen):
        ((loss, _), grads), (new, metrics), step_g = jax.jit(both)(state,
                                                                   batch)
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (host(state), float(loss), host(grads), host(new), metrics,
            host(step_g))


def port_step(cfg, state, batch, m=2):
    """One ``make_train_step`` of ``m`` microbatches on ``state`` (in
    place): (metrics, the gradient leaves its optimizer was handed)."""
    seen = []
    with recording(steps, seen):
        _, metrics = steps.make_train_step(cfg, num_microbatches=m,
                                           peak_lr=LR, warmup=1)(state, batch)
    return metrics, nn.tree_leaves(seen[0])


def rel(a, b) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-12))


def clipped(grads: list) -> list:
    """The gradients as AdamW sees them: clipped to global norm 1."""
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
    return [g * min(1.0, 1.0 / max(norm, 1e-12)) for g in grads]


def assert_step_close(got, want, g_got, g_want, label) -> float:
    """AdamW's first step from one state: ``got`` (taken on the gradients
    ``g_got``) within 1e-5 of ``want`` (on ``g_want``) wherever the clipped
    ``g_got`` is at least UPDATE_FLOOR, and everywhere within lr |dg| /
    (min |g| + eps) + 1e-5 for the clipped gradients' gap dg (min |g| is 0
    where their signs differ). Returns the share of elements below the
    floor."""
    n_low = n = 0
    for p, w, a, b in zip(nn.tree_leaves(got), nn.tree_leaves(want),
                          clipped(g_got), clipped(g_want)):
        low = a.abs() < UPDATE_FLOOR
        g_min = torch.where(a * b > 0, torch.minimum(a.abs(), b.abs()), 0.0)
        gap = LR * (a - b).abs() / (g_min + ADAM_EPS)
        err = (p - w).abs()
        assert float(torch.where(low, 0.0, err).max()) <= 1e-5, label
        assert bool((err <= gap + 1e-5).all()), label
        n_low += int(low.sum())
        n += low.numel()
    print(f"{label}: {n_low / n:.2e} of the elements ({n_low} of {n}) "
          f"below the floor, held to the gradient gap's bound")
    return n_low / n


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_step_matches_the_reference(arch):
    jcfg, cfg = configs(arch)
    batch = make_batch(cfg)
    tree, jloss, jgrads, jnew, jmetrics, jstep_g = reference(jcfg, batch)
    state = nn.train_state_from_numpy(tree, cfg)
    before = nn.tree_map(torch.clone, state["params"])
    opt0 = nn.tree_map(torch.clone, state["opt"])
    want_step_g = nn.tree_leaves(nn.params_from_numpy(jstep_g, cfg))

    live = nn.tree_map(lambda p: p.detach().requires_grad_(), state["params"])
    loss, _ = steps.loss_fn(live, cfg, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    grads = torch.autograd.grad(loss, nn.tree_leaves(live), allow_unused=True)
    assert abs(float(loss) - jloss) <= 1e-4, (float(loss), jloss)
    want_g = nn.tree_leaves(nn.params_from_numpy(jgrads, cfg))
    grads = [torch.zeros_like(w) if g is None else g
             for g, w in zip(grads, want_g)]
    for g, w in zip(grads, want_g):
        assert rel(g, w) <= 1e-3, (arch, rel(g, w))

    metrics, step_g = port_step(cfg, state, batch)
    new = state
    step_loss = float(metrics["loss"])
    assert np.isfinite(step_loss) and step_loss > 0.5
    assert abs(step_loss - float(jmetrics["loss"])) <= 1e-4
    assert not torch.allclose(nn.tree_leaves(before)[0],
                              nn.tree_leaves(new["params"])[0])
    assert int(new["opt"]["step"]) == 1
    want = nn.params_from_numpy(jnew["params"], cfg)
    assert_step_close(new["params"], want, step_g, want_step_g, arch)
    # the optimizer alone, on the reference's gradients: every element
    params = nn.tree_map(torch.clone, before)
    adamw_update(nn.tree_unflatten(before, want_step_g), opt0, params,
                 lr=float(jmetrics["lr"]))
    for p, w in zip(nn.tree_leaves(params), nn.tree_leaves(want)):
        assert float((p - w).abs().max()) <= 1e-5, arch


@pytest.mark.parametrize("policy", [dict(optimizer="adafactor",
                                         optstate_dtype=jnp.float32,
                                         remat_group=2),
                                    dict(remat="dots")],
                         ids=["adafactor-group2", "dots"])
def test_optimizer_and_remat_policies_match_the_reference(policy):
    """llama3-405b's smoke config at 4 layers (two-level remat: groups of 2
    repeats) with Adafactor, and with the "dots" remat policy: the loss and
    gradients of the reference, and the step's parameters against the
    reference's ``make_train_step``. Adafactor keeps its statistics and its
    RMS clip over the reference's stacked leaves (``nn.stacked``), so its
    step is held to the reference's elementwise within 1e-5; the "dots"
    step as ``assert_step_close``."""
    tp = {k: (torch.float32 if v is jnp.float32 else v)
          for k, v in policy.items()}
    jcfg, cfg = configs("llama3-405b", num_layers=4)
    jcfg, cfg = (dataclasses.replace(jcfg, **policy),
                 dataclasses.replace(cfg, **tp))
    batch = make_batch(cfg, seed=1)
    tree, jloss, jgrads, jnew, _, jstep_g = reference(jcfg, batch)
    state = nn.train_state_from_numpy(tree, cfg)
    assert (cfg.optimizer == "adafactor") == ("vr" in state["opt"])
    live = nn.tree_map(lambda p: p.detach().requires_grad_(), state["params"])
    loss, _ = steps.loss_fn(live, cfg, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    grads = torch.autograd.grad(loss, nn.tree_leaves(live))
    assert abs(float(loss) - jloss) <= 1e-4
    for g, w in zip(grads, nn.tree_leaves(nn.params_from_numpy(jgrads, cfg))):
        assert rel(g, w) <= 1e-3
    _, step_g = port_step(cfg, state, batch)
    want = nn.params_from_numpy(jnew["params"], cfg)
    if cfg.optimizer == "adafactor":
        for p, w in zip(nn.tree_leaves(state["params"]), nn.tree_leaves(want)):
            assert float((p - w).abs().max()) <= 1e-5
        for name in ("vr", "vc"):
            got = nn.tree_leaves(state["opt"][name])
            ref = nn.tree_leaves(nn.tree_map(
                lambda _, a: a, state["opt"][name], jnew["opt"][name]))
            assert len(got) == len(ref)
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                           atol=1e-12)
    else:
        assert_step_close(state["params"], want, step_g,
                          nn.tree_leaves(nn.params_from_numpy(jstep_g, cfg)),
                          cfg.optimizer + " " + cfg.remat)


def test_chunked_xent_matches_cross_entropy():
    """The fused chunked CE (ragged last chunk, ignored labels) equals the
    plain CE on the full logits, value and gradients."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 50, 16), generator=gen, requires_grad=True)
    head = torch.randn((16, 300), generator=gen, requires_grad=True)
    labels = torch.randint(0, 300, (2, 50), generator=gen)
    labels[0, :7] = -1
    ce, z = steps.chunked_softmax_xent(x, head, labels, chunk=16)
    ce2, z2 = steps.cross_entropy(x @ head, labels)
    torch.testing.assert_close(ce, ce2)
    torch.testing.assert_close(z, z2)
    g = torch.autograd.grad(ce + z, (x, head))
    g2 = torch.autograd.grad(ce2 + z2, (x, head))
    for a, b in zip(g, g2):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_two_microbatches_equal_one():
    """A dense model's step over 2 interleaved microbatches equals one over
    the whole batch: the loss within 1e-5, the parameters as in
    ``assert_step_close``."""
    _, cfg = configs("smollm-360m")
    batch = make_batch(cfg, seed=2)
    gen = torch.Generator().manual_seed(0)
    s1 = steps.make_train_state(cfg, gen, "cpu")
    s2 = {"params": nn.tree_map(torch.clone, s1["params"]),
          "opt": nn.tree_map(torch.clone, s1["opt"])}
    m1, g1 = port_step(cfg, s1, batch, m=1)
    m2, g2 = port_step(cfg, s2, batch, m=2)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-5
    assert_step_close(s2["params"], s1["params"], g2, g1, "m=2 vs 1")


def test_a_step_that_raises_leaves_the_state_unchanged(monkeypatch):
    """The second microbatch's loss raises after the first one's gradients
    are in: every parameter and moment and the step counter are bitwise
    as before, and the retried step equals an unfailed one."""
    _, cfg = configs("smollm-360m")
    batch = make_batch(cfg, seed=3)
    gen = torch.Generator().manual_seed(1)
    state = steps.make_train_state(cfg, gen, "cpu")
    step = steps.make_train_step(cfg, num_microbatches=2, peak_lr=LR,
                                 warmup=1)
    step(state, batch)                       # moments and step non-zero
    saved = nn.tree_map(torch.clone, state)
    real = steps.loss_fn
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected device failure")
        return real(*a, **kw)

    monkeypatch.setattr(steps, "loss_fn", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        step(state, batch)
    for a, b in zip(nn.tree_leaves(state), nn.tree_leaves(saved)):
        assert torch.equal(a, b)
    monkeypatch.setattr(steps, "loss_fn", real)
    step(state, batch)
    step(saved, batch)
    for a, b in zip(nn.tree_leaves(state), nn.tree_leaves(saved)):
        assert torch.equal(a, b)
