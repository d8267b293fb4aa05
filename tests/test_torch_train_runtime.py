"""The port's training substrate on the CPU, mirroring
``tests/test_runtime.py``: the checkpoint manager (round trip, retention,
atomicity, async; bfloat16 stored as its words), the fault-tolerant
runner, AdamW and Adafactor (convergence, and one update against the
reference's on the same tree), the schedules against the reference's, the
data pipeline (deterministic, prefetching, bitwise the reference's
batches), ``train_state_from_numpy`` for Adafactor's factored state, the
train launcher and the three examples with ``device="cpu"``."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.models import nn  # noqa: E402
from repro_torch.runtime.fault_tolerance import FaultTolerantRunner  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 4), generator=gen),
                   "b": torch.zeros((4,)),
                   "h": torch.randn((3, 5), generator=gen).to(torch.bfloat16),
                   "layers": [torch.ones((2,)), torch.arange(3)]},
        "opt": {"m": {"w": torch.zeros((8, 4)), "b": torch.zeros((4,))},
                "step": torch.zeros((), dtype=torch.int32)},
    }


def _equal(a, b):
    la, lb = nn.tree_leaves(a), nn.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    st = _tiny_state()
    mgr.save(10, st)
    back = mgr.restore(10, like=st)
    assert _equal(back, st)
    import json
    man = json.loads((tmp_path / "step_10" / "manifest.json").read_text())
    assert man["dtypes"]["params/h"] == "bfloat16"
    assert man["shapes"]["params/layers/1"] == [3]


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    st = _tiny_state()
    for s in (1, 2, 3, 4):
        mgr.save(s, st)
    assert mgr.latest_step() == 4
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]


def test_checkpoint_atomicity_partial_write_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    st = _tiny_state()
    mgr.save(5, st)
    # a crash mid-write: the stray tmp dir must not be visible
    (tmp_path / "step_9.tmp").mkdir()
    (tmp_path / "step_9.tmp" / "garbage").write_text("x")
    assert mgr.latest_step() == 5
    assert _equal(mgr.restore(None, like=st), st)


def test_checkpoint_async(tmp_path):
    """save_async copies to the host at once: a write to the state right
    after the call does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path, keep=2)
    st = _tiny_state()
    want = nn.tree_map(torch.clone, st)
    mgr.save_async(7, st)
    st["params"]["w"].add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 7
    assert _equal(mgr.restore(7, like=st), want)


def test_fault_tolerant_runner_retries_and_restores(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    calls = {"n": 0}

    def flaky_step(state, batch):
        calls["n"] += 1
        if calls["n"] in (3, 4, 5, 6):   # a persistent fault: forces restore
            raise RuntimeError("injected device failure")
        new = {"params": nn.tree_map(lambda x: x + 1.0, state["params"]),
               "opt": state["opt"]}
        return new, {"loss": torch.tensor(1.0)}

    runner = FaultTolerantRunner(flaky_step, mgr, max_retries=2,
                                 checkpoint_every=2)
    st = {"params": {"w": torch.zeros((2,))}, "opt": {}}
    state, step = runner.run(st, [None] * 6)
    assert step == 6
    assert runner.retries >= 3
    assert runner.restores >= 1
    assert mgr.latest_step() is not None
    # steps 0, 1 applied, step 2 restored to the step-2 checkpoint, then
    # steps 3, 4, 5 applied
    assert torch.equal(state["params"]["w"], torch.full((2,), 5.0))


def _quadratic_losses(update_fn, init_fn, steps=60):
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 8)).astype(np.float32))
    params = {"w": torch.zeros((16, 8))}
    opt = init_fn(params)
    losses = []
    for _ in range(steps):
        w = params["w"].detach().requires_grad_()
        loss = torch.mean((w - target) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        update_fn({"w": g}, opt, params)
        losses.append(float(loss))
    return losses


def test_adamw_converges():
    from repro_torch.optim.adamw import adamw_init, adamw_update

    losses = _quadratic_losses(
        lambda g, o, p: adamw_update(g, o, p, lr=0.05, weight_decay=0.0),
        adamw_init)
    assert losses[-1] < 0.05 * losses[0]


def test_adafactor_converges():
    from repro_torch.optim.adafactor import adafactor_init, adafactor_update

    losses = _quadratic_losses(
        lambda g, o, p: adafactor_update(g, o, p, lr=0.1, weight_decay=0.0),
        adafactor_init)
    assert losses[-1] < 0.1 * losses[0]


def _tree(seed):
    rng = np.random.default_rng(seed)
    # keys in sorted order: the order of the reference's tree leaves
    return {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": [{"s": rng.standard_normal((7,)).astype(np.float32),
                        "w": rng.standard_normal((3, 4, 2)).astype(
                            np.float32)}]}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_matches_the_reference(name):
    """Three updates of a nested tree (a matrix, a rank-3 leaf, a vector)
    from the same gradients: the parameters and every state leaf within
    1e-6 of the reference's, the moments in bfloat16 where asked."""
    import importlib

    ref = importlib.import_module(f"repro.optim.{name}")
    port = importlib.import_module(f"repro_torch.optim.{name}")
    init, update = f"{name}_init", f"{name}_update"
    dt = (jnp.bfloat16, torch.bfloat16)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    jo = getattr(ref, init)(jp, dt[0])
    tp = nn.tree_map(torch.from_numpy, _tree(0))
    to = getattr(port, init)(tp, dt[1])
    for i in range(3):
        g = _tree(10 + i)
        jp, jo = getattr(ref, update)(jax.tree.map(jnp.asarray, g), jo, jp,
                                      lr=0.01)
        getattr(port, update)(nn.tree_map(torch.from_numpy, g), to, tp,
                              lr=0.01)
    for key in jo:
        want = jo[key]
        got = to[key]
        if key == "step":
            assert int(got) == int(want) == 3
            continue
        for a, b in zip(nn.tree_leaves(got), jax.tree.leaves(want)):
            b = np.asarray(b.astype(jnp.float32))
            np.testing.assert_allclose(a.float().numpy(), b, atol=1e-6,
                                       rtol=1e-2 if key == "m" else 1e-5)
    for a, b in zip(nn.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-5)


def test_schedules():
    from repro.optim import schedules as ref
    from repro_torch.optim.schedules import (constant, inverse_sqrt,
                                             warmup_cosine)

    lr0 = float(warmup_cosine(0, peak_lr=1.0, warmup=10, total=100))
    lr_w = float(warmup_cosine(torch.tensor(10), peak_lr=1.0, warmup=10,
                               total=100))
    lr_end = float(warmup_cosine(100, peak_lr=1.0, warmup=10, total=100))
    assert lr0 < 0.11 and abs(lr_w - 1.0) < 1e-5 and lr_end < 0.2
    for s in (0, 3, 10, 57, 100, 130):
        kw = dict(peak_lr=0.3, warmup=10, total=100)
        assert abs(float(warmup_cosine(s, **kw))
                   - float(ref.warmup_cosine(jnp.asarray(s), **kw))) < 1e-7
        assert abs(float(inverse_sqrt(s, peak_lr=0.3, warmup=10))
                   - float(ref.inverse_sqrt(jnp.asarray(s), peak_lr=0.3,
                                            warmup=10))) < 1e-7
    assert float(constant(5, lr=0.25)) == 0.25


def test_data_pipeline_deterministic_and_prefetches():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import lm_data_iterator, synth_lm_batch

    cfg = get_config("smollm-360m", smoke=True)
    shape = ShapeConfig("t", 16, 4, "train")
    b1 = synth_lm_batch(cfg, shape, 3, seed=1)
    b2 = synth_lm_batch(cfg, shape, 3, seed=1)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = synth_lm_batch(cfg, shape, 4, seed=1)
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    batches = list(lm_data_iterator(cfg, shape, num_steps=5, seed=1,
                                    device="cpu"))
    assert len(batches) == 5
    assert batches[3]["tokens"].device.type == "cpu"
    np.testing.assert_array_equal(batches[3]["tokens"].numpy(), b1["tokens"])


@pytest.mark.parametrize("arch", ["smollm-360m", "llava-next-34b",
                                  "seamless-m4t-large-v2"])
def test_synth_lm_batch_is_bitwise_the_reference(arch):
    from repro.configs import get_config as jax_get_config
    from repro.configs.base import ShapeConfig as JaxShape
    from repro.data.pipeline import synth_lm_batch as jax_batch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import synth_lm_batch

    got = synth_lm_batch(get_config(arch, smoke=True),
                         ShapeConfig("t", 24, 4, "train"), 7, seed=3,
                         host_id=1, num_hosts=2)
    want = jax_batch(jax_get_config(arch, smoke=True),
                     JaxShape("t", 24, 4, "train"), 7, seed=3, host_id=1,
                     num_hosts=2)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_train_state_from_numpy_carries_adafactor_state():
    """The reference's Adafactor state after one step, carried across: the
    momentum per layer, the statistics in the reference's stacked layout
    bitwise (a stacked norm scale's factored pair included), and a second
    update from it equal to the reference's."""
    import dataclasses

    from repro.configs import get_config as jax_get_config
    from repro.models import steps as jax_steps
    from repro_torch.configs import get_config

    jcfg = dataclasses.replace(jax_get_config("llama3-405b", smoke=True),
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32,
                               optimizer="adafactor",
                               optstate_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(get_config("llama3-405b", smoke=True),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32,
                              optimizer="adafactor",
                              optstate_dtype=torch.bfloat16)
    jstate = jax.jit(lambda k: jax_steps.make_train_state(jcfg, k))(
        jax.random.PRNGKey(0))
    g = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype) + p,
                     jstate["params"])
    from repro.optim.adafactor import adafactor_update
    _, opt = adafactor_update(g, jstate["opt"], jstate["params"], lr=0.1)
    tree = jax.tree.map(np.asarray, {"params": jstate["params"], "opt": opt})
    st = nn.train_state_from_numpy(tree, cfg)
    assert int(st["opt"]["step"]) == 1
    assert st["opt"]["m"]["layers"][1]["mixer"]["wq"].dtype == torch.bfloat16
    for name in ("vr", "vc"):
        got = st["opt"][name]
        want = nn.tree_leaves(nn.tree_map(lambda _, a: a, got,
                                          tree["opt"][name]))
        assert len(nn.tree_leaves(got)) == len(jax.tree.leaves(opt[name]))
        for a, b in zip(nn.tree_leaves(got), want):
            np.testing.assert_array_equal(a.numpy(), b)
    assert tuple(st["opt"]["vr"]["blocks"][0]["ln1"]["scale"].shape) == (
        tree["opt"]["vr"]["blocks"][0]["ln1"]["scale"].shape)
    from repro_torch.optim.adafactor import adafactor_update as port_update
    jp, jo = adafactor_update(g, opt, jstate["params"], lr=0.1)
    port_update(nn.params_from_numpy(jax.tree.map(np.asarray, g), cfg),
                st["opt"], st["params"], lr=0.1,
                layout=lambda t: nn.stacked(t, cfg))
    for a, b in zip(nn.tree_leaves(st["params"]),
                    nn.tree_leaves(nn.params_from_numpy(
                        jax.tree.map(np.asarray, jp), cfg))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-5)
    got = st["opt"]["vr"]
    for a, b in zip(nn.tree_leaves(got), nn.tree_leaves(
            nn.tree_map(lambda _, x: np.asarray(x), got, jo["vr"]))):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5)


def test_train_launcher_on_the_host(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` on a smoke
    config: the reference's lines, a checkpoint, a falling loss."""
    from repro_torch.launch import train

    train.main(["--arch", "smollm-360m", "--device", "cpu", "--steps", "6",
                "--ckpt-every", "3", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     5 loss" in out and "done: 6 steps" in out
    assert CheckpointManager(tmp_path).latest_step() == 6


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_train_lm_smoke",
                                  "torch_train_specificity"])
def test_examples_run_on_the_host(name, capsys):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--steps", "20"])
    assert capsys.readouterr().out
