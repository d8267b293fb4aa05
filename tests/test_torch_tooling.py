"""The port's analysis and runtime tooling against the reference's, on
the CPU: the gradient-compression codecs and the two-stage all-reduce
(``tests/test_properties.py``, ``tests/test_runtime.py`` and the int8
check of ``tests/test_multidevice.py`` in one process), the cost count and
roofline (``tests/test_hlo_cost.py``) on the meta device, the count of a
smoke prefill against ``repro.analysis.hlo_cost`` on the reference's
compiled step, the loop-aware count of a train step (and a real step's
state left as the step leaves it), the flash kernel's visible pairs, one
dry-run cell end to end, and the meta device's route to the plain
attention versions."""

import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.analysis import hlo_cost  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import nn as jax_nn  # noqa: E402
from repro.models import steps as jax_steps  # noqa: E402
from repro.optim import grad_compression as jgc  # noqa: E402
from repro_torch.analysis import cost, roofline  # noqa: E402
from repro_torch.configs import ASSIGNED, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.models import nn, steps  # noqa: E402
from repro_torch.optim import grad_compression as gc  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Gradient compression (tests/test_properties.py, tests/test_runtime.py)
# ---------------------------------------------------------------------------


@given(st.integers(0, 2**32 - 1))
@settings(max_examples=25, deadline=None)
def test_int8_roundtrip_bounded_error(seed):
    rng = np.random.default_rng(seed)
    xn = rng.standard_normal(257).astype(np.float32) * 10
    x = torch.from_numpy(xn)
    q, s = gc.int8_encode(x)
    rec = gc.int8_decode(q, s)
    assert float((rec - x).abs().max()) <= float(s) * 0.5 + 1e-6
    jq, js = jgc.int8_encode(jnp.asarray(xn))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


@given(st.integers(0, 2**32 - 1), st.sampled_from(["int8", "topk"]))
@settings(max_examples=10, deadline=None)
def test_error_feedback_contracts(seed, codec):
    """The compressed sum converges to the true sum: the cumulative applied
    update tracks the cumulative gradient; every step's output and buffer
    against the reference's on the same inputs."""
    rng = np.random.default_rng(seed)
    gn = rng.standard_normal((32, 16)).astype(np.float32)
    g_true = {"w": torch.from_numpy(gn)}
    ef = gc.ef_init(g_true)
    jg, jef = {"w": jnp.asarray(gn)}, jgc.ef_init({"w": jnp.asarray(gn)})
    applied = torch.zeros_like(g_true["w"])
    for _ in range(20):
        rec, ef = gc.ef_compress(g_true, ef, codec=codec, topk_frac=0.25)
        jrec, jef = jgc.ef_compress(jg, jef, codec=codec, topk_frac=0.25)
        np.testing.assert_allclose(rec["w"].numpy(), np.asarray(jrec["w"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ef["w"].numpy(), np.asarray(jef["w"]),
                                   rtol=1e-5, atol=1e-5)
        applied = applied + rec["w"]
    target = g_true["w"] * 20
    drift = float(torch.linalg.norm(applied - target)
                  / torch.linalg.norm(target))
    assert drift < 0.15, drift


@given(st.integers(0, 2**32 - 1), st.floats(0.05, 0.9))
@settings(max_examples=20, deadline=None)
def test_topk_mask_keeps_largest(seed, frac):
    rng = np.random.default_rng(seed)
    xn = rng.standard_normal(128).astype(np.float32)
    mask = gc.topk_mask(torch.from_numpy(xn), frac).numpy()
    kept = np.abs(xn)[mask > 0]
    dropped = np.abs(xn)[mask == 0]
    if len(kept) and len(dropped):
        assert kept.min() >= dropped.max() - 1e-6
    np.testing.assert_array_equal(mask, np.asarray(jgc.topk_mask(
        jnp.asarray(xn), frac)))


def test_two_stage_allreduce_single_axis_noop():
    """Without a 'pod' axis the compressed reduce is the identity."""
    g = {"w": torch.ones((4, 4))}
    out = gc.two_stage_allreduce(g, mesh=Mesh(("data",), (1,)))
    assert torch.equal(out["w"], torch.ones((4, 4)))
    assert gc.two_stage_allreduce(g, mesh=Mesh(("data", "model"), (16, 16))) \
        is g


def _replicated(g, shape):
    return g.expand(*shape, *g.shape).clone()


def test_two_stage_allreduce_int8_one_process():
    """tests/test_multidevice.py's check in one process: 2 pods x 4 data
    shards, every shard holding the same (64, 32) gradient; the int8 path
    within 0.02 of 8 g (relative to its largest element), the float32 path
    the exact sum within float32 rounding, every shard the same result,
    and the wire bytes of the ring formulas."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    mesh = Mesh(("pod", "data"), (2, 4))
    wire = {}
    red = gc.two_stage_allreduce({"w": _replicated(g, (2, 4))}, mesh=mesh,
                                 codec="int8", wire=wire)["w"]
    exact = 8.0 * g
    assert red.shape == (2, 4, 64, 32)
    for p in range(2):
        for d in range(4):
            assert torch.equal(red[p, d], red[0, 0])
    rel = float((red[1, 3] - exact).abs().max() / exact.abs().max())
    assert rel < 0.02, rel
    n = 64 * 32
    assert wire == {"data": 2 * 3 / 4 * 4 * n,
                    "pod": 2 * 1 / 2 * 4 * n + 2 * 1 / 2 * 4}
    f = gc.two_stage_allreduce({"w": _replicated(g, (2, 4))}, mesh=mesh,
                               codec="none")["w"]
    torch.testing.assert_close(f[1, 2], exact, rtol=4 * 2**-24, atol=0)
    # a "model" axis: each (pod, model) device reduces its own block
    mesh3 = Mesh(("pod", "data", "model"), (2, 4, 2))
    m3 = gc.two_stage_allreduce({"w": _replicated(g, (2, 4, 2))},
                                mesh=mesh3)["w"]
    assert m3.shape == (2, 4, 2, 64, 32) and torch.equal(m3[1, 0, 1],
                                                         red[0, 0])


# ---------------------------------------------------------------------------
# Cost count and roofline (tests/test_hlo_cost.py)
# ---------------------------------------------------------------------------


def test_roofline_terms_and_bottleneck():
    a = _meta((4096, 4096), torch.bfloat16)
    b = _meta((4096, 4096), torch.bfloat16)
    out, c = cost.count(lambda a, b: torch.tanh(a @ b), a, b)
    assert out.device.type == "meta"
    r = roofline.analyze(c, model_flops=2 * 4096 ** 3)
    assert r.flops == pytest.approx(2 * 4096 ** 3, rel=0.01)
    assert r.useful_ratio == pytest.approx(1.0, rel=0.01)
    assert r.bottleneck in ("compute", "memory")
    assert r.compute_term > 0 and r.memory_term > 0
    p = roofline.peaks()
    assert r.compute_term == pytest.approx(2 * 4096 ** 3 / p.bf16)
    # mm reads a and b and writes a x b; tanh reads and writes it again
    assert r.hbm_bytes == 5 * 4096 ** 2 * 2


def test_cost_views_and_fused_regions():
    x = torch.zeros((64, 64))
    _, c = cost.count(lambda x: x.view(-1).reshape(64, 64).t().T, x)
    assert c.hbm_bytes == 0 and c.flops == 0
    _, c = cost.count(lambda x: cost.fused("f", lambda y: (y @ y).exp(), x),
                      x)
    assert c.flops == 2 * 64 ** 3
    assert c.ops["f"]["bytes"] == 2 * 64 * 64 * 4 and c.hbm_bytes == \
        c.ops["f"]["bytes"]


@pytest.mark.parametrize("sq,sk,causal,window", [
    (7, 7, True, None), (7, 7, True, 3), (7, 7, False, None),
    (5, 9, True, 2), (9, 5, True, None), (64, 64, True, 64)])
def test_visible_pairs_and_the_flash_count(sq, sk, causal, window):
    """The flash kernel's work is the pairs its mask lets through: against
    a count of the plain version's mask, and the meta route's fused op
    carries exactly those FLOPs (not the plain version's full product)."""
    i, j = np.arange(sq)[:, None], np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok = j <= i
        if window is not None:
            ok &= j > i - window
    pairs = cost.visible_pairs(sq, sk, causal=causal, window=window)
    assert pairs == int(ok.sum())
    from repro_torch.kernels.flash_attention import ops as fa

    q = _meta((2, sq, 4, 16), torch.bfloat16)
    kv = _meta((2, sk, 2, 16), torch.bfloat16)
    _, c = cost.count(fa.flash_attention, q, kv, kv, causal=causal,
                      window=window)
    assert c.ops["flash_attention"]["flops"] == 2 * 2 * 4 * (16 + 16) * pairs
    assert c.flops_by_dtype["bfloat16"] == c.flops


def test_peaks_are_the_cards():
    assert roofline.peaks("NVIDIA H100 80GB HBM3").bf16 == 989e12
    assert roofline.peaks("NVIDIA H100 PCIe").hbm_bw == 2.0e12
    assert roofline.peaks().link_bw == 4.5e11     # 450 GB/s each way
    with pytest.raises(KeyError):
        roofline.peaks("TPU v5 lite")
    for g in (1, 2, 16):
        for kind in ("all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute"):
            assert roofline.wire_bytes(kind, 1e6, g) == hlo_cost._wire(
                kind, 1e6, g)


def test_prefill_count_against_reference_hlo():
    """smollm's smoke config, B 1, S 1536: the port's count on the meta
    device against ``analyze_hlo(...).flops`` of the reference's compiled
    CPU prefill. The reference's attention past 1024 queries is its
    chunked flash, which pads the sequence to whole 1024-chunks (2048) and
    computes every (q, kv) tile; the port counts the flash kernel's own
    work, the S (S + 1) / 2 causal pairs. The gap is exactly that,
    4 B H D (2048^2 - S (S + 1) / 2) a layer; the rest agrees within 1%."""
    B, S = 1, 1536
    cfg, jcfg = (get_config("smollm-360m", smoke=True),
                 jax_get_config("smollm-360m", smoke=True))
    step = steps.make_prefill_step(cfg, batch=B, max_len=S)
    params = nn.abstract_params(steps.model_specs(cfg))
    (logits, _), c = cost.count(step, params,
                                {"tokens": _meta((B, S))})
    assert tuple(logits.shape) == (B, cfg.vocab_size)
    jstep = jax_steps.make_prefill_step(jcfg, batch=B, max_len=S)
    jparams = jax_nn.abstract_params(jax_steps.model_specs(jcfg))
    hlo = jax.jit(jstep).lower(
        jparams, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    ).compile().as_text()
    ref = hlo_cost.analyze_hlo(hlo).flops
    pad = 2048
    gap = cfg.num_layers * 4 * B * cfg.num_heads * cfg.head_dim * (
        pad ** 2 - S * (S + 1) // 2)
    assert c.flops + gap == pytest.approx(ref, rel=0.01), (c.flops, gap, ref)
    assert c.ops["flash_attention"]["count"] == cfg.num_layers


def _train_state_and_batch(cfg, device, B=4, S=64):
    if device == "meta":
        state = steps.make_train_state(cfg, abstract=True)
    else:
        state = steps.make_train_state(cfg, torch.Generator().manual_seed(0),
                                       device=device)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(device)
        for k in ("tokens", "labels")}
    return state, batch


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-30b-a3b"])
def test_train_count_loop_aware_equals_every_microbatch(arch, monkeypatch):
    """One microbatch counted m times plus the update once (meta tensors)
    equals counting each of the m microbatches (``trips`` as a plain
    range, which is what it gives off the meta device)."""
    cfg = get_config(arch, smoke=True)
    step = steps.make_train_step(cfg, num_microbatches=4)
    _, once = cost.count(step, *_train_state_and_batch(cfg, "meta"))
    with monkeypatch.context() as mp:
        mp.setattr(cost, "trips", lambda n, like: range(n))
        _, each = cost.count(step, *_train_state_and_batch(cfg, "meta"))
    assert once.flops == pytest.approx(each.flops, rel=1e-12)
    assert once.hbm_bytes == pytest.approx(each.hbm_bytes, rel=1e-12)
    assert set(once.ops) == set(each.ops)
    for k in each.ops:
        assert once.ops[k]["bytes"] == pytest.approx(each.ops[k]["bytes"],
                                                     rel=1e-12), k
    # one microbatch of the whole batch: the same products, and the
    # weights and the accumulators read once instead of m times
    _, one = cost.count(steps.make_train_step(cfg, num_microbatches=1),
                        *_train_state_and_batch(cfg, "meta"))
    assert one.flops == each.flops and one.hbm_bytes < each.hbm_bytes


def test_count_of_a_real_step_leaves_the_steps_state():
    """Counting a real (CPU) train step runs every microbatch: the state
    and metrics are bitwise the step's without the mode."""
    cfg = get_config("smollm-360m", smoke=True)
    step = steps.make_train_step(cfg, num_microbatches=2)
    plain_state, batch = _train_state_and_batch(cfg, "cpu")
    counted_state, _ = _train_state_and_batch(cfg, "cpu")
    _, plain_metrics = step(plain_state, batch)
    (_, counted_metrics), c = cost.count(step, counted_state, batch)
    assert c.flops > 0
    for a, b in zip(nn.tree_leaves(plain_state),
                    nn.tree_leaves(counted_state)):
        assert torch.equal(a, b)
    for k in plain_metrics:
        assert torch.equal(plain_metrics[k], counted_metrics[k]), k


def test_dryrun_cell_end_to_end(tmp_path):
    """A smoke cell through ``run_cell`` on both meshes: the artifact is
    written, read back on the second call (resumable), and holds the
    placements, per-device bytes, the count and the roofline."""
    shape = ShapeConfig("tiny_train", 64, 32, "train")
    opts = {"smoke": True, "shape": shape, "num_microbatches": 2}
    for kind in ("pod", "multipod"):
        rec = dryrun.run_cell("h2o-danube-1.8b", "tiny_train", kind,
                              out_dir=tmp_path, opts=opts)
        path = tmp_path / f"h2o-danube-1.8b__tiny_train__{kind}.json"
        back = json.loads(path.read_text())
        assert back["cell"] == rec["cell"] and back["device"] == "meta"
        assert back["num_microbatches"] == 2
        assert back["memory"]["fits"] is True
        assert back["memory"]["bytes_per_device"] > 0
        assert back["wire_bytes"] is None and back["wire_bytes_reason"]
        mesh_size = math.prod(back["mesh_shape"].values())
        assert back["cost"]["flops_per_device"] == pytest.approx(
            back["cost"]["flops_global"] / mesh_size)
        # per-device bytes: the split, floored at the device's own
        # arguments and outputs at their shard sizes
        c, mem = back["cost"], back["memory"]
        assert c["hbm_bytes_per_device_split"] == pytest.approx(
            c["hbm_bytes_global"] / mesh_size)
        assert c["hbm_bytes_per_device_floor"] == (
            mem["argument_bytes_per_device"] + mem["output_bytes_per_device"])
        assert c["hbm_bytes_per_device"] == max(
            c["hbm_bytes_per_device_split"], c["hbm_bytes_per_device_floor"])
        assert back["roofline"]["hbm_bytes"] == c["hbm_bytes_per_device"]
        assert back["roofline"]["bottleneck"] in ("compute", "memory")
        assert back["placements"]["params"]["embed"] == [["model", None]]
        axes = {tuple(a["axes"]) for a in back["activation_placements"]}
        assert ("batch", "seq", None) in axes
        again = dryrun.run_cell("h2o-danube-1.8b", "tiny_train", kind,
                                out_dir=tmp_path, opts=opts)
        assert again == back


def test_dryrun_cli_counts_cells(tmp_path, capsys):
    args = types.SimpleNamespace(all=True, mesh="both", arch=None,
                                 shape=None)
    work = dryrun.work_list(args)
    assert len(work) == 66 and len(set(work)) == 66
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                     "--out-dir", str(tmp_path)])
    assert e.value.code == 1
    assert "0/1 cells OK" in capsys.readouterr().out


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_dryrun_state_bytes_and_placements_at_full_width(arch, multi_pod,
                                                         monkeypatch):
    """What the dry-run records for a full-width train cell, against the
    reference's ``state_shardings`` (``NamedSharding`` stood in by its
    spec): the state's per-device bytes (``dryrun.shard_bytes``) are equal,
    and every placement in ``placements_summary`` is one the reference
    resolves (a stacked leaf's less its leading, never-placed "layers"
    entry)."""
    import repro.launch.specs as jax_specs
    from jax.sharding import PartitionSpec as P

    monkeypatch.setattr(jax_nn, "NamedSharding", lambda mesh, spec: spec)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    placed = sp.state_shardings(cfg, mesh)
    jplaced = jax.tree.leaves(
        jax_specs.state_shardings(jcfg, types.SimpleNamespace(
            shape=mesh.shape)), is_leaf=lambda x: isinstance(x, P))
    ref_bytes = 0
    for a, spec in zip(jax.tree.leaves(jax_specs.state_specs(jcfg)),
                       jplaced):
        n = math.prod(a.shape)
        for ax in tuple(spec):
            for name in (ax if isinstance(ax, tuple) else (ax,)):
                if name is not None:
                    n //= mesh.shape[name]
        ref_bytes += n * np.dtype(a.dtype).itemsize
    assert dryrun.shard_bytes(sp.state_specs(cfg), placed) == ref_bytes
    ref = {tuple(s) for s in jplaced} | {tuple(s)[1:] for s in jplaced}
    got = {tuple(tuple(a) if isinstance(a, list) else a for a in p)
           for ps in dryrun.placements_summary(placed).values() for p in ps}
    assert got <= ref


# ---------------------------------------------------------------------------
# The meta device's route
# ---------------------------------------------------------------------------


def test_meta_reaches_plain_attention_and_cuda_the_kernels(monkeypatch):
    """A meta tensor takes each attention op's plain version (the launcher
    is never called); a CUDA tensor still takes the launcher; any other
    device raises in the launcher."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.expected_attention import kernel as ek
    from repro_torch.kernels.expected_attention import ops as ea
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fa

    calls = []

    def launcher(name):
        return lambda *a, **kw: calls.append(name) or "kernel"

    for mod, name in ((fk, "flash_fwd"), (dk, "decode_fwd"),
                      (ek, "ea_scores")):
        monkeypatch.setattr(mod, name, launcher(name))
    q = _meta((2, 16, 4, 32), torch.bfloat16)
    kv = _meta((2, 16, 2, 32), torch.bfloat16)
    assert fa.flash_attention(q, kv, kv).shape == q.shape
    assert da.decode_attention(q[:, :1], kv, kv, kv_valid=5).shape == (
        2, 1, 4, 32)
    assert ea.ea_scores(kv, kv, _meta((2, 2, 32), torch.float32),
                        _meta((2, 2, 32), torch.float32)).shape == (2, 16, 2)
    assert calls == []

    class Card:
        """Stands in for a CUDA tensor: the route reads only its device."""

        device = torch.device("cuda")
        shape = (2, 16, 4, 32)

        def to(self, **kw):
            return self

        def contiguous(self):
            return self

    c = Card()
    assert fa.flash_attention(c, c, c) == "kernel"
    assert da.decode_attention(c, c, c, kv_valid=5) == "kernel"
    assert ea.ea_scores(c, c, c, c) == "kernel"
    assert calls == ["flash_fwd", "decode_fwd", "ea_scores"]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_fwd(q, kv, kv, causal=True, window=None, scale=0.25)
