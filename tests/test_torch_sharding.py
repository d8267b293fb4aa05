"""The port's logical-axis placements against the reference's, and the
meshes and elastic restore built on them, on the CPU.

Placement parity at full width is cheap (no forward runs): for every
``ASSIGNED`` architecture on both production meshes, every leaf of the
params, of the AdamW or Adafactor state and of the ``decode_32k`` cache
resolves to the same per-dim placement as the reference's
``resolve_pspec`` (through ``repro.launch.specs``, with ``NamedSharding``
stood in by its spec: the reference's rules read only ``mesh.shape``, a
dict here), and the summed per-device bytes are equal. The port keeps a
leaf a layer where the reference stacks a period's repeats, so the port's
trees are grouped by ``nn.stacked`` before the comparison."""

import dataclasses
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.specs as jax_specs  # noqa: E402
import repro.models.nn as jax_nn  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import steps as jax_steps  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import ASSIGNED, SHAPES, get_config  # noqa: E402
from repro_torch.launch import mesh as meshes  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.models import nn, steps  # noqa: E402
from repro_torch.runtime.elastic import (elastic_restore,  # noqa: E402
                                         plan_mesh)

MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's shardings as bare PartitionSpecs."""
    monkeypatch.setattr(jax_nn, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax_specs, "NamedSharding", lambda mesh, spec: spec)
    return jax_specs


def _port_mesh(kind):
    return meshes.make_production_mesh(multi_pod=kind == "multipod",
                                       device="meta")


def _stand_in(kind):
    return types.SimpleNamespace(shape=dict(MESHES[kind]))


def _flat_port(tree, prefix=()):
    """{path: spec} of a port tree whose leaves are Placements or Stacks
    of them (a stacked leaf: the reference's leading "layers" entry, never
    placed, before the layer's own)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat_port(sub, prefix + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat_port(sub, prefix + (str(i),)).items()}
    if isinstance(tree, nn.Stack):
        specs = {p.spec for p in tree.xs}
        assert len(specs) == 1, specs       # every repeat placed alike
        return {"/".join(prefix): (None, *specs.pop())}
    return {"/".join(prefix): tuple(tree.spec)}


def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _flat_ref(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(_key(k) for k in path): tuple(spec)
            for path, spec in leaves}


def _group_state(tree, cfg):
    """The port's state placements in the reference's layout: params and
    the moments stacked, Adafactor's statistics as they are."""
    opt = dict(tree["opt"])
    for k in ("m", "v"):
        if k in opt:
            opt[k] = nn.stacked(opt[k], cfg)
    return {"params": nn.stacked(tree["params"], cfg), "opt": opt}


def _group_cache(cache, cfg):
    """The port's per-layer cache list in the reference's layout."""
    def stack(layers):
        return nn.tree_map(lambda *xs: nn.Stack(xs), *layers)

    if cfg.encdec:
        return {"self": stack([c["self"] for c in cache]),
                "cross": stack([c["cross"] for c in cache])}
    return nn.stacked({"layers": cache}, cfg)


def _ref_bytes(abstract, specs, mesh_shape):
    total = 0
    for a, s in zip(jax.tree.leaves(abstract),
                    jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))):
        shape = list(a.shape)
        for i, ax in enumerate(tuple(s)):
            for n in (ax if isinstance(ax, tuple) else (ax,)):
                if n is not None:
                    shape[i] //= mesh_shape[n]
        total += int(np.prod(shape)) * np.dtype(a.dtype).itemsize
    return total


def _port_bytes(tensors, placements):
    return sum(p.shard_bytes(t) for t, p in zip(nn.tree_leaves(tensors),
                                                 nn.tree_leaves(placements)))


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_placement_parity_full_width(arch, kind, ref_specs):
    """Params, optimizer state and the decode_32k cache: every leaf's
    placement and the per-device bytes, port against reference."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    mesh, stand_in = _port_mesh(kind), _stand_in(kind)
    shape = SHAPES["decode_32k"]

    got = _flat_port(_group_state(sp.state_shardings(cfg, mesh), cfg))
    want = _flat_ref(ref_specs.state_shardings(jcfg, stand_in))
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad
    assert (_port_bytes(sp.state_specs(cfg), sp.state_shardings(cfg, mesh))
            == _ref_bytes(jax_specs.state_specs(jcfg),
                          ref_specs.state_shardings(jcfg, stand_in),
                          MESHES[kind]))

    B, S = shape.global_batch, shape.seq_len
    got = _flat_port(_group_cache(sp.cache_shardings(cfg, mesh, B, S), cfg))
    want = _flat_ref(ref_specs.cache_shardings(jcfg, stand_in, B, S))
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad
    cache = sp.decode_input_specs(cfg, shape)["cache"]
    jcache = jax_specs.decode_input_specs(jcfg, shape)["cache"]
    assert (_port_bytes(cache, sp.cache_shardings(cfg, mesh, B, S))
            == _ref_bytes(jcache, ref_specs.cache_shardings(
                jcfg, stand_in, B, S), MESHES[kind]))


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_batch_placements_match_reference(kind, ref_specs):
    """Every cell's inputs: dim 0 over the data axes, or replicated where
    the batch does not divide (the 500k cell's batch of 1)."""
    for arch in ("llava-next-34b", "seamless-m4t-large-v2", "mamba2-130m"):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for name, shape in SHAPES.items():
            batch = sp.train_batch_specs(cfg, shape)
            jbatch = jax_specs.train_batch_specs(jcfg, shape)
            got = _flat_port(sp.batch_shardings(batch, _port_mesh(kind)))
            want = _flat_ref(ref_specs.batch_shardings(jbatch,
                                                       _stand_in(kind)))
            assert got == want, (arch, name)
            assert {k: tuple(v.shape) for k, v in batch.items()} == {
                k: tuple(v.shape) for k, v in jbatch.items()}
    mesh = _port_mesh(kind)
    assert sp.batch_pspec(mesh) == (("pod", "data") if kind == "multipod"
                                    else "data")


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b", "seamless-m4t-large-v2"])
def test_spec_axes_match_reference(arch):
    """Every spec the port builds carries the reference's logical axes and
    shape (the reference's stacked leaves less their "layers" axis)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jspecs = jax.tree.leaves(jax_steps.model_specs(jcfg),
                             is_leaf=jax_nn.is_spec)
    ported = nn.tree_leaves(nn.stacked_specs(steps.model_specs(cfg), cfg))
    key = lambda s: (tuple(s.shape), tuple(s.axes))  # noqa: E731
    assert sorted(map(key, ported)) == sorted(map(key, jspecs))


def test_resolve_pspec_matches_reference_on_edge_cases():
    """Divisibility fallback, claimed axes and tuple axes on both
    meshes, against the reference's function."""
    cases = [((4096, 32, 128), ("embed_fsdp", "heads", "head_dim")),
             ((56, 128, 7168), ("heads", "cache_head_dim", "embed")),
             ((1, 32768, 8, 128), ("batch", None, "kv_heads",
                                   "cache_head_dim")),
             ((128, 8, 64, 128), ("batch", "ssm_heads", None, None)),
             ((24,), ("ssm_heads",)), ((7, 5), ()), ((), ())]
    for kind in MESHES:
        for shape, axes in cases:
            want = tuple(jax_nn.resolve_pspec(shape, axes, _stand_in(kind)))
            got = nn.resolve_pspec(shape, axes, _port_mesh(kind))
            assert got == want, (kind, shape, axes)


def test_meshes():
    pod = meshes.make_production_mesh()
    multi = meshes.make_production_mesh(multi_pod=True)
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    assert meshes.make_local_mesh().shape == {"data": 1, "model": 1}
    assert meshes.data_axes(multi) == ("pod", "data")
    assert meshes.data_axes(pod) == ("data",)
    assert meshes.mesh_axis_sizes(multi) == multi.shape
    probe = meshes.make_probe_mesh(2, device="cpu")
    assert meshes.data_axes(probe) == ("data",)
    p = nn.Placement(multi, (("pod", "data"), "model"))
    assert p.shard_shape((64, 32, 3)) == (2, 2, 3)
    assert p.shard_bytes(torch.empty((64, 32, 3), dtype=torch.bfloat16,
                                     device="meta")) == 2 * 2 * 3 * 2


def test_logical_constraint_records_only_in_a_mesh_context():
    x = torch.zeros((32, 8, 16))
    axes = ("batch", "seq", "vocab")
    assert nn.logical_constraint(x, axes) is x
    mesh = meshes.make_production_mesh(multi_pod=True)
    with nn.mesh_context(mesh) as scope:
        assert nn.logical_constraint(x, axes) is x
        nn.logical_constraint(x, axes)
    assert scope.constraints == {(axes, (32, 8, 16)):
                                 [(("pod", "data"), None, "model"), 2]}
    assert nn.logical_constraint(x, axes) is x
    assert nn._MESH_CTX.get() is None


def test_model_records_activation_placements():
    """The reference's call sites: a prefill inside a mesh context records
    the embeddings', the flash inputs' and the logits' placements."""
    cfg = get_config("smollm-360m", smoke=True)
    params = nn.abstract_params(steps.model_specs(cfg))
    step = steps.make_prefill_step(cfg, batch=32, max_len=64)
    tokens = torch.zeros((32, 64), dtype=torch.int32, device="meta")
    with nn.mesh_context(meshes.make_production_mesh()) as scope:
        logits, _ = step(params, {"tokens": tokens})
    axes = {a for a, _ in scope.constraints}
    assert {("batch", "seq", None), ("batch", None, "heads", None),
            ("batch", None, "kv_heads", None),
            ("batch", "seq", "vocab")} <= axes
    assert logits.device.type == "meta"


# ---------------------------------------------------------------------------
# Elastic re-meshing (tests/test_runtime.py)
# ---------------------------------------------------------------------------


def test_elastic_mesh_plan():
    p = plan_mesh(512, model_parallel=16)
    assert p.shape == (32, 16)
    p = plan_mesh(500, model_parallel=16)   # 12 chips lost
    assert p.shape == (31, 16)
    assert p.build(device="cpu").shape == {"data": 31, "model": 16}
    with pytest.raises(ValueError):
        plan_mesh(8, model_parallel=16)


def _tiny_state():
    return {"params": {"w": torch.arange(6, dtype=torch.float32)
                       .reshape(2, 3)},
            "opt": {"mu": torch.zeros(2, 3)}}


def test_elastic_restore_changes_sharding(tmp_path):
    """Restore re-places onto a different (single-device here) mesh."""
    mgr = CheckpointManager(tmp_path)
    st = _tiny_state()
    mgr.save(1, st)
    mesh = meshes.Mesh(("data",), (1,), device="cpu")
    sh = nn.tree_map(lambda _: nn.Placement(mesh, ()), st)
    back = mgr.restore(1, like=st, shardings=sh)
    assert back["params"]["w"].placement == nn.Placement(mesh, ())
    assert torch.equal(back["params"]["w"], st["params"]["w"])


def test_elastic_restore_of_a_train_state(tmp_path):
    """A smoke config's train state (bf16 params, Adafactor statistics on
    the stacked layout) restored from meta stand-ins onto the local mesh:
    bitwise, every leaf on the mesh's device with the placement of
    ``state_shardings``."""
    cfg = dataclasses.replace(get_config("llama3-405b", smoke=True),
                              optimizer="adafactor")
    state = steps.make_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, state)
    mesh = meshes.make_local_mesh(device="cpu")
    back = elastic_restore(mgr, cfg, steps.make_train_state(cfg,
                                                            abstract=True),
                           mesh)
    want = nn.tree_leaves(sp.state_shardings(cfg, mesh))
    for a, b, p in zip(nn.tree_leaves(back), nn.tree_leaves(state), want):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert a.device.type == "cpu" and a.placement == p
