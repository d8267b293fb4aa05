"""The PyTorch port imports neither JAX nor the JAX package, and its entry
points never fall back to the CPU quietly."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _port_modules() -> list[str]:
    pkg = SRC / "repro_torch"
    mods = []
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax_and_no_reference():
    mods = _port_modules()
    for m in ("kernels.cosine_topk.ops", "launch.serve", "index.clustered",
              "index.mutable", "launch.coalescer", "obs.hub",
              "index.sharded", "launch.mesh", "launch.fleet",
              "models.ssm", "models.encdec", "configs.jamba_v0_1_52b",
              "configs.seamless_m4t_large_v2", "configs.llama3_405b",
              "models.flash_ref", "models.steps", "optim.adamw",
              "optim.adafactor", "optim.schedules", "checkpoint.manager",
              "data.pipeline", "runtime.fault_tolerance", "launch.train",
              "analysis.cost", "analysis.roofline", "launch.dryrun",
              "launch.specs", "runtime.elastic", "optim.grad_compression"):
        assert f"repro_torch.{m}" in mods
    script = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300,
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_card_tests_import_no_jax_and_no_reference():
    """The tests marked ``cuda`` run on a machine with a card and no JAX:
    they live in ``test_torch_cuda_*.py``, which — with any helper module
    of ``tests/`` they import — import neither ``jax`` nor ``repro``, and
    no other test file holds a ``cuda``-marked test."""
    tests = pathlib.Path(__file__).resolve().parent
    todo = sorted(tests.glob("test_torch_cuda_*.py"))
    assert len(todo) == 10
    seen = set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", "") == "importorskip"):
                names = [a.value for a in node.args
                         if isinstance(a, ast.Constant)]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "repro"), \
                    f"{path.name} imports {name}"
                if (tests / f"{top}.py").exists():
                    todo.append(tests / f"{top}.py")
    for path in sorted(tests.glob("test_*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            marks = [d for d in getattr(node, "decorator_list", [])
                     if getattr(d, "attr", "") == "cuda"
                     and getattr(d.value, "attr", "") == "mark"]
            assert not marks or path.name.startswith("test_torch_cuda_"), \
                f"{path.name}::{node.name} is marked cuda"


def test_resolve_device_raises_without_cuda(monkeypatch):
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_non_cuda_tensors():
    """On a CPU tensor the ops use the plain version; the launchers
    themselves take only CUDA tensors and raise otherwise."""
    from repro_torch.kernels.cosine_topk.kernel import probe
    from repro_torch.kernels.kmeans.kernel import assign_blocks

    x = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        probe(x, x[:1], torch.zeros((1, 1)), k=1, n_valid=8)
    with pytest.raises(ValueError, match="CUDA"):
        probe(x, x[:2], torch.zeros((2, 1)), k=1, n_valid=8,
              mask=torch.ones(8, dtype=torch.int32), mode="and")
    with pytest.raises(ValueError, match="CUDA"):
        assign_blocks(x, x[:2])


def test_attention_launchers_refuse_non_cuda_tensors():
    """The KV-batch kernels' launchers, likewise; the modules of the slice
    are among those the import test above loads."""
    from repro_torch.kernels.decode_attention.kernel import decode_fwd
    from repro_torch.kernels.expected_attention.kernel import ea_scores
    from repro_torch.kernels.flash_attention.kernel import flash_fwd

    mods = _port_modules()
    for m in ("models.lm", "models.steps", "serving.compress", "core.kvbatch",
              "kernels.flash_attention.kernel",
              "kernels.decode_attention.kernel",
              "kernels.expected_attention.kernel"):
        assert f"repro_torch.{m}" in mods
    q, kv = torch.zeros((1, 4, 2, 16)), torch.zeros((1, 4, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd(q, kv, kv, causal=True, window=None, scale=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        decode_fwd(q[:, :1], kv, kv, torch.full((1,), 4, dtype=torch.int32),
                   scale=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        ea_scores(kv, kv, torch.zeros((1, 2, 16)), torch.zeros((1, 2, 16)))
