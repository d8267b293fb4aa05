"""Nothing of the benchmark imports JAX or the JAX package, and neither
the reference nor the control imports anything of the program. Module
names are compared whole by their top-level part: ``repro_torch`` is the
program, not the JAX package ``repro``."""

import ast
import pathlib

BENCH = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = "repro_torch"


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                names.add("semhist_bench." + (node.module or ""))
            elif node.module == "semhist_bench":
                names |= {f"semhist_bench.{a.name}" for a in node.names}
            else:
                names.add(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") in ("importorskip", "import_module"):
            names |= {a.value for a in node.args
                      if isinstance(a, ast.Constant)
                      and isinstance(a.value, str)}
    return names


def _top(name: str) -> str:
    return name.split(".")[0]


def _closure(start: str) -> set[str]:
    """Every module ``start`` reaches inside the benchmark, and every
    outside name those import."""
    todo, seen, outside = [start], set(), set()
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = BENCH / (mod.split(".", 1)[1].replace(".", "/") + ".py")
        if not path.is_file():
            path = BENCH / mod.split(".", 1)[1] / "__init__.py"
        for name in _imports(path):
            if _top(name) == "semhist_bench":
                todo.append(name if name.count(".") else name)
            else:
                outside.add(name)
    return outside


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        bad = {n for n in _imports(path) if _top(n) in FORBIDDEN}
        assert not bad, f"{path.name} imports {sorted(bad)}"


def test_the_reference_and_the_control_import_nothing_of_the_program():
    for start in ("semhist_bench.reference", "semhist_bench.control"):
        outside = _closure(start)
        assert "torch" in {_top(n) for n in outside}
        bad = {n for n in outside if _top(n) in FORBIDDEN | {PROGRAM}}
        assert not bad, f"{start} reaches {sorted(bad)}"


def test_names_are_compared_whole():
    assert _top("repro_torch.core.optimizer") != "repro"
    assert _top("repro.core") in FORBIDDEN
    assert _top("jaxlib") in FORBIDDEN and _top("jaxtyping") not in FORBIDDEN


def test_the_vlm_references_import_nothing_of_the_program():
    """``vlmcheck`` and every ``vlm/<id>.py`` reach neither JAX nor the
    program."""
    refs = sorted((BENCH / "vlm").glob("*.py"))
    assert refs
    outside = _closure("semhist_bench.vlmcheck")
    for path in refs:
        for name in _imports(path):
            if _top(name) == "semhist_bench":
                outside |= _closure(name)
            else:
                outside.add(name)
    assert "torch" in {_top(n) for n in outside}
    bad = {n for n in outside if _top(n) in FORBIDDEN | {PROGRAM}}
    assert not bad, f"the VLM's reference reaches {sorted(bad)}"
