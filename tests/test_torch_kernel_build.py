"""The kernels' build cache (``repro_torch.kernels._build``) on the host: a
library's name hashes its source and every header the source includes, so
an edit to a shared header (``csrc/hopper.cuh``) builds the libraries that
include it anew instead of loading a stale one. No ``nvcc`` is needed: the
name is computed from the files alone."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


def test_target_hashes_the_included_headers(tmp_path, monkeypatch):
    """Changing the bytes of a header included by a header changes the
    target's name; changing a file nobody includes does not."""
    (tmp_path / "k.cu").write_bytes(b'#include "a.cuh"\n#include <stdint.h>\n'
                                    b"int f() { return g(); }\n")
    (tmp_path / "a.cuh").write_bytes(b'#pragma once\n  # include "b.cuh"\n')
    (tmp_path / "b.cuh").write_bytes(b"int g() { return 1; }\n")
    (tmp_path / "other.cuh").write_bytes(b"int h();\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _build._target("k")
    (tmp_path / "other.cuh").write_bytes(b"int h(); int i();\n")
    assert _build._target("k") == first
    (tmp_path / "b.cuh").write_bytes(b"int g() { return 2; }\n")
    second = _build._target("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "b.cuh").write_bytes(b"int g() { return 1; }\n")
    assert _build._target("k") == first


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd"])
def test_flash_sources_include_the_shared_header(name):
    """Both flash sources take their Hopper helpers from ``hopper.cuh``,
    so it is part of both libraries' names."""
    assert [p.name for p in _build.sources(name)] == [f"{name}.cu",
                                                      "hopper.cuh"]
