"""The kernel build's content hash covers the headers a source includes,
so an edited ``csrc/*.cuh`` never loads a stale library. Builds nothing."""

from opensetgaitrecognition_pcaa_tpu_torch.ops import _build


def _tree(tmp_path):
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "engine.cuh"\nint f();\n')
    (tmp_path / "engine.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("constexpr int kTile = 128;\n")
    (tmp_path / "other.cuh").write_text("constexpr int kOther = 1;\n")
    return tmp_path


def test_digest_changes_with_an_included_header(tmp_path):
    src = _tree(tmp_path)
    before = _build.source_digest("k", src)
    assert _build.source_digest("k", src) == before
    (src / "engine.cuh").write_text('#pragma once\n#include "inner.cuh"\n// edited\n')
    assert _build.source_digest("k", src) != before


def test_digest_follows_headers_included_by_headers(tmp_path):
    src = _tree(tmp_path)
    before = _build.source_digest("k", src)
    (src / "inner.cuh").write_text("constexpr int kTile = 64;\n")
    assert _build.source_digest("k", src) != before


def test_digest_ignores_headers_not_included(tmp_path):
    src = _tree(tmp_path)
    before = _build.source_digest("k", src)
    (src / "other.cuh").write_text("constexpr int kOther = 2;\n")
    assert _build.source_digest("k", src) == before


def test_both_pointnet_sources_include_the_engine():
    for name in ("pointnet_infer", "pointnet_train"):
        text = (_build.SRC_DIR / f"{name}.cu").read_text()
        assert _build._INCLUDE.findall(text) == ["tf32x3.cuh"], name


def test_digest_follows_a_redirected_source_dir(tmp_path, monkeypatch):
    # load_library compiles SRC_DIR as it stands at the call, so the digest
    # must hash that directory and not the one of import time
    shipped = _build.source_digest("pointnet_train")
    copy = tmp_path / "csrc"
    copy.mkdir()
    for path in _build.SRC_DIR.iterdir():
        if path.is_file():
            (copy / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "SRC_DIR", copy)
    assert _build.source_digest("pointnet_train") == shipped
    header = copy / "tf32x3.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert _build.source_digest("pointnet_train") != shipped


def test_a_cached_library_brings_back_its_build_log(tmp_path, monkeypatch):
    # a library built by an earlier process is loaded without nvcc, and its
    # ptxas report comes from the log written beside it at the build
    src = tmp_path / "csrc"
    src.mkdir()
    _tree(src)
    build = tmp_path / "kernels"
    build.mkdir()
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("loaded", path))
    so = build / f"libk_{_build.source_digest('k', src)}.so"
    so.write_bytes(b"")
    so.with_suffix(".log").write_text("ptxas info    : Used 168 registers\n")
    assert _build.load_library("k") == ("loaded", str(so))
    assert _build.BUILD_LOGS["k"] == "ptxas info    : Used 168 registers\n"
