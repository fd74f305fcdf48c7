"""The kernel build's content hash covers the headers a source includes,
so an edited ``csrc/*.cuh`` never loads a stale library. Builds nothing."""

import re

import pytest

from benchmark import tracing
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


def _headers(name):
    """The ``csrc/`` headers ``<name>.cu`` includes, directly or through
    another header, in include order."""
    out = []

    def visit(text):
        for inc in _build._INCLUDE.findall(text):
            path = _build.SRC_DIR / inc
            if inc not in out and path.is_file():
                out.append(inc)
                visit(path.read_text())

    visit((_build.SRC_DIR / f"{name}.cu").read_text())
    return out


def test_both_pointnet_sources_include_the_engine():
    # the train layer kernel runs the mma.sync engine; the eval kernel the
    # wgmma engine, which takes its split and epilogue helpers from it
    assert _headers("pointnet_train") == ["tf32x3.cuh"]
    assert _headers("pointnet_infer") == ["tf32x3_wgmma.cuh", "tf32x3.cuh"]


def _kernel_names(text):
    """The ``__global__`` functions of a CUDA source, each with the
    namespaces around it, as a profiler names them (``a::b::kernel``; an
    unnamed namespace as ``(anonymous namespace)``)."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)
    names, scopes, depth = [], [], 0
    token = re.compile(r"namespace\s*(\w*)\s*\{|__global__|\{|\}")
    for m in token.finditer(text):
        if m.group(0).startswith("namespace"):
            scopes.append((m.group(1) or "(anonymous namespace)", depth))
            depth += 1
        elif m.group(0) == "{":
            depth += 1
        elif m.group(0) == "}":
            depth -= 1
            if scopes and scopes[-1][1] == depth:
                scopes.pop()
        else:
            name = next(c.group(1) for c in re.finditer(r"(\w+)\s*\(", text[m.end():])
                        if c.group(1) != "__launch_bounds__")
            names.append("::".join([s for s, _ in scopes] + [name]))
    return names


def test_kernel_name_parser():
    text = ("namespace a {\nstruct S { int x; };\n// __global__ void gone()\n"
            "__global__ void __launch_bounds__(64) k1(int) {}\n}  // namespace a\n"
            "namespace {\ntemplate <class E>\n__global__ void k2(E e) { if (1) {} }\n}\n"
            "__global__ void k3() {}\n")
    assert _kernel_names(text) == ["a::k1", "(anonymous namespace)::k2", "k3"]


def test_eval_kernels_keep_names_the_benchmark_finds():
    """Every kernel the eval PointNet source can launch (its own and those
    of the headers it includes) carries a name fragment that the
    benchmark's trace reader counts as the eval kernel
    (``PORT_KERNELS["pointnet_infer"]``): the roofline reads their device
    time and the launch check their number."""
    names = []
    for path in ["pointnet_infer.cu"] + _headers("pointnet_infer"):
        names += _kernel_names((_build.SRC_DIR / path).read_text())
    assert {"tf32x3_wgmma::gemm_kernel", "tf32x3_wgmma::split_kernel",
            "(anonymous namespace)::group_mean_kernel"} <= set(names), names
    fragments = tracing.PORT_KERNELS["pointnet_infer"]
    for name in names:
        assert any(f in name.lower() for f in fragments), name


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


@pytest.mark.parametrize("part,kernels", [
    ("p4t_group", {"p4t_fps_kernel", "p4t_ball_query_kernel"}),
    ("p4t_tube", {"p4t_tube_fwd_kernel", "p4t_tube_bwd_kernel", "p4t_tube_reduce_kernel"}),
    ("p4t_linear", {"p4t_linear_wgrad_kernel", "p4t_linear_reduce_kernel"}),
])
def test_p4t_kernels_keep_names_the_benchmark_finds(part, kernels):
    """Every kernel of a P4Transformer source carries a name fragment of its
    benchmark part (``benchmark/kernels/<part>.json``), whose roofline reads
    their device time and whose launch check counts them."""
    names = _kernel_names((_build.SRC_DIR / f"{part}.cu").read_text())
    assert {n.split("::")[-1] for n in names} == kernels, names
    for name in names:
        assert any(f in name.lower() for f in tracing.PORT_KERNELS[part]), name


def test_p4t_linear_engine_launches_carry_the_part_name():
    """The dense products' forward and input gradient run the engine's
    ``gemm_kernel`` and ``split_kernel_tagged``, whose names a profiler
    gives with their template arguments: every epilogue and split tag
    ``p4t_linear.cu`` hands the engine holds ``p4t_linear``, and the file
    includes the engine beside it."""
    text = (_build.SRC_DIR / "p4t_linear.cu").read_text()
    epilogues = re.findall(r"tw::launch\([^;]*?(\w+)\{", text, flags=re.S)
    assert epilogues and all("p4t_linear" in e for e in epilogues), epilogues
    tags = re.findall(r"tw::split_planes_tagged<(\w+),", text)
    assert len(tags) == 2 and all("p4t_linear" in t for t in tags), tags
    assert _headers("p4t_linear") == ["tf32x3_wgmma.cuh", "tf32x3.cuh"]
