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
    # the train layer kernel runs the mma.sync engine, and its bf16 variant
    # the Hopper primitives; the eval kernel the wgmma engine, which takes
    # the primitives from hopper.cuh and its split helper from tf32x3.cuh
    assert _headers("pointnet_train") == ["hopper.cuh", "tf32x3.cuh"]
    assert _headers("pointnet_infer") == ["tf32x3_wgmma.cuh", "hopper.cuh", "tf32x3.cuh"]


def _kernel_names(text, marker="__global__"):
    """The ``__global__`` functions of a CUDA source (or the functions
    declared with another ``marker``, such as ``__device__``, at namespace
    scope), each with the namespaces around it, as a profiler names them
    (``a::b::kernel``; an unnamed namespace as ``(anonymous namespace)``)."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/|\"(?:\\.|[^\"\\])*\"", "", text, flags=re.S)
    names, scopes, depth = [], [], 0
    token = re.compile(r"namespace\s*(\w*)\s*\{|" + marker + r"\b|\{|\}")
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
        elif depth == len(scopes):  # not a member of a struct
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
    text = ('namespace h {\n__device__ __forceinline__ void f(int) { asm("{ }"); }\n'
            "struct T { __device__ int g() const { return 0; } };\n}\n"
            "__host__ __device__ constexpr int k() { return 1; }\n")
    assert _kernel_names(text, "__device__") == ["h::f", "k"]


@pytest.mark.parametrize("part,kernels", [
    ("pointnet_infer", {"tf32x3_wgmma::gemm_kernel", "tf32x3_wgmma::split_kernel",
                        "(anonymous namespace)::group_mean_kernel"}),
    ("pointnet_train", {"wgmma_bf16::layer_kernel", "tf32x3::gemm_kernel",
                        "(anonymous namespace)::stats_kernel", "(anonymous namespace)::pool_kernel",
                        "(anonymous namespace)::pool_bf16_kernel"}),
])
def test_eval_kernels_keep_names_the_benchmark_finds(part, kernels):
    """Every kernel a PointNet source (the eval one, and the train one) can
    launch, its own and those of the headers it includes, carries a name
    fragment that the benchmark's trace reader counts as that part's kernel
    (``PORT_KERNELS[part]``): the roofline reads their device time and the
    launch check their number."""
    names = []
    for path in [f"{part}.cu"] + _headers(part):
        names += _kernel_names((_build.SRC_DIR / path).read_text())
    assert kernels <= set(names), names
    fragments = tracing.PORT_KERNELS[part]
    for name in names:
        assert any(f in name.lower() for f in fragments), name


# The Hopper primitives, each defined once, in hopper.cuh.
_HOPPER_DEVICE = {"smem_addr", "mbar_init", "mbar_expect_tx", "mbar_arrive", "mbar_wait",
                  "tma_load", "tma_load_3d", "ldmatrix_x4", "desc_sw128", "wgmma_fence", "wgmma_commit",
                  "wgmma_wait", "expm1_nonpositive", "elu"}
_HOPPER_HOST = {"encode_tiled", "make_map", "make_map_3d"}
# each wgmma engine's own: its MMA shape and its producer
_PER_ENGINE = {"wgmma_rs", "produce"}


def test_hopper_primitives_are_defined_once():
    """No ``__device__`` function is defined in more than one of
    ``hopper.cuh`` and the sources that use it (but each engine's own MMA
    shape and producer), the primitives are hopper.cuh's, no other source
    builds a tensor map, and hopper.cuh defines no kernel: a kernel there
    would carry no name fragment of the source that launches it."""
    sources = ["hopper.cuh", "tf32x3_wgmma.cuh", "pointnet_train.cu", "p4t_linear.cu",
               "p4t_attention.cu"]
    where = {}
    for path in sources:
        text = (_build.SRC_DIR / path).read_text()
        for name in {n.split("::")[-1] for n in _kernel_names(text, "__device__")}:
            where.setdefault(name, []).append(path)
    twice = {n: p for n, p in where.items() if len(p) > 1 and n not in _PER_ENGINE}
    assert not twice, twice
    assert all(where.get(n) == ["hopper.cuh"] for n in _HOPPER_DEVICE), where
    host = re.compile(r"^\s*(?:inline\s+)?\w+\s+(" + "|".join(_HOPPER_HOST) + r")\s*\(", re.M)
    for path in sorted(_build.SRC_DIR.iterdir()):
        found = set(host.findall(path.read_text()))
        assert found == (_HOPPER_HOST if path.name == "hopper.cuh" else set()), (path, found)
    assert _kernel_names((_build.SRC_DIR / "hopper.cuh").read_text()) == []


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
    ("p4t_attention", {"p4t_attention_fwd_kernel", "p4t_attention_delta_kernel",
                       "p4t_attention_dkdv_kernel", "p4t_attention_dq_kernel"}),
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
    ``gemm_kernel`` and ``split_kernel``, whose names a profiler
    gives with their template arguments: every epilogue and split tag
    ``p4t_linear.cu`` hands the engine holds ``p4t_linear``, and the file
    includes the engine beside it."""
    text = (_build.SRC_DIR / "p4t_linear.cu").read_text()
    epilogues = re.findall(r"tw::launch\([^;]*?(\w+)\{", text, flags=re.S)
    assert epilogues and all("p4t_linear" in e for e in epilogues), epilogues
    tags = re.findall(r"tw::split_planes<(\w+),", text)
    assert len(tags) == 2 and all("p4t_linear" in t for t in tags), tags
    assert _headers("p4t_linear") == ["tf32x3_wgmma.cuh", "hopper.cuh", "tf32x3.cuh"]


def test_p4t_attention_builds_on_the_primitives_alone():
    """Attention's kernels take the Hopper primitives from hopper.cuh and the
    split from tf32x3.cuh, and not the GEMM engine: no kernel of another
    part is compiled into its library, and every name of its own holds
    ``p4t_attention`` and no other part's fragment."""
    assert _headers("p4t_attention") == ["hopper.cuh", "tf32x3.cuh"]
    names = _kernel_names((_build.SRC_DIR / "p4t_attention.cu").read_text())
    others = {f for part, frags in tracing.PORT_KERNELS.items() if part != "p4t_attention"
              for f in frags}
    for name in names:
        assert "p4t_attention" in name and not any(f in name.lower() for f in others), name


@pytest.mark.parametrize("part,kernels", [
    ("dgcnn_knn", {"dgcnn_knn_select"}),
    ("dgcnn_edge", {"dgcnn_edge_fwd", "dgcnn_edge_moments", "dgcnn_edge_out",
                    "dgcnn_edge_bwd_prep", "dgcnn_edge_rev", "dgcnn_edge_bwd"}),
])
def test_dgcnn_kernels_keep_names_the_benchmark_finds(part, kernels):
    """Every kernel of a DGCNN source carries its benchmark part's name
    fragment (``benchmark/kernels/<part>.json``) and no other part's, and
    the sources include no header: nothing of another part is compiled in."""
    text = (_build.SRC_DIR / f"{part}.cu").read_text()
    names = _kernel_names(text)
    assert {n.split("::")[-1] for n in names} == kernels, names
    assert _headers(part) == []
    others = {f for p, frags in tracing.PORT_KERNELS.items() if p != part for f in frags}
    for name in names:
        assert any(f in name.lower() for f in tracing.PORT_KERNELS[part]), name
        assert not any(f in name.lower() for f in others), name
