"""The k-nearest-neighbour graph of DGCNN's EdgeConv layers, in feature space:
the plain PyTorch version and the wrapper of the hand-written CUDA kernel
(``csrc/dgcnn_knn.cu``).

No TPU kernel is ported here: the JAX package has no DGCNN. For each frame
of ``(F, N, C)`` features and each point i, the graph holds the ``k_eff =
min(k, N)`` points j of the smallest squared distance

    d_ij = Σ_c (h_ic − h_jc)²,

summed in channel order from 0 in f32, each difference, product and sum
rounded on its own (no contraction into a fused multiply-add), the point
itself included (its distance is 0), ordered by ascending distance, ties to
the lower index. The kernel rounds the same way (``__fsub_rn``,
``__fmul_rn``, ``__fadd_rn``) and orders the same way, so its indices are
the plain version's bit for bit.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, which takes f64 too. The wrapper counts its kernel launches
(``.launches``).
"""

from __future__ import annotations

import ctypes

import torch

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library

_KERNEL = "dgcnn_knn"
MAX_POINTS = 256  # a lane holds 8 distances of its row; the edge kernels' slot is one byte
SMEM_BYTES = 232_448  # a block's shared memory on Hopper


def all_sq_dists(h: torch.Tensor) -> torch.Tensor:
    """``(F, N, C) → (F, N, N)``: every pair's squared distance, in the
    module docstring's arithmetic."""
    d = torch.zeros(h.shape[:2] + h.shape[1:2], dtype=h.dtype, device=h.device)
    for c in range(h.shape[-1]):
        diff = h[..., c][:, :, None] - h[..., c][:, None, :]
        d = d + diff * diff
    return d


def knn_ref(h: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: ``(F, N, C) → (F, N, min(k, N))`` int64."""
    order = torch.sort(all_sq_dists(h), dim=-1, stable=True).indices
    return order[..., :min(k, h.shape[1])].contiguous()


def _library() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    lib.dgcnn_knn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.dgcnn_knn.restype = ctypes.c_int
    return lib


def smem_bytes(n: int, c: int) -> int:
    """The kernel's shared memory for a frame of ``n`` points of ``c``
    channels: the frame's rows at an odd stride."""
    return 4 * n * (c | 1)


def dgcnn_knn(h: torch.Tensor, k: int) -> torch.Tensor:
    """``h (F, N, C)`` → ``(F, N, min(k, N))`` int64: each point's nearest
    points of its frame in feature space, nearest first."""
    if h.dim() != 3 or h.shape[1] < 1 or h.shape[2] < 1:
        raise ValueError(f"features must be (F, N, C), got {tuple(h.shape)}")
    if k < 1:
        raise ValueError(f"a graph takes at least one neighbour, got k = {k}")
    f, n, c = h.shape
    if h.device.type == "cpu":
        return knn_ref(h, k)
    if h.device.type != "cuda":
        raise ValueError(f"no kernel for device {h.device}")
    if h.dtype != torch.float32 or not h.is_contiguous():
        raise ValueError(f"the kernel takes contiguous float32 features, got {h.dtype}")
    if n > MAX_POINTS or smem_bytes(n, c) > SMEM_BYTES:
        raise ValueError(f"a frame of {n} points of {c} channels: the kernel takes at most "
                         f"{MAX_POINTS} points and {SMEM_BYTES} bytes of a frame")
    k_eff = min(k, n)
    out = torch.empty((f, n, k_eff), dtype=torch.int64, device=h.device)
    with torch.cuda.device(h.device):
        err = _library().dgcnn_knn(h.data_ptr(), f, n, c, k_eff, out.data_ptr(),
                                   torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dgcnn_knn kernel launch failed: cudaError {err}")
    dgcnn_knn.launches += 1
    return out


# Kernel launches since the last reset; the plain version does not count.
dgcnn_knn.launches = 0
