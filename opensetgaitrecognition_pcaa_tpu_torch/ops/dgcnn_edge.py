"""The edge pass of DGCNN's EdgeConv layer: BatchNorm over the edges, the
extremum over each point's neighbours and LeakyReLU, forward and backward.
The plain PyTorch version, the wrapper of the hand-written CUDA kernels
(``csrc/dgcnn_edge.cu``) and the autograd Function.

No TPU kernel is ported here: the JAX package has no DGCNN. The layer's
edge feature is ``h_ij = W_a·(x_j − x_i) + W_b·x_i = A_i + B_j`` with the
per-point products ``A = (W_b − W_a)·x`` and ``B = W_a·x`` (``models/
dgcnn.py``); from ``ab = [A | B]`` ``(F, N, 2·O)`` and the graph ``idx (F, N,
k)`` (``ops/dgcnn_knn.py``), for each point i and channel c::

    y_ic = LeakyReLU(s_c·(ext_j (A_ic + B_jc) − μ_c) + β_c),  s_c = γ_c / √(σ²_c + eps)

where ``ext`` is the max over the k neighbours where ``γ_c ≥ 0`` (so
``s_c ≥ 0``) and the min where ``γ_c < 0``: BatchNorm's affine map and
LeakyReLU are monotone in each channel, so the extremum of the edges gives
the max of the published ``amax`` over the normalised edges exactly. The
extremum's slot is the first extremal neighbour, in the graph's order. In
train mode μ and σ² (biased) are taken over all ``M = F·N·k`` edges, as sums
of ``e`` and ``e²`` in f64, ``σ² = Σe²/M − μ²``; in eval mode they are the
running estimates. The output is ``(ext − μ)·(1/√(σ² + eps)·γ) + β`` in
``models/norm.py::TorchBatchNorm``'s order of operations, then LeakyReLU.

The backward is BatchNorm's over every edge, not over the chosen ones
only: with ``g_ijc`` the output's gradient ``dz_ic`` on the chosen edge and
0 elsewhere, ``x̂ = (e − μ)/√(σ² + eps)``, ``S1 = Σ dz`` and ``S2 = Σ dz·x̂``
over the points (``dβ`` and ``dγ``), each edge's gradient is

    de_ijc = s_c·(g_ijc − S1_c/M − x̂_ijc·S2_c/M)

(the last two terms absent in eval mode), and ``dA_i`` sums it over the
point's out-edges, ``dB_j`` over its in-edges (the reverse graph).

``edge_conv`` is a ``torch.autograd.Function``: the forward keeps ``ab``,
the graph, the ``(F, N, O)`` extremum and a one-byte slot, never a ``(F, N,
k, O)`` tensor of the edges. A CUDA tensor launches the kernels or raises;
a CPU tensor takes the plain versions, which loop over the k slots and take
f64 too (``gradcheck``). The wrapper counts its kernel launches
(``.launches``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library

_KERNEL = "dgcnn_edge"
MAX_K = 256  # the extremum's slot is one byte


def _split(ab: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    o = ab.shape[-1] // 2
    return ab[..., :o], ab[..., o:]


def _neighbours(b: torch.Tensor, idx: torch.Tensor, s: int) -> torch.Tensor:
    """``B`` at each point's neighbour in slot ``s``: ``(F, N, O)``."""
    rows = torch.arange(b.shape[0], device=b.device)[:, None]
    return b[rows, idx[:, :, s]]


def edge_forward_ref(ab: torch.Tensor, idx: torch.Tensor, gamma: torch.Tensor, train: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward's pass over the edges → the extremum
    ``(F, N, O)``, its slot (uint8), and in train mode the edges' mean and
    biased variance ``(O,)`` (else empty)."""
    a, b = _split(ab)
    take_max = gamma >= 0
    ext = a + _neighbours(b, idx, 0)
    slot = torch.zeros(ext.shape, dtype=torch.uint8, device=ab.device)
    s1 = ext.double().sum(dim=(0, 1))
    s2 = (ext.double() ** 2).sum(dim=(0, 1))
    for s in range(1, idx.shape[2]):
        e = a + _neighbours(b, idx, s)
        better = torch.where(take_max, e > ext, e < ext)
        ext = torch.where(better, e, ext)
        slot = torch.where(better, s, slot).to(torch.uint8)
        s1 = s1 + e.double().sum(dim=(0, 1))
        s2 = s2 + (e.double() ** 2).sum(dim=(0, 1))
    if not train:
        empty = ab.new_empty((0,))
        return ext, slot, empty, empty
    m = idx.numel()
    mean = s1 / m
    var = torch.clamp(s2 / m - mean * mean, min=0.0)
    return ext, slot, mean.to(ab.dtype), var.to(ab.dtype)


def _scales(mean, var, gamma, eps):
    inv = torch.reciprocal(torch.sqrt(var + eps))
    return inv, inv * gamma


def edge_out_ref(ext, mean, var, gamma, beta, eps: float, slope: float) -> torch.Tensor:
    """Plain version of the output: LeakyReLU of the normalised extremum."""
    _, scale = _scales(mean, var, gamma, eps)
    z = (ext - mean) * scale + beta
    return torch.where(z > 0, z, z * slope)


def edge_backward_ref(dy, ab, idx, ext, slot, mean, var, gamma, beta, eps: float, slope: float,
                      train: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward → ``d_ab`` ``(F, N, 2·O)``, ``dγ``,
    ``dβ``: the module docstring's edge gradients, a slot at a time."""
    a, b = _split(ab)
    inv, scale = _scales(mean, var, gamma, eps)
    z = (ext - mean) * scale + beta
    dz = torch.where(z > 0, dy, dy * slope)
    dbeta = dz.sum(dim=(0, 1))
    dgamma = (dz * (ext - mean) * inv).sum(dim=(0, 1))
    m = idx.numel()
    c1, c2 = (dbeta / m, dgamma / m) if train else (torch.zeros_like(dbeta),) * 2
    f, n, k = idx.shape
    da = torch.zeros_like(a)
    db = torch.zeros((f * n,) + a.shape[2:], dtype=ab.dtype, device=ab.device)
    rows = (torch.arange(f, device=ab.device)[:, None] * n + idx.permute(2, 0, 1)).reshape(k, -1)
    for s in range(k):
        xhat = (a + _neighbours(b, idx, s) - mean) * inv
        de = scale * (torch.where(slot == s, dz, torch.zeros_like(dz)) - c1 - xhat * c2)
        da = da + de
        db.index_add_(0, rows[s], de.reshape(f * n, -1))
    return torch.cat([da, db.reshape(a.shape)], dim=-1), dgamma, dbeta


def _library() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    shape = [ctypes.c_int] * 4
    p = ctypes.c_void_p
    options = [ctypes.c_int, ctypes.c_float, ctypes.c_float]  # train, eps, slope
    # ab, idx, gamma, beta; ext, slot, partial, mean, var, y; the stream
    lib.dgcnn_edge_forward.argtypes = [p] * 4 + shape + options + [p] * 6 + [p]
    lib.dgcnn_edge_forward.restype = ctypes.c_int
    # dy, ab, idx, ext, slot, mean, var, gamma; beta, dz, partial, rev, d_ab,
    # dgamma, dbeta; the stream
    lib.dgcnn_edge_backward.argtypes = [p] * 8 + shape + options + [p] * 7 + [p]
    lib.dgcnn_edge_backward.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(**tensors) -> None:
    device = next(iter(tensors.values()))[0].device
    for name, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, ab on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class EdgeConv(torch.autograd.Function):
    """``(ab, idx, γ, β, running mean, running var) → (y, batch mean, batch
    var)``; gradients for ``ab``, ``γ`` and ``β``. In eval mode the batch
    statistics are copies of the running ones."""

    @staticmethod
    def forward(ctx, ab, idx, gamma, beta, run_mean, run_var, train, eps, slope):
        f, n, k = idx.shape
        o = ab.shape[-1] // 2
        if ab.device.type == "cpu":
            ext, slot, mean, var = edge_forward_ref(ab, idx, gamma, train)
            if not train:  # copies: the buffers move in place at the next train step
                mean, var = run_mean.clone(), run_var.clone()
            y = edge_out_ref(ext, mean, var, gamma, beta, eps, slope)
        else:
            _check_cuda(ab=(ab, torch.float32), idx=(idx, torch.int64),
                        gamma=(gamma, torch.float32), beta=(beta, torch.float32),
                        run_mean=(run_mean, torch.float32), run_var=(run_var, torch.float32))
            ext = torch.empty((f, n, o), dtype=torch.float32, device=ab.device)
            slot = torch.empty((f, n, o), dtype=torch.uint8, device=ab.device)
            y = torch.empty_like(ext)
            if train:
                mean = torch.empty((o,), dtype=torch.float32, device=ab.device)
                var = torch.empty_like(mean)
                partial = torch.empty((f, 2, o), dtype=torch.float64, device=ab.device)
            else:
                mean, var = run_mean.clone(), run_var.clone()
                partial = torch.empty(0, device=ab.device)
            with torch.cuda.device(ab.device):
                err = _library().dgcnn_edge_forward(
                    ab.data_ptr(), idx.data_ptr(), gamma.data_ptr(), beta.data_ptr(), f, n, k, o,
                    int(train), eps, slope, ext.data_ptr(), slot.data_ptr(), partial.data_ptr(),
                    mean.data_ptr(), var.data_ptr(), y.data_ptr(), _stream(ab))
            if err != 0:
                raise RuntimeError(f"dgcnn_edge forward kernels failed: cudaError {err}")
            edge_conv.launches += 3 if train else 2
        ctx.save_for_backward(ab, idx, ext, slot, mean, var, gamma, beta)
        ctx.options = (train, eps, slope)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        ab, idx, ext, slot, mean, var, gamma, beta = ctx.saved_tensors
        train, eps, slope = ctx.options
        dy = dy.contiguous()
        if ab.device.type == "cpu":
            d_ab, dgamma, dbeta = edge_backward_ref(dy, ab, idx, ext, slot, mean, var, gamma,
                                                    beta, eps, slope, train)
        else:
            f, n, k = idx.shape
            o = ext.shape[-1]
            dev = ab.device
            d_ab = torch.empty_like(ab)
            dgamma = torch.empty((o,), dtype=torch.float32, device=dev)
            dbeta = torch.empty_like(dgamma)
            dz = torch.empty_like(ext)
            partial = torch.empty((f, 2, o), dtype=torch.float64, device=dev)
            rev = torch.empty((f, n * k + n + 1), dtype=torch.int32, device=dev)
            with torch.cuda.device(dev):
                err = _library().dgcnn_edge_backward(
                    dy.data_ptr(), ab.data_ptr(), idx.data_ptr(), ext.data_ptr(),
                    slot.data_ptr(), mean.data_ptr(), var.data_ptr(), gamma.data_ptr(), f, n, k,
                    o, int(train), eps, slope, beta.data_ptr(), dz.data_ptr(),
                    partial.data_ptr(), rev.data_ptr(), d_ab.data_ptr(), dgamma.data_ptr(),
                    dbeta.data_ptr(), _stream(ab))
            if err != 0:
                raise RuntimeError(f"dgcnn_edge backward kernels failed: cudaError {err}")
            edge_conv.launches += 4
        return d_ab, None, dgamma, dbeta, None, None, None, None, None


def edge_conv(ab: torch.Tensor, idx: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              run_mean: torch.Tensor, run_var: torch.Tensor, train: bool, eps: float = 1e-5,
              slope: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The edge pass of ``ab = [A | B]`` ``(F, N, 2·O)`` over the graph ``idx
    (F, N, k)`` → ``(y (F, N, O), mean, var)``: in train mode the edges'
    batch statistics (biased variance), in eval mode copies of ``run_mean``
    and ``run_var``, which are not moved here."""
    if ab.dim() != 3 or ab.shape[-1] % 2 or idx.dim() != 3 or idx.shape[:2] != ab.shape[:2]:
        raise ValueError(f"ab must be (F, N, 2·O) and idx (F, N, k), got {tuple(ab.shape)} and "
                         f"{tuple(idx.shape)}")
    if not 1 <= idx.shape[2] <= min(MAX_K, ab.shape[1]):
        raise ValueError(f"{idx.shape[2]} neighbours of {ab.shape[1]} points; the slot holds "
                         f"{MAX_K}")
    o = ab.shape[-1] // 2
    if any(t.shape != (o,) for t in (gamma, beta, run_mean, run_var)):
        raise ValueError(f"the BatchNorm's tensors must be ({o},)")
    if ab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {ab.device}")
    return EdgeConv.apply(ab, idx, gamma, beta, run_mean, run_var, train, eps, slope)


# Kernel launches since the last reset (forwards and backwards); the plain
# versions do not count.
edge_conv.launches = 0
