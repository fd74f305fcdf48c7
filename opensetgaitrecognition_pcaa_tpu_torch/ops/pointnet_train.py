"""Train-mode PointNet stack + point pooling: the plain PyTorch version, the
wrappers of the hand-written CUDA kernels, and the exact backward.

Port of ``opensetgaitrecognition_pcaa_tpu/ops/pallas/pointnet_train.py``.
Train-mode BatchNorm needs the whole batch's statistics between layers, so
the stack runs layer by layer: each layer reads the previous layer's raw
output, applies that layer's BatchNorm + ELU as it reads, computes
``y = h @ W + b``, writes y raw and returns the batch mean and the biased
variance ``max(Σy²/n − mean², 0)`` of y; a pool step applies the last
BatchNorm + ELU and averages over the points of each frame.

``pointnet_pool_train`` is a ``torch.autograd.Function``:

- forward: ``fused_layer`` four times and ``fused_pool`` once. For a CUDA
  tensor each wrapper launches its kernel (``csrc/pointnet_train.cu``; the
  layer on the tensor cores in the exact three-pass TF32 mode of
  ``ops/tf32x3.py``) or raises; for a CPU tensor it computes its plain
  version (``fused_layer_ref``, ``fused_pool_ref``);
- backward: plain PyTorch, as the JAX package's ``_bwd`` is plain XLA: the
  exact train-mode BatchNorm backward (mean and variance differentiated as
  functions of the batch), the normalize + ELU recomputed from the stored
  raw outputs, and the matmul VJPs by ``torch.matmul``.

The kernel masks a ragged last row tile itself, so the TPU kernel's
padding-row correction (``_stats_from_sums``) has no counterpart here.
``pointnet_pool_train_ref`` is the whole forward in plain PyTorch, which
autograd differentiates on its own.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library

_KERNEL = "pointnet_train"
_EPS = 1e-5

Layer = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def bn_affine(mean: torch.Tensor, var: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor) -> torch.Tensor:
    """``(3, C)`` rows mean, scale = γ/√(σ²+ε), β: the BatchNorm that
    ``fused_layer`` and ``fused_pool`` apply on read."""
    return torch.stack([mean, torch.rsqrt(var + _EPS) * gamma, beta]).contiguous()


def _activate(h: torch.Tensor, affine: Optional[torch.Tensor]) -> torch.Tensor:
    if affine is None:
        return h
    return F.elu((h - affine[0]) * affine[1] + affine[2])


def fused_layer_ref(h: torch.Tensor, affine: Optional[torch.Tensor], w: torch.Tensor,
                    b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of one layer: ``(R, C_in) → (y (R, C_out), mean, var)``."""
    y = torch.matmul(_activate(h.float(), affine), w) + b
    n = y.shape[0]
    mean = torch.sum(y, dim=0) / n
    var = torch.clamp(torch.sum(y * y, dim=0) / n - mean * mean, min=0.0)
    return y, mean, var


def fused_pool_ref(y: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """Plain version of the pool: ``(F, N, D) → (F, D)``."""
    return torch.mean(_activate(y, affine), dim=1)


def _library() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    layer = lib.pointnet_train_layer_f32
    layer.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    layer.restype = ctypes.c_int
    pool = lib.pointnet_train_pool_f32
    pool.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    pool.restype = ctypes.c_int
    lib.pointnet_train_row_tile.argtypes = []
    lib.pointnet_train_row_tile.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the input on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")


def _check_layer_args(h, affine, w, b) -> Tuple[int, int, int]:
    """Raise unless the layer kernel takes these arguments → (R, C_in, C_out)."""
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError(f"h and w must be 2-D, got {tuple(h.shape)} and {tuple(w.shape)}")
    rows, c_in = h.shape
    c_out = w.shape[1]
    if rows < 1:
        raise ValueError("h has no rows")
    if c_in % 4 or c_out % 4:
        raise ValueError(f"the kernel takes widths that are multiples of 4, got {c_in} -> {c_out}")
    _check("h", h, (rows, c_in), h.device)
    _check("w", w, (c_in, c_out), h.device)
    _check("b", b, (c_out,), h.device)
    if affine is not None:
        _check("affine", affine, (3, c_in), h.device)
    return rows, c_in, c_out


def fused_layer(h: torch.Tensor, affine: Optional[torch.Tensor], w: torch.Tensor,
                b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One train-mode layer: the previous BatchNorm + ELU applied on read
    (``affine`` from ``bn_affine``; None for layer 0), ``y = h @ W + b``,
    and y's batch mean and biased variance → ``(y, mean, var)``.

    A CPU tensor takes ``fused_layer_ref``; a CUDA tensor launches the
    layer kernel and its fixed-order reduction, or raises.
    """
    if h.device.type == "cpu":
        return fused_layer_ref(h, affine, w, b)
    if h.device.type != "cuda":
        raise ValueError(f"no kernel for device {h.device}")
    rows, c_in, c_out = _check_layer_args(h, affine, w, b)
    lib = _library()
    row_tile = lib.pointnet_train_row_tile()  # rows per block of the layer kernel
    y = torch.empty((rows, c_out), dtype=torch.float32, device=h.device)
    partials = torch.empty((-(-rows // row_tile), 2, c_out), dtype=torch.float32,
                           device=h.device)
    mean = torch.empty(c_out, dtype=torch.float32, device=h.device)
    var = torch.empty(c_out, dtype=torch.float32, device=h.device)
    fn = lib.pointnet_train_layer_f32
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        wt = w.t().contiguous()  # the kernel reads W K-major: (C_out, C_in)
        err = fn(h.data_ptr(), None if affine is None else affine.data_ptr(), wt.data_ptr(),
                 b.data_ptr(), y.data_ptr(), partials.data_ptr(), mean.data_ptr(),
                 var.data_ptr(), rows, c_in, c_out, stream)
    if err != 0:
        raise RuntimeError(f"pointnet_train layer kernel launch failed: cudaError {err}")
    fused_layer.launches += 1
    return y, mean, var


def fused_pool(y: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """Last BatchNorm + ELU, then the mean over points: ``(F, N, D) → (F, D)``.

    A CPU tensor takes ``fused_pool_ref``; a CUDA tensor launches the pool
    kernel, or raises.
    """
    if y.device.type == "cpu":
        return fused_pool_ref(y, affine)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    if y.dim() != 3 or min(y.shape) < 1:
        raise ValueError(f"y must be (F, N, D) with no empty axis, got {tuple(y.shape)}")
    frames, n, d = y.shape
    _check("y", y, (frames, n, d), y.device)
    _check("affine", affine, (3, d), y.device)
    out = torch.empty((frames, d), dtype=torch.float32, device=y.device)
    fn = _library().pointnet_train_pool_f32
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), affine.data_ptr(), out.data_ptr(), frames, n, d, stream)
    if err != 0:
        raise RuntimeError(f"pointnet_train pool kernel launch failed: cudaError {err}")
    fused_pool.launches += 1
    return out


# Kernel launches since the last reset; the plain versions do not count.
fused_layer.launches = 0
fused_pool.launches = 0


def _forward(x: torch.Tensor, params: Sequence[Layer], layer_fn, pool_fn):
    """→ (pooled (B, T, D), raw outputs ys, means, vars)."""
    b, t, n, c = x.shape
    h = x.reshape(b * t * n, c)
    affine = None
    ys, means, variances = [], [], []
    for w, bias, gamma, beta in params:
        y, mean, var = layer_fn(h, affine, w, bias)
        ys.append(y)
        means.append(mean)
        variances.append(var)
        affine = bn_affine(mean, var, gamma, beta)
        h = y
    pooled = pool_fn(ys[-1].reshape(b * t, n, -1), affine)
    return pooled.reshape(b, t, -1), ys, means, variances


def pointnet_pool_train_ref(x: torch.Tensor, params: Sequence[Layer]):
    """Plain version of ``pointnet_pool_train``, differentiable by autograd."""
    pooled, _, means, variances = _forward(x.float(), params, fused_layer_ref, fused_pool_ref)
    return pooled, tuple(means), tuple(variances)


class _PointNetPoolTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *flat):
        params = [tuple(p.contiguous() for p in flat[i:i + 4]) for i in range(0, len(flat), 4)]
        pooled, ys, means, variances = _forward(x.contiguous(), params, fused_layer, fused_pool)
        ctx.save_for_backward(x, *(p for layer in params for p in layer), *ys, *means,
                              *variances)
        ctx.n_layers = len(params)
        ctx.mark_non_differentiable(*means, *variances)
        return (pooled, *means, *variances)

    @staticmethod
    def backward(ctx, g_pooled, *_stat_grads):
        # the means/vars outputs feed only the running statistics: their
        # cotangents are ignored, as in the JAX package's _bwd
        saved = ctx.saved_tensors
        k = ctx.n_layers
        x = saved[0]
        params = [saved[1 + 4 * i:5 + 4 * i] for i in range(k)]
        ys = saved[1 + 4 * k:1 + 5 * k]
        means = saved[1 + 5 * k:1 + 6 * k]
        variances = saved[1 + 6 * k:1 + 7 * k]
        b, t, n, c = x.shape
        rows = b * t * n

        # mean-pool backward: the same share to each of a frame's points
        d = ys[-1].shape[1]
        g_h = (g_pooled / n)[:, :, None, :].expand(b, t, n, d).reshape(rows, d)
        grads = [None] * (4 * k)
        g_x = None
        for li in range(k - 1, -1, -1):
            w, _, gamma, beta = params[li]
            inv = torch.rsqrt(variances[li] + _EPS)
            x_hat = (ys[li] - means[li]) * inv
            bn_out = x_hat * gamma + beta
            g_bn = g_h * torch.where(bn_out > 0, 1.0, torch.exp(torch.clamp(bn_out, max=0.0)))
            g_gamma = torch.sum(g_bn * x_hat, dim=0)
            g_beta = torch.sum(g_bn, dim=0)
            # train-mode BatchNorm: the batch mean and variance depend on y
            g_y = inv * gamma * (g_bn - g_beta / rows - x_hat * (g_gamma / rows))
            if li == 0:
                h_prev = x.reshape(rows, c)
            else:
                w_p, _, gamma_p, beta_p = params[li - 1]
                h_prev = _activate(ys[li - 1],
                                   bn_affine(means[li - 1], variances[li - 1], gamma_p, beta_p))
            grads[4 * li:4 * li + 4] = [torch.matmul(h_prev.t(), g_y), torch.sum(g_y, dim=0),
                                        g_gamma, g_beta]
            if li > 0:
                g_h = torch.matmul(g_y, w.t())
            elif ctx.needs_input_grad[0]:
                g_x = torch.matmul(g_y, w.t()).reshape(x.shape)
        return (g_x, *grads)


def pointnet_pool_train(x: torch.Tensor, params: Sequence[Layer]):
    """Train-mode PointNet stack + mean pool: ``(B, T, N, C) → (B, T, D)``.

    :param params: 4 layers ``(W (C_in, C_out), b, γ, β)``, W in the JAX
        package's ``(in, out)`` layout.
    :returns: ``(pooled, means, vars)``: the batch means and biased
        variances of each layer's raw output, for the caller to fold into
        the running statistics. Differentiable with respect to x and params.
    """
    flat = [p for layer in params for p in layer]
    out = _PointNetPoolTrain.apply(x.float(), *flat)
    k = len(params)
    return out[0], tuple(out[1:1 + k]), tuple(out[1 + k:])
