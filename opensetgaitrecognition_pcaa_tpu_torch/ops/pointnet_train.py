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
padding-row correction (``_stats_from_sums``) has no counterpart here. It
takes widths that are multiples of 4; ``fused_layer`` pads other widths
(``NFEATURES=5``, ``POINTNET_OUT_DIM=30``) with zeros (``pad_layer``: zero
input columns and weight rows, an affine of mean 0, scale 0 and shift 0, so
a padded input is ELU(0) = 0; zero weight columns and biases, so a padded
output is 0) and slices y and the statistics back to the real widths. The
autograd Function sees only real widths, so no gradient reaches a padded
column.
``pointnet_pool_train_ref`` is the whole forward in plain PyTorch, which
autograd differentiates on its own.

With a ``mesh`` (``parallel/mesh.py``) the batch's rows lie on the ranks of
the data group and a layer's W may be this model rank's column shard (a W
with fewer columns than its bias, which every rank holds whole):

- forward: each layer (kernel or plain) hands back the column sums Σy and
  Σy² in f64 where the data group has several ranks (``sums=True``); they
  are all-reduced over it and mean and ``max(Σy²/n − mean², 0)`` formed
  with the global n (``stats_from_sums``, the kernel's own formula). A
  column shard launches the kernel on its columns, whose statistics are
  then complete, and y, mean and var are all-gathered over the model group
  before the next layer reads them; the pool runs at the gathered width;
- backward: the cotangent of the pooled output (each model rank holds a
  part, ``parallel/mesh.py``) is summed over the model group first, so
  every rank of it works on the whole; ``g_gamma``, ``g_beta`` and the row
  count in ``g_y`` are the global batch's (all-reduced over the data
  group); a column shard's dgrad is all-reduced over the model group; a
  replicated leaf's gradient is this rank's share, 1/MP of what its model
  group computes alike, a shard's its own, and both are then summed over
  their ranks by ``parallel/mesh.py::reduce_grads``.

``store_dtype=torch.bfloat16`` is the JAX package's bf16 training path
(``store_dtype`` of ``pointnet_pool_train``, ``pointnet_train.py:61-105,
207-236, 270-333``):

- forward: x is rounded to bf16 at entry; each layer upcasts the stored
  bf16 input, applies the previous BatchNorm + ELU in f32, rounds the
  result h to bf16, and multiplies it by W rounded to bf16 with f32
  accumulation; the f32 bias is added; Σy and Σy² are taken from the
  unrounded f32 y, which is then stored as bf16. The pool reads bf16 y
  and computes and writes f32. On the card these are the bf16 variants
  of the two kernels (the layer a warp-specialised ``wgmma`` kernel fed
  by TMA, with the BatchNorm + ELU applied to its A fragments in
  registers), which take widths that are multiples of 8
  (``pad_layer(..., multiple=8)``) and tensors that start on 16-byte
  boundaries (``check_aligned``);
- backward: the stored ys are upcast, the BatchNorm and ELU backward runs
  in f32, and the wgrad and dgrad take bf16 operands with f32
  accumulation and an f32 result (``mm_bf16``: an f32 GEMM of the bf16
  values on the CPU, which is exact in its products; cuBLAS's bf16 GEMM
  with an f32 output on the card).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from opensetgaitrecognition_pcaa_tpu_torch.ops._build import load_library
from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce

_KERNEL = "pointnet_train"
_EPS = 1e-5
BF16 = torch.bfloat16

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


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands with f32 accumulation and an f32 result.
    On the CPU an f32 GEMM of the bf16 values (each product is exact in
    f32); on the card cuBLAS's bf16 GEMM with an f32 output."""
    a, b = a.to(BF16), b.to(BF16)
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float())
    return torch.mm(a, b, out_dtype=torch.float32)


def stats_from_sums(sums: torch.Tensor, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(2, C)`` f64 column sums of y and y² over ``rows`` rows → (mean,
    biased var) f32: ``mean = Σy/n``, ``var = max(Σy²/n − mean², 0)`` in
    f64, the stats kernel's formula."""
    mean = sums[0] / rows
    var = torch.clamp(sums[1] / rows - mean * mean, min=0.0)
    return mean.float(), var.float()


def fused_layer_ref(h: torch.Tensor, affine: Optional[torch.Tensor], w: torch.Tensor,
                    b: torch.Tensor, sums: bool = False):
    """Plain version of one layer: ``(R, C_in) → (y (R, C_out), mean, var)``;
    y has h's dtype, f32 or bf16 (the module docstring). With ``sums``:
    ``(y, (2, C_out) f64 column sums of y and y²)``."""
    a = _activate(h.float(), affine)
    if h.dtype == BF16:
        a, w = a.to(BF16).float(), w.to(BF16).float()
    y = torch.matmul(a, w) + b
    if sums:
        y64 = y.double()
        return y.to(h.dtype), torch.stack([torch.sum(y64, dim=0), torch.sum(y64 * y64, dim=0)])
    n = y.shape[0]
    mean = torch.sum(y, dim=0) / n
    var = torch.clamp(torch.sum(y * y, dim=0) / n - mean * mean, min=0.0)
    return y.to(h.dtype), mean, var


def fused_pool_ref(y: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """Plain version of the pool: ``(F, N, D) → (F, D)`` in f32, y f32 or bf16."""
    return torch.mean(_activate(y.float(), affine), dim=1)


def _library() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    layer = lib.pointnet_train_layer_f32
    layer.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    layer.restype = ctypes.c_int
    lib.pointnet_train_layer_bf16.argtypes = layer.argtypes
    lib.pointnet_train_layer_bf16.restype = ctypes.c_int
    pool = lib.pointnet_train_pool_f32
    pool.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    pool.restype = ctypes.c_int
    lib.pointnet_train_pool_bf16.argtypes = pool.argtypes
    lib.pointnet_train_pool_bf16.restype = ctypes.c_int
    lib.pointnet_train_row_tile.argtypes = []
    lib.pointnet_train_row_tile.restype = ctypes.c_int
    lib.pointnet_train_bf16_elu.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                                      ctypes.c_void_p]
    lib.pointnet_train_bf16_elu.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the input on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")


def _check_layer_args(h, affine, w, b) -> Tuple[int, int, int]:
    """Raise unless the layer kernel takes these arguments (widths padded
    by ``pad_layer``) → (R, C_in, C_out)."""
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError(f"h and w must be 2-D, got {tuple(h.shape)} and {tuple(w.shape)}")
    rows, c_in = h.shape
    c_out = w.shape[1]
    if rows < 1:
        raise ValueError("h has no rows")
    if c_in < 1 or c_out < 1:
        raise ValueError(f"the kernel takes widths of at least 1, got {c_in} -> {c_out}")
    if h.dtype not in (torch.float32, BF16):
        raise ValueError(f"h must be float32 or bfloat16, got {h.dtype}")
    _check("h", h, (rows, c_in), h.device, h.dtype)
    _check("w", w, (c_in, c_out), h.device)
    _check("b", b, (c_out,), h.device)
    if affine is not None:
        _check("affine", affine, (3, c_in), h.device)
    return rows, c_in, c_out


def check_aligned(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` starts on a 16-byte boundary: the bf16 layer
    kernel reads h and W^T with TMA, the affine in 16-byte loads, and
    writes y in 16-byte stores."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary for the bf16 layer kernel, "
                         f"got address {t.data_ptr():#x}")


def pad_layer(h: torch.Tensor, affine: Optional[torch.Tensor], w: torch.Tensor,
              b: torch.Tensor, multiple: int = 4):
    """Zero-pad C_in and C_out to multiples of ``multiple`` (4 for the f32
    layer kernel, 8 for the bf16 one) → ``(h, affine, w, b)``; the inputs
    where nothing needs padding. Every padded term of a sum is an exact 0,
    and a padded output column and its statistics are 0; the first C_out
    columns are the function of the inputs."""
    c_in, c_out = w.shape
    pi = -(-c_in // multiple) * multiple - c_in
    po = -(-c_out // multiple) * multiple - c_out
    if pi:
        h = F.pad(h, (0, pi))
        if affine is not None:
            affine = F.pad(affine, (0, pi))
    if pi or po:
        w = F.pad(w, (0, po, 0, pi))
        b = F.pad(b, (0, po))
    return h, affine, w, b


def fused_layer(h: torch.Tensor, affine: Optional[torch.Tensor], w: torch.Tensor,
                b: torch.Tensor, sums: bool = False):
    """One train-mode layer: the previous BatchNorm + ELU applied on read
    (``affine`` from ``bn_affine``; None for layer 0), ``y = h @ W + b``,
    and y's batch mean and biased variance → ``(y, mean, var)``. h and y
    are f32, or both bf16 (W rounded to bf16, f32 accumulation, the
    statistics from the unrounded y); W, b, affine and the statistics f32.
    With ``sums`` → ``(y, (2, C_out) f64 column sums of y and y²)``: the
    same kernel, whose statistics pass writes the sums in place of mean
    and var (data parallelism, the module docstring).

    A CPU tensor takes ``fused_layer_ref``; a CUDA tensor launches the
    layer kernel of its dtype and the fixed-order reduction, or raises.
    Widths that are not multiples of 4 (f32) or 8 (bf16) are padded
    (``pad_layer``) and sliced back. The bf16 kernel stages the affine in
    shared memory beside at least 3 ring stages, which holds C_in up to
    6784; a wider C_in raises.
    """
    if h.device.type == "cpu":
        return fused_layer_ref(h, affine, w, b, sums)
    if h.device.type != "cuda":
        raise ValueError(f"no kernel for device {h.device}")
    rows, _, c_real = _check_layer_args(h, affine, w, b)
    bf16 = h.dtype == BF16
    h, affine, w, b = pad_layer(h, affine, w, b, multiple=8 if bf16 else 4)
    c_in, c_out = w.shape
    lib = _library()
    row_tile = lib.pointnet_train_row_tile()  # rows per block of both layer kernels
    y = torch.empty((rows, c_out), dtype=h.dtype, device=h.device)
    partials = torch.empty((-(-rows // row_tile), 2, c_out), dtype=torch.float32,
                           device=h.device)
    if sums:
        mean = var = None
        s12 = torch.empty((2, c_out), dtype=torch.float64, device=h.device)
    else:
        mean = torch.empty(c_out, dtype=torch.float32, device=h.device)
        var = torch.empty(c_out, dtype=torch.float32, device=h.device)
        s12 = None
    fn = lib.pointnet_train_layer_bf16 if bf16 else lib.pointnet_train_layer_f32
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        # the kernel reads W K-major: (C_out, C_in), in h's dtype
        wt = w.t().to(h.dtype).contiguous()
        if bf16:
            for name, t in (("h", h), ("wt", wt), ("y", y), ("affine", affine)):
                if t is not None:
                    check_aligned(name, t)
        err = fn(h.data_ptr(), None if affine is None else affine.data_ptr(), wt.data_ptr(),
                 b.data_ptr(), y.data_ptr(), partials.data_ptr(),
                 None if sums else mean.data_ptr(), None if sums else var.data_ptr(),
                 s12.data_ptr() if sums else None, rows, c_in, c_out, stream)
    if err != 0:
        raise RuntimeError(f"pointnet_train layer kernel launch failed: cudaError {err}")
    if bf16:
        fused_layer.launches_bf16 += 1
    else:
        fused_layer.launches += 1
    fused_layer.widths[c_real] += 1
    if c_out != c_real:
        y = y[:, :c_real].contiguous()
        if sums:
            s12 = s12[:, :c_real]
        else:
            mean, var = mean[:c_real], var[:c_real]
    return (y, s12) if sums else (y, mean, var)


def prologue_elu(x: torch.Tensor) -> torch.Tensor:
    """The bf16 layer kernel's ELU (its branch-free ``expm1f``) on a CUDA
    f32 tensor, elementwise: what the card tests hold to ``F.elu``."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("prologue_elu takes a contiguous float32 CUDA tensor")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().pointnet_train_bf16_elu(
            x.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pointnet_train ELU kernel launch failed: cudaError {err}")
    return out


def fused_pool(y: torch.Tensor, affine: torch.Tensor) -> torch.Tensor:
    """Last BatchNorm + ELU, then the mean over points: ``(F, N, D) → (F, D)``
    f32, y f32 or bf16.

    A CPU tensor takes ``fused_pool_ref``; a CUDA tensor launches the pool
    kernel of y's dtype, or raises.
    """
    if y.device.type == "cpu":
        return fused_pool_ref(y, affine)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    if y.dim() != 3 or min(y.shape) < 1:
        raise ValueError(f"y must be (F, N, D) with no empty axis, got {tuple(y.shape)}")
    frames, n, d = y.shape
    bf16 = y.dtype == BF16
    _check("y", y, (frames, n, d), y.device, BF16 if bf16 else torch.float32)
    _check("affine", affine, (3, d), y.device)
    out = torch.empty((frames, d), dtype=torch.float32, device=y.device)
    lib = _library()
    fn = lib.pointnet_train_pool_bf16 if bf16 else lib.pointnet_train_pool_f32
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), affine.data_ptr(), out.data_ptr(), frames, n, d, stream)
    if err != 0:
        raise RuntimeError(f"pointnet_train pool kernel launch failed: cudaError {err}")
    if bf16:
        fused_pool.launches_bf16 += 1
    else:
        fused_pool.launches += 1
    return out


# Kernel launches since the last reset, per variant (f32, bf16), and the
# layer's launches of both variants per output width; the plain versions do
# not count.
fused_layer.launches = 0
fused_layer.launches_bf16 = 0
fused_layer.widths = collections.Counter()
fused_pool.launches = 0
fused_pool.launches_bf16 = 0


def _is_shard(w: torch.Tensor, bias: torch.Tensor, mesh: Optional[Mesh]) -> bool:
    """Whether W is a model rank's column shard: fewer columns than its
    (replicated) bias, 1/MP of them."""
    if w.shape[1] == bias.shape[0]:
        return False
    if mesh is None or w.shape[1] * mesh.mp != bias.shape[0]:
        raise ValueError(f"W has {w.shape[1]} columns and its bias {bias.shape[0]}: not a column "
                         f"shard of the mesh's model group")
    return True


def _mesh_layer(layer_fn, h, affine, w, bias, mesh: Mesh):
    """``layer_fn`` on this rank's rows and W (whole or its column shard) →
    the global batch's ``(y, mean, var)`` at the layer's full width."""
    shard = _is_shard(w, bias, mesh)
    if shard:
        cols = w.shape[1]
        bias = bias[mesh.model_rank * cols:(mesh.model_rank + 1) * cols].contiguous()
    if mesh.dp > 1:
        y, sums = layer_fn(h, affine, w, bias, sums=True)
        mean, var = stats_from_sums(all_reduce(sums, mesh.data_group), h.shape[0] * mesh.dp)
    else:
        y, mean, var = layer_fn(h, affine, w, bias)
    if shard:
        y, mean, var = (all_gather(v, -1, mesh.model_group) for v in (y, mean, var))
    return y, mean, var


def _forward(x: torch.Tensor, params: Sequence[Layer], layer_fn, pool_fn,
             store_dtype: torch.dtype = torch.float32, mesh: Optional[Mesh] = None):
    """→ (pooled (B, T, D), raw outputs ys in ``store_dtype``, means, vars)."""
    b, t, n, c = x.shape
    h = x.reshape(b * t * n, c).to(store_dtype)
    affine = None
    ys, means, variances = [], [], []
    for w, bias, gamma, beta in params:
        if mesh is None:
            y, mean, var = layer_fn(h, affine, w, bias)
        else:
            y, mean, var = _mesh_layer(layer_fn, h, affine, w, bias, mesh)
        ys.append(y)
        means.append(mean)
        variances.append(var)
        affine = bn_affine(mean, var, gamma, beta)
        h = y
    pooled = pool_fn(ys[-1].reshape(b * t, n, -1), affine)
    return pooled.reshape(b, t, -1), ys, means, variances


def pointnet_pool_train_ref(x: torch.Tensor, params: Sequence[Layer],
                            store_dtype: torch.dtype = torch.float32):
    """Plain version of ``pointnet_pool_train``, differentiable by autograd
    (at bf16 autograd's backward rounds elsewhere than ``_bwd``'s)."""
    pooled, _, means, variances = _forward(x.float(), params, fused_layer_ref, fused_pool_ref,
                                           store_dtype)
    return pooled, tuple(means), tuple(variances)


class _PointNetPoolTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, store_dtype, mesh, *flat):
        params = [tuple(p.contiguous() for p in flat[i:i + 4]) for i in range(0, len(flat), 4)]
        pooled, ys, means, variances = _forward(x.contiguous(), params, fused_layer, fused_pool,
                                                store_dtype, mesh)
        ctx.save_for_backward(x, *(p for layer in params for p in layer), *ys, *means,
                              *variances)
        ctx.n_layers = len(params)
        ctx.bf16 = store_dtype == BF16
        ctx.mesh = mesh
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
        mesh = ctx.mesh
        dp, mp = (1, 1) if mesh is None else (mesh.dp, mesh.mp)
        if mp > 1:  # the model group's parts of the cotangent: the whole on each rank
            g_pooled = all_reduce(g_pooled.contiguous(), mesh.model_group)
        n_rows = rows * dp  # the global batch's rows

        # mean-pool backward: the same share to each of a frame's points
        d = ys[-1].shape[1]
        g_h = (g_pooled / n)[:, :, None, :].expand(b, t, n, d).reshape(rows, d)
        grads = [None] * (4 * k)
        g_x = None
        # wgrad and dgrad: f32, or bf16 operands with f32 accumulation
        mm = mm_bf16 if ctx.bf16 else torch.matmul
        for li in range(k - 1, -1, -1):
            w, bias, gamma, beta = params[li]
            inv = torch.rsqrt(variances[li] + _EPS)
            x_hat = (ys[li].float() - means[li]) * inv
            bn_out = x_hat * gamma + beta
            g_bn = g_h * torch.where(bn_out > 0, 1.0, torch.exp(torch.clamp(bn_out, max=0.0)))
            g_gamma = torch.sum(g_bn * x_hat, dim=0)
            g_beta = torch.sum(g_bn, dim=0)
            sum_gamma, sum_beta = g_gamma, g_beta
            if dp > 1:  # the global batch's column sums
                sum_gamma, sum_beta = all_reduce(torch.stack([g_gamma, g_beta]), mesh.data_group)
            # train-mode BatchNorm: the batch mean and variance depend on y
            g_y = inv * gamma * (g_bn - sum_beta / n_rows - x_hat * (sum_gamma / n_rows))
            shard = _is_shard(w, bias, mesh)
            if shard:  # this rank's columns
                cols = w.shape[1]
                g_y_w = g_y[:, mesh.model_rank * cols:(mesh.model_rank + 1) * cols]
            else:
                g_y_w = g_y
            if li == 0:
                h_prev = x.reshape(rows, c)
            else:
                w_p, b_p, gamma_p, beta_p = params[li - 1]
                h_prev = _activate(ys[li - 1].float(),
                                   bn_affine(means[li - 1], variances[li - 1], gamma_p, beta_p))
            layer = [mm(h_prev.t(), g_y_w), torch.sum(g_y, dim=0), g_gamma, g_beta]
            if mp > 1:  # a replicated leaf's share of what the model group computes alike
                layer = [g if i == 0 and shard else g / mp for i, g in enumerate(layer)]
            grads[4 * li:4 * li + 4] = layer
            if li > 0 or ctx.needs_input_grad[0]:
                g_h = mm(g_y_w, w.t())
                if shard:
                    g_h = all_reduce(g_h, mesh.model_group)
            if li == 0 and ctx.needs_input_grad[0]:
                g_x = (g_h / mp if mp > 1 else g_h).reshape(x.shape)
        return (g_x, None, None, *grads)


def pointnet_pool_train(x: torch.Tensor, params: Sequence[Layer],
                        store_dtype: torch.dtype = torch.float32, mesh: Optional[Mesh] = None):
    """Train-mode PointNet stack + mean pool: ``(B, T, N, C) → (B, T, D)``.

    :param params: 4 layers ``(W (C_in, C_out), b, γ, β)``, W in the JAX
        package's ``(in, out)`` layout; with a ``mesh``, W may be this model
        rank's column shard ``(C_in, C_out / MP)``.
    :param store_dtype: f32, or bf16 for the JAX package's bf16 training
        (the module docstring): the stored activations and the matmul
        operands in bf16, everything else f32.
    :param mesh: x holds this data rank's rows of the batch (the module
        docstring); the statistics are the global batch's.
    :returns: ``(pooled, means, vars)``: the batch means and biased
        variances of each layer's raw output, for the caller to fold into
        the running statistics. Differentiable with respect to x and params.
    """
    flat = [p for layer in params for p in layer]
    if store_dtype not in (torch.float32, BF16):
        raise ValueError(f"store_dtype must be float32 or bfloat16, got {store_dtype}")
    out = _PointNetPoolTrain.apply(x.float(), store_dtype, mesh, *flat)
    k = len(params)
    return out[0], tuple(out[1:1 + k]), tuple(out[1 + k:])
