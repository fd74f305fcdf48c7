"""Shared inference machinery: fixed-size chunks through a forward on a
device, and the f32 settings every entry point uses.

Port of ``opensetgaitrecognition_pcaa_tpu/infer/common.py:25-83``. The JAX
package scans the chunks inside one jitted call; here a Python loop runs
them eagerly. The padding policy is the same (the last row repeats up to a
whole chunk), so every chunk has one shape, and the padding rows are
dropped from the outputs.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from opensetgaitrecognition_pcaa_tpu_torch.utils.profiling import count, span


def ieee_f32() -> None:
    """True f32 for matmuls and convolutions on the card.

    torch runs f32 convolutions through cuDNN in TF32 by default, and TF32
    keeps about three decimal digits: the H100 counterpart of the TPU's
    DEFAULT precision, which flipped open-set decisions
    (``DECISION_PARITY.md``). The JAX package infers at "highest". A bf16
    GEMM with an f32 output (bf16 training's PointNet backward) keeps its
    f32 sums too: no reduced-precision split-K reduction.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def chunk_rows(x: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad ``x`` to a multiple of ``batch_size`` by repeating its last row
    and reshape to ``(steps, batch_size, ...)``."""
    n = x.shape[0]
    steps = -(-n // batch_size)
    pad = steps * batch_size - n
    xp = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0) if pad else x
    return np.asarray(xp).reshape((steps, batch_size) + x.shape[1:])


@torch.inference_mode()
def batched_apply(
    fn: Callable[..., Tuple[torch.Tensor, ...]],
    x: np.ndarray,
    batch_size: int,
    device: torch.device,
    with_index: bool = False,
) -> Tuple[np.ndarray, ...]:
    """Apply ``fn`` to ``x`` chunk by chunk on ``device`` → numpy outputs
    with the padding rows dropped.

    ``with_index=True`` calls ``fn(chunk, step_idx)``, so that a caller can
    pick the rows of a per-sample array that it chunked with ``chunk_rows``
    (they stay aligned with the chunk's rows) or draw fresh noise per chunk.
    """
    n = x.shape[0]
    outs = []
    with span("eval.call"):
        for i, chunk in enumerate(chunk_rows(np.asarray(x, dtype=np.float32), batch_size)):
            count("eval.chunks")
            with span("eval.h2d"):
                chunk = torch.from_numpy(chunk).to(device)
            with span("eval.encoder"):
                res = fn(chunk, i) if with_index else fn(chunk)
            with span("eval.d2h"):
                outs.append([r.cpu().numpy() for r in res])
        with span("eval.concat"):
            joined = tuple(np.concatenate(parts, axis=0)[:n] for parts in zip(*outs))
    return joined
