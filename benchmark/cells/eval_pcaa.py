"""Evaluating a PCAA encoder: ``infer/common.py::batched_apply`` over
``infer/fast_encoder.py::fused_encoder_apply`` (the eval PointNet kernel,
the folded TCN, the heads) on a host-resident split, cycled, in chunks of
the mix's batch: the encoding stage of ``pcaa_inference``.

The comparison: every call's logits and latents against the plain
reference's eval-mode encoder on the same crops and weights (running
statistics included), each as its widest gap over the reference's RMS.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import traffic
from benchmark.harness import note
from benchmark.reference import model as ref
from benchmark.reference import params as ref_params


def weights(ctx, device) -> Dict[str, torch.Tensor]:
    """The encoder's weights and running statistics, made on ``device``
    from the seed, without the ``encoder.`` prefix."""
    leaves = ref_params.pcaa_encoder(ctx.dims, ctx.n_classes, stats=True)
    return {k[len("encoder."):]: v for k, v in ref_params.make(leaves, ctx.seed, device).items()}


def build_encoder(ctx, device):
    """The program's eval-mode ``CGEncoder`` holding the benchmark's
    weights and running statistics."""
    from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGEncoder

    d = ctx.dims
    encoder = CGEncoder(ctx.n_classes, in_features=d["NFEATURES"],
                        sup_latent_dim=d["SUP_LATENT_DIM"], pointnet_out_dim=d["POINTNET_OUT_DIM"],
                        dtc_filters=tuple(d["DTC_FILTERS"]), use_projection_head=True,
                        generator=torch.Generator().manual_seed(0)).to(device).eval()
    w = weights(ctx, device)
    own = {**dict(encoder.named_parameters()), **dict(encoder.named_buffers())}
    if set(own) != set(w):
        raise ValueError(f"the program's encoder differs from the benchmark's: "
                         f"{sorted(set(own) ^ set(w))[:6]}")
    with torch.no_grad():
        for k, t in own.items():
            t.copy_(w[k])
    return encoder


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.device = torch.device(ctx.device)
        self.x, _ = traffic.crops(ctx.traffic, ctx.dims, ctx.seed)
        self.batch = ctx.traffic["batch"]
        note("data")
        self.encoder = build_encoder(ctx, self.device)
        note("build")
        self.crops = self.failed = 0
        self.outputs: List[Tuple[np.ndarray, np.ndarray]] = []
        self.call(self.x[: self.batch])  # warm-up: the chunk's shape, the kernel's library
        note("warm_up")
        self.crops = 0
        self.outputs = []

    def call(self, x: np.ndarray) -> None:
        from opensetgaitrecognition_pcaa_tpu_torch.infer.common import batched_apply, ieee_f32
        from opensetgaitrecognition_pcaa_tpu_torch.infer.fast_encoder import fused_encoder_apply
        from torch.profiler import record_function

        ieee_f32()
        with record_function("bench.eval_call"):
            logits, fv = batched_apply(lambda c: fused_encoder_apply(self.encoder, c), x,
                                       self.batch, self.device)
        if self.ctx.fault == "altered" and not self.outputs:  # a planted fault
            fv = fv.copy()
            fv[len(fv) // 2, 0] += 1.0
        self.outputs.append((logits, fv))
        self.crops += len(x)
        self.failed += int(np.sum(~np.isfinite(logits).all(1) | ~np.isfinite(fv).all(1)))

    def window(self, deadline: float) -> int:
        crops = 0
        while time.perf_counter() < deadline:
            self.call(self.x)
            crops += len(self.x)
        return crops

    def segment(self) -> Dict[str, float]:
        self.call(self.x)
        return {"crops": len(self.x)}

    def end_to_end(self, crops: int, seconds: float) -> Dict[str, float]:
        return {"eval_windows_per_s": crops / seconds}

    def attempted(self) -> Tuple[int, int]:
        return self.crops, self.failed

    def counted(self) -> Dict[str, int]:
        from opensetgaitrecognition_pcaa_tpu_torch.ops.pointnet_infer import pointnet_pool_infer

        return {"pointnet_infer": pointnet_pool_infer.launches}

    def info(self) -> Dict:
        return {"dims": dict(self.ctx.dims), "batch": self.batch,
                "family": self.ctx.config["family"], "n_classes": self.ctx.n_classes}

    def readings(self) -> Dict:
        return {"x": self.x, "outputs": self.outputs}

    def free(self) -> None:
        self.encoder = None


def reference(ctx, readings: Dict, exact: bool = True) -> Dict:
    """The plain eval-mode encoder over the crops → one call's outputs."""
    device = torch.device(ctx.device)
    ref.exact_f32(exact)
    p = {"encoder." + k: v for k, v in weights(ctx, device).items()}
    logits, fv = ref.pcaa_eval(p, torch.from_numpy(readings["x"]).to(device))
    ref.exact_f32(True)
    return {"outputs": [(logits.cpu().numpy(), fv.cpu().numpy())]}


def compare(prog: Dict, want: Dict) -> List[Tuple[str, float]]:
    """``logit_gap`` and ``latent_gap``: over every call, the widest gap of
    an output over the reference's RMS of that output."""
    ref_logits, ref_fv = want["outputs"][0]
    gaps = [0.0, 0.0]
    for outs in prog["outputs"]:
        for i, (got, r) in enumerate(zip(outs, (ref_logits, ref_fv))):
            rms = float(np.sqrt(np.mean(np.square(r, dtype=np.float64))))
            gaps[i] = max(gaps[i], float(np.max(np.abs(got.astype(np.float64) - r))) / rms)
    return [("logit_gap", gaps[0]), ("latent_gap", gaps[1])]


def check(ctx, readings: Dict) -> List[Tuple[str, float, float]]:
    return [(name, value, ctx.limits[name])
            for name, value in compare(readings, reference(ctx, readings)) if name in ctx.limits]
