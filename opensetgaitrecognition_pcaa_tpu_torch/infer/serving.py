"""Open-set decisions for live requests: in process, or packed into a
``.osgr`` serving artifact.

Port of ``opensetgaitrecognition_pcaa_tpu/infer/serving.py``.

- PCAA: a request is ``(B, k, T, N, C)`` windows of k sequential crops; the
  answer is one decision per window (a train-class index, or ``n_labels``
  for "unknown") and the count of crops above the threshold. The encoder
  runs folded (the CUDA PointNet kernel on the card); the mixture score
  runs in f64 on the same device, with the underflow tie of
  ``ops/openset.py::underflow_tied``.
- OR-CED: the device forward (folded encoder with a given eps, argmax,
  latent, decoder, per-crop Chamfer through the CUDA kernel) and the host
  f64 epilogue through ``infer/orced.py::orced_criteria``, so its
  decisions are those of ``orced_apply_ood``.

The artifact (``export_pcaa_decision``, ``export_orced_decision``) holds
one run folder's calibrated decision as a ``torch.export`` program:
``MAGIC | u64-LE meta length | meta JSON | torch.export.save bytes``, the
JAX package's container with the port's own format tag. The program is a
traced ``PCAADecision`` or ``ORCEDForward`` module, with the encoder's
PointNet stage and the Chamfer distance as the custom ops
``osgr_torch::pointnet_pool_infer`` and ``osgr_torch::seq_chamfer``
(``ops/pointnet_infer.py``, ``ops/chamfer_kernel.py``); a CUDA tensor
reaches the hand-written kernels through them, a CPU tensor their plain
versions. The batch is symbolic, so one artifact takes any batch size. It
is traced on the device that calibrated it and saved with its weights on
the CPU; ``load_serving_artifact`` moves it to the device it is asked for,
so one file serves the CPU and the card. The meta carries the threshold
or the ORCED class statistics, and the custom ops the program calls.

A JAX-written artifact (format ``osgr-serving-v1``) holds StableHLO,
which only ``jax.export`` can run: the loader refuses it, and any other
format, before it deserializes anything. The precision flags are not part
of a traced graph: ``ServingArtifact.call`` sets ``ieee_f32`` first.
"""

from __future__ import annotations

import json
import math
import os
import struct
from functools import partial
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.export import Dim
from torch.export.passes import move_to_device_pass

from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, VARIATION, variation_from_model_name
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
from opensetgaitrecognition_pcaa_tpu_torch.infer.common import ieee_f32
from opensetgaitrecognition_pcaa_tpu_torch.infer.fast_encoder import (
    Pool,
    encoder_eval,
    orced_encoder_eval,
)
from opensetgaitrecognition_pcaa_tpu_torch.infer.orced import (
    THRESHOLD_G,
    ORCEDClassStats,
    _orced_pass,
    orced_class_stats,
    orced_criteria,
    orced_inference_setup,
)
from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import (
    calibrate_open_set,
    pcaa_inference_setup,
)
from opensetgaitrecognition_pcaa_tpu_torch.models.orced import ORCEDDecoder, ORCEDEncoder
from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGEncoder
from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer_kernel import (
    seq_chamfer_kernel,
    seq_chamfer_op,
)
from opensetgaitrecognition_pcaa_tpu_torch.ops.pointnet_infer import (
    pointnet_pool_infer,
    pointnet_pool_op,
)

Device = Union[str, torch.device]
_MAGIC = b"OSGRSRV1"
FORMAT = "osgr-serving-torch-v1"
OP_NAMESPACE = "osgr_torch"
# ln(2**-1075): np.exp rounds to exactly 0.0 below this
_EXP_UNDERFLOW = -1075.0 * math.log(2.0)


def _log_joint_likelihood64(fv: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """f64 ``ops/openset.py::log_joint_likelihood`` with the underflow ties."""
    x = fv.double()
    sq = (
        (x * x).sum(dim=1)[:, None]
        + (means * means).sum(dim=1)[None, :]
        - 2.0 * x @ means.t()
    )
    d = means.shape[1]
    log_pdf = -0.5 * sq - 0.5 * d * math.log(2.0 * math.pi)
    ll = torch.logsumexp(log_pdf, dim=1) - math.log(means.shape[0])
    return torch.where(ll < _EXP_UNDERFLOW, torch.full_like(ll, -math.inf), ll)


def _pcaa_decide(encoder: CGEncoder, pool: Pool, means: torch.Tensor, log_threshold,
                 windows: torch.Tensor, n_labels: int, k: int):
    """The k-window vote with rejection → ``(decisions, n_above)`` int64."""
    b = windows.shape[0]
    flat = windows.reshape((b * k,) + tuple(windows.shape[2:]))
    logits, fv = encoder_eval(encoder, flat, pool)
    preds = logits.argmax(dim=1).reshape(b, k)
    ll = _log_joint_likelihood64(fv, means).reshape(b, k)
    n_above = (ll > log_threshold).sum(dim=1)
    majority = F.one_hot(preds, n_labels).sum(dim=1).argmax(dim=1)
    decisions = torch.where(n_above * 2 > k, majority, torch.full_like(majority, n_labels))
    return decisions, n_above


def make_pcaa_decision_fn(encoder: CGEncoder, n_labels: int, k: int):
    """→ ``decide(means, log_threshold, windows)``.

    ``means``: ``(K, d)`` mixture centres, moved to the windows' device in
    f64; ``windows``: ``(B, k, T, N, C)`` f32 on the encoder's device.
    Returns ``(decisions (B,) int64, n_above (B,) int64)``, the decisions
    of ``infer/pcaa.py::_window_vote`` for single-label windows.
    """
    ieee_f32()

    @torch.inference_mode()
    def decide(means, log_threshold: float, windows: torch.Tensor):
        means64 = torch.as_tensor(np.asarray(means), dtype=torch.float64, device=windows.device)
        return _pcaa_decide(encoder, pointnet_pool_infer, means64, log_threshold, windows,
                            n_labels, k)

    return decide


def _orced_forward(encoder: ORCEDEncoder, decoder: ORCEDDecoder, pool: Pool, chamfer,
                   x: torch.Tensor, eps: torch.Tensor):
    logits, z, _, _ = orced_encoder_eval(encoder, x, pool, eps=eps)
    return logits.argmax(dim=1), z, chamfer(decoder(z), x)


def make_orced_forward_fn(encoder: ORCEDEncoder, decoder: ORCEDDecoder):
    """→ ``forward(x, eps)``, the device part of the OR-CED decision.

    ``x``: ``(B, T, N, C)`` f32 crops and ``eps``: ``(B, latent)`` f32
    reparametrization draws, both on the modules' device. Returns
    ``(preds (B,) int64, z (B, latent) f32, re (B,) f32)``: argmax class,
    latent sample and per-crop Chamfer reconstruction error.
    """
    ieee_f32()

    @torch.inference_mode()
    def forward(x: torch.Tensor, eps: torch.Tensor):
        return _orced_forward(encoder, decoder, pointnet_pool_infer,
                              partial(seq_chamfer_kernel, avg_out=False), x, eps)

    return forward


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def orced_decide_host(preds, z, re, means_z, stds_z, thr_re, n_labels: int,
                      threshold_g: float = THRESHOLD_G):
    """Host f64 epilogue over ``make_orced_forward_fn``'s outputs (tensors
    or arrays) → ``(decisions (B,) int64, latent_flag (B,) bool,
    rec_flag (B,) bool)``."""
    preds = _host(preds)
    stats = ORCEDClassStats(
        means_z=np.asarray(means_z, np.float64),
        stds_z=np.asarray(stds_z, np.float64),
        thresholds_re=np.asarray(thr_re, np.float64),
        n_classes=int(n_labels),
    )
    latent_flag, rec_flag = orced_criteria(
        stats, threshold_g, preds, _host(z).astype(np.float64), _host(re).astype(np.float64)
    )
    decisions = np.array(preds, dtype=np.int64)
    decisions[latent_flag | rec_flag] = int(n_labels)
    return decisions, latent_flag, rec_flag


class PCAADecision(nn.Module):
    """The PCAA decision of one calibrated run, to trace: ``(B, k, T, N,
    C)`` windows → ``(decisions (B,) int64, n_above (B,) int64)``, the body
    of ``make_pcaa_decision_fn`` with the PointNet stage through the custom
    op. The f64 centres and the threshold are buffers."""

    def __init__(self, encoder: CGEncoder, means: np.ndarray, log_threshold: float,
                 n_labels: int, k: int):
        super().__init__()
        device = next(encoder.parameters()).device
        self.encoder = encoder
        self.register_buffer("means", torch.as_tensor(np.asarray(means), dtype=torch.float64,
                                                      device=device))
        self.register_buffer("log_threshold", torch.tensor(float(log_threshold),
                                                           dtype=torch.float64, device=device))
        self.n_labels, self.k = int(n_labels), int(k)

    def forward(self, windows: torch.Tensor):
        return _pcaa_decide(self.encoder, pointnet_pool_op, self.means, self.log_threshold,
                            windows, self.n_labels, self.k)


class ORCEDForward(nn.Module):
    """The device part of the OR-CED decision, to trace: ``(B, T, N, C)``
    crops and ``(B, latent)`` eps → ``(preds (B,) int64, z, re (B,))``, as
    ``make_orced_forward_fn`` computes them, with the PointNet stage and
    the Chamfer distance through the custom ops."""

    def __init__(self, encoder: ORCEDEncoder, decoder: ORCEDDecoder):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder

    def forward(self, x: torch.Tensor, eps: torch.Tensor):
        return _orced_forward(self.encoder, self.decoder, pointnet_pool_op, seq_chamfer_op, x, eps)


def _export(module: nn.Module, *example: torch.Tensor) -> torch.export.ExportedProgram:
    """Trace ``module`` on its example inputs' device with a symbolic batch
    (each example holds 2 rows: torch specializes batches of 0 and 1), then
    move its weights to the CPU."""
    batch = Dim("b", min=1)
    with torch.no_grad():
        program = torch.export.export(module.eval(), example, strict=False,
                                      dynamic_shapes=tuple({0: batch} for _ in example))
    return move_to_device_pass(program, "cpu")


def _custom_ops(program: torch.export.ExportedProgram) -> List[str]:
    """The port's custom ops that ``program`` calls, by name."""
    return sorted({
        node.target.name() for node in program.graph.nodes
        if node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload)
        and node.target.namespace == OP_NAMESPACE
    })


def _write_artifact(out_path: str, meta: Dict, program: torch.export.ExportedProgram) -> str:
    """Write the container; ``meta`` gains the list of custom ops."""
    meta["ops"] = _custom_ops(program)
    meta_bytes = json.dumps(meta).encode("utf-8")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(meta_bytes)))
        f.write(meta_bytes)
        torch.export.save(program, f)  # written in place after the header
    return out_path


class ServingArtifact:
    """A loaded decision artifact: its ``meta`` dict and its program on
    ``device``."""

    def __init__(self, meta: Dict, program: torch.export.ExportedProgram, device: torch.device):
        self.meta = meta
        self.device = device
        self._module = program.module()

    def call(self, *args) -> Tuple[torch.Tensor, ...]:
        """Raw call with the exported signature (``meta['inputs']``): arrays
        or tensors in, tensors on the artifact's device out."""
        ieee_f32()
        inputs = [torch.as_tensor(a, dtype=torch.float32, device=self.device) for a in args]
        with torch.inference_mode():
            return tuple(self._module(*inputs))

    def decide(self, x, *, eps: Optional[np.ndarray] = None, seed: int = 0):
        """PCAA takes ``x=(B, k, T, N, C)`` windows → ``(decisions,
        n_above)``; ORCED takes ``x=(B, T, N, C)`` crops (``eps`` drawn from
        ``np.random.default_rng(seed)`` unless given), runs the program and
        the host f64 epilogue → ``(decisions, latent_flag, rec_flag)``.
        numpy arrays out."""
        if self.meta["model"] == "pcaa":
            return tuple(_host(t) for t in self.call(x))
        if eps is None:
            eps = (
                np.random.default_rng(seed)
                .standard_normal((len(x), self.meta["latent_dim"]))
                .astype(np.float32)
            )
        preds, z, re = self.call(x, eps)
        return orced_decide_host(
            preds, z, re, self.meta["means_z"], self.meta["stds_z"],
            self.meta["thresholds_re"], self.meta["n_labels"],
            self.meta.get("threshold_g", THRESHOLD_G),
        )


def _read_meta(f, path: str) -> Dict:
    """The header of an artifact → its meta; ``ValueError`` naming ``path``
    for anything but the port's format."""
    header = f.read(len(_MAGIC) + 8)
    if len(header) < len(_MAGIC) + 8 or header[:len(_MAGIC)] != _MAGIC:
        raise ValueError(f"not a serving artifact: {path!r}")
    (meta_len,) = struct.unpack("<Q", header[len(_MAGIC):])
    try:
        meta = json.loads(f.read(meta_len).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"not a serving artifact: {path!r} ({e})") from e
    fmt = meta.get("format") if isinstance(meta, dict) else None
    if fmt != FORMAT:
        raise ValueError(
            f"{path!r} is a serving artifact of format {fmt!r}; the port loads {FORMAT!r} "
            "(a JAX-written artifact holds StableHLO, which only jax.export runs)"
        )
    return meta


def load_serving_artifact(path: str, device: Device = "cuda") -> ServingArtifact:
    """Read an artifact that ``export_*_decision`` wrote and move its
    program to ``device``. Raises ``ValueError``, naming ``path``, for
    another format (a JAX-written artifact included) or a custom op that is
    not registered, before it deserializes the program."""
    with open(path, "rb") as f:
        meta = _read_meta(f, path)
        for name in meta.get("ops", []):
            namespace, op = name.split("::")
            if not hasattr(getattr(torch.ops, namespace), op):
                raise ValueError(f"{path!r} calls the op {name}, which is not registered")
        program = torch.export.load(f)
    device = torch.device(device)
    return ServingArtifact(meta, move_to_device_pass(program, device), device)


def export_pcaa_decision(
    model_name: str,
    k: int,
    *,
    models_path: str = "models",
    data_path: Optional[str] = None,
    out_path: Optional[str] = None,
    generate_dataset: bool = True,
    seed: int = 0,
    unseen_valid_ratio: float = 0.2,
    variation: Optional[VARIATION] = None,
    device: Device = "cuda",
) -> Tuple[str, Dict]:
    """Calibrate one trained PCAA run on ``device`` (``calibrate_open_set``,
    the threshold ``pcaa_inference`` uses) and write its decision for
    k-crop windows as an artifact → ``(path, meta)``."""
    var = variation or variation_from_model_name(model_name)
    cfg, encoder, means = pcaa_inference_setup(
        model_name, var, device=device, models_path=models_path, data_path=data_path,
        generate_dataset=generate_dataset,
    )
    ieee_f32()
    cal = calibrate_open_set(encoder, means, cfg, device=device, seed=seed,
                             unseen_valid_ratio=unseen_valid_ratio)
    module = PCAADecision(encoder, means, cal.log_threshold, cal.n_labels, k)
    example = torch.zeros((2, k, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES), device=device)
    program = _export(module, example)
    meta = {
        "format": FORMAT,
        "model": "pcaa",
        "model_name": model_name,
        "variation": var.value,
        "k": k,
        "n_labels": cal.n_labels,
        "unknown_label": cal.n_labels,
        "log_threshold": float(cal.log_threshold),
        "inputs": [f"windows (b, {k}, {cfg.NSTEPS}, {cfg.NMAX}, {cfg.NFEATURES}) f32"],
        "outputs": ["decisions (b,) i64", "n_above_threshold (b,) i64"],
    }
    out_path = out_path or os.path.join(models_path, model_name, f"serving_decision_k{k}.osgr")
    return _write_artifact(out_path, meta, program), meta


def export_orced_decision(
    model_name: str,
    *,
    models_path: str = "models",
    data_path: Optional[str] = None,
    out_path: Optional[str] = None,
    generate_dataset: bool = True,
    batch_size: int = 64,
    seed: int = 0,
    device: Device = "cuda",
) -> Tuple[str, Dict]:
    """Calibrate one trained OR-CED run on ``device`` and write its forward
    as an artifact, the class statistics in its meta → ``(path, meta)``.

    The statistics come from the TRAIN pass exactly as ``orced_inference``
    draws it (the split's subsampling from ``default_rng(seed)``, the
    reparametrization from ``torch.Generator(device).manual_seed(seed)``,
    whole batches of ``batch_size``), so they are those of
    ``orced_inference(dump_calibration=True)`` at this seed.
    """
    device = torch.device(device)
    cfg, encoder, decoder = orced_inference_setup(
        model_name, device=device, models_path=models_path, data_path=data_path,
        generate_dataset=generate_dataset,
    )
    ieee_f32()
    x_tr, y_tr = RadarCropDataset(
        SPLIT.TRAIN, cfg.GEN_DATA_PATH, subsample_factor=cfg.SUBSAMPLE_FACTOR,
        subsample_rng=np.random.default_rng(seed),
    ).load_all()
    n_keep = (len(y_tr) // batch_size) * batch_size  # drop_last, as in orced_inference
    tr_preds, tr_z, tr_re = _orced_pass(
        encoder, decoder, x_tr[:n_keep], device=device, batch_size=batch_size,
        generator=torch.Generator(device=device).manual_seed(seed),
    )
    stats = orced_class_stats(tr_re, tr_z, y_tr[:n_keep].astype(np.int64), tr_preds)
    latent = cfg.SUP_LATENT_DIM
    program = _export(ORCEDForward(encoder, decoder),
                      torch.zeros((2, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES), device=device),
                      torch.zeros((2, latent), device=device))
    meta = {
        "format": FORMAT,
        "model": "orced",
        "model_name": model_name,
        "n_labels": stats.n_classes,
        "unknown_label": stats.n_classes,
        "latent_dim": latent,
        "inputs": [
            f"crops (b, {cfg.NSTEPS}, {cfg.NMAX}, {cfg.NFEATURES}) f32",
            f"eps (b, {latent}) f32 reparam draw",
        ],
        # the program emits the forward triple; ServingArtifact.decide runs
        # the host f64 epilogue on it with the statistics below
        "outputs": ["preds (b,) i64", f"z (b, {latent}) f32", "rec_error (b,) f32"],
        "threshold_g": THRESHOLD_G,
        "means_z": np.asarray(stats.means_z, np.float64).tolist(),
        "stds_z": np.asarray(stats.stds_z, np.float64).tolist(),
        "thresholds_re": np.asarray(stats.thresholds_re, np.float64).tolist(),
    }
    out_path = out_path or os.path.join(models_path, model_name, "serving_decision.osgr")
    return _write_artifact(out_path, meta, program), meta
