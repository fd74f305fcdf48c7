"""OR-CED baseline training (VAE + metric learning).

Port of ``opensetgaitrecognition_pcaa_tpu/train/orced.py:69-555``. One Adam
over the encoder, the decoder and the mean learner; the loss of a batch is

    REC_W·Chamfer + CE_W·CE + TRIPLET_W·Triplet(MS-mined, L2-normalized z)
    + KL_W·CG-KL·(epoch / EPOCHS)

with the KL weight annealed linearly by epoch (reference
``train_ORCED.py:122``), so epoch 0 trains with no KL term. Kept
semantics of the JAX trainer:

- the reference quirk ``betas=(B1, B1)``: Adam's second-moment decay is
  B1 = 0.9, not B2;
- the rec loss is the plain ``seq_chamfer``, the encoder the plain
  ``GaitBackbone``, and Adam the plain ``train/optim.py`` update, as the
  JAX trainer uses XLA and optax there: no kernel runs in ORCED training,
  and ``FUSED_POINTNET`` is not read;
- the train step runs the encoder and the mean learner in train mode, both
  BatchNorm stacks moving their running statistics; the valid epoch runs
  the encoder in eval mode and still samples the reparametrization noise;
- ``eps`` injection replays given noise, so that a port step and a JAX
  step can run on the same state, batch and noise; otherwise the noise of
  the train steps and of every valid epoch comes from one
  ``torch.Generator`` seeded from ``cfg.SEED`` (fresh draws each epoch,
  which cannot be JAX's);
- a best-by-valid-accuracy checkpoint every ``CHECKPOINT_FREQUENCY``
  epochs, a strict ``>`` from 0.0, and the final state when no epoch
  improved; the run folder holds ``<NAME>_{E,G,ML}.msgpack``, which both
  packages' ``orced_inference_setup`` read;
- with ``SAVE_RESUME_STATE`` the full state (parameters, running
  statistics, the Adam state, the noise generator of the train and valid
  eps, the host shuffle generator, the epoch and the best weights so far)
  is written at each checkpoint epoch, and a later call resumes from it;
  the KL weight of a resumed epoch is that epoch's.

- ``COMPUTE_DTYPE="bfloat16"`` computes the encoder's backbone and the
  decoder in bf16 (``models/layers.py``) and stores Adam's first moments
  in bf16, ``BF16_ADAM_NU`` the second moments too, with JAX
  ``build_orced``'s optimizer: ``optax.adam(mu_dtype)`` without
  ``BF16_ADAM_NU``, ``adam_lowmem`` with it, ``adam_factored`` with
  ``FACTORED_ADAM_NU`` (``train/optim.py``), all with ``b2 = B1``;
  ``BF16_WEIGHT_CACHE`` (bf16 compute only) runs the decoder on bf16
  copies of its weights, refreshed after each Adam step and rebuilt after
  a restore or sharding, as ``train/pcaa.py`` does: the same bits as
  without it.

- ``DP_DEVICES × MP_DEVICES > 1`` trains one run over that many ranks,
  as ``train/pcaa.py`` does and JAX ``train_orced`` (``:429-486``): each
  data rank takes its rows of every batch, the reparametrization's eps is
  drawn at the global shape and sliced, the triplet loss mines the global
  pair grid of the all-gathered embeddings (``ops/losses.py``), the wide
  kernels are sharded after any resume restore, and rank 0 writes the run
  folder from gathered full trees.

Modules, parameters, running statistics and Adam moments are updated in
place. ``FUSED_ADAM`` and ``DEFERRED_DECODER_UPDATE`` are PCAA-only and
raise ``ValueError`` as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import orced_module_variables
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import (
    RadarCropDataset,
    epoch_batch_indices,
)
from opensetgaitrecognition_pcaa_tpu_torch.infer.common import ieee_f32
from opensetgaitrecognition_pcaa_tpu_torch.models.mean_learner import GaussianMeanLearner
from opensetgaitrecognition_pcaa_tpu_torch.models.orced import ORCEDDecoder, ORCEDEncoder
from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer import seq_chamfer
from opensetgaitrecognition_pcaa_tpu_torch.ops.losses import (
    cg_kl_divergence,
    cross_entropy,
    triplet_loss_with_ms_miner,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.metrics import MetricLogger
from opensetgaitrecognition_pcaa_tpu_torch.train.optim import AdamState, adam_init, adam_update_
from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import Mesh, module_specs
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
    _draw,
    _payload_from_arrays,
    _stack,
    adam_dtypes,
    check_weight_cache,
    compute_dtype,
    full_payload,
    full_resume_tree,
    global_metrics,
    mesh_grads,
    model_row_sum,
    place_state,
    refresh_cache_,
    restore_resume_tree,
    rows_of,
    run_mesh,
    weight_cache,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import (
    load_best_payload,
    load_train_state,
    mark_run_completed,
    module_path,
    save_best_payload,
    save_params,
    save_train_state,
)
from opensetgaitrecognition_pcaa_tpu_torch.utils.profiling import count, span

Device = Union[str, torch.device]


def _check_supported(cfg: Config) -> None:
    for flag in ("FUSED_ADAM", "DEFERRED_DECODER_UPDATE"):
        if getattr(cfg, flag):
            raise ValueError(f"Config.{flag} is PCAA-only; unset it for ORCED runs")
    check_weight_cache(cfg)


class ORCEDModules(nn.Module):
    """The encoder, the decoder and the mean learner, under the keys of the
    JAX package's ``ORCEDState.params``."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        n, latent = cfg.n_classes, cfg.SUP_LATENT_DIM
        dtype = compute_dtype(cfg)  # the encoder and the decoder only, as in JAX
        self.encoder = ORCEDEncoder(
            n, in_features=cfg.NFEATURES, sup_latent_dim=latent,
            pointnet_out_dim=cfg.POINTNET_OUT_DIM, dtc_filters=tuple(cfg.DTC_FILTERS),
            generator=generator, compute_dtype=dtype,
        )
        self.decoder = ORCEDDecoder(latent, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES, generator,
                                    compute_dtype=dtype)
        self.mean_learner = GaussianMeanLearner(n, latent, generator)


@dataclasses.dataclass
class ORCEDState:
    opt: AdamState
    generator: torch.Generator  # the reparametrization noise when none is injected
    # BF16_WEIGHT_CACHE: the decoder's bf16 weight copies by name in the
    # modules (train/pcaa.py::weight_cache); empty when the option is off
    cast: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def build_orced(cfg: Config, *, device: Device = "cuda") -> Tuple[ORCEDModules, ORCEDState]:
    """Modules with torch's default init drawn from ``cfg.SEED``, a zero
    Adam state and, with ``BF16_WEIGHT_CACHE``, the decoder's weight
    copies, on ``device``."""
    _check_supported(cfg)
    mods = ORCEDModules(cfg, torch.Generator().manual_seed(cfg.SEED)).to(device)
    noise = torch.Generator(device=device).manual_seed(cfg.SEED + 1)
    opt = adam_init(mods.named_parameters(), **adam_dtypes(cfg))
    cast = weight_cache(mods) if cfg.BF16_WEIGHT_CACHE else {}
    return mods, ORCEDState(opt=opt, generator=noise, cast=cast)


def make_orced_train_step(mods: ORCEDModules, cfg: Config, mesh: Optional[Mesh] = None):
    """→ ``step(state, pcs, labels, kl_mult, eps=None) → (state, metrics)``;
    with ``mesh``, as ``train/pcaa.py::make_train_step`` takes it."""
    ieee_f32()
    n = cfg.n_classes
    params = dict(mods.named_parameters())
    specs = None if mesh is None else module_specs(mods)
    row_sum = model_row_sum(specs, mesh)
    # reference quirk: betas=(B1, B1)
    adam = dict(lr=cfg.LR, b1=cfg.B1, b2=cfg.B1)

    def step(state: ORCEDState, pcs: torch.Tensor, labels: torch.Tensor, kl_mult: float,
             eps: Optional[torch.Tensor] = None):
        mods.train()
        oh = F.one_hot(labels.long(), n).float()
        if eps is None and mesh is not None:
            eps = _draw(state.generator, (pcs.shape[0], cfg.SUP_LATENT_DIM), pcs.device, mesh)
        with span("train.encoder"):
            logits, z, mu, logvar = mods.encoder(pcs, eps=eps, generator=state.generator)
        with span("train.losses"):
            rec = mods.decoder(z)
            mu_gts = mods.mean_learner(oh)

            rec_loss = cfg.REC_W * seq_chamfer(rec, pcs)
            sup_loss = cfg.CE_W * cross_entropy(logits, labels)
            z_norm = z / torch.linalg.norm(z, dim=1, keepdim=True)
            trip_loss = cfg.TRIPLET_W * triplet_loss_with_ms_miner(
                z_norm, labels, margin=cfg.TRIPLET_MARGIN, mesh=mesh
            )
            kl_loss = cfg.KL_W * cg_kl_divergence(mu, logvar, mu_gts) * kl_mult
            tot_loss = rec_loss + sup_loss + trip_loss + kl_loss
        with span("train.backward"):
            # a cached decoder weight takes its gradient through its bf16 copy
            targets = {k: state.cast.get(k, p) for k, p in params.items()}
            grads = mesh_grads(tot_loss, targets, specs, mesh)
        with span("train.adam"):
            adam_update_(state.opt, params, grads, **adam, row_sum=row_sum)
            refresh_cache_(state.cast, params)
        with span("train.metrics"):
            metrics = global_metrics({
                "rec_loss": rec_loss.detach(),
                "sup_loss": sup_loss.detach(),
                "trip_loss": trip_loss.detach(),
                "kl_loss": kl_loss.detach(),
                "tot_loss": tot_loss.detach(),
                "n_correct": torch.sum(torch.argmax(logits, dim=1) == labels).float(),
            }, mesh)
        return state, metrics

    return step


def make_orced_epoch_fns(mods: ORCEDModules, cfg: Config, mesh: Optional[Mesh] = None):
    """→ ``(train_epoch, valid_epoch)``: Python loops over the batches that
    a ``(steps, B)`` index matrix picks from device-resident splits.
    ``noise`` (optional, both): ``eps`` of shape ``(steps, B, latent)``
    replayed instead of fresh draws. With ``mesh`` each rank takes its rows
    of every batch and of the noise, and the metrics are global."""
    train_step = make_orced_train_step(mods, cfg, mesh)

    def train_epoch(state: ORCEDState, x_all, y_all, perm, kl_mult: float, noise=None):
        with span("train.epoch"):
            with span("train.epoch_setup"):
                perm = rows_of(torch.as_tensor(perm, device=x_all.device).long(), mesh)
                if noise is not None:
                    noise = rows_of(torch.as_tensor(noise), mesh)
            out = []
            for i in range(perm.shape[0]):
                with span("train.step"):
                    count("train.steps")
                    with span("train.gather"):
                        idx = perm[i]
                        pcs, labels = x_all[idx], y_all[idx]
                    eps = None if noise is None else noise[i]
                    state, m = train_step(state, pcs, labels, kl_mult, eps)
                out.append(m)
            with span("train.epoch_stack"):
                stacked = _stack(out)
        return state, stacked

    @torch.no_grad()
    def valid_epoch(state: ORCEDState, x_all, y_all, perm, noise=None):
        perm = rows_of(torch.as_tensor(perm, device=x_all.device).long(), mesh)
        if noise is not None:
            noise = rows_of(torch.as_tensor(noise), mesh)
        mods.eval()
        try:
            out = []
            for i in range(perm.shape[0]):
                idx = perm[i]
                pcs, labels = x_all[idx], y_all[idx]
                eps = None if noise is None else noise[i]
                if eps is None and mesh is not None:
                    eps = _draw(state.generator, (pcs.shape[0], cfg.SUP_LATENT_DIM), pcs.device,
                                mesh)
                # eval mode still samples the reparametrization noise
                logits, z, _, _ = mods.encoder(pcs, eps=eps, generator=state.generator)
                out.append(global_metrics({
                    "rec_loss": cfg.REC_W * seq_chamfer(mods.decoder(z), pcs),
                    "ce_loss": cfg.CE_W * cross_entropy(logits, labels),
                    "n_correct": torch.sum(torch.argmax(logits, dim=1) == labels).float(),
                }, mesh))
        finally:
            mods.train()
        return _stack(out)

    return train_epoch, valid_epoch


def write_orced_checkpoint(run_dir: str, name: str, payload: Dict[str, torch.Tensor]) -> None:
    """Write the reference's E (with the running statistics), G and ML
    files from an ``ORCEDModules`` state_dict."""
    variables = orced_module_variables(payload)
    for module, tag in (("encoder", "E"), ("decoder", "G"), ("mean_learner", "ML")):
        save_params(variables[module], module_path(run_dir, name, tag))


def train_orced(
    cfg: Config,
    *,
    wandb_mode: str = "disabled",
    datasets: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = None,
    verbose: bool = True,
    resume: bool = True,
    device: Device = "cuda",
) -> Dict[str, float]:
    """Train one OR-CED run end to end; write the run folder the JAX
    package writes (``config.json``, ``metrics.jsonl``,
    ``<NAME>_{E,G,ML}.msgpack``, ``run_complete.json``) and return the final
    metrics, throughput included.

    :param datasets: optional ``(x_train, y_train, x_valid, y_valid)``;
        otherwise the splits are read from ``cfg.GEN_DATA_PATH``.
    :param resume: continue from the run folder's ``train_state.msgpack``
        if the port wrote one (``ValueError`` if another program did).
    :param device: the CUDA card unless the caller asks for the CPU.

    With ``DP_DEVICES × MP_DEVICES > 1``, as ``train_pcaa``.
    """
    ieee_f32()
    _check_supported(cfg)
    mesh = run_mesh(cfg)
    lead = mesh is None or mesh.rank == 0  # the rank that writes the run folder
    run_dir = cfg.run_dir()
    device = torch.device(device)
    # read first: a state the port cannot resume raises before anything is written
    ckpt_path = os.path.join(run_dir, "train_state.msgpack")
    restored = load_train_state(ckpt_path) if resume else None
    if lead:
        os.makedirs(run_dir, exist_ok=True)
        cfg.save(os.path.join(run_dir, "config.json"))
    name = cfg.MODEL_NAME

    if datasets is None:
        splits = [
            RadarCropDataset(split, cfg.GEN_DATA_PATH, scenarios=cfg.scenarios,
                             subsample_factor=cfg.SUBSAMPLE_FACTOR).load_all()
            for split in (SPLIT.TRAIN, SPLIT.VALID)
        ]
        datasets = (*splits[0], *splits[1])
    x_train, y_train, x_valid, y_valid = (
        torch.as_tensor(np.asarray(a)).to(device) for a in datasets
    )

    mods, state = build_orced(cfg, device=device)
    logger = MetricLogger(run_dir, cfg.to_dict(), mode=wandb_mode) if lead else None
    host_rng = np.random.default_rng(cfg.SEED)
    opts = {"opt": (state.opt, "")}  # the Adam state, its parameters' key prefix in mods

    best_valid_acc = 0.0
    best_payload = None
    start_epoch = 0
    if restored is not None:
        tree, start_epoch, meta = restored
        restore_resume_tree(tree, mods, {"opt": state.opt}, state.generator)
        del restored, tree  # the host copy: 2.6 GB at the published widths
        host_rng.bit_generator.state = meta["host_rng_state"]
        best_valid_acc = meta.get("best_valid_acc", 0.0)
        best = load_best_payload(ckpt_path)
        if best is not None:
            best_payload = _payload_from_arrays(best, mods)
        if verbose and lead:
            print(f"[{name}] resuming from epoch {start_epoch}")
    specs = place_state(mods, opts, mesh, cfg.MP_MIN_DIM)
    if cfg.BF16_WEIGHT_CACHE:  # the copies of the restored, placed masters
        state.cast = weight_cache(mods)
    train_epoch, valid_epoch = make_orced_epoch_fns(mods, cfg, mesh)

    n_train = x_train.shape[0]
    steps = n_train // cfg.BATCH_SIZE
    valid_steps = x_valid.shape[0] // cfg.BATCH_SIZE
    valid_perm = epoch_batch_indices(x_valid.shape[0], cfg.BATCH_SIZE, shuffle=False)
    out: Dict[str, float] = {}
    t_start = time.time()
    total_windows = 0
    for epoch in range(start_epoch, cfg.EPOCHS):
        kl_mult = float(np.float32(epoch / cfg.EPOCHS))  # train_ORCED.py:122
        perm = epoch_batch_indices(n_train, cfg.BATCH_SIZE, shuffle=True, rng=host_rng)
        state, m = train_epoch(state, x_train, y_train, perm, kl_mult)
        vm = valid_epoch(state, x_valid, y_valid, valid_perm)
        m = {k: v.cpu().numpy() for k, v in m.items()}
        vm = {k: v.cpu().numpy() for k, v in vm.items()}
        total_windows += steps * cfg.BATCH_SIZE

        train_acc = float(np.sum(m["n_correct"]) / (steps * cfg.BATCH_SIZE))
        valid_acc = float(np.sum(vm["n_correct"]) / (valid_steps * cfg.BATCH_SIZE))
        epoch_metrics = {
            "Reconstruction Loss Train": float(np.mean(m["rec_loss"])),
            "Reconstruction Loss Valid": float(np.mean(vm["rec_loss"])),
            "Cross Entropy Loss Train": float(np.mean(m["sup_loss"])),
            "Cross Entropy Loss Valid": float(np.mean(vm["ce_loss"])),
            "Triplet Loss": float(np.mean(m["trip_loss"])),
            "KL Loss": float(np.mean(m["kl_loss"])),
            "Total Loss Train": float(np.mean(m["tot_loss"])),
            "Train Accuracy": train_acc,
            "Valid Accuracy": valid_acc,
        }
        if lead:
            logger.log(epoch_metrics, step=epoch)
        if verbose and lead:
            print(
                f"[{name}] epoch {epoch + 1}/{cfg.EPOCHS} "
                f"rec={epoch_metrics['Reconstruction Loss Train']:.4f} "
                f"kl={epoch_metrics['KL Loss']:.4f} "
                f"trip={epoch_metrics['Triplet Loss']:.4f} "
                f"acc={train_acc:.3f} vacc={valid_acc:.3f}"
            )
        if epoch % cfg.CHECKPOINT_FREQUENCY == 0:
            improved = valid_acc > best_valid_acc
            if improved:
                best_valid_acc = valid_acc
                best_payload = full_payload(mods, mesh, specs)
            if cfg.SAVE_RESUME_STATE:
                tree = full_resume_tree(mods, opts, state.generator, mesh, specs)
                if lead:
                    save_train_state(tree, epoch, host_rng.bit_generator.state, ckpt_path,
                                     extra={"best_valid_acc": best_valid_acc})
                    if improved:
                        save_best_payload(best_payload, ckpt_path)
                del tree
            if not lead and best_payload is not None:
                best_payload = {}  # only rank 0 writes it
        out = dict(epoch_metrics)

    elapsed = time.time() - t_start
    out["windows_per_sec"] = total_windows / max(elapsed, 1e-9)
    out["best_valid_accuracy"] = best_valid_acc
    # the final state if no checkpoint epoch improved the valid accuracy
    final = best_payload if best_payload is not None else full_payload(mods, mesh, specs)
    if lead:
        logger.finish()
        write_orced_checkpoint(run_dir, name, final)
        mark_run_completed(run_dir, out)
    return out
