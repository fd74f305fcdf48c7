"""PCAA V4 adversarial training.

Port of ``opensetgaitrecognition_pcaa_tpu/train/pcaa.py:83-1007`` for the
published variant V4 (fixed centroids, encoder and decoder projection
heads). The JAX package scans a jitted step over an epoch; here a Python
loop runs an eager step. Kept semantics of the JAX step:

- **one** train-mode encoder forward per step: the critic (D) step sees its
  latents detached, and the generator (G) loss backpropagates through the
  same graph;
- the D step's gradients are taken and D is updated before the G loss is
  built, so the G step's critic uses the **updated** D parameters, and
  ``torch.autograd.grad`` over the G parameters keeps G-loss gradients off
  D;
- the WGAN-GP term is two-sided, with per-sample alphas of shape (B, 1);
- the CE term joins the G loss every ``SUPERVISION_FREQUENCY``-th batch;
- two Adam states (``train/optim.py``); ``Config.FUSED_ADAM`` sends the
  generator's update through ``ops/adam.py``, ``Config.FUSED_POINTNET``
  the encoder's PointNet through ``train/fused_encoder.py``;
- the prior sample ``z0 + centroid`` is detached; ``inject=(z0, alphas)``
  replays given noise so that a port step and a JAX step can run on the
  same state, batch and noise;
- a best-by-valid-accuracy checkpoint every ``CHECKPOINT_FREQUENCY``
  epochs, epoch 0 included, validated with the eval-mode encoder, decoder
  and ``seq_chamfer``.

Modules, parameters, running statistics and Adam moments are updated in
place. Not ported yet, and raising ``NotImplementedError``: V1, V2/BASE and
V3, the discriminator projection head, data/tensor parallelism, bf16
compute, the resume state, and the TPU-only options (``BF16_ADAM_NU``,
``FACTORED_ADAM_NU``, ``DEFERRED_DECODER_UPDATE``, ``BF16_WEIGHT_CACHE``).
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

from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import module_variables
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import (
    RadarCropDataset,
    epoch_batch_indices,
)
from opensetgaitrecognition_pcaa_tpu_torch.infer.common import ieee_f32
from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import (
    CGDecoder,
    CGDiscriminator,
    CGEncoder,
    ProjectionHead,
)
from opensetgaitrecognition_pcaa_tpu_torch.ops.adam import fused_adam_tree_update
from opensetgaitrecognition_pcaa_tpu_torch.ops.centroids import sample_distant_points
from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer import seq_chamfer
from opensetgaitrecognition_pcaa_tpu_torch.ops.gp import gradient_penalty
from opensetgaitrecognition_pcaa_tpu_torch.ops.losses import cross_entropy
from opensetgaitrecognition_pcaa_tpu_torch.train.fused_encoder import fused_train_encoder_apply
from opensetgaitrecognition_pcaa_tpu_torch.train.metrics import MetricLogger
from opensetgaitrecognition_pcaa_tpu_torch.train.optim import AdamState, adam_init, adam_update_
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import (
    mark_run_completed,
    module_path,
    save_array,
    save_params,
)

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """Which optional pieces a PCAA ablation variant uses."""

    name: str
    use_enc_head: bool
    use_decoder: bool
    use_dec_head: bool
    learned_centroids: bool
    use_disc_head: bool = False


VARIANTS: Dict[VARIATION, VariantSpec] = {
    VARIATION.V1: VariantSpec("V1", True, True, True, True),
    VARIATION.V2: VariantSpec("V2", False, True, False, False),
    VARIATION.BASE: VariantSpec("BASE", False, True, False, False),
    VARIATION.V3: VariantSpec("V3", False, False, False, False),
    VARIATION.V4: VariantSpec("V4", True, True, True, False),
}


def check_unported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` on the options that neither trainer of
    the port has yet: bf16 compute, the TPU-only optimizer and weight
    options, data/tensor parallelism and the resume state."""
    if cfg.COMPUTE_DTYPE != "float32":
        raise NotImplementedError(f"COMPUTE_DTYPE={cfg.COMPUTE_DTYPE!r}: the port trains in f32")
    for flag in ("BF16_ADAM_NU", "FACTORED_ADAM_NU", "BF16_WEIGHT_CACHE"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"{flag} is not ported")
    if cfg.DP_DEVICES * cfg.MP_DEVICES > 1:
        raise NotImplementedError("data and tensor parallelism are not ported yet")
    if cfg.SAVE_RESUME_STATE:
        raise NotImplementedError("SAVE_RESUME_STATE: the resume state is not ported yet")


def _check_supported(cfg: Config, spec: VariantSpec) -> None:
    if spec != VARIANTS[VARIATION.V4]:
        raise NotImplementedError(
            f"variant {spec}: the port trains V4 without the discriminator "
            "projection head only (V1, V2/BASE, V3 and the head are not ported yet)"
        )
    if cfg.DEFERRED_DECODER_UPDATE:
        raise NotImplementedError("DEFERRED_DECODER_UPDATE is not ported")
    check_unported(cfg)


class PCAAModules(nn.Module):
    """The generator side ``g`` (encoder, decoder head, decoder: one Adam)
    and the critic side ``d`` (discriminator: the other Adam). Keys match
    the JAX package's ``params_g`` / ``params_d`` trees."""

    def __init__(self, cfg: Config, spec: VariantSpec, generator: torch.Generator):
        super().__init__()
        n, latent = cfg.n_classes, cfg.SUP_LATENT_DIM
        self.g = nn.ModuleDict({
            "encoder": CGEncoder(
                n, in_features=cfg.NFEATURES, sup_latent_dim=latent,
                pointnet_out_dim=cfg.POINTNET_OUT_DIM, dtc_filters=tuple(cfg.DTC_FILTERS),
                use_projection_head=spec.use_enc_head, generator=generator,
            ),
            "dec_head": ProjectionHead(latent, 2 * latent, generator),
            "decoder": CGDecoder(2 * latent, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES, generator),
        })
        self.d = nn.ModuleDict({"discriminator": CGDiscriminator(latent, n, generator)})


@dataclasses.dataclass
class PCAAState:
    opt_g: AdamState
    opt_d: AdamState
    centroids: torch.Tensor  # (n_classes, latent) fixed prior means
    generator: torch.Generator  # the step's noise when none is injected


def build_pcaa(cfg: Config, spec: VariantSpec, *,
               device: Device = "cuda") -> Tuple[PCAAModules, PCAAState]:
    """Modules with torch's default init drawn from ``cfg.SEED``, zero Adam
    states and the fixed centroids, on ``device``."""
    _check_supported(cfg, spec)
    mods = PCAAModules(cfg, spec, torch.Generator().manual_seed(cfg.SEED)).to(device)
    # fixed prior centroids (reference utils.py:216-251, seed 42)
    centroids = sample_distant_points(
        cfg.SUP_LATENT_DIM, cfg.n_classes, min_dist=10, sphere_radius=10, seed=42
    )
    noise = torch.Generator(device=device).manual_seed(cfg.SEED + 1)
    state = PCAAState(
        opt_g=adam_init(mods.g.named_parameters()),
        opt_d=adam_init(mods.d.named_parameters()),
        centroids=torch.from_numpy(centroids).to(device),
        generator=noise,
    )
    return mods, state


def make_train_step(mods: PCAAModules, cfg: Config):
    """→ ``step(state, pcs, labels, step_idx, inject=None) → (state, metrics)``."""
    ieee_f32()
    n = cfg.n_classes
    latent = cfg.SUP_LATENT_DIM
    encoder = mods.g["encoder"]
    dec_head = mods.g["dec_head"]
    decoder = mods.g["decoder"]
    discriminator = mods.d["discriminator"]
    g_params = dict(mods.g.named_parameters())
    d_params = dict(mods.d.named_parameters())
    adam = dict(lr=cfg.LR, b1=cfg.B1, b2=cfg.B2)

    def step(state: PCAAState, pcs: torch.Tensor, labels: torch.Tensor, step_idx: int,
             inject: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        mods.train()
        batch = pcs.shape[0]
        oh = F.one_hot(labels.long(), n).float()

        # --- ONE train-mode encoder forward for the whole step -------------
        if cfg.FUSED_POINTNET:
            logits, fv = fused_train_encoder_apply(encoder, pcs)
        else:
            logits, fv = encoder(pcs)
        fv_detached = fv.detach()

        # prior sample, detached
        mus = oh @ state.centroids
        if inject is None:
            z0 = torch.randn((batch, latent), generator=state.generator, device=pcs.device)
            alphas = torch.rand((batch, 1), generator=state.generator, device=pcs.device)
        else:
            z0, alphas = inject
        z = (z0 + mus).detach()

        def critic(h):
            return discriminator(h, oh)[:, 0]

        # --- critic step ------------------------------------------------------
        real_logits = critic(z)
        fake_logits = critic(fv_detached)
        gp = gradient_penalty(critic, z, fv_detached, alphas)
        d_loss = torch.mean(fake_logits) - torch.mean(real_logits) + cfg.GP_WEIGHT * gp
        d_grads = torch.autograd.grad(d_loss, list(d_params.values()))
        adam_update_(state.opt_d, d_params, dict(zip(d_params, d_grads)), **adam)

        # --- generator step: critic with the updated D parameters -----------
        rec_loss = seq_chamfer(decoder(dec_head(fv)), pcs)
        adv_loss = -torch.mean(critic(fv)) * cfg.ADV_WEIGHT
        sup_loss = cross_entropy(logits, labels)
        tot_loss = rec_loss + adv_loss
        if step_idx % cfg.SUPERVISION_FREQUENCY == 0:
            tot_loss = tot_loss + sup_loss
        # the classifier head gets no gradient on unsupervised batches:
        # zeros, which Adam still steps with, as in the JAX package
        g_grads = torch.autograd.grad(
            tot_loss, list(g_params.values()), allow_unused=True, materialize_grads=True
        )
        g_grads = dict(zip(g_params, g_grads))
        if cfg.FUSED_ADAM:
            opt = state.opt_g
            opt.count = fused_adam_tree_update(g_grads, opt.count, opt.mu, opt.nu, g_params,
                                               **adam)
        else:
            adam_update_(state.opt_g, g_params, g_grads, **adam)

        metrics = {
            "rec_loss": rec_loss.detach(),
            "d_loss": d_loss.detach(),
            "sup_loss": sup_loss.detach(),
            "tot_loss": tot_loss.detach(),
            "n_correct": torch.sum(torch.argmax(logits, dim=1) == labels).float(),
        }
        return state, metrics

    return step


def _stack(metrics: list) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_epoch_fns(mods: PCAAModules, cfg: Config):
    """→ ``(train_epoch, valid_epoch)``: Python loops over the batches that
    a ``(steps, B)`` index matrix picks from device-resident splits."""
    train_step = make_train_step(mods, cfg)
    encoder = mods.g["encoder"]
    dec_head = mods.g["dec_head"]
    decoder = mods.g["decoder"]

    def train_epoch(state: PCAAState, x_all, y_all, perm, noise=None):
        """``noise`` (optional): ``(z0 (steps, B, latent), alphas (steps, B, 1))``
        replayed instead of fresh draws."""
        perm = torch.as_tensor(perm, device=x_all.device).long()
        out = []
        for i in range(perm.shape[0]):
            idx = perm[i]
            inject = None if noise is None else (noise[0][i], noise[1][i])
            state, m = train_step(state, x_all[idx], y_all[idx], i, inject)
            out.append(m)
        return state, _stack(out)

    @torch.no_grad()
    def valid_epoch(state: PCAAState, x_all, y_all, perm):
        perm = torch.as_tensor(perm, device=x_all.device).long()
        mods.eval()
        try:
            out = []
            for idx in perm:
                pcs, labels = x_all[idx], y_all[idx]
                logits, fv = encoder(pcs)
                out.append({
                    "rec_loss": seq_chamfer(decoder(dec_head(fv)), pcs),
                    "ce_loss": cross_entropy(logits, labels),
                    "n_correct": torch.sum(torch.argmax(logits, dim=1) == labels).float(),
                })
        finally:
            mods.train()
        return _stack(out)

    return train_epoch, valid_epoch


def _ckpt_payload(mods: PCAAModules) -> Dict[str, torch.Tensor]:
    """A copy, on the device, of every parameter and running statistic
    (no optimizer moments)."""
    return {k: v.detach().clone() for k, v in mods.state_dict().items()}


def _checkpoint(run_dir: str, name: str, payload: Dict[str, torch.Tensor]) -> None:
    """Write the reference's per-module files: E (with the running
    statistics), D, G and GPH."""
    variables = module_variables(payload)
    for module, tag in (("encoder", "E"), ("discriminator", "D"), ("decoder", "G"),
                        ("dec_head", "GPH")):
        save_params(variables[module], module_path(run_dir, name, tag))


def train_pcaa(
    cfg: Config,
    variation: VARIATION = VARIATION.V4,
    *,
    proj_head_on_discriminator: bool = False,
    wandb_mode: str = "disabled",
    datasets: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = None,
    verbose: bool = True,
    resume: bool = True,
    device: Device = "cuda",
) -> Dict[str, float]:
    """Train one PCAA run end to end; write the run folder the JAX package
    writes (``config.json``, ``metrics.jsonl``, ``discriminator_means.npy``,
    ``<NAME>_{E,D,G,GPH}.msgpack``, ``run_complete.json``) and return the
    final metrics, throughput included.

    :param datasets: optional ``(x_train, y_train, x_valid, y_valid)``;
        otherwise the splits are read from ``cfg.GEN_DATA_PATH``.
    :param device: the CUDA card unless the caller asks for the CPU.
    """
    ieee_f32()
    spec = VARIANTS[variation]
    if variation == VARIATION.V4 and proj_head_on_discriminator:
        spec = dataclasses.replace(spec, use_disc_head=True)
    _check_supported(cfg, spec)
    run_dir = cfg.run_dir()
    if resume and os.path.exists(os.path.join(run_dir, "train_state.msgpack")):
        raise NotImplementedError(
            f"{run_dir} holds a resume state, which the port cannot read yet"
        )
    device = torch.device(device)

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

    mods, state = build_pcaa(cfg, spec, device=device)
    save_array(state.centroids.cpu().numpy(), os.path.join(run_dir, "discriminator_means.npy"))

    train_epoch, valid_epoch = make_epoch_fns(mods, cfg)
    logger = MetricLogger(run_dir, cfg.to_dict(), mode=wandb_mode)
    host_rng = np.random.default_rng(cfg.SEED)

    n_train = x_train.shape[0]
    steps = n_train // cfg.BATCH_SIZE
    valid_steps = x_valid.shape[0] // cfg.BATCH_SIZE
    valid_perm = epoch_batch_indices(x_valid.shape[0], cfg.BATCH_SIZE, shuffle=False)
    best_valid_acc = 0.0
    best_payload = None
    out: Dict[str, float] = {}
    t_start = time.time()
    for epoch in range(cfg.EPOCHS):
        perm = epoch_batch_indices(n_train, cfg.BATCH_SIZE, shuffle=True, rng=host_rng)
        state, m = train_epoch(state, x_train, y_train, perm)
        vm = valid_epoch(state, x_valid, y_valid, valid_perm)
        m = {k: v.cpu().numpy() for k, v in m.items()}
        vm = {k: v.cpu().numpy() for k, v in vm.items()}

        train_acc = float(np.sum(m["n_correct"]) / (steps * cfg.BATCH_SIZE))
        valid_acc = float(np.sum(vm["n_correct"]) / (valid_steps * cfg.BATCH_SIZE))
        # CE and total means over the supervised batches only, as the reference logs them
        sup_mask = (np.arange(len(m["sup_loss"])) % cfg.SUPERVISION_FREQUENCY) == 0
        epoch_metrics = {
            "Reconstruction Loss Train": float(np.mean(m["rec_loss"])),
            "Reconstruction Loss Valid": float(np.mean(vm["rec_loss"])),
            "Cross Entropy Loss Train": float(np.mean(m["sup_loss"][sup_mask])),
            "Cross Entropy Loss Valid": float(np.mean(vm["ce_loss"])),
            "Discriminator Loss": float(np.mean(m["d_loss"])),
            "Total Loss Train": float(np.mean(m["tot_loss"][sup_mask])),
            "Train Accuracy": train_acc,
            "Valid Accuracy": valid_acc,
        }
        logger.log(epoch_metrics, step=epoch)
        if verbose:
            print(
                f"[{name}] epoch {epoch + 1}/{cfg.EPOCHS} "
                f"rec={epoch_metrics['Reconstruction Loss Train']:.4f} "
                f"d={epoch_metrics['Discriminator Loss']:.4f} "
                f"ce={epoch_metrics['Cross Entropy Loss Train']:.4f} "
                f"acc={train_acc:.3f} vacc={valid_acc:.3f}"
            )
        # best-by-valid-accuracy checkpoint every CHECKPOINT_FREQUENCY
        # epochs, epoch 0 included (reference PCAA_ablation.py:1087-1119)
        if epoch % cfg.CHECKPOINT_FREQUENCY == 0 and valid_acc > best_valid_acc:
            best_valid_acc = valid_acc
            best_payload = _ckpt_payload(mods)
        out = dict(epoch_metrics)

    elapsed = time.time() - t_start
    out["windows_per_sec"] = cfg.EPOCHS * steps * cfg.BATCH_SIZE / max(elapsed, 1e-9)
    out["best_valid_accuracy"] = best_valid_acc
    logger.finish()
    # the final state if no checkpoint epoch improved the valid accuracy
    _checkpoint(run_dir, name, best_payload if best_payload is not None else _ckpt_payload(mods))
    mark_run_completed(run_dir, out)
    return out
