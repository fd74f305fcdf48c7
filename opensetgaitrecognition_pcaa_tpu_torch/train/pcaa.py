"""PCAA adversarial training: one trainer for the ablation variants.

Port of ``opensetgaitrecognition_pcaa_tpu/train/pcaa.py:83-1007``: V1, V2,
BASE, V3 and V4, and V4 with the discriminator projection head
(``proj_head_on_discriminator``), each a ``VariantSpec`` of which pieces
exist. The JAX package scans a jitted step over an epoch; here a Python
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
- the prior sample ``z0 + mu`` is detached; ``mu`` is the class's fixed
  centroid, or for V1 the output of the frozen mean learner run in train
  mode on the batch's one-hots (its running statistics move, its
  parameters never); ``inject=(z0, alphas)`` replays given noise so that
  a port step and a JAX step can run on the same state, batch and noise;
- V3 has no decoder: its reconstruction loss is an f32 zero;
- the discriminator projection head (DPH) is applied to detached latents
  in the D step and its output detached again, and in the G step only the
  latents take gradients: the head never moves. Its leaves stay in D's
  Adam, stepping on zero gradients, as in the JAX package;
- a best-by-valid-accuracy checkpoint every ``CHECKPOINT_FREQUENCY``
  epochs, epoch 0 included, validated with the eval-mode encoder, decoder
  and ``seq_chamfer``; with ``SAVE_RESUME_STATE`` the full state
  (parameters, running statistics, both Adam states, the centroids, the
  noise generator, the host shuffle generator, the epoch and the best
  weights so far) is written at each such epoch, and a later call resumes
  from it (``train/run_folder.py``).

- ``COMPUTE_DTYPE="bfloat16"`` computes the encoder's backbone and the
  decoder in bf16 with the JAX package's casts (``models/layers.py``;
  the fused PointNet stores bf16 activations and its TCN stays f32,
  ``train/fused_encoder.py``) and stores Adam's first moments in bf16;
  ``BF16_ADAM_NU`` stores the second moments in bf16 too. The optimizer
  is JAX ``build_pcaa``'s: ``optax.adam(mu_dtype)`` without
  ``BF16_ADAM_NU`` or ``FUSED_ADAM``, ``adam_lowmem`` with either
  (``train/optim.py``).

- ``DP_DEVICES × MP_DEVICES > 1`` trains one run over that many ranks
  of ``torch.distributed`` (``parallel/mesh.py``; start them with its
  ``launch``), as JAX ``make_epoch_fns(mesh=...)`` and ``shard_state``
  do: each data rank takes its rows of every global batch, the noise is
  drawn at the global shape from the same generator on every rank and
  sliced, so that it equals the single-device draws; the gradients are
  of each rank's share of the global loss (``mesh_grads``) and the metrics
  are reduced to their global values; with ``MP_DEVICES > 1`` the wide kernels are sharded on
  their output axis after any resume restore. Rank 0 alone writes the run
  folder, from gathered full trees, so its files are a single-device
  run's.

- ``build_pcaa(..., encoder=P4TSpec())`` puts a P4Transformer encoder
  (``models/p4t.py``), and ``encoder=DGCNNSpec()`` a DGCNN encoder
  (``models/dgcnn.py``), in the PointNet encoder's place, under the same
  name and heads; the step calls it as it calls ``CGEncoder``, and
  ``FUSED_ADAM`` takes its 2-D leaves of at least 2^21 elements too. Either
  trains on one device at f32 compute without ``FUSED_POINTNET``
  (``_check_supported``), and writes no run folder: ``train_pcaa`` builds
  the PointNet encoder only, and ``convert.py`` and inference refuse any
  other (``models/pcaa.py::refuse_other_encoders``).

- ``FACTORED_ADAM_NU`` takes JAX ``adam_factored`` for both Adam states
  (``train/optim.py``: a rank-1 second moment on 2-D leaves of at least
  2^20 elements, mu in bf16 under bf16 compute, ``BF16_ADAM_NU`` not
  read), and refuses ``FUSED_ADAM`` as JAX does.
- ``DEFERRED_DECODER_UPDATE`` (JAX ``_deferred_decoder_write``): a step
  updates the decoder's moments but not its parameters; the pending write
  is applied from the stored moments at the top of the next step of the
  epoch, and once more after the epoch's last step (the flush), so that
  the state at each epoch's end, which validation, checkpoints and resume
  see, is the plain schedule's. At f32 moments the parameters are the
  plain schedule's bits; at bf16 moments the write reads the stored,
  rounded moments, as in JAX. It needs a decoder, and excludes
  ``FUSED_ADAM`` and ``FACTORED_ADAM_NU``, as in JAX.
- ``BF16_WEIGHT_CACHE`` (bf16 compute only; JAX ``cast_g``): bf16 copies
  of the decoder's 2-D weights (not its biases, not the decoder head),
  which the decoder's bf16 layers read instead of rounding the f32
  masters (``models/layers.py``), so that the G loss's gradients land on
  the copies, in bf16, and are upcast; the copies are refreshed by the G
  Adam write (``FUSED_ADAM``: by the kernel, ``ops/adam.py``) or by the
  deferred write, and rebuilt from the masters after a resume restore and
  after sharding. Cache on and off give the same bits.

Modules, parameters, running statistics and Adam moments are updated in
place.
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
from opensetgaitrecognition_pcaa_tpu_torch.models.layers import TorchDense
from opensetgaitrecognition_pcaa_tpu_torch.models.dgcnn import DGCNNEncoder, DGCNNSpec
from opensetgaitrecognition_pcaa_tpu_torch.models.mean_learner import GaussianMeanLearner
from opensetgaitrecognition_pcaa_tpu_torch.models.p4t import P4TEncoder, P4TSpec
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
from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    create_mesh,
    gather_state,
    global_shapes,
    module_specs,
    reduce_grads,
    shard_modules,
    sub_specs,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.fused_encoder import fused_train_encoder_apply
from opensetgaitrecognition_pcaa_tpu_torch.train.metrics import MetricLogger
from opensetgaitrecognition_pcaa_tpu_torch.train.optim import (
    FACTORED_MIN_ELEMS,
    AdamState,
    adam_init,
    adam_state_tree,
    adam_update_,
    adam_write_,
    load_adam_state_tree,
    load_tensors_,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import (
    load_best_payload,
    load_train_state,
    mark_run_completed,
    module_path,
    save_array,
    save_best_payload,
    save_params,
    save_train_state,
)
from opensetgaitrecognition_pcaa_tpu_torch.utils.profiling import count, span

Device = Union[str, torch.device]
# an encoder in the PointNet encoder's place (None: the PointNet encoder)
EncoderSpec = Optional[Union[P4TSpec, DGCNNSpec]]


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


def check_weight_cache(cfg: Config) -> None:
    """``ValueError`` with JAX's words where ``BF16_WEIGHT_CACHE`` meets
    f32 compute."""
    if cfg.BF16_WEIGHT_CACHE and cfg.COMPUTE_DTYPE != "bfloat16":
        raise ValueError("BF16_WEIGHT_CACHE is a bf16-compute traffic optimization; under f32 "
                         "compute it would CHANGE numerics, not just traffic")


def weight_cache(modules: nn.Module) -> Dict[str, torch.Tensor]:
    """``BF16_WEIGHT_CACHE``: a bf16 copy of the weight of each dense layer
    of the ``decoder`` in ``modules`` (its 2-D weights; biases stay f32
    masters), set as the layer's ``weight_bf16`` so that the layer reads it
    (``models/layers.py``), taking gradients → the copies by parameter name
    in ``modules``. Called again after the weights were restored or
    sharded, it makes the copies anew from them."""
    cache = {}
    for name, layer in modules.named_modules():
        if isinstance(layer, TorchDense) and name.startswith("decoder."):
            layer.weight_bf16 = layer.weight.detach().to(torch.bfloat16).requires_grad_()
            cache[name + ".weight"] = layer.weight_bf16
    return cache


@torch.no_grad()
def refresh_cache_(cache: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]) -> None:
    """Round each parameter that ``cache`` copies into its copy, in place."""
    for name, w16 in cache.items():
        w16.copy_(params[name])


def model_row_sum(specs: Optional[Dict], mesh: Optional[Mesh]):
    """``adam_update_``'s ``row_sum`` for a run on ``mesh``: the partial
    sums over the output axis of a factored leaf that the model group
    shards, summed over that group; None without a mesh."""
    if mesh is None:
        return None
    return lambda name, rows: rows if specs.get(name) is None else mesh.sum_model(rows)


def run_mesh(cfg: Config) -> Optional[Mesh]:
    """The mesh of ``DP_DEVICES × MP_DEVICES`` ranks where that is above
    one (JAX ``train_pcaa``/``train_orced``), else None."""
    if cfg.DP_DEVICES * cfg.MP_DEVICES == 1:
        return None
    if cfg.BATCH_SIZE % cfg.DP_DEVICES:
        raise ValueError(f"BATCH_SIZE {cfg.BATCH_SIZE} does not split over DP_DEVICES "
                         f"{cfg.DP_DEVICES}")
    return create_mesh(cfg.DP_DEVICES * cfg.MP_DEVICES, model_parallel=cfg.MP_DEVICES)


def global_metrics(metrics: Dict[str, torch.Tensor],
                   mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """A step's metrics on this data rank's rows, a loss (a mean over its
    rows, or a value of the global batch) or a count (``n_...``) → their
    global values: the losses averaged over the data group, the counts
    summed. The ranks of a model group hold the same ones."""
    if mesh is None:
        return metrics
    keys = list(metrics)
    total = mesh.sum_data(torch.stack([metrics[k].detach().float() for k in keys]))
    return {k: v if k.startswith("n_") else v / mesh.dp for k, v in zip(keys, total)}


def gather_opts(opts: Dict[str, Tuple[AdamState, str]], specs: Dict, mesh: Mesh
                ) -> Dict[str, AdamState]:
    """Each ``(Adam state, key prefix of its parameters)`` with its moments
    gathered whole (``gather_state``; every rank calls it)."""
    return {name: dataclasses.replace(
        opt, mu=gather_state(opt.mu, sub_specs(specs, prefix), mesh),
        nu=gather_state(opt.nu, sub_specs(specs, prefix), mesh))
        for name, (opt, prefix) in opts.items()}


def compute_dtype(cfg: Config) -> torch.dtype:
    """bf16 where ``COMPUTE_DTYPE`` is "bfloat16", else f32, as the JAX
    package reads it."""
    return torch.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16" else torch.float32


def adam_dtypes(cfg: Config) -> Dict:
    """``adam_init``'s storage options for both trainers, as JAX
    ``build_pcaa``/``build_orced`` choose them: mu bf16 under bf16 compute,
    nu bf16 with ``BF16_ADAM_NU``, and ``optax.adam``'s b1 rounding where
    the JAX package takes ``optax.adam`` (neither ``BF16_ADAM_NU`` nor
    ``FUSED_ADAM``); with ``FACTORED_ADAM_NU``, ``adam_factored``'s state
    (mu bf16 under bf16 compute, nu f32 or factored)."""
    if cfg.FACTORED_ADAM_NU:
        return dict(mu_dtype=compute_dtype(cfg), factored_min_elems=FACTORED_MIN_ELEMS)
    return dict(mu_dtype=compute_dtype(cfg),
                nu_dtype=torch.bfloat16 if cfg.BF16_ADAM_NU else torch.float32,
                optax_mu=not (cfg.BF16_ADAM_NU or cfg.FUSED_ADAM))


def _check_supported(cfg: Config, spec: VariantSpec, encoder: EncoderSpec = None) -> None:
    """JAX ``build_pcaa``'s refusals, with its words, and what a
    P4Transformer or DGCNN ``encoder`` does not carry."""
    if encoder is not None:
        title = encoder.title
        if cfg.FUSED_POINTNET:
            raise ValueError(f"FUSED_POINTNET fuses the PointNet encoder's layers; a {title} "
                             f"encoder has none")
        if cfg.COMPUTE_DTYPE == "bfloat16":
            raise ValueError(f"the {title} encoder trains at f32 compute: its bf16 casts are not "
                             f"written")
        if cfg.DP_DEVICES * cfg.MP_DEVICES > 1:
            raise ValueError(f"the {title} encoder trains on one device: the mesh's sharding "
                             f"covers the PointNet encoder's layers only")
        if isinstance(encoder, P4TSpec):
            if cfg.NFEATURES != 4:
                raise ValueError(f"the P4Transformer encoder takes (x, y, z, Doppler) points, "
                                 f"NFEATURES 4, got {cfg.NFEATURES}")
            encoder.frames(cfg.NSTEPS)
            encoder.anchors(cfg.NMAX)
        else:
            encoder.check(cfg.NMAX)
    if spec.use_disc_head and spec.name != "V4":
        raise ValueError(f"variant {spec.name}: the discriminator projection head is V4-only")
    if cfg.FACTORED_ADAM_NU and cfg.FUSED_ADAM:
        raise ValueError("FACTORED_ADAM_NU and FUSED_ADAM are exclusive")
    if cfg.DEFERRED_DECODER_UPDATE:
        if not spec.use_decoder:
            raise ValueError("DEFERRED_DECODER_UPDATE targets the decoder")
        if cfg.FUSED_ADAM or cfg.FACTORED_ADAM_NU:
            raise ValueError(
                "DEFERRED_DECODER_UPDATE recomputes the write from the stored (count, mu, nu) "
                "moments — the fused kernel writes params inside its own pass and the factored "
                "state has no per-element nu to recompute from")
    check_weight_cache(cfg)
    if cfg.BF16_WEIGHT_CACHE and not spec.use_decoder:
        raise ValueError("BF16_WEIGHT_CACHE targets the decoder")


class PCAAModules(nn.Module):
    """The generator side ``g`` (one Adam): the encoder, and the decoder
    head and decoder where the variant has them; the critic side ``d``
    (the other Adam): the discriminator, and the discriminator projection
    head (DPH) for V4 with ``proj_head_on_discriminator``; and ``ml``, V1's
    frozen mean learner (no Adam; JAX ``ml_params`` and
    ``batch_stats["mean_learner"]``), empty for the other variants. Keys
    match the JAX package's ``params_g`` / ``params_d`` trees. ``encoder``
    (a ``P4TSpec`` or a ``DGCNNSpec``) builds a P4Transformer or DGCNN
    encoder in the PointNet encoder's place (``models/p4t.py``,
    ``models/dgcnn.py``)."""

    def __init__(self, cfg: Config, spec: VariantSpec, generator: torch.Generator,
                 encoder: EncoderSpec = None):
        super().__init__()
        n, latent = cfg.n_classes, cfg.SUP_LATENT_DIM
        dtype = compute_dtype(cfg)  # the encoder and the decoder only, as in JAX
        if encoder is None:
            enc = CGEncoder(
                n, in_features=cfg.NFEATURES, sup_latent_dim=latent,
                pointnet_out_dim=cfg.POINTNET_OUT_DIM, dtc_filters=tuple(cfg.DTC_FILTERS),
                use_projection_head=spec.use_enc_head, generator=generator,
                compute_dtype=dtype,
            )
        elif isinstance(encoder, P4TSpec):
            enc = P4TEncoder(n, encoder, sup_latent_dim=latent,
                             use_projection_head=spec.use_enc_head, generator=generator)
        else:
            enc = DGCNNEncoder(n, encoder, in_features=cfg.NFEATURES, sup_latent_dim=latent,
                               dtc_filters=tuple(cfg.DTC_FILTERS),
                               use_projection_head=spec.use_enc_head, generator=generator)
        g = {"encoder": enc}
        if spec.use_dec_head:
            g["dec_head"] = ProjectionHead(latent, 2 * latent, generator)
        if spec.use_decoder:
            dec_in = 2 * latent if spec.use_dec_head else latent
            g["decoder"] = CGDecoder(dec_in, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES, generator,
                                     compute_dtype=dtype)
        self.g = nn.ModuleDict(g)
        d = {"discriminator": CGDiscriminator(latent, n, generator)}
        if spec.use_disc_head:
            # latent -> latent, as the JAX package builds it: the reference
            # declares Linear(2·latent, latent) but feeds it the latent
            d["disc_head"] = ProjectionHead(latent, latent, generator)
        self.d = nn.ModuleDict(d)
        self.ml = nn.ModuleDict(
            {"mean_learner": GaussianMeanLearner(n, latent, generator)}
            if spec.learned_centroids else {}
        )
        self.spec = spec


@dataclasses.dataclass
class PCAAState:
    opt_g: AdamState
    opt_d: AdamState
    centroids: torch.Tensor  # (n_classes, latent) fixed prior means; V1 ignores them
    generator: torch.Generator  # the step's noise when none is injected
    # BF16_WEIGHT_CACHE: the decoder's bf16 weight copies by name in mods.g
    # (weight_cache); empty when the option is off
    cast_g: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def build_pcaa(cfg: Config, spec: VariantSpec, *, device: Device = "cuda",
               encoder: EncoderSpec = None) -> Tuple[PCAAModules, PCAAState]:
    """Modules with torch's default init drawn from ``cfg.SEED``, zero Adam
    states, the fixed centroids and, with ``BF16_WEIGHT_CACHE``, the
    decoder's weight copies, on ``device``; with ``encoder`` (a ``P4TSpec``
    or a ``DGCNNSpec``), a P4Transformer or DGCNN encoder in the PointNet
    encoder's place."""
    _check_supported(cfg, spec, encoder)
    mods = PCAAModules(cfg, spec, torch.Generator().manual_seed(cfg.SEED), encoder).to(device)
    # fixed prior centroids (reference utils.py:216-251, seed 42)
    centroids = sample_distant_points(
        cfg.SUP_LATENT_DIM, cfg.n_classes, min_dist=10, sphere_radius=10, seed=42
    )
    noise = torch.Generator(device=device).manual_seed(cfg.SEED + 1)
    state = PCAAState(
        opt_g=adam_init(mods.g.named_parameters(), **adam_dtypes(cfg)),
        opt_d=adam_init(mods.d.named_parameters(), **adam_dtypes(cfg)),
        centroids=torch.from_numpy(centroids).to(device),
        generator=noise,
        cast_g=weight_cache(mods.g) if cfg.BF16_WEIGHT_CACHE else {},
    )
    return mods, state


def _rec_loss(mods: PCAAModules, fv: torch.Tensor, pcs: torch.Tensor) -> torch.Tensor:
    """Chamfer loss of the decoder's reconstruction of ``pcs`` from the
    latents; an f32 zero for a variant without a decoder (V3)."""
    if "decoder" not in mods.g:
        return fv.new_zeros(())
    h = mods.g["dec_head"](fv) if "dec_head" in mods.g else fv
    return seq_chamfer(mods.g["decoder"](h), pcs)


def _draw(generator: torch.Generator, shape: Tuple[int, ...], device, mesh: Optional[Mesh],
          draw=torch.randn) -> torch.Tensor:
    """Noise of ``shape`` (rows first) for this rank's rows: drawn at the
    global batch's shape and sliced, so that every rank draws what one
    device would."""
    if mesh is None:
        return draw(shape, generator=generator, device=device)
    full = draw((shape[0] * mesh.dp,) + tuple(shape[1:]), generator=generator, device=device)
    return full[batch_sharding(mesh, full.shape[0])]


def mesh_grads(loss: torch.Tensor, params: Dict[str, torch.Tensor], specs,
               mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The gradients of a rank's ``loss`` w.r.t. ``params`` by name, zeros
    where it does not reach. With a mesh, ``loss`` is the rank's estimate
    of the global loss (its rows' means, values of the global batch), and
    the gradients are of its share, 1/(DP × MP) of it: the shares of the
    ranks sum to the global loss (``parallel/mesh.py``). They are then
    summed over the ranks that hold each leaf (``reduce_grads`` with
    ``specs``). The gradient of a bf16 leaf (a ``weight_cache`` copy) is
    upcast to f32 first: its master's gradient."""
    if mesh is not None:
        loss = loss / (mesh.dp * mesh.mp)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    grads = {k: g.float() for k, g in zip(params, grads)}
    if mesh is not None:
        reduce_grads(grads, specs, mesh)
    return grads


def decoder_params(mods: PCAAModules) -> Dict[str, torch.Tensor]:
    """The decoder's parameters by name in ``mods.g``."""
    return {k: p for k, p in mods.g.named_parameters() if k.startswith("decoder.")}


def deferred_write_(cfg: Config, dec_params: Dict[str, torch.Tensor], state: PCAAState) -> None:
    """``DEFERRED_DECODER_UPDATE``: apply the pending decoder write from
    the stored moments (``train/optim.py::adam_write_``) and refresh the
    weight cache from it."""
    adam_write_(state.opt_g, dec_params, lr=cfg.LR, b1=cfg.B1, b2=cfg.B2)
    refresh_cache_(state.cast_g, dec_params)


def make_train_step(mods: PCAAModules, cfg: Config, mesh: Optional[Mesh] = None):
    """→ ``step(state, pcs, labels, step_idx, inject=None) → (state, metrics)``.

    With ``mesh`` (the modules placed by ``parallel/mesh.py::
    shard_modules``), ``pcs``, ``labels`` and an ``inject`` hold this data
    rank's rows of the global batch, the gradients are of the rank's share
    of the loss (``mesh_grads``), summed over the ranks that hold each leaf,
    and the metrics are global. With ``DEFERRED_DECODER_UPDATE`` a step
    whose ``step_idx`` is above 0 first applies the previous step's decoder
    write; the epoch's caller flushes the last one (``deferred_write_``)."""
    ieee_f32()
    spec = mods.spec
    n = cfg.n_classes
    latent = cfg.SUP_LATENT_DIM
    encoder = mods.g["encoder"]
    discriminator = mods.d["discriminator"]
    disc_head = mods.d["disc_head"] if spec.use_disc_head else None
    mean_learner = mods.ml["mean_learner"] if spec.learned_centroids else None
    g_params = dict(mods.g.named_parameters())
    d_params = dict(mods.d.named_parameters())
    dec_params = decoder_params(mods)
    deferred = cfg.DEFERRED_DECODER_UPDATE
    adam = dict(lr=cfg.LR, b1=cfg.B1, b2=cfg.B2)
    store_dtype = compute_dtype(cfg)
    g_specs = d_specs = g_shapes = None
    if mesh is not None:
        specs = module_specs(mods)
        g_specs, d_specs = sub_specs(specs, "g."), sub_specs(specs, "d.")
        g_shapes = global_shapes(g_params, g_specs, mesh)
    g_row_sum, d_row_sum = model_row_sum(g_specs, mesh), model_row_sum(d_specs, mesh)

    def step(state: PCAAState, pcs: torch.Tensor, labels: torch.Tensor, step_idx: int,
             inject: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        mods.train()
        batch = pcs.shape[0]
        oh = F.one_hot(labels.long(), n).float()
        if deferred and step_idx > 0:
            # the previous step's decoder write; the epoch's first step has
            # none pending (the flush after the last epoch's last step)
            with span("train.deferred_write"):
                deferred_write_(cfg, dec_params, state)

        # --- ONE train-mode encoder forward for the whole step -------------
        with span("train.encoder"):
            if cfg.FUSED_POINTNET:
                logits, fv = fused_train_encoder_apply(encoder, pcs, store_dtype, mesh)
            else:
                logits, fv = encoder(pcs)
        fv_detached = fv.detach()

        def critic(h):
            return discriminator(h, oh)[:, 0]

        # --- critic step ------------------------------------------------------
        with span("train.critic"):
            # prior sample, detached
            if mean_learner is not None:
                with torch.no_grad():  # train-mode BatchNorm: its running statistics move
                    mus = mean_learner(oh)
            else:
                mus = oh @ state.centroids
            if inject is None:
                z0 = _draw(state.generator, (batch, latent), pcs.device, mesh)
                alphas = _draw(state.generator, (batch, 1), pcs.device, mesh, torch.rand)
            else:
                z0, alphas = inject
            z = (z0 + mus).detach()
            fake = fv_detached
            if disc_head is not None:
                with torch.no_grad():
                    fake = disc_head(fv_detached)
            real_logits = critic(z)
            fake_logits = critic(fake)
            gp = gradient_penalty(critic, z, fake, alphas, mesh)
            d_loss = torch.mean(fake_logits) - torch.mean(real_logits) + cfg.GP_WEIGHT * gp
            # the DPH gets no gradient (every path into it is detached): zeros,
            # which Adam steps with, so it stays at its init, as in the JAX package
            d_grads = mesh_grads(d_loss, d_params, d_specs, mesh)
        with span("train.critic_adam"):
            adam_update_(state.opt_d, d_params, d_grads, **adam, row_sum=d_row_sum)

        # --- generator step: critic with the updated D parameters -----------
        with span("train.losses"):
            rec_loss = _rec_loss(mods, fv, pcs)
            adv_loss = (-torch.mean(critic(fv if disc_head is None else disc_head(fv)))
                        * cfg.ADV_WEIGHT)
            sup_loss = cross_entropy(logits, labels)
            tot_loss = rec_loss + adv_loss
            if step_idx % cfg.SUPERVISION_FREQUENCY == 0:
                tot_loss = tot_loss + sup_loss
        # the classifier head gets no gradient on unsupervised batches:
        # zeros, which Adam still steps with, as in the JAX package; a cached
        # decoder weight takes its gradient through its bf16 copy
        with span("train.backward"):
            targets = {k: state.cast_g.get(k, p) for k, p in g_params.items()}
            g_grads = mesh_grads(tot_loss, targets, g_specs, mesh)
        with span("train.adam"):
            if cfg.FUSED_ADAM:
                opt = state.opt_g
                opt.count = fused_adam_tree_update(g_grads, opt.count, opt.mu, opt.nu, g_params,
                                                   global_shapes=g_shapes, cache=state.cast_g,
                                                   **adam)
            else:
                adam_update_(state.opt_g, g_params, g_grads, **adam, row_sum=g_row_sum,
                             skip_write=dec_params if deferred else ())
                if not deferred:  # deferred: the copies follow the write
                    refresh_cache_(state.cast_g, g_params)

        with span("train.metrics"):
            metrics = global_metrics({
                "rec_loss": rec_loss.detach(),
                "d_loss": d_loss.detach(),
                "sup_loss": sup_loss.detach(),
                "tot_loss": tot_loss.detach(),
                "n_correct": torch.sum(torch.argmax(logits, dim=1) == labels).float(),
            }, mesh)
        return state, metrics

    return step


def _stack(metrics: list) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def rows_of(perm: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A ``(steps, B)`` index matrix cut to this data rank's rows of each
    batch (JAX ``with_sharding_constraint(..., P("data"))``)."""
    return perm if mesh is None else perm[:, batch_sharding(mesh, perm.shape[1])]


def make_epoch_fns(mods: PCAAModules, cfg: Config, mesh: Optional[Mesh] = None):
    """→ ``(train_epoch, valid_epoch)``: Python loops over the batches that
    a ``(steps, B)`` index matrix picks from device-resident splits. With
    ``mesh`` each rank takes its rows of every batch (and of replayed
    noise) and the metrics are global (``make_train_step``). With
    ``DEFERRED_DECODER_UPDATE`` an epoch ends with the flush of the last
    pending decoder write."""
    train_step = make_train_step(mods, cfg, mesh)
    encoder = mods.g["encoder"]
    dec_params = decoder_params(mods)

    def train_epoch(state: PCAAState, x_all, y_all, perm, noise=None):
        """``noise`` (optional): ``(z0 (steps, B, latent), alphas (steps, B, 1))``
        replayed instead of fresh draws."""
        with span("train.epoch"):
            with span("train.epoch_setup"):
                perm = rows_of(torch.as_tensor(perm, device=x_all.device).long(), mesh)
                if noise is not None:
                    noise = tuple(rows_of(torch.as_tensor(a), mesh) for a in noise)
            out = []
            for i in range(perm.shape[0]):
                with span("train.step"):
                    count("train.steps")
                    with span("train.gather"):
                        idx = perm[i]
                        pcs, labels = x_all[idx], y_all[idx]
                    inject = None if noise is None else (noise[0][i], noise[1][i])
                    state, m = train_step(state, pcs, labels, i, inject)
                out.append(m)
            if cfg.DEFERRED_DECODER_UPDATE:
                with span("train.deferred_flush"):
                    deferred_write_(cfg, dec_params, state)
            with span("train.epoch_stack"):
                stacked = _stack(out)
        return state, stacked

    @torch.no_grad()
    def valid_epoch(state: PCAAState, x_all, y_all, perm):
        perm = rows_of(torch.as_tensor(perm, device=x_all.device).long(), mesh)
        mods.eval()
        try:
            out = []
            for idx in perm:
                pcs, labels = x_all[idx], y_all[idx]
                logits, fv = encoder(pcs)
                out.append(global_metrics({
                    "rec_loss": _rec_loss(mods, fv, pcs),
                    "ce_loss": cross_entropy(logits, labels),
                    "n_correct": torch.sum(torch.argmax(logits, dim=1) == labels).float(),
                }, mesh))
        finally:
            mods.train()
        return _stack(out)

    return train_epoch, valid_epoch


def _ckpt_payload(mods: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy, on the device, of every parameter and running statistic
    (no optimizer moments)."""
    return {k: v.detach().clone() for k, v in mods.state_dict().items()}


def resume_tree(mods: Union[nn.Module, Dict[str, torch.Tensor]], opts: Dict[str, AdamState],
                generator: torch.Generator, **tensors: torch.Tensor) -> Dict:
    """The resume file's tree of a trainer: ``modules`` (the state_dict, or
    ``mods`` where it is one already: a sharded run's gathered state),
    each Adam state of ``opts`` under its name, the noise ``generator``'s
    state and the named ``tensors``, all numpy on the host."""
    state_dict = mods.state_dict() if isinstance(mods, nn.Module) else mods
    tree = {"modules": {k: v.detach().cpu().numpy() for k, v in state_dict.items()},
            "generator": generator.get_state().numpy()}
    tree.update({name: adam_state_tree(opt) for name, opt in opts.items()})
    tree.update({name: t.detach().cpu().numpy() for name, t in tensors.items()})
    return tree


def restore_resume_tree(tree: Dict, mods: nn.Module, opts: Dict[str, AdamState],
                        generator: torch.Generator, **tensors: torch.Tensor) -> None:
    """Load a ``resume_tree`` in place into the modules, Adam states,
    generator and tensors it was taken from."""
    load_tensors_(mods.state_dict(), tree["modules"], "modules")
    for name, opt in opts.items():
        load_adam_state_tree(opt, tree[name])
    load_tensors_(tensors, {k: tree[k] for k in tensors}, "state")
    generator.set_state(torch.from_numpy(np.array(tree["generator"])))


def _payload_from_arrays(arrays: Dict[str, np.ndarray], mods: nn.Module) -> Dict[str, torch.Tensor]:
    """A saved best payload as a ``_ckpt_payload`` of ``mods``."""
    payload = _ckpt_payload(mods)
    load_tensors_(payload, arrays, "best payload")
    return payload


def learned_means(mods: PCAAModules, payload: Dict[str, torch.Tensor]) -> np.ndarray:
    """V1's "learned" centroids: the mean learner with the payload's
    weights and running statistics, in train mode on the identity one-hots,
    under no grad (reference ``PCAA_ablation.py:369-376``). Train-mode
    BatchNorm moves the running statistics; the JAX package throws that
    update away (``mutable=["batch_stats"]``), and so does the port, by
    running a module of its own, whole and on this rank alone: neither
    ``mods`` nor ``payload`` moves."""
    prefix = "ml.mean_learner."
    weights = {k[len(prefix):]: v for k, v in payload.items() if k.startswith(prefix)}
    n, latent = weights["dense.0.weight"].shape[1], weights["dense.3.weight"].shape[0]
    device = weights["dense.0.weight"].device
    ml = GaussianMeanLearner(n, latent, torch.Generator().manual_seed(0)).to(device).train()
    ml.load_state_dict(weights)
    with torch.no_grad():
        return ml(torch.eye(n, device=device)).cpu().numpy()


def place_state(mods: nn.Module, opts: Dict[str, Tuple[AdamState, str]], mesh: Optional[Mesh],
                min_dim: int) -> Optional[Dict[str, Optional[int]]]:
    """Put a run's full modules and the moments of its Adam states (each
    with the key prefix of its parameters in ``mods``) on ``mesh``
    (``shard_modules``) → the specs of the modules' state_dict; None and
    nothing moved without a mesh."""
    if mesh is None:
        return None
    moments = [(m, prefix) for opt, prefix in opts.values() for m in (opt.mu, opt.nu)]
    return shard_modules(mods, moments, mesh, min_dim=min_dim)


def full_payload(mods: nn.Module, mesh: Optional[Mesh], specs) -> Dict[str, torch.Tensor]:
    """``_ckpt_payload`` of the whole modules: gathered over the model group
    where the run is sharded (every rank calls it)."""
    payload = _ckpt_payload(mods)
    return payload if mesh is None else gather_state(payload, specs, mesh)


def full_resume_tree(mods: nn.Module, opts: Dict[str, Tuple[AdamState, str]],
                     generator: torch.Generator, mesh: Optional[Mesh], specs,
                     **tensors: torch.Tensor) -> Dict:
    """``resume_tree`` of the whole state, a single-device run's (every rank
    calls it)."""
    if mesh is None:
        return resume_tree(mods, {k: opt for k, (opt, _) in opts.items()}, generator, **tensors)
    return resume_tree(full_payload(mods, mesh, specs), gather_opts(opts, specs, mesh), generator,
                       **tensors)


# (module key in the payload's module_variables, file tag), in the JAX order
_MODULE_FILES = (("encoder", "E"), ("discriminator", "D"), ("decoder", "G"), ("dec_head", "GPH"),
                 ("disc_head", "DPH"), ("mean_learner", "ML"))


def _checkpoint(run_dir: str, name: str, mods: PCAAModules,
                payload: Dict[str, torch.Tensor]) -> None:
    """Write the reference's per-module files of the variant: E (with the
    running statistics) and D always, G where there is a decoder, GPH and
    DPH where there are those heads, and for V1 ML (with its running
    statistics) and the learned ``discriminator_means.npy``."""
    variables = module_variables(payload)
    for module, tag in _MODULE_FILES:
        if module in variables:
            save_params(variables[module], module_path(run_dir, name, tag))
    if mods.spec.learned_centroids:
        save_array(learned_means(mods, payload), os.path.join(run_dir, "discriminator_means.npy"))


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
    the variant's ``<NAME>_<TAG>.msgpack`` files, ``run_complete.json``) and
    return the final metrics, throughput included.

    :param proj_head_on_discriminator: V4 with the discriminator projection
        head (ignored for the other variants, as in the JAX package).
    :param datasets: optional ``(x_train, y_train, x_valid, y_valid)``;
        otherwise the splits are read from ``cfg.GEN_DATA_PATH``.
    :param resume: continue from the run folder's ``train_state.msgpack``
        if the port wrote one (``ValueError`` if another program did).
    :param device: the CUDA card unless the caller asks for the CPU.

    It trains the PointNet encoder only: a P4Transformer or DGCNN encoder
    has no JAX tree to write, and trains through ``build_pcaa(...,
    encoder=P4TSpec())`` or ``encoder=DGCNNSpec()`` and ``make_epoch_fns``.

    With ``DP_DEVICES × MP_DEVICES > 1`` every rank of an initialised
    ``torch.distributed`` world of that size calls it (``parallel/mesh.py::
    launch``); ``BATCH_SIZE`` must split over ``DP_DEVICES``. Rank 0 writes
    the run folder; every rank returns the same metrics.
    """
    ieee_f32()
    spec = VARIANTS[variation]
    if variation == VARIATION.V4 and proj_head_on_discriminator:
        spec = dataclasses.replace(spec, use_disc_head=True)
    _check_supported(cfg, spec)
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

    mods, state = build_pcaa(cfg, spec, device=device)
    if lead and not spec.learned_centroids:
        save_array(state.centroids.cpu().numpy(), os.path.join(run_dir, "discriminator_means.npy"))

    logger = MetricLogger(run_dir, cfg.to_dict(), mode=wandb_mode) if lead else None
    host_rng = np.random.default_rng(cfg.SEED)
    # each Adam state with the key prefix of its parameters in mods
    opts = {"opt_g": (state.opt_g, "g."), "opt_d": (state.opt_d, "d.")}

    best_valid_acc = 0.0
    best_payload = None
    start_epoch = 0
    if restored is not None:
        tree, start_epoch, meta = restored
        restore_resume_tree(tree, mods, {k: opt for k, (opt, _) in opts.items()},
                            state.generator, centroids=state.centroids)
        del restored, tree  # the host copy: 2.6 GB at the published widths
        host_rng.bit_generator.state = meta["host_rng_state"]
        best_valid_acc = meta.get("best_valid_acc", 0.0)
        # the best weights so far, so that the run's end writes them even
        # when no resumed epoch beats the restored best accuracy
        best = load_best_payload(ckpt_path)
        if best is not None:
            best_payload = _payload_from_arrays(best, mods)
        if verbose and lead:
            print(f"[{name}] resuming from epoch {start_epoch}")
    # JAX shards after the restore too (train/pcaa.py:904-911)
    specs = place_state(mods, opts, mesh, cfg.MP_MIN_DIM)
    if cfg.BF16_WEIGHT_CACHE:  # the copies of the restored, placed masters
        state.cast_g = weight_cache(mods.g)
    train_epoch, valid_epoch = make_epoch_fns(mods, cfg, mesh)

    n_train = x_train.shape[0]
    steps = n_train // cfg.BATCH_SIZE
    valid_steps = x_valid.shape[0] // cfg.BATCH_SIZE
    valid_perm = epoch_batch_indices(x_valid.shape[0], cfg.BATCH_SIZE, shuffle=False)
    out: Dict[str, float] = {}
    t_start = time.time()
    total_windows = 0
    for epoch in range(start_epoch, cfg.EPOCHS):
        perm = epoch_batch_indices(n_train, cfg.BATCH_SIZE, shuffle=True, rng=host_rng)
        state, m = train_epoch(state, x_train, y_train, perm)
        vm = valid_epoch(state, x_valid, y_valid, valid_perm)
        m = {k: v.cpu().numpy() for k, v in m.items()}
        vm = {k: v.cpu().numpy() for k, v in vm.items()}
        total_windows += steps * cfg.BATCH_SIZE

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
        if lead:
            logger.log(epoch_metrics, step=epoch)
        if verbose and lead:
            print(
                f"[{name}] epoch {epoch + 1}/{cfg.EPOCHS} "
                f"rec={epoch_metrics['Reconstruction Loss Train']:.4f} "
                f"d={epoch_metrics['Discriminator Loss']:.4f} "
                f"ce={epoch_metrics['Cross Entropy Loss Train']:.4f} "
                f"acc={train_acc:.3f} vacc={valid_acc:.3f}"
            )
        # best-by-valid-accuracy checkpoint every CHECKPOINT_FREQUENCY
        # epochs, epoch 0 included (reference PCAA_ablation.py:1087-1119)
        if epoch % cfg.CHECKPOINT_FREQUENCY == 0:
            improved = valid_acc > best_valid_acc
            if improved:
                best_valid_acc = valid_acc
                best_payload = full_payload(mods, mesh, specs)
            if cfg.SAVE_RESUME_STATE:
                tree = full_resume_tree(mods, opts, state.generator, mesh, specs,
                                        centroids=state.centroids)
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
        _checkpoint(run_dir, name, mods, final)
        mark_run_completed(run_dir, out)
    return out
