"""OR-CED open-set inference: the ensemble OOD decision.

Port of ``opensetgaitrecognition_pcaa_tpu/infer/orced.py:58-474``:

1. a train-split pass collects per-crop latents, per-crop Chamfer
   reconstruction errors and argmax predictions, over whole batches only
   (``drop_last``: the first ``(n // batch_size) * batch_size`` crops);
2. per class k: mean and std of the rec errors of all class-k crops, and of
   the latents of the *correctly predicted* class-k crops;
3. a crop is "unseen" if its latent score exceeds 0.95 for **every** class,
   OR its rec error exceeds ``μ_k + 2σ_k`` of its predicted class;
4. the unseen split leaves out its first-encountered subject, filtering
   whole batches by their *first* label, so the result depends on
   ``batch_size``;
5. ``ensemble_ood_final_{preds,labels}_fixed.npy`` and the confusion-matrix
   PNG ``openset_cnfmtrx_ensemble_ood_fixed.png`` go to the figures folder
   and ``ensemble_ood_log.json`` to the run folder, under the JAX package's
   names.

The encoder trunk runs folded through the CUDA PointNet kernel and the
rec errors through the CUDA Chamfer kernel on the card (their plain
versions on the CPU, or with ``use_kernel=False``); the decoder is
``torch.matmul``. The criterion stays on the host in numpy f64, as in the
JAX package. Kept quirk: the latent "covariance" passed to the cdf is
``diag(std)``, standard deviations on the diagonal.

The reparametrization samples in eval. With ``eps_streams`` the draws are
given per split, rows aligned with the evaluation order; otherwise each
split draws fresh noise per chunk from its own ``torch.Generator`` on the
device, seeded from ``seed``. The port cannot replay JAX's PRNG, so only
the distribution of those draws matches the JAX package's.

With ``generate_dataset=True`` (the default, as in the JAX package) the
setup first rewrites the run's split directories from the raw tracks with
``data/splits.py::generate_splits``, seed 0.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import decoder_state_dict, encoder_state_dict
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
from opensetgaitrecognition_pcaa_tpu_torch.data.splits import generate_splits
from opensetgaitrecognition_pcaa_tpu_torch.infer.artifacts import (
    openset_metrics,
    plot_openset_confusion_matrix,
    save_json,
)
from opensetgaitrecognition_pcaa_tpu_torch.infer.common import batched_apply, chunk_rows, ieee_f32
from opensetgaitrecognition_pcaa_tpu_torch.infer.fast_encoder import fused_orced_encoder_apply
from opensetgaitrecognition_pcaa_tpu_torch.models.orced import ORCEDDecoder, ORCEDEncoder
from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer import seq_chamfer
from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer_kernel import seq_chamfer_kernel
from opensetgaitrecognition_pcaa_tpu_torch.ops.openset import hyperrectangle_prob
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import load_params, module_path

Device = Union[str, torch.device]
THRESHOLD_G = 0.95  # the latent criterion's threshold
_SPLITS = ("train", "test", "unseen")


class ORCEDClassStats(NamedTuple):
    """Per-class statistics behind the OR-ensemble decision."""

    means_z: np.ndarray  # (K, d) latent means over correctly predicted crops
    stds_z: np.ndarray  # (K, d) latent stds over correctly predicted crops
    thresholds_re: np.ndarray  # (K,) rec-error μ_k + 2σ_k
    n_classes: int


def orced_class_stats(rec_err_tr: np.ndarray, f_vecs_tr: np.ndarray, gt_labels: np.ndarray,
                      pred_labels: np.ndarray) -> ORCEDClassStats:
    """The train split's per-class statistics."""
    n_classes = len(np.unique(gt_labels))
    correct = gt_labels == pred_labels
    means_z, stds_z, thresholds_re = [], [], []
    for k in range(n_classes):
        mean_re = np.mean(rec_err_tr[gt_labels == k])
        std_re = np.std(rec_err_tr[gt_labels == k])
        sel = f_vecs_tr[correct][gt_labels[correct] == k]
        means_z.append(np.mean(sel, axis=0))
        stds_z.append(np.std(sel, axis=0))
        thresholds_re.append(mean_re + 2 * std_re)
    return ORCEDClassStats(
        means_z=np.stack(means_z),
        stds_z=np.stack(stds_z),
        thresholds_re=np.array(thresholds_re),
        n_classes=n_classes,
    )


def orced_latent_scores(stats: ORCEDClassStats, z_test: np.ndarray) -> np.ndarray:
    """``(K, n)`` latent scores ``p_k`` of each crop against each class."""
    # quirk: diag(std), not diag(std²)
    return np.stack([hyperrectangle_prob(stats.means_z[k], stats.stds_z[k], z_test)
                     for k in range(stats.n_classes)])


def orced_criteria(stats: ORCEDClassStats, thresholds_g: float, x_test_prediction: np.ndarray,
                   z_test: np.ndarray, re_test: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """→ ``(latent_bools, rec_err_bools)``, the two rejection criteria, in
    numpy f64: the single implementation behind ``orced_apply_ood`` and the
    serving epilogue ``infer/serving.py::orced_decide_host``."""
    p_z_ks = orced_latent_scores(stats, z_test)
    latent_bools = np.sum(1 - p_z_ks < 1 - thresholds_g, axis=0) == stats.n_classes
    thr_re = stats.thresholds_re[np.asarray(x_test_prediction)]
    rec_err_bools = np.asarray(re_test) > thr_re
    return latent_bools, rec_err_bools


def orced_apply_ood(stats: ORCEDClassStats, thresholds_g: float, x_test_prediction: np.ndarray,
                    z_test: np.ndarray, re_test: np.ndarray) -> np.ndarray:
    """The OR-ensemble decision: the predicted class, or ``n_classes`` for
    "unseen"."""
    latent_bools, rec_err_bools = orced_criteria(
        stats, thresholds_g, x_test_prediction, z_test, re_test
    )
    out = np.array(x_test_prediction, dtype=np.int64)
    out[np.logical_or(latent_bools, rec_err_bools)] = stats.n_classes
    return out


def orced_ensemble_ood_detection(rec_err_tr, f_vecs_tr, thresholds_g, gt_labels, pred_labels,
                                 x_test_prediction, z_test, re_test) -> np.ndarray:
    """Class statistics from the train arrays, then ``orced_apply_ood``."""
    stats = orced_class_stats(rec_err_tr, f_vecs_tr, gt_labels, pred_labels)
    return orced_apply_ood(stats, thresholds_g, x_test_prediction, z_test, re_test)


def _orced_pass(
    encoder: ORCEDEncoder,
    decoder: ORCEDDecoder,
    x: np.ndarray,
    *,
    device: Device,
    batch_size: int = 128,
    eps: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
    use_kernel: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched eval pass → ``(preds int64, latents, per-crop rec errors)``.

    ``eps``: per-crop reparametrization draws ``(len(x), latent)``, rows
    aligned with ``x``; otherwise each chunk draws from ``generator``.
    """
    device = torch.device(device)
    eps_chunks = None
    if eps is not None:
        if eps.shape[0] != x.shape[0]:
            raise ValueError(f"eps has {eps.shape[0]} rows for {x.shape[0]} crops")
        # chunked by batched_apply's own policy: rows stay aligned with x
        eps_chunks = chunk_rows(np.asarray(eps, np.float32), batch_size)
    elif generator is None:
        raise ValueError("_orced_pass needs eps or a generator")
    chamfer = seq_chamfer_kernel if use_kernel else seq_chamfer

    def fwd(chunk, step_idx):
        e = None if eps_chunks is None else torch.from_numpy(eps_chunks[step_idx]).to(device)
        logits, z, _, _ = fused_orced_encoder_apply(
            encoder, chunk, eps=e, generator=generator, use_kernel=use_kernel
        )
        re = chamfer(decoder(z), chunk, avg_out=False)
        return logits.argmax(dim=1), z, re

    preds, zs, res = batched_apply(fwd, x, batch_size, device, with_index=True)
    return preds.astype(np.int64), zs, res


def orced_inference_setup(
    model_name: str,
    *,
    device: Device = "cuda",
    models_path: str = "models",
    data_path: Optional[str] = None,
    generate_dataset: bool = True,
):
    """Load one run folder → ``(cfg, encoder, decoder)``, the modules on
    ``device`` in eval mode; first rewrite the run's splits from the raw
    tracks under ``data_path`` (default ``cfg.DATA_PATH``) if
    ``generate_dataset``.

    The JAX package's setup also reads the mean learner ``ML`` and returns
    its cluster means; no OR-CED decision reads them, so the port reads
    only ``E`` and ``G``."""
    run_dir = os.path.join(models_path, model_name)
    cfg = Config.load(os.path.join(run_dir, "config.json"))
    if generate_dataset:
        generate_splits(
            data_path=data_path or cfg.DATA_PATH, gen_data_path=cfg.GEN_DATA_PATH,
            train_classes=cfg.TRAIN_CLASSES, seed=0, nmax_points=cfg.NMAX,
            nsteps=cfg.NSTEPS, crop_step=cfg.CROP_STEP, verbose=False,
        )
    encoder = ORCEDEncoder(
        n_out_labels=cfg.n_classes, in_features=cfg.NFEATURES,
        sup_latent_dim=cfg.SUP_LATENT_DIM, pointnet_out_dim=cfg.POINTNET_OUT_DIM,
        dtc_filters=tuple(cfg.DTC_FILTERS),
    )
    encoder.load_state_dict(encoder_state_dict(load_params(module_path(run_dir, model_name, "E"))))
    decoder = ORCEDDecoder(cfg.SUP_LATENT_DIM, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES)
    decoder.load_state_dict(decoder_state_dict(load_params(module_path(run_dir, model_name, "G"))))
    return cfg, encoder.to(device).eval(), decoder.to(device).eval()


def orced_inference(
    model_names: Sequence[str],
    *,
    device: Device = "cuda",
    models_path: str = "models",
    figures_path: str = "figures",
    data_path: Optional[str] = None,
    generate_dataset: bool = True,
    batch_size: int = 64,
    seed: int = 0,
    eps_streams: Optional[Dict[str, np.ndarray]] = None,
    crop_order: Optional[Dict[str, Sequence[str]]] = None,
    confusion_png: bool = True,
    dump_calibration: bool = False,
    use_kernel: bool = True,
) -> Dict:
    """OR-CED evaluation over runs → ``{name: metrics}`` (reference
    ``ORCED_inference``).

    - ``eps_streams``: ``{"train"|"test"|"unseen": (n_crops, latent)}``
      reparametrization draws, rows aligned with the evaluation order,
      used instead of fresh noise;
    - ``crop_order``: ``{"train"|"test"|"unseen": [basenames]}``, an
      evaluation order in place of the sorted one (it matters through the
      ``drop_last`` cut and the unseen batch filter);
    - ``dump_calibration``: also write the per-crop arrays and the class
      statistics to ``<run>/orced_calibration.npz``;
    - ``use_kernel=False`` runs the plain PointNet and Chamfer versions on
      the card, for comparison with the kernels.
    """
    ieee_f32()
    device = torch.device(device)
    results: Dict = {}
    for model_name in model_names:
        figures_folder = os.path.join(figures_path, model_name)
        os.makedirs(figures_folder, exist_ok=True)
        cfg, encoder, decoder = orced_inference_setup(
            model_name, device=device, models_path=models_path, data_path=data_path,
            generate_dataset=generate_dataset,
        )
        # every split honours the run's SUBSAMPLE_FACTOR, each with its own
        # seeded draw
        data = {}
        for i, (key, split) in enumerate(zip(_SPLITS, (SPLIT.TRAIN, SPLIT.TEST, SPLIT.UNSEEN))):
            ds = RadarCropDataset(split, cfg.GEN_DATA_PATH, subsample_factor=cfg.SUBSAMPLE_FACTOR,
                                  subsample_rng=np.random.default_rng(seed + i))
            x, y = ds.load_all()
            if crop_order is not None and key in crop_order:
                pos = {f: j for j, f in enumerate(ds.filenames)}
                idx = np.array([pos[os.path.basename(f)] for f in crop_order[key]])
                if len(idx) != len(x):
                    raise ValueError(f"crop_order[{key!r}] has {len(idx)} crops, the split {len(x)}")
                x, y = x[idx], y[idx]
            data[key] = (x, y)

        def run_pass(key: str, n: int, i: int):
            eps = None if eps_streams is None else eps_streams.get(key)
            gen = None
            if eps is None:
                gen = torch.Generator(device=device).manual_seed(seed + i)
            else:
                eps = eps[:n]
            return _orced_pass(encoder, decoder, data[key][0][:n], device=device,
                               batch_size=batch_size, eps=eps, generator=gen,
                               use_kernel=use_kernel)

        # the train statistics pass drops the last partial batch
        y_tr = data["train"][1]
        n_keep = (len(y_tr) // batch_size) * batch_size
        tr_preds, tr_z, tr_re = run_pass("train", n_keep, 0)
        gt_labels = y_tr[:n_keep].astype(np.int64)
        n_labels = len(np.unique(gt_labels))
        stats = orced_class_stats(tr_re, tr_z, gt_labels, tr_preds)

        x_te, y_te = data["test"]
        te_preds, te_z, te_re = run_pass("test", len(x_te), 1)
        test_open_preds = orced_apply_ood(stats, THRESHOLD_G, te_preds, te_z, te_re)

        # unseen: leave out the first-encountered subject, filtering whole
        # batches by their first label
        x_un, y_un = data["unseen"]
        un_preds, un_z, un_re = run_pass("unseen", len(x_un), 2)
        leave_out = int(y_un[0])
        keep = [np.arange(s, min(s + batch_size, len(y_un)))
                for s in range(0, len(y_un), batch_size) if int(y_un[s]) != leave_out]
        keep_idx = np.concatenate(keep) if keep else np.empty((0,), dtype=np.int64)
        unseen_open_preds = orced_apply_ood(
            stats, THRESHOLD_G, un_preds[keep_idx], un_z[keep_idx], un_re[keep_idx]
        )

        final_preds = np.concatenate([test_open_preds, unseen_open_preds])
        final_labels = np.concatenate(
            [y_te.astype(np.int64), np.full(len(unseen_open_preds), n_labels)]
        )
        metrics = openset_metrics(final_labels, final_preds)
        if confusion_png:
            plot_openset_confusion_matrix(
                final_labels, final_preds, n_labels,
                os.path.join(figures_folder, "openset_cnfmtrx_ensemble_ood_fixed.png"),
            )
        np.save(os.path.join(figures_folder, "ensemble_ood_final_preds_fixed.npy"), final_preds)
        np.save(os.path.join(figures_folder, "ensemble_ood_final_labels_fixed.npy"), final_labels)
        run_dir = os.path.join(models_path, model_name)
        save_json(metrics, os.path.join(run_dir, "ensemble_ood_log.json"))
        if dump_calibration:
            np.savez(
                os.path.join(run_dir, "orced_calibration.npz"),
                train_preds=tr_preds, train_z=tr_z, train_re=tr_re, train_labels=gt_labels,
                test_preds=te_preds, test_z=te_z, test_re=te_re, test_labels=y_te,
                unseen_preds=un_preds, unseen_z=un_z, unseen_re=un_re, unseen_labels=y_un,
                unseen_keep=keep_idx, means_z=stats.means_z, stds_z=stats.stds_z,
                thresholds_re=stats.thresholds_re, n_labels=n_labels,
            )
        results[model_name] = metrics
    return results
