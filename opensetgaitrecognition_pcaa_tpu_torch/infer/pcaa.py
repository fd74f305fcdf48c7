"""PCAA open-set inference: k-window voting with Gaussian-mixture rejection.

Port of ``opensetgaitrecognition_pcaa_tpu/infer/pcaa.py:64-475``:

1. encode every sequential TEST and UNSEEN crop → 32-d latents, once per
   run, in chunks of 256 through the folded encoder (the CUDA PointNet
   kernel on the card, its plain version on the CPU);
2. score each latent by the mixture of unit Gaussians centred at the run's
   ``discriminator_means``, in log space;
3. pick the rejection threshold by Youden's J on {seen TEST = positive} vs
   {a 20% subject subset of UNSEEN = negative};
4. vote over non-overlapping k-crop windows: a window whose crops are
   mostly above the threshold takes the majority class, otherwise
   "unknown" (= ``n_labels``);
5. write ``naive_seq_log_{k}.json``, ``final_{preds,labels}_{k}.npy``,
   ``naive_seq_log_subsampled{s}.json`` and the confusion-matrix PNG
   ``openset_confusion_matrix_naive_seq_{k}.png`` under the JAX package's
   names.

With ``generate_dataset=True`` (the default, as in the JAX package) the
setup first rewrites the run's split directories from the raw tracks with
``data/splits.py::generate_splits``, seed 0.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from opensetgaitrecognition_pcaa_tpu_torch.config import (
    ALL_SCENARIOS,
    SCENARIO,
    SPLIT,
    VARIATION,
    Config,
    variation_from_model_name,
)
from opensetgaitrecognition_pcaa_tpu_torch.convert import encoder_state_dict
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
from opensetgaitrecognition_pcaa_tpu_torch.data.splits import generate_splits
from opensetgaitrecognition_pcaa_tpu_torch.infer.artifacts import (
    openset_metrics,
    plot_openset_confusion_matrix,
    save_json,
)
from opensetgaitrecognition_pcaa_tpu_torch.infer.common import batched_apply, ieee_f32
from opensetgaitrecognition_pcaa_tpu_torch.infer.fast_encoder import fused_encoder_apply
from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGEncoder
from opensetgaitrecognition_pcaa_tpu_torch.ops.openset import (
    best_youden_threshold,
    log_joint_likelihood,
    underflow_tied,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import load_params, module_path

Device = Union[str, torch.device]


def pcaa_inference_setup(
    model_name: str,
    variation: VARIATION,
    *,
    device: Device = "cuda",
    models_path: str = "models",
    data_path: Optional[str] = None,
    generate_dataset: bool = True,
    force_pc_subsampling: int = 0,
):
    """Load config, encoder weights and centroids of one run folder →
    ``(cfg, encoder on device in eval mode, means)``; first rewrite the
    run's splits from the raw tracks under ``data_path`` (default
    ``cfg.DATA_PATH``) if ``generate_dataset``."""
    run_dir = os.path.join(models_path, model_name)
    cfg = Config.load(os.path.join(run_dir, "config.json"))
    if generate_dataset:
        generate_splits(
            data_path=data_path or cfg.DATA_PATH, gen_data_path=cfg.GEN_DATA_PATH,
            train_classes=cfg.TRAIN_CLASSES, seed=0,
            force_pc_subsampling=force_pc_subsampling, nmax_points=cfg.NMAX,
            nsteps=cfg.NSTEPS, crop_step=cfg.CROP_STEP, verbose=False,
        )
    # the projection head exists for V1 and V4 (see the JAX package)
    encoder = CGEncoder(
        n_out_labels=cfg.n_classes,
        in_features=cfg.NFEATURES,
        sup_latent_dim=cfg.SUP_LATENT_DIM,
        pointnet_out_dim=cfg.POINTNET_OUT_DIM,
        dtc_filters=tuple(cfg.DTC_FILTERS),
        use_projection_head=variation in (VARIATION.V1, VARIATION.V4),
    )
    encoder.load_state_dict(encoder_state_dict(load_params(module_path(run_dir, model_name, "E"))))
    encoder = encoder.to(device).eval()
    means = np.load(os.path.join(run_dir, "discriminator_means.npy"))
    return cfg, encoder, means


def _encode_split(
    encoder: CGEncoder,
    dataset: RadarCropDataset,
    device: Device,
    batch_size: int = 256,
    use_kernel: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """→ (latents ``(n, d)``, argmax predictions ``(n,)`` int64) for a split."""
    x, _ = dataset.load_all()

    def fwd(chunk):
        logits, fv = fused_encoder_apply(encoder, chunk, use_kernel=use_kernel)
        return fv, logits.argmax(dim=1)

    fvs, preds = batched_apply(fwd, x, batch_size, torch.device(device))
    return fvs, preds.astype(np.int64)


def _window_vote(
    log_liks: np.ndarray,
    preds: np.ndarray,
    labels: np.ndarray,
    k: int,
    log_threshold: float,
    n_labels: int,
    keep_mask: Optional[np.ndarray] = None,
    true_label_override: Optional[int] = None,
) -> Tuple[List[int], List[int]]:
    """Non-overlapping k-windows in sequential order; majority vote or
    reject. Windows with mixed labels are skipped, so is a window whose
    first crop ``keep_mask`` excludes, and a tail shorter than k."""
    out_preds: List[int] = []
    out_labels: List[int] = []
    for start in range(0, len(log_liks) - k + 1, k):
        sl = slice(start, start + k)
        lab = labels[sl]
        if len(np.unique(lab)) != 1:
            continue
        if keep_mask is not None and not keep_mask[start]:
            continue
        n_above = int(np.sum(log_liks[sl] > log_threshold))
        if n_above > k / 2:
            vote = int(np.argmax(np.bincount(preds[sl])))
        else:
            vote = n_labels
        out_preds.append(vote)
        out_labels.append(
            int(lab[0]) if true_label_override is None else true_label_override
        )
    return out_preds, out_labels


class OpenSetCalibration(NamedTuple):
    """Per-crop scores and the Youden-J threshold of one run."""

    log_threshold: float
    test_ll: np.ndarray
    test_preds: np.ndarray
    test_labels: np.ndarray
    unseen_ll: np.ndarray
    unseen_preds: np.ndarray
    unseen_labels: np.ndarray
    is_val: np.ndarray  # unseen crops held out for threshold validation
    n_labels: int


def calibrate_open_set(
    encoder: CGEncoder,
    discriminator_means: np.ndarray,
    cfg: Config,
    *,
    device: Device,
    scenarios_list: Sequence[SCENARIO] = ALL_SCENARIOS,
    seed: int = 0,
    unseen_valid_ratio: float = 0.2,
    use_kernel: bool = True,
) -> OpenSetCalibration:
    """Score the sequential TEST and UNSEEN splits and pick the threshold
    (steps 1-3 of the module docstring)."""
    rng = np.random.default_rng(seed)
    ds_test = RadarCropDataset(
        SPLIT.TEST, cfg.GEN_DATA_PATH, scenarios=scenarios_list, sequential=True
    )
    ds_unseen = RadarCropDataset(
        SPLIT.UNSEEN, cfg.GEN_DATA_PATH, scenarios=scenarios_list, sequential=True
    )
    test_fvs, test_preds = _encode_split(encoder, ds_test, device, use_kernel=use_kernel)
    unseen_fvs, unseen_preds = _encode_split(encoder, ds_unseen, device, use_kernel=use_kernel)

    test_ll = underflow_tied(np.asarray(log_joint_likelihood(test_fvs, discriminator_means)))
    unseen_ll = underflow_tied(np.asarray(log_joint_likelihood(unseen_fvs, discriminator_means)))

    # 20% of the unseen subjects → threshold-validation set
    unseen_labels = ds_unseen.labels
    unseen_subjects = np.unique(unseen_labels)
    val_subjects = rng.choice(
        unseen_subjects,
        size=int(np.ceil(unseen_valid_ratio * len(unseen_subjects))),
        replace=False,
    )
    is_val = np.isin(unseen_labels, val_subjects)

    scores = np.concatenate([unseen_ll[is_val], test_ll])
    det_labels = np.concatenate([np.zeros(int(is_val.sum())), np.ones(len(test_ll))])
    return OpenSetCalibration(
        log_threshold=best_youden_threshold(det_labels, scores),
        test_ll=test_ll,
        test_preds=test_preds,
        test_labels=ds_test.labels,
        unseen_ll=unseen_ll,
        unseen_preds=unseen_preds,
        unseen_labels=unseen_labels,
        is_val=is_val,
        n_labels=ds_test.n_classes,
    )


def _artifact_suffix(k, force_pc_subsampling: int,
                     scenarios_list: Sequence[SCENARIO]) -> str:
    """The reference's file-name switch (``inference_PCAA.py:333-345``)."""
    if force_pc_subsampling and tuple(scenarios_list) == ALL_SCENARIOS:
        return f"{k}_subsampled{force_pc_subsampling}"
    if not force_pc_subsampling and tuple(scenarios_list) != ALL_SCENARIOS:
        return f"{k}_scenarios" + "_".join(s.value for s in scenarios_list)
    return f"{k}"


def naive_sequential_procedure(
    k: int,
    cal: OpenSetCalibration,
    model_folder: str,
    *,
    figures_folder: Optional[str] = None,
    scenarios_list: Sequence[SCENARIO] = ALL_SCENARIOS,
    force_pc_subsampling: int = 0,
    confusion_png: bool = False,
) -> Tuple[Dict, np.ndarray, np.ndarray]:
    """k-window voting over a calibration → ``(metrics, preds, labels)``;
    writes ``naive_seq_log_<suffix>.json`` and, with ``confusion_png``, the
    confusion-matrix PNG into ``figures_folder``."""
    p1, l1 = _window_vote(
        cal.test_ll, cal.test_preds, cal.test_labels, k, cal.log_threshold, cal.n_labels
    )
    p2, l2 = _window_vote(
        cal.unseen_ll, cal.unseen_preds, cal.unseen_labels, k, cal.log_threshold,
        cal.n_labels, keep_mask=~cal.is_val, true_label_override=cal.n_labels,
    )
    final_preds = np.array(p1 + p2)
    final_labels = np.array(l1 + l2)
    if confusion_png:
        plot_openset_confusion_matrix(
            final_labels, final_preds, cal.n_labels,
            os.path.join(figures_folder, f"openset_confusion_matrix_naive_seq_{k}.png"),
        )
    out_log = {"n_steps": k, **openset_metrics(final_labels, final_preds)}
    suffix = _artifact_suffix(k, force_pc_subsampling, scenarios_list)
    save_json(out_log, os.path.join(model_folder, f"naive_seq_log_{suffix}.json"))
    return out_log, final_preds, final_labels


def pcaa_inference(
    model_names: Sequence[str],
    ks: Sequence[int],
    *,
    device: Device = "cuda",
    models_path: str = "models",
    figures_path: str = "figures",
    data_path: Optional[str] = None,
    force_pc_subsampling: int = 0,
    scenarios_list: Sequence[SCENARIO] = ALL_SCENARIOS,
    variation: Optional[VARIATION] = None,
    generate_dataset: bool = True,
    dump_calibration: bool = False,
    confusion_png: bool = True,
    use_kernel: bool = True,
) -> Dict:
    """Open-set inference over runs × window sizes (reference
    ``CGAAE_inference``, ``inference_PCAA.py:382-469``).

    ``generate_dataset`` rewrites each run's splits from the raw tracks
    under ``data_path`` (default the run's ``DATA_PATH``), with
    ``force_pc_subsampling`` points a frame if it is set; that value also
    names the artifacts. ``dump_calibration``
    also writes the per-crop calibration arrays to
    ``<model_folder>/calibration.npz``. ``use_kernel=False`` runs the plain
    PointNet version on the card, for comparison with the kernel.
    """
    if force_pc_subsampling and tuple(scenarios_list) != ALL_SCENARIOS:
        raise ValueError(
            "force_pc_subsampling and scenarios_list cannot both be non-default"
        )
    ieee_f32()
    all_logs: Dict = {}
    for model_name in model_names:
        model_folder = os.path.join(models_path, model_name)
        figures_folder = os.path.join(figures_path, model_name)
        os.makedirs(figures_folder, exist_ok=True)
        var = variation or variation_from_model_name(model_name)
        cfg, encoder, means = pcaa_inference_setup(
            model_name, var, device=device, models_path=models_path, data_path=data_path,
            generate_dataset=generate_dataset, force_pc_subsampling=force_pc_subsampling,
        )
        cal = calibrate_open_set(
            encoder, means, cfg, device=device, scenarios_list=scenarios_list,
            seed=0, unseen_valid_ratio=0.2, use_kernel=use_kernel,
        )
        if dump_calibration:
            np.savez(os.path.join(model_folder, "calibration.npz"), **cal._asdict())
        out_log: Dict = {}
        for k in ks:
            metrics, final_preds, final_labels = naive_sequential_procedure(
                k, cal, model_folder, figures_folder=figures_folder,
                scenarios_list=scenarios_list,
                force_pc_subsampling=force_pc_subsampling,
                confusion_png=confusion_png,
            )
            suffix = _artifact_suffix(k, force_pc_subsampling, scenarios_list)
            np.save(os.path.join(model_folder, f"final_preds_{suffix}.npy"), final_preds)
            np.save(os.path.join(model_folder, f"final_labels_{suffix}.npy"), final_labels)
            out_log[k] = {
                "f1_micro": metrics["f1_micro"],
                "f1_macro": metrics["f1_macro"],
                "f1_weighted": metrics["f1_weighted"],
            }
        save_json(out_log, os.path.join(
            model_folder, f"naive_seq_log_subsampled{force_pc_subsampling}.json"))
        all_logs[model_name] = out_log
    return all_logs
