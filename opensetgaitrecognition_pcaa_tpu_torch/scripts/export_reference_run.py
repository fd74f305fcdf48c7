"""Export a run folder to the reference's torch run-folder contract.

Port of ``scripts/export_reference_run.py``, the inverse of
``import_reference_run``: a run folder (``config.json``, one ``.msgpack``
tree per module, ``discriminator_means.npy``), trained by the port or by
the JAX package, becomes the folder the reference's own inference reads:

====================          =============================
run-folder input              reference output
====================          =============================
config.json                   config.pkl
<NAME>_E.msgpack              <NAME>_E.pt
<NAME>_G.msgpack              <NAME>_G.pt          (if present)
<NAME>_D.msgpack              <NAME>_D.pt          (PCAA only)
<NAME>_ML.msgpack             <NAME>_ML.pt         (if present)
<NAME>_GPH.msgpack            <NAME>_GPH.pt        (if present)
<NAME>_DPH.msgpack            <NAME>_DPH.pt        (if present)
discriminator_means.npy       discriminator_means.pt (PCAA only)
====================          =============================

The state_dicts are those the JAX exporter writes: the same keys in the
same order, the same bits. The layouts go through the forward maps of
``transplant.py``; each module is checked by mapping the state_dict back:
the tree must come back bit for bit. The reference decoders declare four
BatchNorm modules their forward never runs, whose keys a strict
``load_state_dict`` asks for: default-initialized entries are added.

``config.pkl`` needs no reference checkout either: the reference pickles
``TRAIN_SCENARIOS`` as ``constants.SCENARIO`` members, so for the dump a
value-identical stand-in enum is registered as ``constants.SCENARIO``
(a ``constants`` module already loaded is restored afterwards). ORCED
configs also carry the loss weights its driver adds. The export computes
on the host.

    python -m opensetgaitrecognition_pcaa_tpu_torch.scripts.export_reference_run \\
        --run models/MY_RUN --out-models /path/to/reference/models

The kind is detected: ``<NAME>_D.msgpack`` present → PCAA, else ORCED.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pickle
import sys
import types
from enum import Enum
from typing import Optional, Sequence

import numpy as np
import torch

from opensetgaitrecognition_pcaa_tpu_torch.config import SCENARIO, Config
from opensetgaitrecognition_pcaa_tpu_torch.scripts.import_reference_run import _flat
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import load_params, module_path
from opensetgaitrecognition_pcaa_tpu_torch.transplant import (
    cg_discriminator_state_dict,
    cg_encoder_state_dict,
    decoder_bn_placeholder_entries,
    mean_learner_state_dict,
    orced_decoder_state_dict,
    orced_encoder_state_dict,
    sequential_head_state_dict,
    torch_cg_decoder_to_flax,
    torch_cg_discriminator_to_flax,
    torch_cg_encoder_to_flax,
    torch_mean_learner_to_flax,
    torch_orced_decoder_to_flax,
    torch_orced_encoder_to_flax,
    torch_sequential_head_to_flax,
)

# ---------------------------------------------------------------------------
# Config → config.pkl
# ---------------------------------------------------------------------------

# the CONFIG keys every reference run folder carries, from the same-named fields
_BASE_KEYS = (
    "NMAX", "NSTEPS", "CROP_STEP", "NFEATURES", "POINTNET_OUT_DIM", "SUP_LATENT_DIM", "LR",
    "B1", "B2", "SUBSAMPLE_FACTOR", "EPOCHS", "BATCH_SIZE", "GP_WEIGHT", "ADV_WEIGHT",
    "MODEL_NAME", "NOTES", "CHECKPOINT_FREQUENCY", "SUPERVISION_FREQUENCY",
)

# the keys the reference's ORCED driver adds before pickling
_ORCED_KEYS = ("TRIPLET_W", "CE_W", "REC_W", "KL_W", "TRIPLET_MARGIN")


@contextlib.contextmanager
def _reference_scenario_cls():
    """Yield an enum class that pickles as ``constants.SCENARIO``: the
    reference's own where its ``constants`` module is loaded, else a
    stand-in with the same members, registered as ``constants`` in
    ``sys.modules`` for the dump only (pickle looks the class up there).
    A ``constants`` module that was loaded but lacks ``SCENARIO`` is put
    back afterwards, never deleted."""
    mod = sys.modules.get("constants")
    if mod is not None and hasattr(mod, "SCENARIO"):
        yield mod.SCENARIO
        return
    standin = Enum("SCENARIO", {s.name: s.value for s in SCENARIO})
    standin.__module__ = "constants"
    standin.__qualname__ = "SCENARIO"
    fake = types.ModuleType("constants")
    fake.SCENARIO = standin
    sys.modules["constants"] = fake
    try:
        yield standin
    finally:
        if mod is not None:
            sys.modules["constants"] = mod
        elif sys.modules.get("constants") is fake:
            del sys.modules["constants"]


def framework_config_to_reference(cfg: Config, kind: str, scenario_cls) -> dict:
    """``Config`` → the reference CONFIG dict: python scalars,
    ``DTC_FILTERS``/``TRAIN_CLASSES`` as lists, scenarios as
    ``scenario_cls`` members."""
    d = {k: getattr(cfg, k) for k in _BASE_KEYS}
    # the shipped decoder's size, as the reference derives it
    # (NSTEPS * NMAX * NFEATURES), not the DEC_MLP_SIZE field nothing keeps
    d["DEC_MLP_SIZE"] = cfg.decoder_mlp_size
    d["DTC_FILTERS"] = list(cfg.DTC_FILTERS)
    d["TRAIN_CLASSES"] = [int(c) for c in cfg.TRAIN_CLASSES]
    d["TRAIN_SCENARIOS"] = [scenario_cls(s) for s in cfg.TRAIN_SCENARIOS]
    if kind == "orced":
        d.update({k: getattr(cfg, k) for k in _ORCED_KEYS})
    return d


def dump_reference_config(cfg: Config, kind: str, path: str) -> None:
    with _reference_scenario_cls() as scenario_cls:
        with open(path, "wb") as f:
            pickle.dump(framework_config_to_reference(cfg, kind, scenario_cls), f)


# ---------------------------------------------------------------------------
# module export and its check
# ---------------------------------------------------------------------------


def _assert_roundtrip(source_tree: dict, recovered_tree: dict, tag: str) -> None:
    """inverse(forward(tree)) must be the tree, bit for bit."""
    fs, fr = _flat(source_tree), _flat(recovered_tree)
    if set(fs) != set(fr):
        missing = sorted(".".join(k) for k in set(fs) - set(fr))
        extra = sorted(".".join(k) for k in set(fr) - set(fs))
        raise AssertionError(
            f"{tag}: round-trip key mismatch (missing: {missing or '-'}; "
            f"unexpected: {extra or '-'})"
        )
    for k in fs:
        a = np.asarray(fs[k], dtype=np.float32)
        b = np.asarray(fr[k], dtype=np.float32)
        if not np.array_equal(a, b):
            raise AssertionError(
                f"{tag}: round-trip mismatch at {'.'.join(k)} "
                f"(max |delta| {np.max(np.abs(a - b)):.3e})"
            )


def _save_pt(sd: dict, path: str) -> None:
    torch.save(sd, path)


def detect_kind(run_dir: str, name: str) -> str:
    """PCAA run folders hold a discriminator, ORCED ones never do."""
    return "pcaa" if os.path.exists(module_path(run_dir, name, "D")) else "orced"


def _load_run_config(run_dir: str) -> Config:
    cfg = Config.load(os.path.join(run_dir, "config.json"))
    name = os.path.basename(os.path.normpath(run_dir))
    if cfg.MODEL_NAME != name:
        raise ValueError(
            f"config.json MODEL_NAME={cfg.MODEL_NAME!r} does not match the "
            f"run folder name {name!r}"
        )
    return cfg


def _export_decoder(dec: dict, cfg: Config, to_flax, path: str) -> None:
    dec_sd = orced_decoder_state_dict({"params": dec}, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES)
    _assert_roundtrip(dec, to_flax(dec_sd, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES), "G")
    dec_sd.update(decoder_bn_placeholder_entries(cfg.decoder_mlp_size))
    _save_pt(dec_sd, path)


def _export_mean_learner(ml_vars: dict, path: str) -> None:
    ml_sd = mean_learner_state_dict(ml_vars)
    mp, ms = torch_mean_learner_to_flax(ml_sd)
    _assert_roundtrip(ml_vars, {"params": mp, "batch_stats": ms}, "ML")
    _save_pt(ml_sd, path)


def export_pcaa_run(run_dir: str, out_dir: str) -> str:
    """A PCAA run folder (any variant) → the reference folder
    ``<out_dir>/<NAME>``, whose path it returns."""
    cfg = _load_run_config(run_dir)
    name = cfg.MODEL_NAME
    dst = os.path.join(out_dir, name)
    os.makedirs(dst, exist_ok=True)
    dump_reference_config(cfg, "pcaa", os.path.join(dst, "config.pkl"))

    def _msg(tag):
        return module_path(run_dir, name, tag)

    def _pt(tag):
        return os.path.join(dst, f"{name}_{tag}.pt")

    enc_vars = load_params(_msg("E"))
    use_head = "MLP_head" in enc_vars["params"]
    enc_sd = cg_encoder_state_dict(enc_vars, use_projection_head=use_head)
    p, s = torch_cg_encoder_to_flax(enc_sd, use_projection_head=use_head)
    _assert_roundtrip(enc_vars, {"params": p, "batch_stats": s}, "E")
    _save_pt(enc_sd, _pt("E"))

    disc = load_params(_msg("D"))["params"]
    disc_sd = cg_discriminator_state_dict(disc)
    _assert_roundtrip(disc, torch_cg_discriminator_to_flax(disc_sd), "D")
    _save_pt(disc_sd, _pt("D"))

    if os.path.exists(_msg("G")):  # V3 trains no decoder
        _export_decoder(load_params(_msg("G"))["params"], cfg, torch_cg_decoder_to_flax,
                        _pt("G"))

    for tag in ("GPH", "DPH"):
        if os.path.exists(_msg(tag)):
            head = load_params(_msg(tag))["params"]
            head_sd = sequential_head_state_dict(head)
            _assert_roundtrip(head, torch_sequential_head_to_flax(head_sd), tag)
            _save_pt(head_sd, _pt(tag))

    if os.path.exists(_msg("ML")):  # V1's learned-centroid mean learner
        _export_mean_learner(load_params(_msg("ML")), _pt("ML"))

    means = np.load(os.path.join(run_dir, "discriminator_means.npy"))
    want = (cfg.n_classes, cfg.SUP_LATENT_DIM)
    if means.shape != want:
        raise ValueError(
            f"discriminator_means shape {means.shape} does not match the "
            f"config-declared {want}"
        )
    torch.save(torch.tensor(np.asarray(means, dtype=np.float32)),
               os.path.join(dst, "discriminator_means.pt"))
    return dst


def export_orced_run(run_dir: str, out_dir: str) -> str:
    """An ORCED run folder (E, G, ML) → the reference folder ``<out_dir>/<NAME>``."""
    cfg = _load_run_config(run_dir)
    name = cfg.MODEL_NAME
    dst = os.path.join(out_dir, name)
    os.makedirs(dst, exist_ok=True)
    dump_reference_config(cfg, "orced", os.path.join(dst, "config.pkl"))

    enc_vars = load_params(module_path(run_dir, name, "E"))
    enc_sd = orced_encoder_state_dict(enc_vars)
    p, s = torch_orced_encoder_to_flax(enc_sd)
    _assert_roundtrip(enc_vars, {"params": p, "batch_stats": s}, "E")
    _save_pt(enc_sd, os.path.join(dst, f"{name}_E.pt"))

    _export_decoder(load_params(module_path(run_dir, name, "G"))["params"], cfg,
                    torch_orced_decoder_to_flax, os.path.join(dst, f"{name}_G.pt"))
    _export_mean_learner(load_params(module_path(run_dir, name, "ML")),
                         os.path.join(dst, f"{name}_ML.pt"))
    return dst


def export_reference_run(run_dir: str, out_dir: str) -> str:
    run_dir = os.path.normpath(run_dir)
    name = os.path.basename(run_dir)
    kind = detect_kind(run_dir, name)
    print(f"[export] {name}: detected {kind.upper()} run")
    if kind == "pcaa":
        return export_pcaa_run(run_dir, out_dir)
    return export_orced_run(run_dir, out_dir)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(
        description="Export a run folder to the reference's torch run-folder contract.")
    p.add_argument("--run", required=True,
                   help="run folder (models/<NAME>, holding config.json + <NAME>_*.msgpack)")
    p.add_argument("--out-models", required=True,
                   help="destination models/ root; the run exports to <out-models>/<NAME>")
    args = p.parse_args(argv)
    dst = export_reference_run(args.run, args.out_models)
    print(f"[export] wrote {dst}")


if __name__ == "__main__":
    main()
