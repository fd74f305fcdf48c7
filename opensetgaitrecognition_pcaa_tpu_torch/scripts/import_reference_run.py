"""Import a reference torch run folder into the run-folder contract.

Port of ``scripts/import_reference_run.py``. Reference training leaves
``models/<NAME>/`` holding a pickled config, one ``.pt`` state_dict per
module and the centroid tensor; this writes the run folder that the
port's (and the JAX package's) inference, drivers and serving export read:

====================       =============================
reference input            run-folder output
====================       =============================
config.pkl                 config.json
<NAME>_E.pt                <NAME>_E.msgpack
<NAME>_G.pt                <NAME>_G.msgpack        (if present)
<NAME>_D.pt                <NAME>_D.msgpack        (PCAA only)
<NAME>_ML.pt               <NAME>_ML.msgpack       (if present)
<NAME>_GPH.pt              <NAME>_GPH.msgpack      (if present)
<NAME>_DPH.pt              <NAME>_DPH.msgpack      (if present)
discriminator_means.pt     discriminator_means.npy (PCAA only)
====================       =============================

The files are byte for byte those the JAX importer writes. The layouts
go through the inverse maps of ``transplant.py``; each module is checked
twice before it is written: mapped back through the forward map it must
give the loaded state_dict bit for bit, with no entry left over, and its
shapes must be those of the architecture that ``config.pkl`` declares
(the port's modules built on the meta device, so no weight is made).

``config.pkl`` is read without the reference checkout: a tolerant
unpickler puts the port's value-identical enums in place of
``constants.SCENARIO`` and ``constants.SPLIT``. The ``.pt`` files are read
with ``torch.load(weights_only=True)`` on the CPU. The import computes on
the host.

    python -m opensetgaitrecognition_pcaa_tpu_torch.scripts.import_reference_run \\
        --ref-run /ref/models/PCAA_Abl2_V4.8.0 --out-models models_imported

The kind is detected: ``<NAME>_D.pt`` present → PCAA, else ORCED (every
PCAA variant saves a discriminator, ORCED never does). ``<NAME>`` is
config.pkl's MODEL_NAME, the stem of every ``.pt``, so a copied or
renamed folder still imports.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import pickle
import shutil
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from opensetgaitrecognition_pcaa_tpu_torch.config import SCENARIO, SPLIT, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import (
    decoder_variables,
    discriminator_variables,
    encoder_variables,
    head_variables,
    mean_learner_variables,
)
from opensetgaitrecognition_pcaa_tpu_torch.models.mean_learner import GaussianMeanLearner
from opensetgaitrecognition_pcaa_tpu_torch.models.orced import ORCEDEncoder
from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import (
    CGDecoder,
    CGDiscriminator,
    CGEncoder,
    ProjectionHead,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import module_path, save_params
from opensetgaitrecognition_pcaa_tpu_torch.transplant import (
    cg_encoder_state_dict,
    mean_learner_state_dict,
    orced_decoder_state_dict,
    orced_encoder_state_dict,
    torch_cg_decoder_to_flax,
    torch_cg_discriminator_to_flax,
    torch_cg_encoder_to_flax,
    torch_mean_learner_to_flax,
    torch_orced_decoder_to_flax,
    torch_orced_encoder_to_flax,
    torch_sequential_head_to_flax,
)

# ---------------------------------------------------------------------------
# config.pkl → Config
# ---------------------------------------------------------------------------


class _TolerantUnpickler(pickle.Unpickler):
    """Unpickle a reference ``config.pkl`` without the reference on
    ``sys.path``: enums pickle as ``cls(value)`` calls, and where the
    reference's ``constants`` module cannot be imported, the port's
    ``SCENARIO``/``SPLIT`` (the same values) stand in."""

    _SUBSTITUTES = {
        ("constants", "SCENARIO"): SCENARIO,
        ("constants", "SPLIT"): SPLIT,
    }

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ModuleNotFoundError, AttributeError):
            try:
                return self._SUBSTITUTES[(module, name)]
            except KeyError:
                raise pickle.UnpicklingError(
                    f"config.pkl references {module}.{name}, which is neither "
                    "importable nor a known reference enum"
                ) from None


def load_reference_config(path: str) -> dict:
    """→ the reference CONFIG dict of ``config.pkl``."""
    with open(path, "rb") as f:
        return _TolerantUnpickler(io.BytesIO(f.read())).load()


def reference_config_to_framework(ref_cfg: dict, **overrides) -> Config:
    """The reference CONFIG dict → ``Config``. The keys are the same; the
    scenario enums become their values, numpy scalars python numbers, and
    keys ``Config`` lacks (wandb's) are dropped."""
    d = {}
    for k, v in ref_cfg.items():
        if k == "TRAIN_SCENARIOS":
            v = [getattr(s, "value", str(s)) for s in v]
        elif k == "TRAIN_CLASSES":
            v = [int(c) for c in v]
        elif isinstance(v, np.generic):
            v = v.item()
        d[k] = v
    d.update(overrides)
    return Config.from_dict(d)


# ---------------------------------------------------------------------------
# module conversion and its checks
# ---------------------------------------------------------------------------


def _flat(tree: dict, prefix: tuple = ()) -> dict:
    """``{path: leaf}`` of a tree of dicts (a tuple of a shape tree is a leaf)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _declared_shapes(make_module: Callable[[], torch.nn.Module], to_variables) -> dict:
    """The tree of the shapes of the module ``make_module`` builds, built on
    the meta device: no weight is made."""
    with torch.device("meta"):
        module = make_module()
    return to_variables(module.state_dict())


def _assert_matches_config(tree: dict, want_shapes: dict, tag: str) -> None:
    """The converted tree must have exactly the entries and shapes of the
    architecture the config declares: config.pkl and a mixed-up or edited
    ``.pt`` would otherwise import and fail deep in the first consumer,
    which builds its modules from the config."""
    want, got = _flat(want_shapes), _flat(tree)
    if set(got) != set(want):
        missing = sorted(".".join(k) for k in set(want) - set(got))
        extra = sorted(".".join(k) for k in set(got) - set(want))
        raise ValueError(
            f"{tag}: checkpoint entries do not match the config-declared "
            f"architecture (missing: {missing or '-'}; unexpected: "
            f"{extra or '-'}) — config.pkl and {tag}.pt disagree"
        )
    for k in want:
        if tuple(np.shape(got[k])) != tuple(want[k]):
            raise ValueError(
                f"{tag}: checkpoint shape {tuple(np.shape(got[k]))} at "
                f"{'.'.join(k)} does not match the config-declared "
                f"architecture's {tuple(want[k])} — config.pkl and "
                f"{tag}.pt disagree (check TRAIN_CLASSES / SUP_LATENT_DIM / "
                "POINTNET_OUT_DIM / DTC_FILTERS / NSTEPS / NMAX / NFEATURES)"
            )


def _load_state_dict(path: str) -> dict:
    return dict(torch.load(path, map_location="cpu", weights_only=True))


def _assert_roundtrip(original_sd: dict, rebuilt_sd: dict, tag: str,
                      allowed_extra: tuple = ()) -> None:
    """Every entry the forward map gives must equal the loaded one bit for
    bit, and every loaded entry must be one the map gives, so a state_dict
    with extra layers is refused, not cut. ``num_batches_tracked`` is
    exempt (the map writes 0; eval never reads it); ``allowed_extra``
    names key prefixes a checkpoint may carry beyond the map (the
    reference decoders' forward-unused ``bn1..4``)."""
    for k, v in rebuilt_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        a = np.asarray(v.detach().cpu().numpy(), dtype=np.float32)
        b = np.asarray(original_sd[k].detach().cpu().numpy(), dtype=np.float32)
        if not np.array_equal(a, b):
            raise AssertionError(
                f"{tag}: round-trip mismatch at {k} (max |delta| {np.max(np.abs(a - b)):.3e})"
            )
    extra = sorted(
        k for k in original_sd
        if k not in rebuilt_sd and not k.endswith("num_batches_tracked")
        and not any(k.startswith(p) for p in allowed_extra)
    )
    if extra:
        raise ValueError(
            f"{tag}: checkpoint carries entries the reference module does "
            f"not declare ({extra}) — not a reference {tag} state_dict"
        )


def _head_roundtrip(original_sd: dict, params: dict, tag: str) -> None:
    """The forward check of the ``Sequential(Linear, ELU)`` heads and the
    discriminator, layer by layer in the checkpoint's own numbering."""
    rebuilt = {}
    layer_keys = sorted({k.split(".")[0] for k in original_sd if k.endswith(".weight")}, key=int)
    if len(layer_keys) != len(params):
        raise ValueError(
            f"{tag}: checkpoint declares {len(layer_keys)} Linear layers, the "
            f"converted head holds {len(params)} — not a reference {tag} state_dict"
        )
    for i, dense in enumerate(sorted(params, key=lambda s: int(s.split("_")[1]))):
        li = layer_keys[i]
        rebuilt[f"{li}.weight"] = torch.tensor(
            np.asarray(params[dense]["kernel"], dtype=np.float32).T)
        rebuilt[f"{li}.bias"] = torch.tensor(np.asarray(params[dense]["bias"], dtype=np.float32))
    _assert_roundtrip(original_sd, rebuilt, tag)


@contextlib.contextmanager
def _staged_run_dir(final_dir: str):
    """Build the run folder in ``<final_dir>.importing.<pid>`` and move it
    into place only when the whole import succeeded: a refused import
    leaves no run folder behind (a folder holding ``config.json`` reads as
    a run to the drivers and collectors), and a folder already at
    ``final_dir`` stays untouched. Callers write ``config.json`` last, so a
    stage killed before promotion holds none in most cases; the old run
    goes aside as ``<final_dir>.replaced`` for the one rename that swaps
    them."""
    stage = f"{final_dir}.importing.{os.getpid()}"
    shutil.rmtree(stage, ignore_errors=True)
    os.makedirs(stage)
    try:
        yield stage
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    old = final_dir + ".replaced"
    shutil.rmtree(old, ignore_errors=True)
    if os.path.isdir(final_dir):
        os.replace(final_dir, old)
    os.replace(stage, final_dir)
    shutil.rmtree(old, ignore_errors=True)


def _import_run(ref_run_dir: str, out_models: str, write_modules, cfg_overrides: dict) -> Config:
    cfg = reference_config_to_framework(
        load_reference_config(os.path.join(ref_run_dir, "config.pkl")),
        MODELS_PATH=out_models, **cfg_overrides,
    )
    name = cfg.MODEL_NAME or os.path.basename(os.path.normpath(ref_run_dir))
    if not cfg.MODEL_NAME:
        cfg = cfg.replace(MODEL_NAME=name)
    with _staged_run_dir(cfg.run_dir()) as run_dir:
        write_modules(ref_run_dir, cfg, name, run_dir)
        # last: an interrupted stage must not hold the file that makes a run folder
        cfg.save(os.path.join(run_dir, "config.json"))
    return cfg


def import_pcaa_run(ref_run_dir: str, out_models: str, **cfg_overrides) -> Config:
    """A reference PCAA run folder (any variant) → a run folder under
    ``out_models``; ``cfg_overrides`` replace fields of the imported config."""
    return _import_run(ref_run_dir, out_models, _write_pcaa_modules, cfg_overrides)


def _write_pcaa_modules(ref_run_dir: str, cfg: Config, name: str, run_dir: str) -> None:
    def _pt(tag):
        return os.path.join(ref_run_dir, f"{name}_{tag}.pt")

    n, latent = cfg.n_classes, cfg.SUP_LATENT_DIM
    # the projection head is read off the checkpoint (V1 and V4 train one)
    enc_sd = _load_state_dict(_pt("E"))
    use_head = "MLP_head.0.weight" in enc_sd
    p, s = torch_cg_encoder_to_flax(enc_sd, use_projection_head=use_head)
    enc_vars = {"params": p, "batch_stats": s}
    _assert_roundtrip(enc_sd, cg_encoder_state_dict(enc_vars, use_head), "E")
    _assert_matches_config(enc_vars, _declared_shapes(lambda: CGEncoder(
        n, in_features=cfg.NFEATURES, sup_latent_dim=latent,
        pointnet_out_dim=cfg.POINTNET_OUT_DIM, dtc_filters=tuple(cfg.DTC_FILTERS),
        use_projection_head=use_head), encoder_variables), "E")
    save_params(enc_vars, module_path(run_dir, name, "E"))

    disc_sd = _load_state_dict(_pt("D"))
    bad = [k for k in disc_sd if "model." not in k]
    if bad:  # the discriminator wraps an nn.Sequential named "model"
        raise ValueError(
            f"D: keys without the reference's 'model.' prefix "
            f"(CGDiscriminator wraps an nn.Sequential named 'model'): {bad}"
        )
    disc_params = torch_cg_discriminator_to_flax(disc_sd)
    _head_roundtrip({k.split("model.", 1)[1]: v for k, v in disc_sd.items()}, disc_params, "D")
    _assert_matches_config({"params": disc_params}, _declared_shapes(
        lambda: CGDiscriminator(latent, n), discriminator_variables), "D")
    save_params({"params": disc_params}, module_path(run_dir, name, "D"))

    # the decoder reads the GPH's 2·latent projection where one was trained
    dec_in = 2 * latent if os.path.exists(_pt("GPH")) else latent
    if os.path.exists(_pt("G")):  # V3 trains no decoder
        dec_sd = _load_state_dict(_pt("G"))
        dec_params = torch_cg_decoder_to_flax(dec_sd, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES)
        _assert_roundtrip(
            dec_sd,
            orced_decoder_state_dict({"params": dec_params}, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES),
            "G", allowed_extra=("bn1.", "bn2.", "bn3.", "bn4."),
        )
        _assert_matches_config({"params": dec_params}, _declared_shapes(
            lambda: CGDecoder(dec_in, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES),
            decoder_variables), "G")
        save_params({"params": dec_params}, module_path(run_dir, name, "G"))
        del dec_sd, dec_params

    for tag, width in (("GPH", 2 * latent), ("DPH", latent)):
        if not os.path.exists(_pt(tag)):
            continue
        head_sd = _load_state_dict(_pt(tag))
        if tag == "DPH" and tuple(head_sd["0.weight"].shape) == (latent, 2 * latent):
            # The reference V4 declares its discriminator projection head
            # Linear(2·latent → latent) but would feed it the latent-wide
            # sup_fv: that path cannot run, so the head stays at its init in
            # every reference V4 folder. The usable head is latent → latent.
            print(
                f"[import] skipping {tag}: the reference's dead "
                "discriminator projection head (declared "
                f"{2 * latent}->{latent}, never executable — "
                "PCAA_ablation.py:783-786 vs :934-936)"
            )
            continue
        head_params = torch_sequential_head_to_flax(head_sd)
        _head_roundtrip(head_sd, head_params, tag)
        _assert_matches_config({"params": head_params}, _declared_shapes(
            lambda w=width: ProjectionHead(latent, w), head_variables), tag)
        save_params({"params": head_params}, module_path(run_dir, name, tag))

    if os.path.exists(_pt("ML")):  # V1's learned-centroid mean learner
        _write_mean_learner(_pt("ML"), n, latent, module_path(run_dir, name, "ML"))

    means = torch.load(os.path.join(ref_run_dir, "discriminator_means.pt"), map_location="cpu",
                       weights_only=True)
    means = np.asarray(means.detach().cpu().numpy(), dtype=np.float32)
    if means.shape != (n, latent):
        raise ValueError(
            f"discriminator_means shape {means.shape} does not match the "
            f"config-declared ({n}, {latent})"
        )
    np.save(os.path.join(run_dir, "discriminator_means.npy"), means)


def _write_mean_learner(pt: str, n: int, latent: int, out: str) -> None:
    ml_sd = _load_state_dict(pt)
    mp, ms = torch_mean_learner_to_flax(ml_sd)
    ml_vars = {"params": mp, "batch_stats": ms}
    _assert_roundtrip(ml_sd, mean_learner_state_dict(ml_vars), "ML")
    _assert_matches_config(ml_vars, _declared_shapes(
        lambda: GaussianMeanLearner(n, latent), mean_learner_variables), "ML")
    save_params(ml_vars, out)


def import_orced_run(ref_run_dir: str, out_models: str, **cfg_overrides) -> Config:
    """A reference ORCED run folder (E, G, ML) → a run folder under ``out_models``."""
    return _import_run(ref_run_dir, out_models, _write_orced_modules, cfg_overrides)


def _write_orced_modules(ref_run_dir: str, cfg: Config, name: str, run_dir: str) -> None:
    n, latent = cfg.n_classes, cfg.SUP_LATENT_DIM
    enc_sd = _load_state_dict(os.path.join(ref_run_dir, f"{name}_E.pt"))
    p, s = torch_orced_encoder_to_flax(enc_sd)
    enc_vars = {"params": p, "batch_stats": s}
    _assert_roundtrip(enc_sd, orced_encoder_state_dict(enc_vars), "E")
    _assert_matches_config(enc_vars, _declared_shapes(lambda: ORCEDEncoder(
        n, in_features=cfg.NFEATURES, sup_latent_dim=latent,
        pointnet_out_dim=cfg.POINTNET_OUT_DIM, dtc_filters=tuple(cfg.DTC_FILTERS)),
        encoder_variables), "E")
    save_params(enc_vars, module_path(run_dir, name, "E"))

    dec_sd = _load_state_dict(os.path.join(ref_run_dir, f"{name}_G.pt"))
    dec_params = torch_orced_decoder_to_flax(dec_sd, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES)
    _assert_roundtrip(
        dec_sd,
        orced_decoder_state_dict({"params": dec_params}, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES),
        "G", allowed_extra=("bn1.", "bn2.", "bn3.", "bn4."),
    )
    _assert_matches_config({"params": dec_params}, _declared_shapes(
        lambda: CGDecoder(latent, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES), decoder_variables), "G")
    save_params({"params": dec_params}, module_path(run_dir, name, "G"))
    del dec_sd, dec_params

    _write_mean_learner(os.path.join(ref_run_dir, f"{name}_ML.pt"), n, latent,
                        module_path(run_dir, name, "ML"))


def _run_name(ref_run_dir: str) -> str:
    """The checkpoints' stem: config.pkl's MODEL_NAME, not the folder's name."""
    ref_cfg = load_reference_config(os.path.join(ref_run_dir, "config.pkl"))
    name = ref_cfg.get("MODEL_NAME") or os.path.basename(os.path.normpath(ref_run_dir))
    if not os.path.exists(os.path.join(ref_run_dir, f"{name}_E.pt")):
        raise FileNotFoundError(
            f"{ref_run_dir} holds no {name}_E.pt — config.pkl declares "
            f"MODEL_NAME={name!r} but the folder's checkpoints do not "
            "follow that stem (mixed-up folder?)"
        )
    return name


def detect_kind(ref_run_dir: str) -> str:
    """``"pcaa"`` if the run saved a discriminator (every PCAA variant
    does), else ``"orced"``."""
    name = _run_name(ref_run_dir)
    return "pcaa" if os.path.exists(os.path.join(ref_run_dir, f"{name}_D.pt")) else "orced"


def import_reference_run(ref_run_dir: str, out_models: str, kind: str = "auto",
                         **cfg_overrides) -> Config:
    if kind == "auto":
        kind = detect_kind(ref_run_dir)
    fn = import_pcaa_run if kind == "pcaa" else import_orced_run
    return fn(ref_run_dir, out_models, **cfg_overrides)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref-run", nargs="+", required=True,
                    help="one or more reference run folders (models/<NAME>)")
    ap.add_argument("--out-models", default="models_imported")
    ap.add_argument("--kind", choices=("auto", "pcaa", "orced"), default="auto")
    ap.add_argument("--data-path", default=None, help="override DATA_PATH in the saved config")
    ap.add_argument("--gen-data-path", default=None,
                    help="override GEN_DATA_PATH in the saved config")
    args = ap.parse_args(argv)

    overrides = {}
    if args.data_path:
        overrides["DATA_PATH"] = args.data_path
    if args.gen_data_path:
        overrides["GEN_DATA_PATH"] = args.gen_data_path

    for ref_run in args.ref_run:
        kind = detect_kind(ref_run) if args.kind == "auto" else args.kind
        cfg = import_reference_run(ref_run, args.out_models, kind, **overrides)
        print(f"[import] {ref_run} → {cfg.run_dir()} ({kind}, "
              f"{cfg.n_classes} classes, round-trip verified)")


if __name__ == "__main__":
    main()
