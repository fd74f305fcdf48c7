"""Run-folder trees ↔ the reference's torch ``state_dict``s.

The port's copy of ``tools/transplant.py``. The forward maps take a
module's tree as ``train/run_folder.py::load_params`` returns it (nested
dicts of numpy arrays: ``{"params": ..., "batch_stats": ...}``) and give
the ``state_dict`` of the reference's torch module; the inverse maps
(``torch_*_to_flax``) give the tree back. Every function returns the
same arrays and tensors, bit for bit, as its namesake there. Layouts:

- a ``Conv2d(1×1)`` weight ``(out, in, 1, 1)`` is the transpose of the
  PointNet dense kernel ``(in, out)``;
- a ``Conv1d`` weight ``(out, in, k)`` is the TCN conv kernel ``(k, in,
  out)`` reversed;
- BatchNorm ``weight``/``bias``/``running_mean``/``running_var`` are the
  tree's ``scale``/``bias`` and ``batch_stats`` ``mean``/``var``;
- the reference reads the decoder's flat output as ``(C, T, N)``, the
  run folder's modules as ``(T, N, C)``, so the last decoder layer's
  output units are permuted (``decoder_output_permutation``).

The decoder's last layer is the largest array at the published widths
(9000 × 18000 f32): each direction copies it once for the permutation,
and the forward map's tensor shares that copy's memory.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _bn_entries(prefix: str, scale_bias: dict, stats: dict) -> dict:
    return {
        f"{prefix}.weight": _t(scale_bias["scale"]),
        f"{prefix}.bias": _t(scale_bias["bias"]),
        f"{prefix}.running_mean": _t(stats["mean"]),
        f"{prefix}.running_var": _t(stats["var"]),
        f"{prefix}.num_batches_tracked": torch.tensor(0, dtype=torch.long),
    }


def _linear_entries(prefix: str, dense: dict) -> dict:
    return {
        f"{prefix}.weight": _t(np.asarray(dense["kernel"]).T),
        f"{prefix}.bias": _t(dense["bias"]),
    }


def _backbone_entries(params: dict, stats: dict) -> dict:
    """The ``pc_block`` and ``tc_block`` entries of both encoders."""
    sd = {}
    pn_p = params["GaitBackbone_0"]["PointNetBlock_0"]
    pn_s = stats["GaitBackbone_0"]["PointNetBlock_0"]
    for i in range(4):
        w = np.asarray(pn_p[f"TorchDense_{i}"]["kernel"]).T  # (out, in)
        sd[f"pc_block.pointnet{i + 1}.module.0.weight"] = _t(w[:, :, None, None])
        sd[f"pc_block.pointnet{i + 1}.module.0.bias"] = _t(pn_p[f"TorchDense_{i}"]["bias"])
        sd.update(_bn_entries(f"pc_block.pointnet{i + 1}.module.1",
                              pn_p[f"TorchBatchNorm_{i}"], pn_s[f"TorchBatchNorm_{i}"]))
    tc_p = params["GaitBackbone_0"]["TemporalConvBlock_0"]
    tc_s = stats["GaitBackbone_0"]["TemporalConvBlock_0"]
    # the TCN's depth is len(DTC_FILTERS), read off the tree
    n_tcn = sum(k.startswith("CausalDilatedConv1d_") for k in tc_p)
    for i in range(n_tcn):
        conv = tc_p[f"CausalDilatedConv1d_{i}"]["Conv_0"]
        sd[f"tc_block.dtc{i + 1}.conv1d.weight"] = _t(np.asarray(conv["kernel"]).transpose(2, 1, 0))
        sd[f"tc_block.dtc{i + 1}.conv1d.bias"] = _t(conv["bias"])
        sd.update(_bn_entries(f"tc_block.dtc{i + 1}.batch_norm",
                              tc_p[f"CausalDilatedConv1d_{i}"]["TorchBatchNorm_0"],
                              tc_s[f"CausalDilatedConv1d_{i}"]["TorchBatchNorm_0"]))
    return sd


def cg_encoder_state_dict(enc_vars: dict, use_projection_head: bool) -> dict:
    """``CGEncoder`` tree → the reference ``models.CGEncoder`` state_dict."""
    p, s = enc_vars["params"], enc_vars["batch_stats"]
    sd = _backbone_entries(p, s)
    sd.update(_linear_entries("MLP_sup1.0", p["MLP_sup1"]))
    if use_projection_head:
        sd.update(_linear_entries("MLP_head.0", p["MLP_head"]))
    sd.update(_linear_entries("MLP_sup2.0", p["MLP_sup2"]))
    return sd


def orced_encoder_state_dict(enc_vars: dict) -> dict:
    """``ORCEDEncoder`` tree → the reference ``models.ORCEDEncoder`` state_dict."""
    p, s = enc_vars["params"], enc_vars["batch_stats"]
    sd = _backbone_entries(p, s)
    sd.update(_linear_entries("MLP_mu.0", p["MLP_mu"]))
    sd.update(_linear_entries("MLP_logvar.0", p["MLP_logvar"]))
    sd.update(_linear_entries("MLP_classification.0", p["MLP_classification"]))
    return sd


def decoder_output_permutation(nsteps: int, nmax: int, nfeatures: int) -> np.ndarray:
    """``perm[j_torch] = j_fw``: permuting the last layer's output units by
    this makes the reference decoder, which reads its flat output as
    ``(C, T, N)``, emit the clouds the ``(T, N, C)`` decoder emits."""
    c, t, n = np.meshgrid(np.arange(nfeatures), np.arange(nsteps), np.arange(nmax),
                          indexing="ij")
    return (t * nmax * nfeatures + n * nfeatures + c).ravel()


def orced_decoder_state_dict(dec_vars: dict, nsteps: int, nmax: int, nfeatures: int) -> dict:
    """``CGDecoder``/``ORCEDDecoder`` tree → the reference decoder's
    ``dense{1..5}`` entries, the last layer's output units permuted; the
    forward-unused ``bn{1..4}`` entries come from
    ``decoder_bn_placeholder_entries``."""
    p = dec_vars["params"]
    sd = {}
    for i in range(4):
        sd.update(_linear_entries(f"dense{i + 1}", p[f"TorchDense_{i}"]))
    w = np.asarray(p["TorchDense_4"]["kernel"], dtype=np.float32).T  # (out, in), fw unit order
    b = np.asarray(p["TorchDense_4"]["bias"])
    perm = decoder_output_permutation(nsteps, nmax, nfeatures)
    # the gather is a fresh C-order array: the tensor takes its memory
    sd["dense5.weight"] = torch.from_numpy(np.ascontiguousarray(w[perm]))
    sd["dense5.bias"] = _t(b[perm])
    return sd


def mean_learner_state_dict(ml_vars: dict) -> dict:
    """``GaussianMeanLearner`` tree → the reference ``models.GaussianMeanLearner``
    state_dict (``model.{0,3,6}`` Linear, ``model.{1,4,7}`` BatchNorm,
    ``model.9`` Linear)."""
    p, s = ml_vars["params"], ml_vars["batch_stats"]
    sd = {}
    for i, li in enumerate((0, 3, 6)):
        sd.update(_linear_entries(f"model.{li}", p[f"TorchDense_{i}"]))
        sd.update(_bn_entries(f"model.{li + 1}", p[f"TorchBatchNorm_{i}"],
                              s[f"TorchBatchNorm_{i}"]))
    sd.update(_linear_entries("model.9", p["TorchDense_3"]))
    return sd


def cg_discriminator_state_dict(params: dict) -> dict:
    """``CGDiscriminator`` params → the reference ``models.CGDiscriminator``
    state_dict (``Sequential(Linear, ELU, Linear, ELU, Linear)`` as ``model.``)."""
    sd = {}
    for i, li in enumerate((0, 2, 4)):
        sd.update(_linear_entries(f"model.{li}", params[f"TorchDense_{i}"]))
    return sd


def sequential_head_state_dict(params: dict) -> dict:
    """``ProjectionHead`` params → the reference's ``Sequential(Linear, ELU)``
    head state_dict."""
    return _linear_entries("0", params["TorchDense_0"])


def decoder_bn_placeholder_entries(dec_mlp_size: int) -> dict:
    """Default-initialized ``bn1..bn4`` entries (weight 1, bias 0, mean 0,
    var 1) for a reference decoder: it declares four BatchNorm1d modules
    that its forward never runs, and a strict ``load_state_dict`` asks for
    their keys."""
    sd = {}
    for i in range(1, 5):
        width = dec_mlp_size // (2 ** (5 - i))
        sd[f"bn{i}.weight"] = torch.ones(width)
        sd[f"bn{i}.bias"] = torch.zeros(width)
        sd[f"bn{i}.running_mean"] = torch.zeros(width)
        sd[f"bn{i}.running_var"] = torch.ones(width)
        sd[f"bn{i}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


# ---------------------------------------------------------------------------
# the inverse maps: reference state_dicts → run-folder trees
# ---------------------------------------------------------------------------


def _n(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def _dense_tree(sd: dict, prefix: str) -> dict:
    return {"kernel": _n(sd[f"{prefix}.weight"]).T, "bias": _n(sd[f"{prefix}.bias"])}


def _torch_backbone_to_flax(sd: dict):
    """``pc_block`` + ``tc_block`` entries → the ``GaitBackbone_0``
    ``(params, batch_stats)`` subtrees of both encoders."""
    pn_p, pn_s, tc_p, tc_s = {}, {}, {}, {}
    for i in range(4):
        pre = f"pc_block.pointnet{i + 1}.module"
        pn_p[f"TorchDense_{i}"] = {
            "kernel": _n(sd[f"{pre}.0.weight"])[:, :, 0, 0].T,
            "bias": _n(sd[f"{pre}.0.bias"]),
        }
        pn_p[f"TorchBatchNorm_{i}"] = {
            "scale": _n(sd[f"{pre}.1.weight"]),
            "bias": _n(sd[f"{pre}.1.bias"]),
        }
        pn_s[f"TorchBatchNorm_{i}"] = {
            "mean": _n(sd[f"{pre}.1.running_mean"]),
            "var": _n(sd[f"{pre}.1.running_var"]),
        }
    n_tcn = len({k.split(".")[1] for k in sd if k.startswith("tc_block.dtc")})
    for i in range(n_tcn):
        pre = f"tc_block.dtc{i + 1}"
        tc_p[f"CausalDilatedConv1d_{i}"] = {
            "Conv_0": {
                "kernel": _n(sd[f"{pre}.conv1d.weight"]).transpose(2, 1, 0),
                "bias": _n(sd[f"{pre}.conv1d.bias"]),
            },
            "TorchBatchNorm_0": {
                "scale": _n(sd[f"{pre}.batch_norm.weight"]),
                "bias": _n(sd[f"{pre}.batch_norm.bias"]),
            },
        }
        tc_s[f"CausalDilatedConv1d_{i}"] = {
            "TorchBatchNorm_0": {
                "mean": _n(sd[f"{pre}.batch_norm.running_mean"]),
                "var": _n(sd[f"{pre}.batch_norm.running_var"]),
            }
        }
    params = {"PointNetBlock_0": pn_p, "TemporalConvBlock_0": tc_p}
    batch_stats = {"PointNetBlock_0": pn_s, "TemporalConvBlock_0": tc_s}
    return params, batch_stats


def torch_cg_encoder_to_flax(sd: dict, use_projection_head: bool):
    """The reference ``CGEncoder`` state_dict → ``(params, batch_stats)``."""
    bb_p, bb_s = _torch_backbone_to_flax(sd)
    params = {
        "GaitBackbone_0": bb_p,
        "MLP_sup1": _dense_tree(sd, "MLP_sup1.0"),
        "MLP_sup2": _dense_tree(sd, "MLP_sup2.0"),
    }
    if use_projection_head:
        params["MLP_head"] = _dense_tree(sd, "MLP_head.0")
    return params, {"GaitBackbone_0": bb_s}


def torch_cg_decoder_to_flax(sd: dict, nsteps: int, nmax: int, nfeatures: int):
    """The reference decoder's ``dense{1..5}`` → decoder params, the last
    layer's output units put back in ``(T, N, C)`` order."""
    params = {f"TorchDense_{i}": _dense_tree(sd, f"dense{i + 1}") for i in range(4)}
    w_t = _n(sd["dense5.weight"])  # (out_torch, in)
    b_t = _n(sd["dense5.bias"])
    perm = decoder_output_permutation(nsteps, nmax, nfeatures)
    # column-major (in, out): each unit's weights are one contiguous copy
    k = np.empty_like(w_t.T)
    k[:, perm] = w_t.T
    b = np.empty_like(b_t)
    b[perm] = b_t
    params["TorchDense_4"] = {"kernel": k, "bias": b}
    return params


def torch_orced_encoder_to_flax(sd: dict):
    """The reference ``ORCEDEncoder`` state_dict → ``(params, batch_stats)``."""
    bb_p, bb_s = _torch_backbone_to_flax(sd)
    params = {
        "GaitBackbone_0": bb_p,
        "MLP_mu": _dense_tree(sd, "MLP_mu.0"),
        "MLP_logvar": _dense_tree(sd, "MLP_logvar.0"),
        "MLP_classification": _dense_tree(sd, "MLP_classification.0"),
    }
    return params, {"GaitBackbone_0": bb_s}


def torch_orced_decoder_to_flax(sd: dict, nsteps: int, nmax: int, nfeatures: int):
    """The reference ``ORCEDDecoder``: the CG decoder's keys and permutation."""
    return torch_cg_decoder_to_flax(sd, nsteps, nmax, nfeatures)


def torch_mean_learner_to_flax(sd: dict):
    """The reference ``GaussianMeanLearner`` state_dict → ``(params, batch_stats)``."""
    params, stats = {}, {}
    for i, li in enumerate((0, 3, 6)):
        params[f"TorchDense_{i}"] = _dense_tree(sd, f"model.{li}")
        params[f"TorchBatchNorm_{i}"] = {
            "scale": _n(sd[f"model.{li + 1}.weight"]),
            "bias": _n(sd[f"model.{li + 1}.bias"]),
        }
        stats[f"TorchBatchNorm_{i}"] = {
            "mean": _n(sd[f"model.{li + 1}.running_mean"]),
            "var": _n(sd[f"model.{li + 1}.running_var"]),
        }
    params["TorchDense_3"] = _dense_tree(sd, "model.9")
    return params, stats


def torch_cg_discriminator_to_flax(sd: dict):
    """The reference ``CGDiscriminator`` state_dict → params."""
    return {f"TorchDense_{i}": _dense_tree(sd, f"model.{li}") for i, li in enumerate((0, 2, 4))}


def torch_sequential_head_to_flax(sd: dict):
    """The reference's ``Sequential(Linear, ELU)`` head → ``ProjectionHead`` params."""
    return {"TorchDense_0": _dense_tree(sd, "0")}
