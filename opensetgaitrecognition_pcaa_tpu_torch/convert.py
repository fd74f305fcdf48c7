"""JAX parameter trees ↔ the port's ``state_dict``.

The JAX package stores a module's weights as ``{"params": ...,
"batch_stats": ...}`` (``<NAME>_<TAG>.msgpack``). The maps follow
``tools/transplant.py``:

- a dense kernel ``(in, out)`` is the transpose of ``Linear.weight``;
- a conv kernel ``(k, in, out)`` is the ``Conv1d`` weight ``(out, in, k)``;
- BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` map
  across as they are.

Adam moments have their parameter's shape, so they map as the parameter
does. Both directions are exact: values are copied, never recomputed.
A collection missing from the tree (``batch_stats`` of a moment tree) is
skipped, and so is a key missing from the ``state_dict``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

# (path in the JAX tree, state_dict key, layout)
_Entry = Tuple[Tuple[str, ...], str, str]


def _dense(path: Tuple[str, ...], key: str) -> Iterator[_Entry]:
    yield ("params",) + path + ("kernel",), f"{key}.weight", "dense"
    yield ("params",) + path + ("bias",), f"{key}.bias", "plain"


def _norm(path: Tuple[str, ...], key: str) -> Iterator[_Entry]:
    yield ("params",) + path + ("scale",), f"{key}.scale", "plain"
    yield ("params",) + path + ("bias",), f"{key}.bias", "plain"
    yield ("batch_stats",) + path + ("mean",), f"{key}.mean", "plain"
    yield ("batch_stats",) + path + ("var",), f"{key}.var", "plain"


def _encoder_entries(n_tcn: int, use_projection_head: bool) -> Iterator[_Entry]:
    pn = ("GaitBackbone_0", "PointNetBlock_0")
    for i in range(4):
        yield from _dense(pn + (f"TorchDense_{i}",), f"backbone.pointnet.dense.{i}")
        yield from _norm(pn + (f"TorchBatchNorm_{i}",), f"backbone.pointnet.norm.{i}")
    tcn = ("GaitBackbone_0", "TemporalConvBlock_0")
    for i in range(n_tcn):
        layer = tcn + (f"CausalDilatedConv1d_{i}",)
        key = f"backbone.tcn.layers.{i}"
        yield ("params",) + layer + ("Conv_0", "kernel"), f"{key}.conv.weight", "conv"
        yield ("params",) + layer + ("Conv_0", "bias"), f"{key}.conv.bias", "plain"
        yield from _norm(layer + ("TorchBatchNorm_0",), f"{key}.norm")
    heads = ["MLP_sup1"] + (["MLP_head"] if use_projection_head else []) + ["MLP_sup2"]
    for name in heads:
        yield from _dense((name,), name)


def _dense_stack_entries(n_layers: int) -> Iterator[_Entry]:
    """``CGDecoder`` (5 layers) and ``CGDiscriminator`` (3): flax names
    ``TorchDense_k``, port keys ``dense.k``."""
    for i in range(n_layers):
        yield from _dense((f"TorchDense_{i}",), f"dense.{i}")


def _head_entries() -> Iterator[_Entry]:
    yield from _dense(("TorchDense_0",), "dense")


def _n_tcn(enc_vars: Dict) -> int:
    tcn = enc_vars["params"]["GaitBackbone_0"]["TemporalConvBlock_0"]
    return sum(k.startswith("CausalDilatedConv1d_") for k in tcn)


def _relayout(a: np.ndarray, layout: str) -> np.ndarray:
    """JAX layout ↔ torch layout; each map is its own inverse."""
    if layout == "dense":
        return a.T
    if layout == "conv":
        return a.transpose(2, 1, 0)
    return a


def _to_state_dict(variables: Dict, entries) -> Dict[str, torch.Tensor]:
    out = {}
    for path, key, layout in entries:
        if path[0] not in variables:
            continue
        leaf = variables
        for p in path:
            leaf = leaf[p]
        a = _relayout(np.asarray(leaf), layout)
        out[key] = torch.from_numpy(np.array(a, order="C"))  # writable copy
    return out


def _to_variables(state_dict: Dict[str, torch.Tensor], entries) -> Dict:
    tree: Dict = {}
    for path, key, layout in entries:
        if key not in state_dict:
            continue
        a = _relayout(state_dict[key].detach().cpu().numpy(), layout)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return tree


def encoder_state_dict(enc_vars: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``CGEncoder`` variables → the port's ``CGEncoder`` state_dict."""
    use_head = "MLP_head" in enc_vars["params"]
    return _to_state_dict(enc_vars, _encoder_entries(_n_tcn(enc_vars), use_head))


def encoder_variables(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """The port's ``CGEncoder`` state_dict → JAX variables (numpy leaves)."""
    n_tcn = len({k.split(".")[3] for k in state_dict if k.startswith("backbone.tcn.layers.")})
    use_head = "MLP_head.weight" in state_dict
    return _to_variables(state_dict, _encoder_entries(n_tcn, use_head))


def decoder_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``CGDecoder`` variables (``<NAME>_G``) → the port's state_dict."""
    return _to_state_dict(variables, _dense_stack_entries(5))


def decoder_variables(state_dict: Dict[str, torch.Tensor]) -> Dict:
    return _to_variables(state_dict, _dense_stack_entries(5))


def discriminator_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``CGDiscriminator`` variables (``<NAME>_D``) → the port's state_dict."""
    return _to_state_dict(variables, _dense_stack_entries(3))


def discriminator_variables(state_dict: Dict[str, torch.Tensor]) -> Dict:
    return _to_variables(state_dict, _dense_stack_entries(3))


def head_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``ProjectionHead`` variables (``<NAME>_GPH``) → the port's state_dict."""
    return _to_state_dict(variables, _head_entries())


def head_variables(state_dict: Dict[str, torch.Tensor]) -> Dict:
    return _to_variables(state_dict, _head_entries())


# (module key in the port's generator/critic ModuleDict = key in the JAX
# params_g/params_d tree, state_dict → variables, variables → state_dict)
_GENERATOR = (
    ("encoder", encoder_variables, encoder_state_dict),
    ("dec_head", head_variables, head_state_dict),
    ("decoder", decoder_variables, decoder_state_dict),
)
_CRITIC = (("discriminator", discriminator_variables, discriminator_state_dict),)


def _sub(state_dict: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def module_variables(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """A ``PCAAModules`` state_dict (``g.encoder.…``, ``d.discriminator.…``)
    → per-module JAX variables ``{"encoder": {"params", "batch_stats"},
    "dec_head": {"params"}, "decoder": …, "discriminator": …}``."""
    out = {}
    for side, table in (("g", _GENERATOR), ("d", _CRITIC)):
        for name, to_vars, _ in table:
            sub = _sub(state_dict, f"{side}.{name}.")
            if sub:
                out[name] = to_vars(sub)
    return out


def _side_state_dict(params: Dict, table,
                     batch_stats: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    out = {}
    for name, _, to_sd in table:
        if name not in params:
            continue
        variables = {"params": params[name]}
        if batch_stats is not None and name in batch_stats:
            variables["batch_stats"] = batch_stats[name]
        out.update({f"{name}.{k}": v for k, v in to_sd(variables).items()})
    return out


def _side_tree(state_dict: Dict[str, torch.Tensor], table) -> Tuple[Dict, Dict]:
    params, stats = {}, {}
    for name, to_vars, _ in table:
        sub = _sub(state_dict, f"{name}.")
        if not sub:
            continue
        variables = to_vars(sub)
        params[name] = variables["params"]
        if "batch_stats" in variables:
            stats[name] = variables["batch_stats"]
    return params, stats


def pcaa_state_from_jax(tree: Dict, mods, state) -> None:
    """Load a JAX ``PCAAState`` into the port's modules and optimizer
    state, in place, on the modules' device.

    ``tree`` has numpy leaves: ``params_g``, ``params_d``, ``batch_stats``,
    ``opt_g`` and ``opt_d`` (each ``{"count", "mu", "nu"}``, the Adam
    state of ``opt[0]``) and ``centroids``.
    """
    g_sd = _side_state_dict(tree["params_g"], _GENERATOR, tree["batch_stats"])
    mods.g.load_state_dict(g_sd)
    mods.d.load_state_dict(_side_state_dict(tree["params_d"], _CRITIC))
    device = state.centroids.device
    for opt, side, table in ((state.opt_g, "g", _GENERATOR), (state.opt_d, "d", _CRITIC)):
        t = tree[f"opt_{side}"]
        opt.count = int(np.asarray(t["count"]))
        for moments, key in ((opt.mu, "mu"), (opt.nu, "nu")):
            sd = _side_state_dict(t[key], table)
            if set(sd) != set(moments):
                raise ValueError(f"opt_{side}.{key} leaves differ from the port's parameters")
            for name, value in sd.items():
                moments[name].copy_(value.to(device))
    state.centroids.copy_(torch.tensor(np.asarray(tree["centroids"]), device=device))


def pcaa_state_to_jax(mods, state) -> Dict:
    """The port's modules and optimizer state → the tree that
    ``pcaa_state_from_jax`` reads (numpy leaves)."""
    params_g, stats = _side_tree(mods.g.state_dict(), _GENERATOR)
    params_d, _ = _side_tree(mods.d.state_dict(), _CRITIC)
    tree = {"params_g": params_g, "params_d": params_d, "batch_stats": stats,
            "centroids": state.centroids.cpu().numpy()}
    for opt, side, table in ((state.opt_g, "g", _GENERATOR), (state.opt_d, "d", _CRITIC)):
        tree[f"opt_{side}"] = {
            "count": np.asarray(opt.count, np.int32),
            "mu": _side_tree(opt.mu, table)[0],
            "nu": _side_tree(opt.nu, table)[0],
        }
    return tree
