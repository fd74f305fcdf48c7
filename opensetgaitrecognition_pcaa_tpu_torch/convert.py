"""JAX parameter trees ↔ the port's ``state_dict``.

The JAX package stores a module's weights as ``{"params": ...,
"batch_stats": ...}`` (``<NAME>_<TAG>.msgpack``): the PCAA encoder,
decoder, critic, heads and V1's mean learner (``E``, ``G``, ``D``,
``GPH``, ``DPH``, ``ML``) and the ORCED encoder, decoder and mean learner
(``E``, ``G``, ``ML``). A training state
(parameters, running statistics and Adam moments) maps across whole:
``pcaa_state_from_jax``/``pcaa_state_to_jax`` and
``orced_state_from_jax``/``orced_state_to_jax``. The maps follow
``tools/transplant.py``:

- a dense kernel ``(in, out)`` is the transpose of ``Linear.weight``;
- a conv kernel ``(k, in, out)`` is the ``Conv1d`` weight ``(out, in, k)``;
- BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` map
  across as they are.

Adam moments have their parameter's shape, so they map as the parameter
does; a factored second moment (``FACTORED_ADAM_NU``, ``{"r", "c"}`` at
the kernel's place in JAX ``adam_factored``'s tree) maps across as it is,
its factors being named for the JAX layout (``train/optim.py``). Both
directions are exact: values are copied, never recomputed. A
bf16 leaf (the moments of a bf16 run; numpy holds it as
``ml_dtypes.bfloat16``, whose dtype name is "bfloat16") becomes a
``torch.bfloat16`` tensor of the same bits; going back, a bf16 tensor
becomes an f32 array of the same values, since the port does not import
ml_dtypes.
A collection missing from the tree (``batch_stats`` of a moment tree) is
skipped, and so is a key missing from the ``state_dict``. The state_dict
of a module built on the meta device maps to the tree of its shapes (a
tuple at each leaf), with no values read or made.
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


# the heads of the two encoders, in the order of their JAX tree
_ORCED_HEADS = ("MLP_mu", "MLP_logvar", "MLP_classification")


def _encoder_heads(names, use_projection_head: bool):
    """``CGEncoder``'s heads, or ``ORCEDEncoder``'s where ``names`` (the
    JAX params or the ``state_dict`` keys' first parts) hold ``MLP_mu``."""
    if "MLP_mu" in names:
        return _ORCED_HEADS
    return ("MLP_sup1",) + (("MLP_head",) if use_projection_head else ()) + ("MLP_sup2",)


def _encoder_entries(n_tcn: int, heads) -> Iterator[_Entry]:
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
    for name in heads:
        yield from _dense((name,), name)


def _dense_stack_entries(n_layers: int) -> Iterator[_Entry]:
    """``CGDecoder`` (5 layers) and ``CGDiscriminator`` (3): flax names
    ``TorchDense_k``, port keys ``dense.k``."""
    for i in range(n_layers):
        yield from _dense((f"TorchDense_{i}",), f"dense.{i}")


def _head_entries() -> Iterator[_Entry]:
    yield from _dense(("TorchDense_0",), "dense")


def _mean_learner_entries() -> Iterator[_Entry]:
    """``GaussianMeanLearner``: 4 dense layers, BatchNorm after the first 3."""
    for i in range(4):
        yield from _dense((f"TorchDense_{i}",), f"dense.{i}")
    for i in range(3):
        yield from _norm((f"TorchBatchNorm_{i}",), f"norm.{i}")


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
        a = np.array(_relayout(np.asarray(leaf), layout), order="C")  # writable copy
        if a.dtype.name == "bfloat16":
            out[key] = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            out[key] = torch.from_numpy(a)
    return out


def _to_variables(state_dict: Dict[str, torch.Tensor], entries) -> Dict:
    tree: Dict = {}
    for path, key, layout in entries:
        if key not in state_dict:
            continue
        t = state_dict[key].detach()
        if t.is_meta:  # shapes only: both layouts reverse the axes
            leaf = tuple(reversed(t.shape)) if layout != "plain" else tuple(t.shape)
        else:
            t = t.cpu()
            a = _relayout((t.float() if t.dtype == torch.bfloat16 else t).numpy(), layout)
            leaf = np.array(a, order="C")  # a copy: never a view of the tensor
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return tree


def encoder_state_dict(enc_vars: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``CGEncoder`` or ``ORCEDEncoder`` variables (``<NAME>_E``) → the
    port's state_dict of the same module."""
    params = enc_vars["params"]
    heads = _encoder_heads(params, "MLP_head" in params)
    return _to_state_dict(enc_vars, _encoder_entries(_n_tcn(enc_vars), heads))


def _encoder_entries_of(state_dict: Dict[str, torch.Tensor]) -> Iterator[_Entry]:
    """The entries of the encoder whose state_dict this is."""
    n_tcn = len({k.split(".")[3] for k in state_dict if k.startswith("backbone.tcn.layers.")})
    names = {k.split(".")[0] for k in state_dict}
    return _encoder_entries(n_tcn, _encoder_heads(names, "MLP_head" in names))


def encoder_variables(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """The port's ``CGEncoder`` or ``ORCEDEncoder`` state_dict → JAX
    variables (numpy leaves); ``ValueError`` for any other encoder's, such
    as a P4Transformer or DGCNN encoder's (``models/p4t.py``,
    ``models/dgcnn.py``): without ``backbone.`` keys the JAX package has no
    tree for it."""
    if not any(k.startswith("backbone.") for k in state_dict):
        raise ValueError("an encoder other than the PointNet encoder (no backbone.* keys) has no "
                         "JAX tree: its run folder, resume state and export are not written "
                         "(train it through build_pcaa(..., encoder=...) and make_epoch_fns)")
    return _to_variables(state_dict, _encoder_entries_of(state_dict))


def decoder_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``CGDecoder`` or ``ORCEDDecoder`` variables (``<NAME>_G``) → the
    port's state_dict."""
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


def mean_learner_state_dict(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``GaussianMeanLearner`` variables (``<NAME>_ML``) → the port's
    state_dict."""
    return _to_state_dict(variables, _mean_learner_entries())


def mean_learner_variables(state_dict: Dict[str, torch.Tensor]) -> Dict:
    return _to_variables(state_dict, _mean_learner_entries())


# (module key in the port's generator/critic ModuleDict = key in the JAX
# params_g/params_d tree, state_dict → variables, variables → state_dict);
# a variant holds only some of them (train/pcaa.py::PCAAModules)
_GENERATOR = (
    ("encoder", encoder_variables, encoder_state_dict),
    ("dec_head", head_variables, head_state_dict),
    ("decoder", decoder_variables, decoder_state_dict),
)
_CRITIC = (
    ("discriminator", discriminator_variables, discriminator_state_dict),
    ("disc_head", head_variables, head_state_dict),
)
# V1's frozen mean learner: JAX ml_params and batch_stats["mean_learner"]
_MEAN_LEARNER = (("mean_learner", mean_learner_variables, mean_learner_state_dict),)
_PCAA_SIDES = (("g", _GENERATOR), ("d", _CRITIC), ("ml", _MEAN_LEARNER))
# the ORCED modules: one Adam over all three (keys of the JAX ORCEDState trees)
_ORCED = (
    ("encoder", encoder_variables, encoder_state_dict),
    ("decoder", decoder_variables, decoder_state_dict),
    ("mean_learner", mean_learner_variables, mean_learner_state_dict),
)


def _sub(state_dict: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


# each module's entries, from its own state_dict
_MODULE_ENTRIES = {
    "encoder": _encoder_entries_of,
    "decoder": lambda sd: _dense_stack_entries(5),
    "discriminator": lambda sd: _dense_stack_entries(3),
    "dec_head": lambda sd: _head_entries(),
    "disc_head": lambda sd: _head_entries(),
    "mean_learner": lambda sd: _mean_learner_entries(),
}


def leaf_entries(state_dict: Dict) -> Dict[str, Tuple[str, Tuple[str, ...], str]]:
    """Each key of a ``PCAAModules`` (``g.encoder.…``, ``d.…``, ``ml.…``)
    or ``ORCEDModules`` (``encoder.…``) state_dict → (its module's key, its
    path in that module's JAX variables, its layout: "dense", "conv" or
    "plain"). A key of no table is left out."""
    prefixes = [(f"{side}.{name}.", name) for side, table in _PCAA_SIDES for name, _, _ in table]
    prefixes += [(f"{name}.", name) for name, _, _ in _ORCED]
    out = {}
    for prefix, name in prefixes:
        sub = _sub(state_dict, prefix)
        if sub:
            for path, key, layout in _MODULE_ENTRIES[name](sub):
                if key in sub:
                    out[prefix + key] = (name, path, layout)
    return out


def module_variables(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """A ``PCAAModules`` state_dict (``g.encoder.…``, ``d.discriminator.…``,
    ``ml.mean_learner.…``) → per-module JAX variables of the modules it
    holds: ``{"encoder": {"params", "batch_stats"}, "dec_head": {"params"},
    "decoder": …, "discriminator": …, "disc_head": …, "mean_learner":
    {"params", "batch_stats"}}``."""
    out = {}
    for side, table in _PCAA_SIDES:
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


@torch.no_grad()
def _refresh_copies(cache: Dict[str, torch.Tensor], modules) -> None:
    """Round the loaded weights into a trainer's bf16 weight copies
    (``BF16_WEIGHT_CACHE``), keyed by parameter name in ``modules``."""
    for name, w16 in cache.items():
        w16.copy_(modules.get_parameter(name))


def _factored_paths(moments: Dict, table) -> Dict[str, Tuple[str, ...]]:
    """Each factored second moment of ``moments`` (a dict at a dense
    kernel's key) → its path in the JAX moment tree (module key, then the
    kernel's path in the module's params)."""
    out = {}
    for name, _, _ in table:
        sub = _sub(moments, f"{name}.")
        if sub:
            for path, key, _ in _MODULE_ENTRIES[name](sub):
                if isinstance(sub.get(key), dict):
                    out[f"{name}.{key}"] = (name,) + path[1:]
    return out


def _at(tree: Dict, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def _load_moments(moments: Dict, jax_tree: Dict, table, what: str) -> None:
    """Copy a JAX moment tree into the port's moments in place, factored
    leaves as their ``{"r", "c"}``."""
    factored = _factored_paths(moments, table)
    # a factored leaf converts through a stand-in of its kernel's shape
    plain = {k: (v if k not in factored else None) for k, v in moments.items()}
    jax_tree = _copy_tree(jax_tree)
    for k, path in factored.items():
        rc = _at(jax_tree, path[:-1])
        r, c = (np.asarray(rc[path[-1]][f]) for f in ("r", "c"))
        rc[path[-1]] = np.zeros((len(r), len(c)), np.float32)
        moments[k]["r"].copy_(torch.from_numpy(np.array(r)).to(moments[k]["r"].device))
        moments[k]["c"].copy_(torch.from_numpy(np.array(c)).to(moments[k]["c"].device))
    sd = _side_state_dict(jax_tree, table)
    if set(sd) != set(plain):
        raise ValueError(f"{what} leaves differ from the port's parameters")
    for name, value in sd.items():
        if name not in factored:
            moments[name].copy_(value.to(moments[name].device))


def _copy_tree(tree):
    return {k: _copy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def _moment_tree(moments: Dict, table) -> Dict:
    """The port's moments → the JAX moment tree, factored leaves as their
    ``{"r", "c"}``."""
    factored = _factored_paths(moments, table)
    stand_in = {k: (torch.zeros(len(v["c"]), len(v["r"])) if k in factored else v)
                for k, v in moments.items()}
    tree = _side_tree(stand_in, table)[0]
    for k, path in factored.items():
        _at(tree, path[:-1])[path[-1]] = {f: moments[k][f].detach().cpu().numpy()
                                          for f in ("r", "c")}
    return tree


def pcaa_state_from_jax(tree: Dict, mods, state) -> None:
    """Load a JAX ``PCAAState`` into the port's modules and optimizer
    state, in place, on the modules' device.

    ``tree`` has numpy leaves: ``params_g``, ``params_d``, ``batch_stats``,
    ``opt_g`` and ``opt_d`` (each ``{"count", "mu", "nu"}``, the Adam
    state of ``opt[0]``), ``centroids`` and, for V1, ``ml_params``. The
    state's bf16 weight copies, if any, are refreshed from the loaded
    weights.
    """
    g_sd = _side_state_dict(tree["params_g"], _GENERATOR, tree["batch_stats"])
    mods.g.load_state_dict(g_sd)
    mods.d.load_state_dict(_side_state_dict(tree["params_d"], _CRITIC))
    ml = {"mean_learner": tree["ml_params"]} if tree.get("ml_params") else {}
    mods.ml.load_state_dict(_side_state_dict(ml, _MEAN_LEARNER, tree["batch_stats"]))
    device = state.centroids.device
    for opt, side, table in ((state.opt_g, "g", _GENERATOR), (state.opt_d, "d", _CRITIC)):
        t = tree[f"opt_{side}"]
        opt.count = int(np.asarray(t["count"]))
        for moments, key in ((opt.mu, "mu"), (opt.nu, "nu")):
            _load_moments(moments, t[key], table, f"opt_{side}.{key}")
    _refresh_copies(state.cast_g, mods.g)
    state.centroids.copy_(torch.tensor(np.asarray(tree["centroids"]), device=device))


def orced_module_variables(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """An ``ORCEDModules`` state_dict (``encoder.…``, ``decoder.…``,
    ``mean_learner.…``) → per-module JAX variables, the trees of the
    ``E``, ``G`` and ``ML`` files."""
    return {name: to_vars(_sub(state_dict, f"{name}.")) for name, to_vars, _ in _ORCED}


def orced_state_from_jax(tree: Dict, mods, state) -> None:
    """Load a JAX ``ORCEDState`` into the port's ``ORCEDModules`` and Adam
    state, in place, on the modules' device.

    ``tree`` has numpy leaves: ``params`` and ``batch_stats`` (keyed
    ``encoder``, ``decoder``, ``mean_learner``) and ``opt``, the
    ``{"count", "mu", "nu"}`` of the Adam state."""
    mods.load_state_dict(_side_state_dict(tree["params"], _ORCED, tree["batch_stats"]))
    opt = state.opt
    opt.count = int(np.asarray(tree["opt"]["count"]))
    for moments, key in ((opt.mu, "mu"), (opt.nu, "nu")):
        _load_moments(moments, tree["opt"][key], _ORCED, f"opt.{key}")
    _refresh_copies(state.cast, mods)


def orced_state_to_jax(mods, state) -> Dict:
    """The port's ORCED modules and Adam state → the tree that
    ``orced_state_from_jax`` reads (numpy leaves)."""
    params, stats = _side_tree(mods.state_dict(), _ORCED)
    opt = state.opt
    return {"params": params, "batch_stats": stats, "opt": {
        "count": np.asarray(opt.count, np.int32),
        "mu": _side_tree(opt.mu, _ORCED)[0],
        "nu": _moment_tree(opt.nu, _ORCED),
    }}


def pcaa_state_to_jax(mods, state) -> Dict:
    """The port's modules and optimizer state → the tree that
    ``pcaa_state_from_jax`` reads (numpy leaves); ``ml_params`` only where
    the variant has a mean learner."""
    params_g, stats = _side_tree(mods.g.state_dict(), _GENERATOR)
    params_d, _ = _side_tree(mods.d.state_dict(), _CRITIC)
    tree = {"params_g": params_g, "params_d": params_d, "batch_stats": stats,
            "centroids": state.centroids.cpu().numpy()}
    ml_params, ml_stats = _side_tree(mods.ml.state_dict(), _MEAN_LEARNER)
    if ml_params:
        tree["ml_params"] = ml_params["mean_learner"]
        stats.update(ml_stats)
    for opt, side, table in ((state.opt_g, "g", _GENERATOR), (state.opt_d, "d", _CRITIC)):
        tree[f"opt_{side}"] = {
            "count": np.asarray(opt.count, np.int32),
            "mu": _side_tree(opt.mu, table)[0],
            "nu": _moment_tree(opt.nu, table),
        }
    return tree
