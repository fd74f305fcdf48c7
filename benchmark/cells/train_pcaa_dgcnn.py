"""Training PCAA V4 with a DGCNN encoder: ``train/pcaa.py::build_pcaa(...,
encoder=DGCNNSpec(...))`` and ``make_epoch_fns(...)[0]`` (``train_epoch``)
over whole epochs of a device-resident split, the step's noise handed in, as
``train_pcaa.py`` drives V4. The encoder's sizes are the configuration's
``DGCNN_*`` keys; the program's ``Config`` takes the others.

The comparison is ``_train``'s, against ``reference/pcaa_v4_dgcnn.py`` run on
the program's graphs, and ``graph_gap``: set-up records the graph of every
layer of its three steps (a forward hook on each ``KNNGraph``), and the
reference, from its own features, takes the largest excess of a chosen
neighbour's distance over its own k-th smallest, relative to that distance
(``reference/pcaa_v4_dgcnn.py::graph_gap``). Layer 1's input is data, so
there it reads 0. The fault ``graph`` swaps one point's k-th neighbour of
layer 1 for its (k+1)-th, at the point where the two lie farthest apart."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

# the program's DGCNN encoder: a checkout without it fails here, at once
from opensetgaitrecognition_pcaa_tpu_torch.models.dgcnn import DGCNNSpec

from benchmark.cells import _train, train_pcaa
from benchmark.reference import model as v4
from benchmark.reference import pcaa_v4_dgcnn as ref
from benchmark.reference.centroids import sample_distant_points

PREFIX = "DGCNN_"


def spec(ctx) -> DGCNNSpec:
    s = ref.spec(ctx.dims)
    return DGCNNSpec(**dict(s, widths=tuple(s["widths"])))


def config(ctx):
    """The program's ``Config`` from the configuration's keys other than
    the encoder's."""
    from opensetgaitrecognition_pcaa_tpu_torch.config import Config

    kw = {k: v for k, v in ctx.dims.items() if not k.startswith(PREFIX)}
    for key in ("DTC_FILTERS", "TRAIN_CLASSES"):
        kw[key] = tuple(kw[key])
    return Config(BATCH_SIZE=ctx.traffic["batch"], SEED=ctx.seed % (1 << 31), **kw)


def swap_kth(module, inputs, graph: torch.Tensor) -> torch.Tensor:
    """A planted fault (a forward hook on a ``KNNGraph``): the graph with one
    point's k-th neighbour swapped for its (k+1)-th, at the point whose two
    lie farthest apart relative to the k-th's distance."""
    from opensetgaitrecognition_pcaa_tpu_torch.ops.dgcnn_knn import dgcnn_knn

    h, k = inputs[0].detach(), graph.shape[2]
    wider = dgcnn_knn(h, k + 1)
    if wider.shape[2] == k:
        raise ValueError(f"the graph fault needs more than k = {k} points a frame")
    d = ref.sq_dists(h, wider[..., k - 1:])
    rel = (d[..., 1] - d[..., 0]) / d[..., 0].clamp(min=torch.finfo(d.dtype).tiny)
    f, i = divmod(int(torch.argmax(rel)), graph.shape[1])
    graph = graph.clone()
    graph[f, i, k - 1] = wider[f, i, k]
    return graph


class Cell(train_pcaa.Cell):
    def _build(self) -> None:
        from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
        from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
            VARIANTS,
            build_pcaa,
            make_epoch_fns,
        )

        ctx = self.ctx
        self.cfg = config(ctx)
        variant = dataclasses.replace(VARIANTS[VARIATION(ctx.config["variant"])],
                                      use_disc_head=ctx.config["proj_head_on_discriminator"])
        self.mods, self.state = build_pcaa(self.cfg, variant, device=self.device,
                                           encoder=spec(ctx))
        _train.load_weights((self.mods.g, self.mods.d), _train.weights(ctx, self.device))
        self.noise_shapes = ((self.cfg.SUP_LATENT_DIM,), (1,))
        self.train_epoch = make_epoch_fns(self.mods, self.cfg)[0]
        self.knn_graphs = [layer.graph for layer in self.mods.g["encoder"].edges]
        if ctx.fault == "graph":
            self.knn_graphs[0].register_forward_hook(swap_kth)

    def _first_steps(self) -> None:
        """``_train``'s three steps, each layer's graph recorded (indices
        below 256: one byte each, on the host)."""
        seen: List[torch.Tensor] = []
        hooks = [g.register_forward_hook(lambda m, i, out: seen.append(out.to("cpu", torch.uint8)))
                 for g in self.knn_graphs]
        try:
            super()._first_steps()
        finally:
            for hook in hooks:
                hook.remove()
        layers = len(self.knn_graphs)
        self.graphs = [seen[i:i + layers] for i in range(0, len(seen), layers)]

    def counted(self) -> Dict[str, int]:
        from opensetgaitrecognition_pcaa_tpu_torch.ops.dgcnn_edge import edge_conv
        from opensetgaitrecognition_pcaa_tpu_torch.ops.dgcnn_knn import dgcnn_knn

        return {"adam": super().counted()["adam"], "dgcnn_knn": dgcnn_knn.launches,
                "dgcnn_edge": edge_conv.launches}

    def readings(self) -> Dict:
        return {**super().readings(), "graphs": self.graphs}


def reference(ctx, readings: Dict, exact: bool = True) -> Dict:
    """The plain V4 + DGCNN step three times from the same weights, rows and
    noise: losses, the step-1 gradient norms, the change norms, each layer's
    record, and its own graphs. Exact, it runs on the program's graphs where
    they fit the step; the control (``exact`` False) on its own."""
    device = torch.device(ctx.device)
    v4.exact_f32(exact)
    xs, ys, p = _train.reference_inputs(ctx, readings, device)
    d = ctx.dims
    centroids = torch.from_numpy(sample_distant_points(
        d["SUP_LATENT_DIM"], ctx.n_classes, min_dist=10, sphere_radius=10, seed=42)).to(device)
    hp = dict(d, shape=(d["NSTEPS"], d["NMAX"], d["NFEATURES"]))
    z0, alphas = (n.to(device) for n in readings["noise"])
    p0 = {k: v.clone() for k, v in p.items()}
    opt_g, opt_d, losses, records = {}, {}, [], []
    frames = xs.shape[1] * d["NSTEPS"]
    for i in range(xs.shape[0]):
        graphs = readings["graphs"][i] if exact else None
        if graphs is not None and any(g.shape[0] != frames for g in graphs):
            graphs = None  # the program's step held other frames: its graphs cannot be run
        if graphs is not None:
            graphs = [g.to(device).long() for g in graphs]
        record: List[Dict] = []
        loss, grads = ref.pcaa_v4_dgcnn_step(p, opt_g, opt_d, xs[i], ys[i], z0[i], alphas[i],
                                             centroids, hp, graphs, record)
        losses.append(loss)
        records.append(record)
        if i == 0:
            grad_norms = _train.leaf_norms(grads)
        del grads
    change = _train.leaf_norms({k: p[k] - p0[k] for k in p})
    v4.exact_f32(True)
    own = [[r["graph"].to("cpu", torch.uint8) for r in step] for step in records]
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "records": records, "graphs": own}


def compare(prog: Dict, reference_: Dict) -> List[Tuple[str, float]]:
    """``_train``'s numbers and ``graph_gap`` of the program's graphs on the
    reference's features."""
    return _train.compare(prog, reference_) + [
        ("graph_gap", ref.graph_gap(prog["graphs"], reference_["records"]))]


def check(ctx, readings: Dict) -> List[Tuple[str, float, float]]:
    reference_ = reference(ctx, readings, True)
    return [(name, value, ctx.limits[name]) for name, value in compare(readings, reference_)
            if name in ctx.limits]


explain = _train.explain
