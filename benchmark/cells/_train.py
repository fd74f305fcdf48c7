"""What the two training cell modules share: the program's state loaded with
the benchmark's weights, the feed (a fresh host permutation per epoch, the
step's noise handed in), the window of whole epochs, the first three steps
whose readings the comparison takes, and the comparison itself.

The comparison of a training cell: set-up drives the
program's own state through its first three steps, by the window's own call
and feed, on three batches of rows that all differ. Compared with the plain
reference run from the same weights, rows and noise:

- ``loss_gap``: each step's losses, ``|program − reference| / max(|ref|, 1)``,
  the largest;
- ``grad_gap``: per leaf, the norm of the first gradient as the optimizer
  got it (its first moment after step 1 over ``1 − b1``) against the
  reference's gradient norm; the gap as a share of the larger of that
  leaf's reference norm and the median leaf's, the worst leaf;
- ``change_gap``: per leaf, the norm of the parameters' change after the
  three steps, the same way; leaves whose reference gradient at step 1 is
  under a thousandth of the median leaf's (a bias under a train-mode
  BatchNorm, the DPH that no gradient reaches) move by round-off alone and
  are left out.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from benchmark import traffic
from benchmark.harness import note
from benchmark.reference import params as ref_params

READ_STEPS = 3
SMALL_GRAD = 1e-3


def config(ctx, **extra):
    from opensetgaitrecognition_pcaa_tpu_torch.config import Config

    kw = dict(ctx.dims)
    for key in ("DTC_FILTERS", "TRAIN_CLASSES"):
        kw[key] = tuple(kw[key])
    return Config(BATCH_SIZE=ctx.traffic["batch"], SEED=ctx.seed % (1 << 31), **kw, **extra)


@torch.no_grad()
def load_weights(modules, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the parameters of ``modules`` by
    name; the two sets of names must be the same."""
    own = {k: p for m in modules for k, p in m.named_parameters()}
    if set(own) != set(weights):
        raise ValueError(f"the program's parameters differ from the benchmark's: "
                         f"{sorted(set(own) ^ set(weights))[:6]}")
    for k, p in own.items():
        p.copy_(weights[k])


def data(ctx) -> Tuple[np.ndarray, np.ndarray]:
    return traffic.crops(ctx.traffic, ctx.dims, ctx.seed)


def leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.detach().float())) * scale
            for k, t in tensors.items()}


class TrainCell:
    """A training cell. Subclasses give ``_build()``, which sets ``cfg``,
    ``mods``, ``state``, ``train_epoch`` and ``noise_shapes``; ``_moments()``
    → each Adam state's first moments by name with its b1; ``_params()`` →
    the parameters by name; and ``_epoch(perm, noise)``, which runs the
    program's epoch call and returns its metrics."""

    noise_shapes: Tuple[Tuple[int, ...], ...] = ()

    def __init__(self, ctx):
        self.ctx = ctx
        self.device = torch.device(ctx.device)
        self.batch = ctx.traffic["batch"]
        x, y = data(ctx)
        self.x = torch.from_numpy(x).to(self.device)
        self.y = torch.from_numpy(y).to(self.device)
        self.host_rng = np.random.default_rng([ctx.seed, 5])
        self.noise_gen = torch.Generator(device=self.device).manual_seed(
            (ctx.seed * 7919 + 11) % (1 << 63))
        self.steps = self.failed = 0
        note("data")
        self._build()
        note("build")
        self._first_steps()
        note("first_steps")

    # --- the feed --------------------------------------------------------
    def perm(self) -> np.ndarray:
        from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import epoch_batch_indices

        return epoch_batch_indices(self.x.shape[0], self.batch, shuffle=True, rng=self.host_rng)

    def noise(self, perm: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """The steps' noise, one row per row of ``perm``: normal, then uniform."""
        draws = (torch.randn, torch.rand)
        return tuple(draws[i](perm.shape + s, generator=self.noise_gen, device=self.device)
                     for i, s in enumerate(self.noise_shapes))

    def run_epoch(self, perm: np.ndarray, noise) -> Dict[str, np.ndarray]:
        from torch.profiler import record_function

        if self.ctx.fault == "half_batch":  # a planted fault: half of each batch left out
            perm, noise = perm[:, : self.batch // 2], tuple(n[:, : self.batch // 2] for n in noise)
        with record_function("bench.train_epoch"):
            m = self._epoch(perm, noise)
        with record_function("bench.epoch_end"):
            m = {k: v.cpu().numpy() for k, v in m.items()}
        self.steps += perm.shape[0]
        self.failed += int(np.sum(~np.all([np.isfinite(v) for v in m.values()], axis=0)))
        return m

    # --- set-up: the three steps the comparison reads --------------------
    def _first_steps(self) -> None:
        perm = self.perm()[:READ_STEPS]
        noise = self.noise(perm)
        params = self._params()
        p0 = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
        m1 = self.run_epoch(perm[:1], tuple(n[:1] for n in noise))
        self.grad_norms = {k: v for moments, b1 in self._moments()
                           for k, v in leaf_norms(moments, 1.0 / (1.0 - b1)).items()}
        m23 = self.run_epoch(perm[1:], tuple(n[1:] for n in noise))
        self.losses = [{k: float(v[i]) for k, v in m.items() if not k.startswith("n_")}
                       for m in (m1, m23) for i in range(len(next(iter(m.values()))))]
        # the difference on the device: a float32 norm of 162M elements on the
        # host loses several % to its running sum; the device's tree sum does not
        self.change_norms = {k: float(torch.linalg.vector_norm(p.detach() - p0[k].to(self.device)))
                             for k, p in params.items()}
        self.read_rows = perm
        self.read_noise = tuple(n.cpu() for n in noise)

    # --- the window --------------------------------------------------------
    def window(self, deadline: float) -> int:
        steps = 0
        while time.perf_counter() < deadline:
            perm = self.perm()
            self.run_epoch(perm, self.noise(perm))
            steps += perm.shape[0]
        return steps

    def segment(self) -> Dict[str, float]:
        perm = self.perm()
        self.run_epoch(perm, self.noise(perm))
        return {"steps": perm.shape[0], "windows": perm.size}

    def end_to_end(self, steps: int, seconds: float) -> Dict[str, float]:
        return {"train_windows_per_s": steps * self.batch / seconds}

    def attempted(self) -> Tuple[int, int]:
        return self.steps, self.failed

    def counted(self) -> Dict[str, int]:
        from opensetgaitrecognition_pcaa_tpu_torch.ops.adam import adam_update_
        from opensetgaitrecognition_pcaa_tpu_torch.ops.pointnet_train import fused_layer, fused_pool

        return {"pointnet_train": fused_layer.launches + fused_pool.launches
                + fused_layer.launches_bf16 + fused_pool.launches_bf16,
                "adam": adam_update_.launches + adam_update_.launches_m16
                + adam_update_.launches_mv16 + adam_update_.launches_v16}

    def info(self) -> Dict:
        return {"dims": dict(self.ctx.dims), "batch": self.batch, "family": self.ctx.config["family"],
                "n_classes": self.ctx.n_classes}

    def readings(self) -> Dict:
        return {"losses": self.losses, "grad_norms": self.grad_norms,
                "change_norms": self.change_norms, "rows": self.read_rows,
                "noise": self.read_noise}

    def free(self) -> None:
        for name in ("mods", "state", "train_epoch", "x", "y"):
            setattr(self, name, None)


def reference_inputs(ctx, readings: Dict, device) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """The crops and labels of the read steps, made again from the seed, and
    the weights made again on the device, each a tensor of its own (the
    reference updates them in place, and views of one buffer would share
    autograd's version counter)."""
    x, y = data(ctx)
    rows = np.asarray(readings["rows"])
    xs = torch.from_numpy(x[rows.reshape(-1)]).to(device).reshape(rows.shape + x.shape[1:])
    ys = torch.from_numpy(y[rows.reshape(-1)]).to(device).reshape(rows.shape)
    return xs, ys, {k: v.clone() for k, v in weights(ctx, device).items()}


def weights(ctx, device) -> Dict[str, torch.Tensor]:
    """The benchmark's weights of the cell's model, made on ``device`` from
    the seed."""
    leaves = ref_params.leaves(ctx.config["model"], ctx.dims, ctx.n_classes)
    return ref_params.make(leaves, ctx.seed, device)


def compare(prog: Dict, ref: Dict) -> List[Tuple[str, float]]:
    """The numbers the module docstring names, and the steadier ones beside
    them: ``loss1_gap`` (the first step's losses alone), ``grad_median_gap``
    and ``change_median_gap`` (the median leaf's gap instead of the worst
    leaf's). A cell's limits file says which of them decide ``correct``."""
    def loss_gaps(steps):
        return max(abs(p[k] - r[k]) / max(abs(r[k]), 1.0)
                   for p, r in zip(prog["losses"][:steps], ref["losses"][:steps]) for k in r)

    def gaps(a: Dict[str, float], b: Dict[str, float], keys) -> List[float]:
        median = float(np.median([b[k] for k in keys]))
        return [abs(a[k] - b[k]) / max(b[k], median) for k in keys]

    g_ref = ref["grad_norms"]
    g_median = float(np.median(list(g_ref.values())))
    moved = [k for k in g_ref if g_ref[k] >= SMALL_GRAD * g_median]
    grad = gaps(prog["grad_norms"], g_ref, list(g_ref))
    change = gaps(prog["change_norms"], ref["change_norms"], moved)
    return [("loss_gap", loss_gaps(len(ref["losses"]))), ("loss1_gap", loss_gaps(1)),
            ("grad_gap", max(grad)), ("grad_median_gap", float(np.median(grad))),
            ("change_gap", max(change)), ("change_median_gap", float(np.median(change)))]


def explain(prog: Dict, ref: Dict, top: int = 6) -> Dict[str, List]:
    """Each step's gap of each loss, and the leaves behind ``grad_gap`` and
    ``change_gap``, worst first: name, the reference's step-1 gradient norm
    over the median leaf's, the two norms compared, the gap."""
    g_ref = ref["grad_norms"]
    g_median = float(np.median(list(g_ref.values())))
    moved = {k for k in g_ref if g_ref[k] >= SMALL_GRAD * g_median}
    out = {"step_loss_gaps": [{k: abs(p[k] - r[k]) / max(abs(r[k]), 1.0) for k in r}
                              for p, r in zip(prog["losses"], ref["losses"])]}
    for key, keys in (("grad_norms", set(g_ref)), ("change_norms", moved)):
        b = ref[key]
        median = float(np.median([b[k] for k in keys]))
        rows = sorted(((abs(prog[key][k] - b[k]) / max(b[k], median), k) for k in keys),
                      reverse=True)
        out[key] = [[k, g_ref[k] / g_median, prog[key][k], b[k], gap] for gap, k in rows[:top]]
    return out


def checked(ctx, prog: Dict, reference: Callable[[bool], Dict]) -> List[Tuple[str, float, float]]:
    ref = reference(True)
    return [(name, value, ctx.limits[name]) for name, value in compare(prog, ref)
            if name in ctx.limits]
