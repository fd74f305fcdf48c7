"""Run-level ("grid") training: the runs of one grid cell on one device, or
spread over a list of devices.

Port of ``opensetgaitrecognition_pcaa_tpu/parallel/grid.py``. The JAX
package vmaps one jitted train step over a run axis and steps the runs in
lockstep. Here each run keeps a solo state of its own: the modules, Adam
states and noise generator of ``build_pcaa``/``build_orced``, a host
``numpy`` generator seeded from its ``SEED`` and the solo ``train_epoch``
of ``make_epoch_fns``/``make_orced_epoch_fns`` built from ``cfgs[0]``. An
epoch runs each run's ``train_epoch`` in turn. The runs share no state, so
taking turns by epoch or by step gives the same result; a run with fewer
steps simply takes fewer, where the JAX trainer masks its trailing steps
(``where(active, new, old)``). The kernels launch through ctypes on
``data_ptr()`` (``ops/pointnet_train.py``), which ``torch.func.vmap``
cannot reach, so the runs are not batched into one step. Grid run r is
solo run r step for step: the same permutations, batches and noise, and on
the CPU the same bits.

A ``mesh`` is the JAX trainer's run axis sharded over devices: here a list
of devices, run r of the chunk living on ``mesh[r % len(mesh)]`` with all
its state, so that each device trains ``R / len(mesh)`` runs in turn. It
spreads memory, not time: one thread steps every run in turn and a step is
bound by the host's launches, so an epoch of 4 V4 runs over 4 H100s took
as long as on one (1518 against 1548 ms, each card busy 0.22 of it against
0.87, peak memory a card 7.1 against 15.0 GB; ``chip_smoke.py
--grid-cards``, H100 80GB HBM3 at 700 W).

Shared with the JAX module: the per-run fields a grid may vary
(``_PER_RUN_FIELDS``) and its check, ``mesh_chunks`` and ``pad_datasets``,
numpy copies with the same behaviour and messages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import epoch_batch_indices
from opensetgaitrecognition_pcaa_tpu_torch.train.orced import (
    build_orced,
    make_orced_epoch_fns,
)
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
    VARIANTS,
    Device,
    _ckpt_payload,
    build_pcaa,
    make_epoch_fns,
)

# Per-run fields the lockstep design legitimately varies: identity/seeding
# and filesystem paths. Every other field (LR, loss weights, supervision
# frequency, EPOCHS, dtype/optimizer flags, shapes) is read from cfgs[0] by
# every run's train step, so a grid that varies any of them would train
# runs 1..R-1 under run 0's hyperparameters.
_PER_RUN_FIELDS = frozenset({
    "MODEL_NAME",
    "NOTES",
    "SEED",
    "TRAIN_CLASSES",
    "DATA_PATH",
    "GEN_DATA_PATH",
    "MODELS_PATH",
    "FIGURES_PATH",
})


def _assert_lockstep_compatible(cfgs: Sequence[Config]) -> None:
    """Fail fast unless all step-relevant config fields agree across runs."""
    base = dataclasses.asdict(cfgs[0])
    for i, c in enumerate(cfgs[1:], start=1):
        d = dataclasses.asdict(c)
        for f, v in base.items():
            if f not in _PER_RUN_FIELDS and d[f] != v:
                raise AssertionError(
                    f"grid cfgs[{i}].{f}={d[f]!r} != cfgs[0].{f}={v!r}: the "
                    "lockstep trainer bakes one train step from cfgs[0], so "
                    "only per-run identity fields "
                    f"({', '.join(sorted(_PER_RUN_FIELDS))}) may differ"
                )


def mesh_chunks(todo, cap: int, n_dev: int):
    """Split a run list into lockstep chunks compatible with a 'data'-axis
    mesh of ``n_dev`` devices: sharding requires the run-axis length to be
    divisible by the axis size, so each cap-sized chunk yields a sharded
    multiple-of-``n_dev`` part plus (if ragged) unsharded tail chunks of at
    most ``cap // n_dev`` runs each.

    → list of ``(chunk, use_mesh)`` pairs. With ``n_dev <= 1`` everything
    is a single-device chunk (use_mesh False) and ``cap`` is the per-device
    capacity.
    """
    out = []
    per_dev = max(1, cap // max(n_dev, 1))
    for c in range(0, len(todo), cap):
        chunk = list(todo[c : c + cap])
        if n_dev <= 1:
            out.append((chunk, False))
            continue
        m = (len(chunk) // n_dev) * n_dev
        if m:
            out.append((chunk[:m], True))
        tail = chunk[m:]
        for t in range(0, len(tail), per_dev):
            out.append((tail[t : t + per_dev], False))
    return out


def pad_datasets(
    datasets: Sequence[Tuple[np.ndarray, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad per-run (x, y) to a common length by repeating row 0.

    Padding rows are never selected by the per-run permutations, so they are
    inert. Returns ``(x (R, n_max, ...), y (R, n_max), n_real (R,))``.
    """
    n_max = max(x.shape[0] for x, _ in datasets)
    xs, ys, ns = [], [], []
    for x, y in datasets:
        pad = n_max - x.shape[0]
        xs.append(np.concatenate([x, np.repeat(x[:1], pad, axis=0)], axis=0) if pad else x)
        ys.append(np.concatenate([y, np.repeat(y[:1], pad, axis=0)], axis=0) if pad else y)
        ns.append(x.shape[0])
    return np.stack(xs), np.stack(ys), np.array(ns, dtype=np.int32)


class _GridBase:
    """What both grid trainers share: the construction checks, the padded
    per-run splits on the device, each run's host shuffle generator, the
    epoch of every run in turn and the best-by-validation payloads. A
    subclass fills ``mods``, ``states`` and ``_train_epochs`` (each run's
    solo ``train_epoch``)."""

    def __init__(self, cfgs, train_sets, valid_sets, mesh: Optional[Sequence[Device]],
                 device: Device):
        assert len(cfgs) == len(train_sets) >= 1
        # a mismatched NMAX/BATCH_SIZE pair would otherwise fail deep inside
        # a step, and a mismatched LR/EPOCHS/loss weight would silently
        # train under cfgs[0]'s values
        _assert_lockstep_compatible(cfgs)
        assert len({c.n_classes for c in cfgs}) == 1, "mismatched n_classes"
        self.cfgs = list(cfgs)
        self.cfg = cfgs[0]
        self.R = len(cfgs)
        if mesh is not None and len(mesh) == 0:
            raise ValueError("a grid's mesh is a list of devices; it is empty")
        devices = [torch.device(d) for d in (mesh if mesh is not None else [device])]
        # run r and all of its state on devices[r % len(devices)]
        self.run_devices = [devices[r % len(devices)] for r in range(self.R)]

        x, y, self.n_real = pad_datasets(train_sets)
        # a run with no full batch would take no step: the solo trainer
        # cannot train it either
        assert int(self.n_real.min()) >= self.cfg.BATCH_SIZE, (
            f"train split sizes {self.n_real.tolist()} must be >= "
            f"BATCH_SIZE={self.cfg.BATCH_SIZE} (drop_last batching)"
        )
        self.x, self.y = self._per_run(x), self._per_run(y)
        if valid_sets is not None:
            xv, yv, self.nv_real = pad_datasets(valid_sets)
            # a valid split smaller than one batch would give vsteps=0 →
            # NaN accuracy → best payload frozen at the initial weights
            assert int(self.nv_real.min()) >= self.cfg.BATCH_SIZE, (
                f"valid split sizes {self.nv_real.tolist()} must be >= "
                f"BATCH_SIZE={self.cfg.BATCH_SIZE} (drop_last batching)"
            )
            self.xv, self.yv = self._per_run(xv), self._per_run(yv)
        else:
            self.xv = None
        self._host_rngs = [np.random.default_rng(c.SEED) for c in cfgs]
        self._steps_per_run = self.n_real // self.cfg.BATCH_SIZE
        self._best_accs = np.full(self.R, -np.inf)
        self._best_payloads: List[Optional[Dict[str, torch.Tensor]]] = [None] * self.R
        self.last_epoch_steps: List[Dict[str, torch.Tensor]] = []
        self.mods: list = []
        self.states: list = []
        self._train_epochs: list = []

    def _per_run(self, stacked: np.ndarray) -> List[torch.Tensor]:
        """Run r's slice of a padded ``(R, ...)`` stack, on its device."""
        return [torch.as_tensor(a).to(d) for a, d in zip(stacked, self.run_devices)]

    def _train_runs(self, *args, sup_keys=()) -> Dict[str, np.ndarray]:
        """One epoch of every run in turn: the run's permutation drawn from
        its host generator as the solo trainers draw it, then its solo
        ``train_epoch(state, x, y, perm, *args)``. Keeps each run's per-step
        metric tensors in ``last_epoch_steps``; → the per-run means, (R,)
        arrays, with the JAX grid's reductions: ``n_correct`` as
        ``train_accuracy``, the ``sup_keys`` over the supervised steps
        (every ``SUPERVISION_FREQUENCY``-th from step 0), the rest over
        every step."""
        B = self.cfg.BATCH_SIZE
        self.last_epoch_steps = []
        for r, train_epoch in enumerate(self._train_epochs):
            perm = epoch_batch_indices(int(self.n_real[r]), B, shuffle=True,
                                       rng=self._host_rngs[r])
            self.states[r], m = train_epoch(self.states[r], self.x[r], self.y[r], perm, *args)
            self.last_epoch_steps.append(m)
        per_run: Dict[str, list] = {}
        for m in self.last_epoch_steps:
            for k, v in m.items():
                v = v.cpu().numpy()
                if k == "n_correct":
                    k, v = "train_accuracy", float(np.sum(v)) / (v.shape[0] * B)
                elif k in sup_keys:
                    v = np.mean(v[:: self.cfg.SUPERVISION_FREQUENCY])
                else:
                    v = np.mean(v)
                per_run.setdefault(k, []).append(v)
        return {k: np.array(v) for k, v in per_run.items()}

    def note_validation(self, valid_accs: np.ndarray) -> np.ndarray:
        """Keep, on the device, the weights of each run whose accuracy beats
        its best so far (from −inf: the first validation is kept), as the
        solo trainers' best-by-validation checkpoint; → the improved mask."""
        improved = valid_accs > self._best_accs
        self._best_accs = np.maximum(self._best_accs, valid_accs)
        for r in np.flatnonzero(improved):
            self._best_payloads[r] = _ckpt_payload(self.mods[r])
        return improved

    def best_run_payloads(self) -> List[Dict[str, torch.Tensor]]:
        """→ each run's best payload (its current weights where none was
        noted): ``_ckpt_payload`` dicts of the run's modules."""
        return [p if p is not None else _ckpt_payload(m)
                for p, m in zip(self._best_payloads, self.mods)]

    def per_run_states(self) -> list:
        """→ ``[(modules, state)]``, each run's live solo state."""
        return list(zip(self.mods, self.states))


class GridPCAATrainer(_GridBase):
    """Grid trainer for R same-shape PCAA runs.

    Usage::

        trainer = GridPCAATrainer(cfgs, VARIATION.V4, train_sets, valid_sets, device="cuda")
        # or spread over cards, run r on mesh[r % len(mesh)]:
        # GridPCAATrainer(cfgs, VARIATION.V4, train_sets, valid_sets, mesh=["cuda:0", "cuda:1"])
        for epoch in range(cfgs[0].EPOCHS):
            metrics = trainer.run_epoch(epoch)   # dict of (R,) arrays
        payloads = trainer.best_run_payloads()   # for checkpointing

    ``cfgs`` may differ only in per-run identity fields (TRAIN_CLASSES,
    SEED, MODEL_NAME, paths — see ``_PER_RUN_FIELDS``); every step-relevant
    field (shapes, LR, loss weights, flags) must agree (asserted).
    ``DEFERRED_DECODER_UPDATE`` is refused, as the JAX grid refuses it;
    ``BF16_WEIGHT_CACHE`` and ``FACTORED_ADAM_NU`` live in each run's solo
    state (``build_pcaa``).
    """

    def __init__(
        self,
        cfgs: Sequence[Config],
        variation: VARIATION,
        train_sets: Sequence[Tuple[np.ndarray, np.ndarray]],
        valid_sets: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
        mesh=None,
        *,
        device: Device = "cuda",
    ):
        if any(c.DEFERRED_DECODER_UPDATE for c in cfgs):
            raise AssertionError(
                "DEFERRED_DECODER_UPDATE is a solo-trainer schedule: the grid trainer owns its "
                "own epoch scan and has no post-scan flush, so validation would see stale "
                "decoder params")
        super().__init__(cfgs, train_sets, valid_sets, mesh, device)
        spec = VARIANTS[variation]
        for c, d in zip(self.cfgs, self.run_devices):
            mods, state = build_pcaa(c, spec, device=d)
            self.mods.append(mods)
            self.states.append(state)
            self._train_epochs.append(make_epoch_fns(mods, self.cfg)[0])

    def run_epoch(self, epoch: int) -> Dict[str, np.ndarray]:
        """One epoch of every run; returns per-run metric means, (R,)
        arrays: ``train_accuracy``, ``sup_loss`` and ``tot_loss`` over the
        supervised steps only (the solo trainer's and the reference's
        means), the rest over every step a run took."""
        return self._train_runs(sup_keys=("sup_loss", "tot_loss"))

    @torch.no_grad()
    def valid_accuracy(self) -> np.ndarray:
        """Per-run validation accuracy (R,): each run's encoder in eval mode
        on its own full valid split, drop_last batches in order (the JAX
        grid's ``valid_fn``: no decoder pass)."""
        assert self.xv is not None
        B = self.cfg.BATCH_SIZE
        accs = []
        for mods, xv, yv, n in zip(self.mods, self.xv, self.yv, self.nv_real):
            perm = torch.as_tensor(epoch_batch_indices(int(n), B, shuffle=False),
                                   device=xv.device).long()
            encoder = mods.g["encoder"]
            encoder.eval()
            try:
                correct = sum(torch.sum(torch.argmax(encoder(xv[idx])[0], dim=1) == yv[idx])
                              for idx in perm)
            finally:
                encoder.train()
            accs.append(float(correct) / perm.numel())
        return np.array(accs)


class GridORCEDTrainer(_GridBase):
    """Grid trainer for R same-shape OR-CED runs (reference grid:
    ``train_ORCED.py:283-329``, sequential), with the per-epoch KL
    annealing ``epoch / EPOCHS``.

    The validation pass runs at the end of every ``run_epoch`` that has
    valid sets, as the solo ``train_orced`` runs it, because it draws its
    reparametrization noise from the run's one noise generator: skipping it
    on the epochs the driver does not checkpoint would train every later
    epoch on other noise than the solo run's. ``valid_accuracy(epoch)``
    returns that pass's accuracies.
    """

    def __init__(
        self,
        cfgs: Sequence[Config],
        train_sets: Sequence[Tuple[np.ndarray, np.ndarray]],
        valid_sets: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
        mesh=None,
        *,
        device: Device = "cuda",
    ):
        super().__init__(cfgs, train_sets, valid_sets, mesh, device)
        self._validated: Optional[Tuple[int, np.ndarray]] = None
        self._valid_epochs = []
        for c, d in zip(self.cfgs, self.run_devices):
            mods, state = build_orced(c, device=d)
            self.mods.append(mods)
            self.states.append(state)
            train_epoch, valid_epoch = make_orced_epoch_fns(mods, self.cfg)
            self._train_epochs.append(train_epoch)
            self._valid_epochs.append(valid_epoch)

    def run_epoch(self, epoch: int) -> Dict[str, np.ndarray]:
        """One epoch of every run, then the validation pass; returns per-run
        metric means, (R,) arrays."""
        kl_mult = float(np.float32(epoch / self.cfg.EPOCHS))  # train_ORCED.py:122
        out = self._train_runs(kl_mult)
        if self.xv is not None:
            B = self.cfg.BATCH_SIZE
            corrects = [
                float(valid_epoch(state, xv, yv,
                                  epoch_batch_indices(int(n), B, shuffle=False))["n_correct"].sum())
                for valid_epoch, state, xv, yv, n in zip(
                    self._valid_epochs, self.states, self.xv, self.yv, self.nv_real)]
            self._validated = (epoch, np.array(corrects) / ((self.nv_real // B) * B))
        return out

    def valid_accuracy(self, epoch: int) -> np.ndarray:
        """Per-run valid accuracy (R,) of ``epoch``'s validation pass, each
        run on its own full valid split (drop_last), with the solo trainer's
        noise stream; ``epoch`` must be the last one run."""
        assert self.xv is not None
        if self._validated is None or self._validated[0] != epoch:
            raise ValueError(f"epoch {epoch} is not the last epoch run: its validation is gone")
        return self._validated[1]
