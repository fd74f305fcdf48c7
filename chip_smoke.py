#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Drives the port's main paths, V4 open-set inference and in-process serving,
V4 training, OR-CED open-set inference, serving and training, the PCAA
ablation (every variant, its CLI, the resume), the serving artifacts,
the remaining sequential drivers, both drivers' ``--grid`` mode and the
reference run-folder export and import, at the
full width
of the published models (NMAX=150, NSTEPS=30, C=4, PointNet width 1024,
TCN filters 16..512, latent 32; decoder S = 18000, 215.2M parameters),
with seeded random weights and seeded crop files. Phases:

1. the card's name and power limit; TF32 off; the CUDA kernels' nvcc
   builds, all sources at once;
2. the PointNet kernel against its plain PyTorch version at the main
   path's shapes and at shapes that cut its tiles (97 frames of N = 37,
   N = 1, D = 512, C = 5; rtol 1e-4, atol 1e-4), and both timed at
   (256, 30, 150), the kernel also at the serving batch of 24 crops;
3. ``pcaa_inference`` through the kernel (its launch count must grow), then
   again through the plain version: latents within atol 1e-4, decisions
   equal except in windows holding a crop within 1e-4 of the threshold;
4. ``make_pcaa_decision_fn`` answers 3 requests of (4, 6, 30, 150, 4)
   windows, with the decisions of ``_window_vote`` on the same crops;
5. encoder windows/s through the kernel and through the plain version;
6. training, B = 16, 6 classes, seeded train/valid crops:
   a. the train-mode PointNet layer kernel (+ its statistics), the pool
      kernel and the Adam kernel against their plain versions at the
      training shapes (72,000 rows; 480 frames of 150 points; the
      9000 x 18000 decoder matrix) and at ragged ones (the layer also at
      N = 1, 6 rows, with K = 4 and 512), timed in the order plain,
      kernel, kernel, plain (Adam also against torch._fused_adam_);
   b. from one seeded state, 5 steps with FUSED_POINTNET and FUSED_ADAM on
      (kernels: exactly 4 layer, 1 pool and 4 Adam launches a step) and 5
      with both off (plain), on the same batches and injected noise; the
      losses must agree step by step;
   c. ``train_pcaa`` for one epoch with both flags on, its run folder
      checked and then scored by ``pcaa_inference`` through the slice-1
      kernel;
7. OR-CED, 6 classes, the crops of phases 3 and 6:
   a. the Chamfer kernel against its plain version (rtol 1e-5, atol 1e-6)
      and an f64 oracle (rtol 1e-3) at (64, 30, 150, 150), (16, 30, 150,
      150) and at ragged, five-channel, one-point, two-tile and N = M =
      704 shapes, and at C = 3, 6 (padded to 4 and 8), 8 and 12 (the
      run-time-C kernel), each a counted launch; bitwise equal across two
      launches and for frames launched alone; timed through its wrapper against plain and
      torch.cdist at (64, 30, 150, 4) (CUDA events around 20 calls each),
      then alone at (64, 30, 150, 4) and (16, 30, 150, 4): device time per
      launch from a CUDA graph of 50 raw launches and from
      torch.profiler, and the wrapper's host time per call (host clock
      around 11 batches of 50 calls, the median batch);
   b. a run folder (E, G, ML) from seeded inits, saved by the port;
   c. ``orced_inference`` through the kernels, then plain, with the same
      pinned eps at batch 64: latents within atol 1e-4, rec errors within
      rtol 1e-3, decisions equal except knife-edge crops;
   d. ``make_orced_forward_fn`` + ``orced_decide_host`` answer 3 requests
      of 16 test crops, with the decisions of ``orced_apply_ood``;
8. OR-CED from raw tracks, at the same full width, B = 16:
   a. the port's synthetic generator writes 10 subjects x 3 scenarios x
      10 raw tracks and ``generate_splits`` cuts them (6 seen subjects),
      timed;
   b. the ORCED step alone for 6 steps (warm ms per step, host clock,
      synchronized), then ``train_orced`` for 2 epochs: finite losses, KL
      exactly 0 in epoch 0, s per epoch from ``metrics.jsonl``, the E, G
      and ML files, and no kernel launched (the JAX trainer reaches none);
   c. ``orced_inference(generate_dataset=True)`` scores the trained folder
      through the kernels and then plain, with pinned eps: decisions equal
      except knife-edge crops, and the confusion PNG decodes (CRCs checked)
      to the matrix of the decisions within one colour step;
9. the PCAA ablation at the same full width, B = 16:
   a. V1, V2, V3 and V4 with the discriminator projection head, each from
      one seeded state on phase 6's crops with injected noise: 3 steps
      through the kernels (launches (layer, pool, adam) (4, 1, 4) a step,
      (4, 1, 0) for V3, whose leaves are all below the Adam kernel's
      size), the same again under torch.profiler after a traced warm-up,
      both from the same state, traced again while the trace holds fewer
      kernel launches than the counters (does a step repeat bit for bit,
      and which first-step gradients do not; device time by kind), then 3
      plain; losses within phase 6b's bound, the DPH at its
      init; on V1's live state, the resume file's save and load timed;
   b. the port's ``run_pcaa_ablation`` driver, kernels on, trains V1-V4
      one epoch on a 6-class subset of phase 8's raw tracks, each run
      folder's file set checked; a second call skips all four and writes
      no splits; ``pcaa_inference`` scores the four folders through the
      inference kernel and then plain, decisions equal but for knife-edge
      windows;
   c. V1 (kernels on, phase 6's crops) and ORCED (a quarter of phase 8's
      crops), each 2 epochs straight against 1 epoch with the resume
      state and a second call resuming: per-epoch metrics and module files
      reported bitwise equal or with their gaps; one ORCED step repeated
      from the same state names the gradients that do not repeat;
10. the serving artifacts and the remaining drivers, at the same width:
   a. ``python -m ...scripts.export_serving --ks 6`` exports phase 3's
      folder (seconds, MB); a fresh process (``--serve-artifacts``, only
      the port imported) loads it on the card and answers phase 4's 3
      requests, the PointNet kernel launched once each, with the decisions
      and counts of ``make_pcaa_decision_fn`` at the calibrated threshold
      except knife-edge windows; loaded on the CPU it answers the first
      request with the same decisions; ms per request beside phase 4's and
      a warm median of 15 more calls beside the in-process one's;
   b. ``export_orced_decision`` exports phase 7b's folder (seconds, MB),
      its class statistics equal ``orced_inference(dump_calibration=True)``'s
      at seed 0 (rtol 1e-6); the fresh process answers 3 requests of 16
      test crops with pinned eps, launching the PointNet and Chamfer
      kernels once each, with ``make_orced_forward_fn`` +
      ``orced_decide_host``'s decisions except knife-edge crops;
   c. ``run_orced`` trains one ORCED run (6 classes, 1 epoch) on phase
      8's raw tracks; a second call trains nothing and writes no split;
   d. ``run_pointsubsampling`` (the training kernels on) trains and
      scores V4 at 50 points, ks 1 and 6; with one log deleted it
      re-scores the run without training; a third call skips it;
   e. ``run_inference_scenarios`` scores phase 9b's V1 and V4 folders per
      scenario at ks 6 and 1 (the JAX driver's file names, finite F1);
      ``collect_results`` lists them;
11. bf16 training (``COMPUTE_DTYPE="bfloat16"``, ``BF16_ADAM_NU``):
   a. the bf16 layer kernel's ptxas report (no spills); the bf16 layer
      kernel (+ its statistics), the bf16-input pool kernel and the Adam
      kernel with m bf16, with m and v bf16 and with v bf16 (f32 compute
      with ``BF16_ADAM_NU``) against their plain
      versions at the training shapes and at ragged and padded ones (y
      within one bf16 rounding step, Adam bitwise); the layer at the
      step's four widths and the pool timed plain, kernel, kernel, plain,
      two launches of each bitwise equal, the kernels' device time from
      torch.profiler, the layer at layer 3's shape with the identity
      prologue beside the affine one, and cuBLAS's bf16 GEMM alone at the
      four shapes (``gemm_ms``, a yardstick); Adam timed the same way; the
      bf16 PointNet autograd Function on the card against the same
      Function on the CPU at the published widths (rtol 1e-2);
   b. the full-width V4 step at B = 16 from one seeded state, f32, bf16
      and bf16 + nu16 through the kernels and bf16 + nu16 plain: ms per
      step, windows/s, device time by kind (torch.profiler, 3 warm steps
      after a traced warm-up, from a snapshot that a retaken trace
      restarts from), the bf16 + nu16 losses through the kernels within 1e-2
      relative of plain; the ORCED step at f32 and bf16 + nu16;
   c. ``run_pcaa_ablation --compute-dtype bfloat16 --bf16-adam-nu``
      (kernels on) trains V4 for one epoch on phase 8's raw tracks, and
      ``pcaa_inference`` scores the folder through the inference kernel;
12. the drivers' ``--grid`` mode (``parallel/grid.py``) on phase 8's raw
   tracks, ``--n-training-classes 6 --n-tests 2 --epochs 1``:
   a. ``run_pcaa_ablation --grid --variants V4`` (kernels on) trains one
      chunk of 2 runs: seconds and peak device memory, launches (layer,
      pool, Adam) (4, 1, 4) a step taken, finite epoch losses (each grid
      run is its solo run, bit for bit on the CPU: the tier-1 tests); a
      grid of 2 runs of GRID_PROFILE_STEPS steps, its run 1 held to the
      same run trained alone (losses within LOSS_RTOL, correct counts
      equal), then its device busy share (torch.profiler's device time
      over the host clock of an unprofiled epoch);
   b. the grid at f32 with ``--bf16-adam-nu`` on 1 split: the Adam kernel
      with v bf16 launched 4 times a step;
   c. ``run_orced --grid`` (no kernel) on the same 2 splits: seconds,
      memory, finite losses;
   d. both ``--grid`` calls again: both splits skipped, none written;
13. the reference run-folder export and import at the same width
   (``scripts/export_reference_run.py``, ``scripts/import_reference_run.py``):
   a. phase 3's V4 folder (given seeded G, D and GPH), phase 7b's OR-CED
      folder and phase 9b's V1 folder exported as reference folders of
      ``.pt`` state_dicts (V1 through ``python -m``): seconds and MB;
   b. each imported back: module files and means byte-equal to the
      source's, ``config.json`` equal but for ``MODELS_PATH`` (the driver's
      V1 also in fields the reference's config.pkl lacks); seconds per
      import, and the decoder's unit permutation alone;
   c. ``pcaa_inference`` of the imported V4 folder through the kernel:
      decisions equal to phase 3's kernel run, latents' max |diff|;
   d. ``orced_inference`` of the imported OR-CED folder with phase 7c's
      eps through both kernels: decisions equal to phase 7c's kernel run;
14. data and tensor parallelism (``parallel/mesh.py``): first the layer
   kernel (f32 and bf16, with and without its f64 column sums) at the
   shapes 14a-b give it and the Adam kernel on a decoder shard, each held
   to its plain version; then one run over 2 ranks, processes started by
   ``launch`` with the gloo backend, both on the one card, at the same
   width, B = 16, MESH_STEPS steps from one seeded state on phase 6's
   train crops with injected noise, each held to the same steps on one
   rank (losses within MESH_LOSS_RTOL, correct counts equal, the gathered
   Adam first moments and running statistics), with each rank's launches,
   seconds and peak memory:
   a. V4 at DP 2 (the kernels on: 8 crops, 36,000 PointNet rows a rank);
   b. V4 at MP 2 (the layer kernel on column shards of 256 and 512, the
      Adam kernel on the decoder's sharded leaves; launches per width and
      leaf printed);
   c. OR-CED at DP 2 (the triplet loss over the all-gathered pair grid);
15. the training options ``BF16_WEIGHT_CACHE``, ``DEFERRED_DECODER_UPDATE``
   and ``FACTORED_ADAM_NU`` at the same width, B = 16, each run from one
   seeded state on phase 6's train crops with injected noise, cuDNN
   deterministic on both sides of every comparison:
   a. the Adam kernel writing the bf16 copy of w (m bf16; m and v bf16)
      against its plain version on the 9000 x 18000 leaf and a ragged one:
      w, m, v and the copy bitwise equal; timed plain, kernel, kernel,
      plain;
   b. the V4 step at bf16 and at bf16 + nu16 (FUSED_POINTNET, FUSED_ADAM),
      CACHE_STEPS steps with the cache on and CACHE_STEPS with it off:
      losses and every parameter, statistic and moment bitwise equal (where
      not, no wider than two runs with the cache off); ms per step on the
      host clock, device time by kind (the elementwise passes among them)
      over 3 traced steps, peak memory;
   c. the ORCED step at bf16, the same;
   d. V4 with ``DEFERRED_DECODER_UPDATE`` against the plain schedule over
      one epoch of CACHE_STEPS batches and its flush: at f32 bitwise equal;
      at bf16 + nu16 + cache losses within rtol 0.05, atol 0.05, correct
      counts within 2, Adam counts equal;
   e. V4 and ORCED with ``FACTORED_ADAM_NU`` at f32 and bf16: the factored
      update of the 9000 x 18000 leaf after step 1 against an f64
      evaluation of its formulas (rtol 1e-5), the second moments' bytes
      against full f32 nu, ms per step;
   f. ``run_pcaa_ablation --variants V4 --compute-dtype bfloat16
      --bf16-weight-cache`` (kernels on) against the same call without the
      flag: the module files under 15b's gate;
16. the P4Transformer kernels (``csrc/p4t_group.cu``, ``csrc/p4t_tube.cu``)
   at the shapes of the benchmark cell ``pcaa_v4_p4t.train_b16`` (B 16, T
   30, N 150, M 75, K 32, D 1024) on the benchmark's synthetic crops:
   farthest-point sampling and the ball query bitwise to their plain
   versions on 48 crops (and the mean ball fill, off any timed path), the
   tube's forward bitwise (maxima and argmax) and its weight gradient
   against the plain one; each kernel timed plain, kernel, kernel, plain
   by CUDA events beside its bound; then the P4Transformer encoder's
   forward and backward at B 16 (ms, peak memory); then one training step
   of the cell's model (``build_pcaa(..., encoder=P4TSpec())``,
   ``make_epoch_fns``) at B 16 with the launch counts at 0, whose counts
   (1 sampling, 1 ball query, the tube's forward and backward, 120 of the
   blocks' dense products) are the record's ``launches``. First, 16a: the
   blocks' dense products (``csrc/p4t_linear.cu``: forward, input gradient,
   weight gradient with the bias's) at the cell's four shapes and 18,000
   and 1,125 rows against f64, each held to the three-pass mode's bound and
   to a multiple of cuBLAS f32's error on the same inputs that single-pass
   TF32 fails, bitwise across two calls, each timed against cuBLAS beside
   its 3xTF32 bound.

It exits non-zero, with no result line, when there is no CUDA card or a
phase fails. The line before the last is the per-kernel JSON record (its
``launches`` counts each kernel's launches on the main paths, each path
driven with the counts at 0: phases 3, 4, 6c, 7c, 7d, 8c, 9b and 10 (the
ORCED export's calibration, the orced_inference it is held against, the
fresh process's requests, the sequential scripts' scoring) for the PointNet
inference kernel (and 11c, 13c and 13d), 6b's kernel steps, 6c, 9a's first kernel
steps, 9b's training, 9c's PCAA runs, 10d's training, 12a-b's driver
calls and 14a-b's ranks for the f32 training kernels, 11b's kernel steps and 11c's training
for their bf16 variants, 12b's grid for the Adam kernel with v bf16, 15b's
cache-on steps and 15f's training for the Adam kernel with the bf16 copy, 7c,
7d, 8c, 10b and 13d for the Chamfer kernel; the Chamfer kernel's ``ms`` is its device
time per launch at (64, 30, 150, 4) from the CUDA graph, every other
``ms`` CUDA events around calls of the wrapper; ``bound_ms`` is the
larger of the operations over 67 TFLOP/s and the bytes over 3.35 TB/s, the H100 SXM's
published f32 and HBM3 peaks, except for the two PointNet layer kernels,
which run three TF32 tensor-core passes per operation: for them both that
f32 bound and the 3xTF32 bound (3 x operations over 495 TFLOP/s) are
printed and the lower goes into ``bound_ms``, ``bound_route`` naming it,
and the bf16 layer kernel, whose operations are counted at the dense bf16
peak, 989 TFLOP/s; the layer kernels' times and bounds are per launch,
the mean of a step's four layers), the last ``{"ok": true, "device":
{...}}``.
Files go to ``build/chip_smoke/``.

``--serve-artifacts DIR`` is phase 10's fresh process.
``python3 chip_smoke.py --chamfer-timing`` builds only the Chamfer kernel
and runs phase 7a's timing, for comparing trees of the port in one call;
``--codec-timing`` times the run-folder codec alone the same way, and
``--pointnet-bf16-timing`` phase 11a's bf16 layer and pool timing, and
``--pointnet-infer-timing`` phase 2 (the eval PointNet kernel's checks
and timings) and phase 4's serving call on a seeded encoder, and ``--p4t``
phase 16 alone.
``--mesh-nccl`` runs phase 14's runs on a machine with 4 cards, with
NCCL: V4 at DP 4 and DP 2 x MP 2, OR-CED at DP 2 x MP 2.
``--grid-cards`` times a grid chunk of GRID_CARD_RUNS V4 runs over every
card against the same runs on one card, with each card's busy share.
``--precision-gate`` runs the bf16 tiers' quality gate alone: V4 on a
synthetic split, 3 seeds x 4 epochs each under f32, bf16 and bf16 + nu16
(the kernels on), best valid accuracy and windows/s per seed and the
paired deltas against f32 (``tools/gate_optimizer_quality.py``'s method).
"""

import contextlib
import dataclasses
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
NAME = "SMOKE_V4"
N_SEEN, N_UNSEEN = 6, 4  # subjects: train classes 0-5, unseen 6-9
CROPS_PER_TRACK = 12
SCENARIOS = ("free_walk", "smartphone")
KS = (1, 2, 6)
KNIFE_EDGE = 1e-4  # |score - threshold| below which f32 noise may flip a crop
SEED = 0
TRAIN_NAME = "TRAIN_V4"
TRAIN_CROPS_PER_TRACK = (12, 4)  # train, valid
TRAIN_B = 16
TRAIN_STEPS = 5
# kernel steps vs plain steps: the layer kernel sums in another order than
# cuBLAS and its statistics are f64 sums of sum(y^2)/n - mean^2, where the
# plain path's BatchNorm takes mean((y - mean)^2) in f32; Adam's first
# steps (about lr * sign(g) per weight) carry such differences into the
# weights. Measured gap over 5 steps: see PERF.md.
LOSS_RTOL = 1e-3
ORCED_NAME = "SMOKE_ORCED"
ORCED_B = 64  # orced_inference's batch
SERVE_CROPS = 16  # crops per ORCED serving request
SERVE_BATCH = 24  # crops per PCAA serving request: 4 windows x 6
SERVE_WARM_CALLS = 15  # phase 10: calls after the 3 requests, for a warm median
# Chamfer kernel vs plain: the kernel rounds each distance as the plain
# pairwise_sq_dists does, so only the order of the sums differs; measured
# gap 2.8e-7 relative (see PERF.md), held at 35 times that. The f64 oracle
# is held at the JAX package's Chamfer parity bound, rtol 1e-3: two f32
# paths of xx + yy - 2xy cancel apart by up to about 2e-4 relative.
CHAMFER_TOL = dict(rtol=1e-5, atol=1e-6)
# Chamfer timing shapes (B, T, N, M): orced_inference's chunk of 64 crops
# and one serving request of 16; launches a CUDA graph captures; wrapper
# calls in a batch the host clock spans, and batches
CHAMFER_TIMED = {"chunk": (ORCED_B, 30, 150, 150), "request": (SERVE_CROPS, 30, 150, 150)}
CHAMFER_GRAPH_LAUNCHES = 50
CHAMFER_HOST_CALLS = 50
CHAMFER_HOST_BATCHES = 11
# phase 8: raw tracks of 10 subjects x 3 scenarios x 10 tracks, 6 seen;
# ORCED trained for 2 epochs, its step timed alone over a few steps
RAW_SUBJECTS, RAW_TRACKS = 10, 10
ORCED_TRAIN_NAME = "TRAIN_ORCED"
ORCED_EPOCHS = 2
ORCED_TIMED_STEPS = 6
# phase 9: the PCAA ablation; steps per path of each variant's step check
# (the first pays cuBLAS/cuDNN set-up), the driver's names, and the ORCED
# resume's cut of phase 8's train and valid crops
ABLATION = (("V1", False), ("V2", False), ("V3", False), ("V4", True))
VARIANT_STEPS = 3
ABLATION_BASE = "SMOKE_ABL_"
ORCED_RESUME_SUBSAMPLE = 0.25
RE_EDGE = 1e-3  # rec error within this relative distance of its threshold
P_EDGE = 1e-6  # latent score within this distance of 0.95
# Published peaks of the H100 SXM (NVIDIA data sheet, 700 W): f32 outside
# the tensor cores, dense TF32 on the tensor cores and HBM3 bandwidth;
# bound_ms is the larger of the operations over a peak and the bytes over
# the bandwidth
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12  # dense, on the tensor cores
HBM_BYTES_PER_S = 3.35e12
# phase 11 (bf16 training): a bf16 kernel against its plain version rounds
# at the same places and sums f32 in another order, so a stored bf16 value
# may sit one rounding step (8 significant bits) away, and a y near zero
# keeps the sum order's f32 error (atol 1e-4, the f32 kernel's bound);
# bf16 kernel steps against bf16 plain steps: such flips move what
# follows, through BatchNorm and the decoder (held at 10 times the f32
# steps' LOSS_RTOL)
BF16_STEP = dict(rtol=2.0**-7, atol=1e-4)
BF16_LOSS_RTOL = 1e-2
BF16_TIMED_STEPS = 4  # the first pays set-up; then 3 under torch.profiler
BF16_LAYER_WIDTHS = ((4, 512), (512, 512), (512, 1024), (1024, 1024))  # a step's 4 layers
BF16_NAME_BASE = "SMOKE_BF16_"
# phase 12 (the grid): run names, steps a run under the profiler
GRID_BASE = "SMOKE_GRID_"
# traces device_ms and the grid's busy share take before they give up on
# torch.profiler (a trace misses kernels now and then, three running at times)
PROFILER_TRACES = 5
GRID_PROFILE_STEPS = 3
# --precision-gate: V4 on a synthetic split, paired seeds (tools/
# gate_optimizer_quality.py's method), f32 against the two bf16 tiers
GATE_SEEDS, GATE_EPOCHS = 3, 4
# phase 15: steps of each cache on/off, deferred and factored run (on the
# host clock; the cache runs then 3 more under torch.profiler)
CACHE_STEPS = 3
GATE_CONFIGS = {"f32": {}, "bf16": {"COMPUTE_DTYPE": "bfloat16"},
                "bf16+nu16": {"COMPUTE_DTYPE": "bfloat16", "BF16_ADAM_NU": True}}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms within the block (its default
    backward-filter is not repeatable: PERF.md §7), restored after it."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn()`` over ``reps`` runs after one warm-up, by CUDA
    events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, rate: float = F32_FLOPS) -> tuple:
    """→ (bound_ms, bound_by): the least time the card could take for
    ``flops`` operations at ``rate`` on ``nbytes`` of input read once and
    output written once."""
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tensor_core_bound(flops: float, nbytes: float) -> dict:
    """The PointNet kernels' two bounds: f32 FFMA, and three TF32
    tensor-core passes per operation; the lower is the record's."""
    ffma, tc = bound(flops, nbytes), bound(3 * flops, nbytes, TF32_FLOPS)
    best, route = (tc, "3xtf32") if tc[0] <= ffma[0] else (ffma, "f32")
    return dict(bound_ms=best[0], bound_by=best[1], bound_route=route, bound_f32_ms=ffma[0],
                bound_3xtf32_ms=tc[0])


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def alternate(fns: dict, order, reps: int) -> dict:
    """Time each named function in the given order (e.g. plain, kernel,
    kernel, plain) and average its runs."""
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(cuda_ms(fns[name], reps))
    return {name: sum(t) / len(t) for name, t in times.items()}


def write_crops(gen: str, rng: np.random.Generator, splits=None) -> None:
    """Seeded crop files ``crop{i}_subj{j}_{scenario}_track{t}.npy`` of
    shape (30, 150, 4): each subject a cloud of its own centre and spread,
    each frame a random number of points, the rest zero (the NMAX padding
    real crops carry). ``splits``: (split, subjects, crops per track);
    default the test and unseen splits of phase 3."""
    if splits is None:
        splits = (("test", range(N_SEEN), CROPS_PER_TRACK),
                  ("unseen", range(N_SEEN, N_SEEN + N_UNSEEN), CROPS_PER_TRACK))
    for split, subjects, crops_per_track in splits:
        os.makedirs(os.path.join(gen, split))
        for subj in subjects:
            centre = rng.normal(0, 1.0, 4)
            spread = rng.uniform(0.2, 0.8, 4)
            for scenario in SCENARIOS:
                walk = np.cumsum(rng.normal(0, 0.05, (crops_per_track * 30, 4)), axis=0)
                for i in range(crops_per_track):
                    crop = np.zeros((30, 150, 4), np.float32)
                    for t in range(30):
                        n_pts = rng.integers(60, 151)
                        pts = centre + walk[i * 30 + t] + spread * rng.normal(size=(n_pts, 4))
                        crop[t, :n_pts] = pts
                    name = f"crop{i}_subj{subj}_{scenario}_track0.npy"
                    np.save(os.path.join(gen, split, name), crop)


def make_run_folder(models: str, cfg, train_x: np.ndarray) -> None:
    """A full-width V4 run folder from a seeded init, its running
    statistics set by 30 train-mode forwards, saved by the port."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.convert import encoder_variables
    from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGEncoder
    from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import module_path, save_params

    enc = CGEncoder(
        n_out_labels=cfg.n_classes, in_features=cfg.NFEATURES,
        sup_latent_dim=cfg.SUP_LATENT_DIM, pointnet_out_dim=cfg.POINTNET_OUT_DIM,
        dtc_filters=cfg.DTC_FILTERS, use_projection_head=True,
        generator=torch.Generator().manual_seed(SEED),
    ).cuda().train()
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for _ in range(30):
            idx = torch.randperm(len(train_x), generator=gen)[:8].numpy()
            enc(torch.from_numpy(train_x[idx]).cuda())
    run_dir = os.path.join(models, NAME)
    cfg.save(os.path.join(run_dir, "config.json"))
    save_params(encoder_variables(enc.state_dict()), module_path(run_dir, NAME, "E"))
    means = np.random.default_rng(SEED).normal(0, 0.3, (cfg.n_classes, cfg.SUP_LATENT_DIM))
    np.save(os.path.join(run_dir, "discriminator_means.npy"), means.astype(np.float32))


def window_starts(labels: np.ndarray, k: int, keep_mask=None):
    """The crops' first indices of the windows ``_window_vote`` emits."""
    return [
        s for s in range(0, len(labels) - k + 1, k)
        if len(np.unique(labels[s:s + k])) == 1 and (keep_mask is None or keep_mask[s])
    ]


def knife_edge(cal) -> tuple:
    thr = float(cal["log_threshold"])
    return (np.abs(cal["test_ll"] - thr) < KNIFE_EDGE,
            np.abs(cal["unseen_ll"] - thr) < KNIFE_EDGE)


def compare_decisions(cal_a, cal_b, dir_a: str, dir_b: str) -> int:
    """Assert equal decisions for every k except in windows that hold a
    knife-edge crop in either run; return the number of such windows. A
    window that differs is logged first: its crops' scores and predicted
    classes in both runs, and both thresholds."""
    for key in ("test_labels", "unseen_labels", "is_val"):
        np.testing.assert_array_equal(cal_a[key], cal_b[key])
    edge_test, edge_unseen = (a | b for a, b in zip(knife_edge(cal_a), knife_edge(cal_b)))
    exempt_total = 0
    for k in KS:
        windows = [("test", s) for s in window_starts(cal_a["test_labels"], k)]
        windows += [("unseen", s)
                    for s in window_starts(cal_a["unseen_labels"], k, ~cal_a["is_val"])]
        edge = np.array([(edge_test if split == "test" else edge_unseen)[s:s + k].any()
                         for split, s in windows], bool)
        for stem in ("final_preds", "final_labels"):
            a = np.load(os.path.join(dir_a, f"{stem}_{k}.npy"))
            b = np.load(os.path.join(dir_b, f"{stem}_{k}.npy"))
            assert a.shape == b.shape == edge.shape, (stem, k, a.shape, b.shape, edge.shape)
            bad = (a != b) & ~edge
            for i in np.flatnonzero(bad):
                split, s = windows[i]
                crops = {side: {f: cal[f"{split}_{f}"][s:s + k].tolist() for f in ("ll", "preds")}
                         for side, cal in (("a", cal_a), ("b", cal_b))}
                log(f"{stem}_{k}: window {i} ({split} crops {s}..{s + k - 1}) decided "
                    f"{a[i]} vs {b[i]}; thresholds {float(cal_a['log_threshold'])!r} vs "
                    f"{float(cal_b['log_threshold'])!r}; crops {crops}")
            assert not bad.any(), f"{stem}_{k}: {int(bad.sum())} windows differ"
        exempt_total += int(edge.sum())
    return exempt_total


def check_train_kernels(card: str) -> dict:
    """Phase 6a: each training kernel against its plain version at the
    training path's shapes and at ragged ones; times in the order plain,
    kernel, kernel, plain. → per kernel dict(err, ms, plain_ms, bound_ms,
    bound_by, library_ms)."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.ops import adam
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_train as pt

    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, device="cuda", generator=g) * scale + shift

    def affine(c):
        return torch.stack([randn(c, scale=0.3, shift=0.5), randn(c, scale=0.1, shift=0.5),
                            randn(c, scale=0.3)]).contiguous()

    rows = TRAIN_B * 30 * 150
    out = {}
    err, ms = 0.0, {"kernel": 0.0, "plain": 0.0}
    flops = moved = 0
    # the training widths, ragged rows, then widths the wrapper pads to
    # multiples of 4: NFEATURES = 5 (C_in 5) and POINTNET_OUT_DIM = 30
    # (5 -> 15 -> 15 -> 30 -> 30)
    for n, c_in, c_out, timed in ((rows, 4, 512, True), (rows, 512, 512, True),
                                  (rows, 512, 1024, True), (rows, 1024, 1024, True),
                                  (2 * 3 * 37, 4, 512, False), (2 * 3 * 37, 512, 1024, False),
                                  (2 * 3 * 1, 4, 512, False), (2 * 3 * 1, 512, 1024, False),
                                  (rows, 5, 512, False), (2 * 3 * 37, 5, 15, False),
                                  (2 * 3 * 37, 15, 15, False), (2 * 3 * 37, 15, 30, False),
                                  (2 * 3 * 37, 30, 30, False)):
        h = randn(n, c_in, scale=2.0, shift=0.5)
        a = None if c_in in (4, 5) else affine(c_in)
        w = randn(c_in, c_out, scale=c_in ** -0.5)
        b = randn(c_out, scale=0.1)
        before = pt.fused_layer.launches
        got = pt.fused_layer(h, a, w, b)
        torch.cuda.synchronize()
        assert pt.fused_layer.launches == before + 1, (n, c_in, c_out)
        assert tuple(got[0].shape) == (n, c_out) and got[1].shape == (c_out,)
        want = pt.fused_layer_ref(h, a, w, b)
        e = max(float((x - y).abs().max()) for x, y in zip(got, want))
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)
        err = max(err, e)
        line = f"phase 6a: layer kernel vs plain at ({n}, {c_in}->{c_out}): max |diff| {e:.3e}"
        if timed:
            t = alternate({"kernel": lambda: pt.fused_layer(h, a, w, b),
                           "plain": lambda: pt.fused_layer_ref(h, a, w, b)},
                          ("plain", "kernel", "kernel", "plain"), reps=5)
            for k in ms:
                ms[k] += t[k]
            flops += 2 * n * c_in * c_out
            moved += nbytes(h, w, b, *got) + (0 if a is None else nbytes(a))
            line += f"; kernel {t['kernel']:.3f} ms, plain {t['plain']:.3f} ms [{card}]"
        log(line)
        del h, got, want
    step = tensor_core_bound(flops, moved)
    # the record is per launch: the mean of the step's 4 layers
    out["layer"] = dict(err=err, ms=ms["kernel"] / 4, plain_ms=ms["plain"] / 4, library_ms=None,
                        **{k: v / 4 if k.endswith("_ms") else v for k, v in step.items()})
    log(f"phase 6a: the 4 layers of a step: kernel {ms['kernel']:.3f} ms, plain "
        f"{ms['plain']:.3f} ms (y, mean, var within rtol 1e-4, atol 1e-4); bound f32 "
        f"{step['bound_f32_ms']:.3f} ms ({100 * step['bound_f32_ms'] / ms['kernel']:.1f}% of the "
        f"kernel's time), 3xTF32 {step['bound_3xtf32_ms']:.3f} ms "
        f"({100 * step['bound_3xtf32_ms'] / ms['kernel']:.1f}%) ({flops / 1e9:.1f} GFLOP, "
        f"{moved / 1e6:.1f} MB); per launch: kernel {ms['kernel'] / 4:.4f} ms, plain "
        f"{ms['plain'] / 4:.4f} ms [{card}]")

    err = 0.0
    for frames, n in ((TRAIN_B * 30, 150), (2 * 3, 37)):
        y = randn(frames, n, 1024, scale=2.0, shift=0.5)
        a = affine(1024)
        got = pt.fused_pool(y, a)
        torch.cuda.synchronize()
        want = pt.fused_pool_ref(y, a)
        e = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = max(err, e)
        log(f"phase 6a: pool kernel vs plain at ({frames}, {n}, 1024): max |diff| {e:.3e}")
    y = randn(TRAIN_B * 30, 150, 1024, scale=2.0, shift=0.5)
    t = alternate({"kernel": lambda: pt.fused_pool(y, a), "plain": lambda: pt.fused_pool_ref(y, a)},
                  ("plain", "kernel", "kernel", "plain"), reps=5)
    # per element: normalize (2 fma), ELU, sum
    bms, by = bound(6 * y.numel(), nbytes(y, a) + TRAIN_B * 30 * 1024 * 4)
    out["pool"] = dict(err=err, ms=t["kernel"], plain_ms=t["plain"], bound_ms=bms, bound_by=by,
                       bound_route="f32", library_ms=None)
    log(f"phase 6a: pool at ({TRAIN_B * 30}, 150, 1024): kernel {t['kernel']:.3f} ms, plain "
        f"{t['plain']:.3f} ms (rtol 1e-5, atol 1e-5); bound {bms:.4f} ms [{card}]")
    del y

    err = 0.0
    s1, s2 = adam.adam_scalars(3, 1e-4, 0.9, 0.99)
    coeffs = dict(s1=s1, s2=s2, b1=0.9, b2=0.99, eps=1e-8)
    for shape in ((2047, 1025), (9000, 18000)):  # 2,098,175 elements: n % 4 == 3
        leaf = [randn(*shape, scale=1e-2), randn(*shape), randn(*shape, scale=1e-3),
                torch.rand(shape, device="cuda", generator=g) * 1e-4]
        ref = [t.clone() for t in leaf]
        adam.adam_update_(*leaf, **coeffs)
        torch.cuda.synchronize()
        adam.adam_update_ref_(*ref, **coeffs)
        e = max(float((x - y).abs().max()) for x, y in zip(leaf[1:], ref[1:]))
        for x, y in zip(leaf[1:], ref[1:]):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
        err = max(err, e)
        log(f"phase 6a: Adam kernel vs plain on a {shape} leaf: max |diff| {e:.3e}")
    # the yardstick: PyTorch's own fused Adam on the same leaf (g, w, m, v)
    lib = [t.clone() for t in ref]
    step = torch.tensor(3.0, device="cuda")

    def fused_adam():
        torch._fused_adam_([lib[1]], [lib[0]], [lib[2]], [lib[3]], [], [step], lr=1e-4,
                           beta1=0.9, beta2=0.99, weight_decay=0.0, eps=1e-8, amsgrad=False,
                           maximize=False)

    t = alternate({"kernel": lambda: adam.adam_update_(*leaf, **coeffs),
                   "plain": lambda: adam.adam_update_ref_(*ref, **coeffs),
                   "library": fused_adam},
                  ("plain", "kernel", "library", "library", "kernel", "plain"), reps=5)
    # per element 13 operations; reads g, w, m, v and writes w, m, v
    bms, by = bound(13 * leaf[0].numel(), nbytes(*leaf) + nbytes(*leaf[1:]))
    out["adam"] = dict(err=err, ms=t["kernel"], plain_ms=t["plain"], bound_ms=bms, bound_by=by,
                       bound_route="f32", library_ms=t["library"])
    log(f"phase 6a: Adam on the 9000 x 18000 leaf: kernel {t['kernel']:.3f} ms, plain "
        f"{t['plain']:.3f} ms, torch._fused_adam_ {t['library']:.3f} ms (rtol 1e-6, atol "
        f"1e-9); bound {bms:.3f} ms [{card}]")
    del leaf, ref, lib
    torch.cuda.empty_cache()
    return out


def train_counts() -> tuple:
    from opensetgaitrecognition_pcaa_tpu_torch.ops import adam
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_train as pt

    return pt.fused_layer.launches, pt.fused_pool.launches, adam.adam_update_.launches


def reset_train_counts() -> None:
    from opensetgaitrecognition_pcaa_tpu_torch.ops import adam
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_train as pt

    pt.fused_layer.launches = pt.fused_pool.launches = adam.adam_update_.launches = 0


def run_steps(cfg, fused: bool, x, y, perm, noise) -> dict:
    """Phase 6b: TRAIN_STEPS steps from the seeded state with both flags
    ``fused`` → losses, step times, launch counts, peak memory."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
        VARIANTS,
        build_pcaa,
        make_train_step,
    )

    cfg = cfg.replace(FUSED_POINTNET=fused, FUSED_ADAM=fused)
    mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cuda")
    step = make_train_step(mods, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = dict(losses=[], ms=[], counts=[])
    for i in range(TRAIN_STEPS):
        idx = perm[i]
        reset_train_counts()
        t0 = time.perf_counter()
        state, m = step(state, x[idx], y[idx], i, (noise[0][i], noise[1][i]))
        torch.cuda.synchronize()
        res["ms"].append(1e3 * (time.perf_counter() - t0))
        res["counts"].append(train_counts())
        res["losses"].append({k: float(v) for k, v in m.items()})
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in mods.parameters())
    res["n_params"] = n_params
    del mods, state, step, m
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_phase(card: str, gen: str) -> dict:
    """Phase 6b and 6c → launches of each training kernel on the main path
    and of the inference kernel in 6c."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, Config
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import (
        RadarCropDataset,
        epoch_batch_indices,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import pcaa_inference
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_infer as pn
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import train_pcaa

    cfg = Config(
        NMAX=150, NSTEPS=30, NFEATURES=4, POINTNET_OUT_DIM=1024,
        DTC_FILTERS=(16, 32, 64, 128, 256, 512), SUP_LATENT_DIM=32,
        TRAIN_CLASSES=tuple(range(N_SEEN)), BATCH_SIZE=TRAIN_B, EPOCHS=1, SEED=SEED,
        MODEL_NAME=TRAIN_NAME, GEN_DATA_PATH=gen, MODELS_PATH=os.path.join(WORK, "models_train"),
    )
    x_np, y_np = RadarCropDataset(SPLIT.TRAIN, gen).load_all()
    x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
    perm = torch.from_numpy(
        epoch_batch_indices(len(x_np), TRAIN_B, shuffle=True, rng=np.random.default_rng(SEED))
    ).long().cuda()
    rng = np.random.default_rng(SEED + 3)
    noise = (torch.from_numpy(rng.normal(size=(TRAIN_STEPS, TRAIN_B, 32)).astype(np.float32)).cuda(),
             torch.from_numpy(rng.uniform(size=(TRAIN_STEPS, TRAIN_B, 1)).astype(np.float32)).cuda())

    runs = {}
    for path, fused in (("plain", False), ("kernel", True)):
        runs[path] = r = run_steps(cfg, fused, x, y, perm, noise)
        warm = r["ms"][1:]  # the first step pays cuBLAS/cuDNN set-up
        ms = sum(warm) / len(warm)
        log(f"phase 6b: {TRAIN_STEPS} steps via {path} ({r['n_params'] / 1e6:.1f}M parameters): "
            f"ms per step {[round(t, 2) for t in r['ms']]}, warm mean {ms:.2f} ms, "
            f"{TRAIN_B / (ms / 1e3):.1f} train windows/s, peak memory {r['peak_gb']:.2f} GB; "
            f"launches (layer, pool, adam) per step {r['counts'][0]} [{card}]")
        r["warm_ms"] = ms
    for counts in runs["kernel"]["counts"]:
        assert counts == (4, 1, 4), counts
    for counts in runs["plain"]["counts"]:
        assert counts == (0, 0, 0), counts
    worst = 0.0
    for i, (k, p) in enumerate(zip(runs["kernel"]["losses"], runs["plain"]["losses"])):
        for key in ("rec_loss", "d_loss", "sup_loss", "tot_loss"):
            assert np.isfinite(k[key]) and np.isfinite(p[key]), (i, key, k[key], p[key])
            gap = abs(k[key] - p[key]) / max(abs(p[key]), 1.0)
            worst = max(worst, gap)
            assert gap <= LOSS_RTOL, (i, key, k[key], p[key])
        log(f"phase 6b: step {i} kernel vs plain: "
            + ", ".join(f"{key} {k[key]:.6f}/{p[key]:.6f}"
                        for key in ("rec_loss", "d_loss", "sup_loss", "tot_loss")))
    log(f"phase 6b: losses kernel vs plain agree within {worst:.3e} "
        f"(relative to max(|plain|, 1); bound {LOSS_RTOL})")
    launches = [TRAIN_STEPS * c for c in (4, 1, 4)]
    del x, y, perm, noise
    gc.collect()
    torch.cuda.empty_cache()

    # --- 6c. one epoch of train_pcaa through the kernels, then score it ------
    reset_train_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_pcaa(cfg.replace(FUSED_POINTNET=True, FUSED_ADAM=True), verbose=False,
                     device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = train_counts()
    steps = len(x_np) // TRAIN_B
    assert counts == (4 * steps, steps, 4 * steps), (counts, steps)
    launches = [a + b for a, b in zip(launches, counts)]
    for k, v in out.items():
        assert np.isfinite(v), (k, v)
    run_dir = os.path.join(cfg.MODELS_PATH, TRAIN_NAME)
    want = {"config.json", "metrics.jsonl", "discriminator_means.npy", "run_complete.json"} | {
        f"{TRAIN_NAME}_{tag}.msgpack" for tag in ("E", "D", "G", "GPH")}
    assert set(os.listdir(run_dir)) == want, sorted(os.listdir(run_dir))
    log(f"phase 6c: train_pcaa, 1 epoch of {steps} steps via the kernels in {seconds:.2f} s "
        f"({out['windows_per_sec']:.1f} windows/s with validation), launches (layer, pool, "
        f"adam) {counts}; Reconstruction Loss Train {out['Reconstruction Loss Train']:.4f}, "
        f"Valid Accuracy {out['Valid Accuracy']:.4f} [{card}]")

    pn.pointnet_pool_infer.launches = 0
    logs = pcaa_inference(
        [TRAIN_NAME], ks=KS, models_path=cfg.MODELS_PATH,
        figures_path=os.path.join(WORK, "figures_train"), generate_dataset=False,
        dump_calibration=True, device="cuda", use_kernel=True,
    )
    infer_launches = pn.pointnet_pool_infer.launches
    assert infer_launches > 0
    cal = dict(np.load(os.path.join(run_dir, "calibration.npz")))
    for key in ("log_threshold", "test_ll", "unseen_ll"):
        assert np.isfinite(cal[key]).all(), key
    for k in KS:
        preds = np.load(os.path.join(run_dir, f"final_preds_{k}.npy"))
        assert len(preds) > 0 and preds.min() >= 0 and preds.max() <= cfg.n_classes
    log(f"phase 6c: pcaa_inference scored the trained run folder through the inference "
        f"kernel ({infer_launches} launches): f1_micro "
        f"{[round(logs[TRAIN_NAME][k]['f1_micro'], 4) for k in KS]}")
    return dict(layer=launches[0], pool=launches[1], adam=launches[2], infer=infer_launches)


def chamfer_inputs(g, b, t, n, m, c=4):
    """Crop-like clouds: gts zero-padded after a random count of real
    points per frame, preds a dense cloud near them."""
    import torch

    gts = torch.randn((b, t, n, c), device="cuda", generator=g)
    keep = torch.randint(max(1, n // 2), n + 1, (b, t, 1, 1), device="cuda", generator=g)
    gts = gts * (torch.arange(n, device="cuda")[None, None, :, None] < keep)
    preds = 0.7 * torch.randn((b, t, m, c), device="cuda", generator=g) + 0.2
    return preds.contiguous(), gts.contiguous()


def chamfer_device_ms(ck, preds, gts) -> dict:
    """Device time of one raw launch of the Chamfer kernel (``ck._launch``,
    no mean over T): ``graph``, a CUDA graph that captured
    CHAMFER_GRAPH_LAUNCHES launches, replayed 5 times between CUDA events
    (the inputs stay in L2, as the decoder's output and the crop chunk are
    when ``orced_inference`` calls it); ``profiler``, torch.profiler's
    kernel time per launch over as many eager launches, None where it
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    k = CHAMFER_GRAPH_LAUNCHES
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ck._launch(preds, gts)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            ck._launch(preds, gts)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph_ms = start.elapsed_time(end) / (5 * k)
    del graph
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(k):
            ck._launch(preds, gts)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "chamfer" in e.key]
    count = sum(e.count for e in events)
    prof_ms = sum(e.device_time_total for e in events) / count / 1e3 if count else None
    return dict(graph=graph_ms, profiler=prof_ms)


def chamfer_host_ms(ck, preds, gts) -> float:
    """Host time of one ``seq_chamfer_kernel(..., avg_out=False)`` call:
    a host clock around each of CHAMFER_HOST_BATCHES batches of
    CHAMFER_HOST_CALLS calls (the card runs behind and is not waited for),
    the median batch over its calls. The median, because the card's host
    is shared and its clock spreads."""
    import torch

    ck.seq_chamfer_kernel(preds, gts, avg_out=False)
    batches = []
    for _ in range(CHAMFER_HOST_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CHAMFER_HOST_CALLS):
            ck.seq_chamfer_kernel(preds, gts, avg_out=False)
        batches.append((time.perf_counter() - t0) / CHAMFER_HOST_CALLS * 1e3)
    torch.cuda.synchronize()
    return sorted(batches)[len(batches) // 2]


def time_chamfer(card: str) -> dict:
    """Phase 7a's timing of the Chamfer kernel at the orced_inference chunk
    (64, 30, 150, 4) and a serving request (16, 30, 150, 4): device time per
    launch (graph and profiler), the wrapper's host time per call, and the
    f32 bound. Works on any tree of the port whose wrapper has ``_launch``
    and ``seq_chamfer_kernel`` (``--chamfer-timing``). → {shape: dict}."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.ops import chamfer_kernel as ck

    out = {}
    for name, (b, t, n, m) in CHAMFER_TIMED.items():
        preds, gts = chamfer_inputs(torch.Generator(device="cuda").manual_seed(SEED), b, t, n, m)
        dev = chamfer_device_ms(ck, preds, gts)
        host = chamfer_host_ms(ck, preds, gts)
        f, c = b * t, 4
        # per pair: the dot (2C), |x|^2 + |y|^2 - 2 x.y (2) and the two minima (2)
        bms, by = bound(f * n * m * (2 * c + 4), nbytes(preds, gts) + f * 4)
        prof = "not measured" if dev["profiler"] is None else f"{dev['profiler'] * 1e3:.2f} us"
        log(f"phase 7a: Chamfer device time at {(b, t, n, 4)} ({f} frames): graph of "
            f"{CHAMFER_GRAPH_LAUNCHES} launches {dev['graph'] * 1e3:.2f} us per launch, profiler "
            f"{prof}; bound {bms * 1e3:.2f} us ({by}, {100 * bms / dev['graph']:.1f}% of the graph "
            f"time); wrapper host time {host * 1e3:.2f} us per call [{card}]")
        out[name] = dict(graph_ms=dev["graph"], profiler_ms=dev["profiler"], host_ms=host,
                         bound_ms=bms, bound_by=by)
        del preds, gts
    return out


def check_chamfer_kernel(card: str) -> dict:
    """Phase 7a: the Chamfer kernel against its plain version and an f64
    oracle at the main path's shape, a serving request's, ragged shapes,
    five channels, one point, two tiles of points and N = M = 704; timed
    against plain and torch.cdist through the wrapper at the main path's
    shape, then alone on the device at the chunk and request shapes
    (``time_chamfer``). → dict(err, ms, plain_ms, bound_ms, bound_by,
    library_ms), ``ms`` the kernel's device time per launch at (64, 30,
    150, 4) (CUDA graph), plain and library through one call each."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.ops import chamfer_kernel as ck
    from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer import frame_chamfer, seq_chamfer

    g = torch.Generator(device="cuda").manual_seed(SEED)
    err = rel = 0.0
    # the main path's shapes, ragged, five-channel, one-point, two-tile and
    # N = M = 704 shapes; then channel counts the wrapper pads (3 to 4, 6 to
    # 8), the C = 8 build and C = 12 through the run-time-C kernel
    for b, t, n, m, c in ((ORCED_B, 30, 150, 150, 4), (SERVE_CROPS, 30, 150, 150, 4),
                          (3, 5, 37, 53, 4), (3, 5, 37, 53, 5), (2, 3, 1, 1, 4), (2, 3, 1, 9, 4),
                          (1, 2, 1500, 2100, 4), (4, 6, 704, 704, 4), (4, 30, 150, 150, 3),
                          (3, 5, 37, 53, 6), (3, 5, 37, 53, 8), (4, 30, 150, 150, 12)):
        preds, gts = chamfer_inputs(g, b, t, n, m, c)
        before = ck.seq_chamfer_kernel.launches
        got = ck.frame_chamfer_kernel(preds, gts)
        torch.cuda.synchronize()
        assert ck.seq_chamfer_kernel.launches == before + 1, (b, t, n, m, c)
        want = frame_chamfer(preds, gts)
        d = ((gts.double()[:, :, :, None] - preds.double()[:, :, None]) ** 2).sum(-1)
        oracle = d.amin(2).sum(2) + d.amin(3).sum(2)
        del d
        torch.testing.assert_close(got, want, **CHAMFER_TOL)
        torch.testing.assert_close(got.double(), oracle, rtol=1e-3, atol=0)
        e = float((got - want).abs().max())
        r = float(((got - want).abs() / want.abs()).max())
        r64 = float(((got.double() - oracle).abs() / oracle.abs()).max())
        err, rel = max(err, e), max(rel, r)
        log(f"phase 7a: Chamfer kernel vs plain at {(b, t, n, m, c)} (B, T, N, M, C): max |diff| "
            f"{e:.3e}, max relative gap {r:.3e}; vs f64 oracle {r64:.3e}")
    preds, gts = chamfer_inputs(g, ORCED_B, 30, 150, 150)
    for avg_out in (True, False):
        torch.testing.assert_close(ck.seq_chamfer_kernel(preds, gts, avg_out=avg_out),
                                   seq_chamfer(preds, gts, avg_out=avg_out), **CHAMFER_TOL)
    first = ck.frame_chamfer_kernel(preds, gts)
    alone = torch.cat([ck.frame_chamfer_kernel(preds[i:i + 1, j:j + 1], gts[i:i + 1, j:j + 1])
                       for i, j in ((0, 0), (17, 29), (63, 5))], 1)
    again = ck.frame_chamfer_kernel(preds, gts)
    torch.cuda.synchronize()
    assert torch.equal(first, again), "two launches differ"
    assert torch.equal(alone[0], first[[0, 17, 63], [0, 29, 5]]), "a frame alone differs"
    log("phase 7a: Chamfer bitwise equal across two launches and for 3 frames launched alone")

    def cdist():  # the yardstick: one library call for the distances
        d = torch.cdist(gts, preds) ** 2
        return d.amin(2).sum(2) + d.amin(3).sum(2)

    torch.testing.assert_close(cdist(), frame_chamfer(preds, gts), rtol=1e-3, atol=1e-3)
    ms = alternate({"kernel": lambda: ck.seq_chamfer_kernel(preds, gts, avg_out=False),
                    "plain": lambda: seq_chamfer(preds, gts, avg_out=False),
                    "library": cdist},
                   ("plain", "kernel", "library", "library", "kernel", "plain"), reps=20)
    log(f"phase 7a: Chamfer at ({ORCED_B}, 30, 150, 4), CUDA events around 20 calls each: "
        f"kernel through its wrapper {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, cdist + "
        f"amin {ms['library']:.4f} ms; max relative gap to plain {rel:.3e} (bound rtol 1e-5, "
        f"atol 1e-6) [{card}]")
    timed = time_chamfer(card)["chunk"]
    return dict(err=err, ms=timed["graph_ms"], plain_ms=ms["plain"], bound_ms=timed["bound_ms"],
                bound_by=timed["bound_by"], bound_route="f32", library_ms=ms["library"])


def make_orced_run_folder(models: str, cfg, train_x: np.ndarray) -> None:
    """A full-width ORCED run folder from seeded inits, the running
    statistics of the encoder and the mean learner set by 30 train-mode
    forwards, saved by the port."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.convert import (
        decoder_variables,
        encoder_variables,
        mean_learner_variables,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.models.mean_learner import GaussianMeanLearner
    from opensetgaitrecognition_pcaa_tpu_torch.models.orced import ORCEDDecoder, ORCEDEncoder
    from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import module_path, save_params

    init = torch.Generator().manual_seed(SEED + 4)
    enc = ORCEDEncoder(
        n_out_labels=cfg.n_classes, in_features=cfg.NFEATURES,
        sup_latent_dim=cfg.SUP_LATENT_DIM, pointnet_out_dim=cfg.POINTNET_OUT_DIM,
        dtc_filters=cfg.DTC_FILTERS, generator=init,
    ).cuda().train()
    dec = ORCEDDecoder(cfg.SUP_LATENT_DIM, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES, generator=init)
    ml = GaussianMeanLearner(cfg.n_classes, cfg.SUP_LATENT_DIM, generator=init).train()
    gen = torch.Generator().manual_seed(SEED + 5)
    noise = torch.Generator(device="cuda").manual_seed(SEED + 5)
    with torch.no_grad():
        for _ in range(30):
            idx = torch.randperm(len(train_x), generator=gen)[:8].numpy()
            enc(torch.from_numpy(train_x[idx]).cuda(), generator=noise)
            ml(torch.eye(cfg.n_classes))
    run_dir = os.path.join(models, ORCED_NAME)
    cfg.save(os.path.join(run_dir, "config.json"))
    save_params(encoder_variables(enc.state_dict()), module_path(run_dir, ORCED_NAME, "E"))
    save_params(decoder_variables(dec.state_dict()), module_path(run_dir, ORCED_NAME, "G"))
    save_params(mean_learner_variables(ml.state_dict()), module_path(run_dir, ORCED_NAME, "ML"))
    log(f"phase 7b: ORCED run folder, {sum(p.numel() for p in dec.parameters()) / 1e6:.1f}M "
        f"decoder parameters, {sum(p.numel() for p in enc.parameters()) / 1e6:.2f}M encoder")


def orced_knife_edge(cal, split: str, keep=None):
    """Crops whose rec error lies within RE_EDGE (relative) of their
    predicted class's threshold, or whose latent score lies within P_EDGE
    of 0.95 for some class."""
    from opensetgaitrecognition_pcaa_tpu_torch.infer.orced import (
        THRESHOLD_G,
        ORCEDClassStats,
        orced_latent_scores,
    )

    stats = ORCEDClassStats(cal["means_z"], cal["stds_z"], cal["thresholds_re"],
                            int(cal["n_labels"]))
    preds, z, re = (cal[f"{split}_{k}"] for k in ("preds", "z", "re"))
    if keep is not None:
        preds, z, re = preds[keep], z[keep], re[keep]
    thr = stats.thresholds_re[preds]
    p = orced_latent_scores(stats, z)
    return (np.abs(re - thr) <= RE_EDGE * np.abs(thr)) | (np.abs(p - THRESHOLD_G) <= P_EDGE).any(0)


def orced_eps(gen: str, latent: int) -> dict:
    """Phase 7c's pinned eps: ``(n_crops, latent)`` f32 for each split."""
    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset

    rng = np.random.default_rng(SEED + 6)
    return {key: rng.normal(size=(len(RadarCropDataset(split, gen)), latent)).astype(np.float32)
            for key, split in (("train", SPLIT.TRAIN), ("test", SPLIT.TEST),
                               ("unseen", SPLIT.UNSEEN))}


def orced_phase(card: str, gen: str) -> dict:
    """Phase 7b-d → launches of the PointNet and Chamfer kernels on the
    ORCED main path (7c's kernel run and 7d)."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, Config
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
    from opensetgaitrecognition_pcaa_tpu_torch.infer.orced import (
        ORCEDClassStats,
        orced_apply_ood,
        orced_inference,
        orced_inference_setup,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.infer.serving import (
        make_orced_forward_fn,
        orced_decide_host,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.ops import chamfer_kernel as ck
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_infer as pn

    cfg = Config(
        NMAX=150, NSTEPS=30, NFEATURES=4, POINTNET_OUT_DIM=1024,
        DTC_FILTERS=(16, 32, 64, 128, 256, 512), SUP_LATENT_DIM=32,
        TRAIN_CLASSES=tuple(range(N_SEEN)), MODEL_NAME=ORCED_NAME, GEN_DATA_PATH=gen,
    )
    train_x, _ = RadarCropDataset(SPLIT.TRAIN, gen).load_all()
    assert len(train_x) >= ORCED_B, len(train_x)
    src = os.path.join(WORK, "models_orced_src")
    make_orced_run_folder(src, cfg, train_x)
    eps = orced_eps(gen, cfg.SUP_LATENT_DIM)

    # --- 7c. orced_inference through the kernels, then plain ------------------
    runs = {}
    for path in ("kernel", "plain"):
        models = os.path.join(WORK, f"models_orced_{path}")
        figures = os.path.join(WORK, f"figures_orced_{path}")
        shutil.copytree(os.path.join(src, ORCED_NAME), os.path.join(models, ORCED_NAME))
        pn.pointnet_pool_infer.launches = ck.seq_chamfer_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = orced_inference(
            [ORCED_NAME], device="cuda", models_path=models, figures_path=figures,
            generate_dataset=False, batch_size=ORCED_B, eps_streams=eps, dump_calibration=True,
            use_kernel=path == "kernel",
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        cal = dict(np.load(os.path.join(models, ORCED_NAME, "orced_calibration.npz")))
        final = {stem: np.load(os.path.join(figures, ORCED_NAME, f"ensemble_ood_final_{stem}_fixed.npy"))
                 for stem in ("preds", "labels")}
        for split in ("train", "test", "unseen"):
            assert np.isfinite(cal[f"{split}_z"]).all() and np.isfinite(cal[f"{split}_re"]).all()
        assert len(final["preds"]) > 0 and final["preds"].max() <= cfg.n_classes
        runs[path] = dict(cal=cal, final=final, models=models, launches=(
            pn.pointnet_pool_infer.launches, ck.seq_chamfer_kernel.launches))
        m = logs[ORCED_NAME]
        log(f"phase 7c: orced_inference via {path}: {seconds:.2f} s, launches (PointNet, "
            f"Chamfer) {runs[path]['launches']}, {len(final['preds'])} decisions, f1_micro "
            f"{m['f1_micro']:.4f}, f1_macro {m['f1_macro']:.4f}, f1_weighted "
            f"{m['f1_weighted']:.4f} [{card}]")
    k_launch, p_launch = runs["kernel"]["launches"], runs["plain"]["launches"]
    assert k_launch[0] > 0 and k_launch[1] > 0, k_launch
    assert p_launch == (0, 0), p_launch
    ck_cal, pl_cal = runs["kernel"]["cal"], runs["plain"]["cal"]
    lat_err = re_gap = 0.0
    for split in ("train", "test", "unseen"):
        np.testing.assert_allclose(ck_cal[f"{split}_z"], pl_cal[f"{split}_z"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(ck_cal[f"{split}_re"], pl_cal[f"{split}_re"], rtol=1e-3, atol=0)
        lat_err = max(lat_err, float(np.abs(ck_cal[f"{split}_z"] - pl_cal[f"{split}_z"]).max()))
        re_gap = max(re_gap, float((np.abs(ck_cal[f"{split}_re"] - pl_cal[f"{split}_re"])
                                    / np.abs(pl_cal[f"{split}_re"])).max()))
    for key in ("train_labels", "test_labels", "unseen_labels", "unseen_keep"):
        np.testing.assert_array_equal(ck_cal[key], pl_cal[key])
    np.testing.assert_array_equal(runs["kernel"]["final"]["labels"], runs["plain"]["final"]["labels"])
    keep = ck_cal["unseen_keep"]
    edge = np.zeros(len(runs["kernel"]["final"]["preds"]), bool)
    for cal in (ck_cal, pl_cal):
        edge |= np.concatenate([orced_knife_edge(cal, "test"), orced_knife_edge(cal, "unseen", keep)])
    bad = (runs["kernel"]["final"]["preds"] != runs["plain"]["final"]["preds"]) & ~edge
    assert not bad.any(), f"{int(bad.sum())} decisions differ away from the knife edge"
    log(f"phase 7c: latents kernel vs plain max |diff| {lat_err:.3e} (atol 1e-4), rec errors "
        f"max relative gap {re_gap:.3e} (rtol 1e-3); decisions equal, {int(edge.sum())} "
        f"knife-edge crops exempt (rec error within rtol {RE_EDGE} of its threshold or a "
        f"latent score within {P_EDGE} of 0.95)")

    # --- 7d. serving: 3 requests of SERVE_CROPS test crops ----------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, encoder, decoder = orced_inference_setup(
        ORCED_NAME, device="cuda", models_path=runs["kernel"]["models"], generate_dataset=False)
    torch.cuda.synchronize()
    log(f"phase 7d: orced_inference_setup (read E and G, move to the card) "
        f"{time.perf_counter() - t0:.2f} s")
    forward = make_orced_forward_fn(encoder, decoder)
    stat_args = (ck_cal["means_z"], ck_cal["stds_z"], ck_cal["thresholds_re"],
                 int(ck_cal["n_labels"]))
    stats = ORCEDClassStats(*stat_args)
    x_test, _ = RadarCropDataset(SPLIT.TEST, gen).load_all()
    edge_test = orced_knife_edge(ck_cal, "test")
    serve_ms, exempt = [], 0
    pn.pointnet_pool_infer.launches = ck.seq_chamfer_kernel.launches = 0
    for r in range(3):
        sl = slice(SERVE_CROPS * r, SERVE_CROPS * (r + 1))
        x = torch.from_numpy(x_test[sl]).cuda()
        e = torch.from_numpy(eps["test"][sl]).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decisions, latent_flag, rec_flag = orced_decide_host(*forward(x, e), *stat_args)
        serve_ms.append(1e3 * (time.perf_counter() - t0))
        want = orced_apply_ood(stats, 0.95, ck_cal["test_preds"][sl], ck_cal["test_z"][sl],
                               ck_cal["test_re"][sl])
        assert decisions.shape == (SERVE_CROPS,)
        assert ((decisions == want) | edge_test[sl]).all(), (decisions, want)
        assert ((decisions == cfg.n_classes) == (latent_flag | rec_flag)).all()
        exempt += int(edge_test[sl].sum())
    serve_launches = (pn.pointnet_pool_infer.launches, ck.seq_chamfer_kernel.launches)
    assert serve_launches == (3, 3), serve_launches
    log(f"phase 7d: served 3 ORCED requests of ({SERVE_CROPS}, 30, 150, 4) with pinned eps; "
        f"decisions equal to orced_apply_ood ({exempt} knife-edge crops exempt); launches "
        f"(PointNet, Chamfer) {serve_launches}; ms per request "
        f"{[round(t, 2) for t in serve_ms]} [{card}]")
    del encoder, decoder, forward
    gc.collect()
    torch.cuda.empty_cache()
    return dict(pointnet=k_launch[0] + serve_launches[0], chamfer=k_launch[1] + serve_launches[1])


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB PNG of unfiltered rows, as
    ``infer/artifacts.py::write_png`` writes it, checking the signature
    and every chunk's CRC → ``(H, W, 3)`` uint8."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, f"bad CRC in {tag}"
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + length
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, colour) == (8, 2), (depth, colour)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 3 * w + 1)
    assert not rows[:, 0].any(), "filtered rows"
    return rows[:, 1:].reshape(h, w, 3)


def orced_training_phase(card: str) -> dict:
    """Phase 8: OR-CED from raw tracks at full width → launches of the
    PointNet and Chamfer kernels while ``orced_inference`` scored the
    trained run folder through them (8d)."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, Config
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import (
        RadarCropDataset,
        epoch_batch_indices,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.data.splits import generate_splits
    from opensetgaitrecognition_pcaa_tpu_torch.data.synthetic import (
        generate_synthetic_raw_dataset,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.infer.artifacts import openset_confusion_matrix
    from opensetgaitrecognition_pcaa_tpu_torch.infer.orced import orced_inference
    from opensetgaitrecognition_pcaa_tpu_torch.ops import chamfer_kernel as ck
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_infer as pn
    from opensetgaitrecognition_pcaa_tpu_torch.train.orced import (
        build_orced,
        make_orced_train_step,
        train_orced,
    )

    # --- 8a. raw tracks and their splits -----------------------------------------
    raw = os.path.join(WORK, "raw")
    gen = os.path.join(WORK, "gen_orced")
    t0 = time.perf_counter()
    generate_synthetic_raw_dataset(raw, n_subjects=RAW_SUBJECTS,
                                   tracks_per_scenario=RAW_TRACKS, seed=SEED)
    raw_s = time.perf_counter() - t0
    cfg = Config(
        NMAX=150, NSTEPS=30, CROP_STEP=6, NFEATURES=4, POINTNET_OUT_DIM=1024,
        DTC_FILTERS=(16, 32, 64, 128, 256, 512), SUP_LATENT_DIM=32,
        TRAIN_CLASSES=tuple(range(N_SEEN)), BATCH_SIZE=TRAIN_B, EPOCHS=ORCED_EPOCHS,
        CHECKPOINT_FREQUENCY=1, SEED=SEED, MODEL_NAME=ORCED_TRAIN_NAME, DATA_PATH=raw,
        GEN_DATA_PATH=gen, MODELS_PATH=os.path.join(WORK, "models_orced_train"),
    )
    t0 = time.perf_counter()
    counts = generate_splits(data_path=raw, gen_data_path=gen, train_classes=cfg.TRAIN_CLASSES,
                             seed=0, nmax_points=cfg.NMAX, nsteps=cfg.NSTEPS,
                             crop_step=cfg.CROP_STEP, verbose=False)
    split_s = time.perf_counter() - t0
    assert all(counts.values()), counts
    log(f"phase 8a: {RAW_SUBJECTS} subjects x 3 scenarios x {RAW_TRACKS} raw tracks written in "
        f"{raw_s:.2f} s; generate_splits {split_s:.2f} s, crops {counts} [{card}]")

    # --- 8b. the ORCED step alone, then train_orced for 2 epochs --------------------
    x_np, y_np = RadarCropDataset(SPLIT.TRAIN, gen).load_all()
    x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
    perm = epoch_batch_indices(len(x_np), TRAIN_B, shuffle=True, rng=np.random.default_rng(SEED))
    mods, state = build_orced(cfg, device="cuda")
    step = make_orced_train_step(mods, cfg)
    n_params = sum(p.numel() for p in mods.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(ORCED_TIMED_STEPS):
        idx = torch.from_numpy(perm[i]).long().cuda()
        t0 = time.perf_counter()
        state, m = step(state, x[idx], y[idx], 0.5)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        assert all(np.isfinite(float(v)) for v in m.values()), m
    warm = step_ms[1:]  # the first step pays cuBLAS/cuDNN set-up
    warm_ms = sum(warm) / len(warm)
    log(f"phase 8b: ORCED step ({n_params / 1e6:.1f}M parameters, B = {TRAIN_B}): ms per step "
        f"{[round(t, 2) for t in step_ms]}, warm mean {warm_ms:.2f} ms (host clock, "
        f"synchronized), {TRAIN_B / (warm_ms / 1e3):.1f} train windows/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
    # where the step's device time goes: torch.profiler over 3 more warm steps
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(ORCED_TIMED_STEPS, ORCED_TIMED_STEPS + 3):
            state, m = step(state, x[torch.from_numpy(perm[i]).long().cuda()],
                            y[torch.from_numpy(perm[i]).long().cuda()], 0.5)
        torch.cuda.synchronize()
    kernels = [(e.key, e.device_time_total / 3e3) for e in prof.key_averages()
               if e.device_time_total > 0]
    groups = {}
    for name, ms in kernels:
        low = name.lower()
        group = ("gemm" if "gemm" in low or "cutlass" in low or "xmma" in low
                 else "elementwise" if "elementwise" in low or "vectorized" in low
                 else "reduce" if "reduce" in low else "other")
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(kernels, key=lambda k: -k[1])[:5]
    log(f"phase 8b: ORCED step device time (torch.profiler, 3 warm steps): "
        f"{sum(ms for _, ms in kernels):.2f} ms busy a step; by kind "
        + ", ".join(f"{g} {ms:.2f}" for g, ms in sorted(groups.items(), key=lambda g: -g[1]))
        + "; top kernels " + "; ".join(f"{name[:48]} {ms:.2f}" for name, ms in top)
        + f" ms a step [{card}]")
    del mods, state, step, m, x, y
    gc.collect()
    torch.cuda.empty_cache()

    pn.pointnet_pool_infer.launches = ck.seq_chamfer_kernel.launches = 0
    reset_train_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_orced(cfg, verbose=False, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # the JAX trainer reaches no Pallas kernel, and the port's none
    assert (pn.pointnet_pool_infer.launches, ck.seq_chamfer_kernel.launches) == (0, 0)
    assert train_counts() == (0, 0, 0), train_counts()
    run_dir = cfg.run_dir()
    want = {"config.json", "metrics.jsonl", "run_complete.json"} | {
        f"{ORCED_TRAIN_NAME}_{tag}.msgpack" for tag in ("E", "G", "ML")}
    assert set(os.listdir(run_dir)) == want, sorted(os.listdir(run_dir))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["_step"] for r in lines] == list(range(ORCED_EPOCHS))
    for r in lines:
        for k, v in r.items():
            assert v is not None and np.isfinite(v), (k, v)
    assert lines[0]["KL Loss"] == 0.0, lines[0]["KL Loss"]
    epoch_s = [lines[0]["_wall"]] + [b["_wall"] - a["_wall"] for a, b in zip(lines, lines[1:])]
    steps = len(x_np) // TRAIN_B
    log(f"phase 8b: train_orced, {ORCED_EPOCHS} epochs of {steps} steps in {seconds:.2f} s "
        f"(with validation and the run folder's write); s per epoch "
        f"{[round(t, 2) for t in epoch_s]}; losses per epoch (rec, ce, triplet, KL) "
        + "; ".join(f"{r['Reconstruction Loss Train']:.4f}, {r['Cross Entropy Loss Train']:.4f}, "
                    f"{r['Triplet Loss']:.4f}, {r['KL Loss']:.4f}" for r in lines)
        + f"; Valid Accuracy {out['Valid Accuracy']:.4f} [{card}]")

    # --- 8c. score the trained folder from the raw tracks, kernels vs plain ---------
    rng = np.random.default_rng(SEED + 8)
    eps = {key: rng.normal(size=(counts[split.value], cfg.SUP_LATENT_DIM)).astype(np.float32)
           for key, split in (("train", SPLIT.TRAIN), ("test", SPLIT.TEST),
                              ("unseen", SPLIT.UNSEEN))}
    runs = {}
    for path in ("kernel", "plain"):
        models = os.path.join(WORK, f"models_orced_train_{path}")
        figures = os.path.join(WORK, f"figures_orced_train_{path}")
        shutil.copytree(run_dir, os.path.join(models, ORCED_TRAIN_NAME))
        pn.pointnet_pool_infer.launches = ck.seq_chamfer_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = orced_inference(
            [ORCED_TRAIN_NAME], device="cuda", models_path=models, figures_path=figures,
            generate_dataset=True, batch_size=ORCED_B, eps_streams=eps, dump_calibration=True,
            use_kernel=path == "kernel",
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        folder = os.path.join(figures, ORCED_TRAIN_NAME)
        final = {stem: np.load(os.path.join(folder, f"ensemble_ood_final_{stem}_fixed.npy"))
                 for stem in ("preds", "labels")}
        image = read_png(os.path.join(folder, "openset_cnfmtrx_ensemble_ood_fixed.png"))
        cm = openset_confusion_matrix(final["labels"], final["preds"], cfg.n_classes)
        cell = image.shape[0] // cm.shape[0]
        assert image.shape == (cell * cm.shape[0], cell * cm.shape[0], 3)
        decoded = (255 - image[cell // 2::cell, cell // 2::cell, 0].astype(np.float64)) / 255
        assert np.abs(decoded - cm).max() <= 1 / 255, np.abs(decoded - cm).max()
        cal = dict(np.load(os.path.join(models, ORCED_TRAIN_NAME, "orced_calibration.npz")))
        runs[path] = dict(final=final, cal=cal, launches=(
            pn.pointnet_pool_infer.launches, ck.seq_chamfer_kernel.launches))
        m = logs[ORCED_TRAIN_NAME]
        log(f"phase 8c: orced_inference(generate_dataset=True) of the trained folder via {path}: "
            f"{seconds:.2f} s (the splits rewritten from the raw tracks), launches (PointNet, "
            f"Chamfer) {runs[path]['launches']}, {len(final['preds'])} decisions, f1_micro "
            f"{m['f1_micro']:.4f}; confusion PNG {image.shape[1]} x {image.shape[0]} decoded, "
            f"cells within 1/255 of the matrix [{card}]")
    k_launch = runs["kernel"]["launches"]
    assert k_launch[0] > 0 and k_launch[1] > 0, k_launch
    assert runs["plain"]["launches"] == (0, 0), runs["plain"]["launches"]
    np.testing.assert_array_equal(runs["kernel"]["final"]["labels"],
                                  runs["plain"]["final"]["labels"])
    keep = runs["kernel"]["cal"]["unseen_keep"]
    edge = np.zeros(len(runs["kernel"]["final"]["preds"]), bool)
    for r in runs.values():
        edge |= np.concatenate([orced_knife_edge(r["cal"], "test"),
                                orced_knife_edge(r["cal"], "unseen", keep)])
    bad = (runs["kernel"]["final"]["preds"] != runs["plain"]["final"]["preds"]) & ~edge
    assert not bad.any(), f"{int(bad.sum())} decisions differ away from the knife edge"
    log(f"phase 8c: decisions through the kernels equal the plain path's; {int(edge.sum())} "
        f"knife-edge crops exempt")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(pointnet=k_launch[0], chamfer=k_launch[1])


def full_width(**kw):
    """The published widths (``config.py`` defaults), 6 train classes, B = 16."""
    from opensetgaitrecognition_pcaa_tpu_torch.config import Config

    return Config(TRAIN_CLASSES=tuple(range(N_SEEN)), BATCH_SIZE=TRAIN_B, SEED=SEED, **kw)


def variant_spec(variant: str, dph: bool):
    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import VARIANTS

    spec = VARIANTS[VARIATION(variant)]
    return dataclasses.replace(spec, use_disc_head=True) if dph else spec


def _busy_ms(events, steps: int) -> tuple:
    """→ (device ms a step, {kind: ms a step}) from a trace's ``key_averages``."""
    groups, total = {}, 0.0
    for e in events:
        if e.device_time_total <= 0:
            continue
        ms = e.device_time_total / 1e3 / steps
        low = e.key.lower()
        group = ("layer_kernel" if "tf32x3" in low or "bf16mma" in low or "wgmma_bf16" in low
                 else "pool_kernel" if any(w in low for w in ("pool_kernel", "pool_bf16",
                                                               "stats_kernel"))
                 else "adam_kernel" if "adam_kernel" in low
                 else "conv" if any(w in low for w in ("conv", "cudnn", "fprop", "dgrad", "wgrad"))
                 else "gemm" if "gemm" in low or "cutlass" in low or "xmma" in low
                 else "elementwise" if "elementwise" in low or "vectorized" in low
                 else "reduce" if "reduce" in low else "other")
        groups[group] = groups.get(group, 0.0) + ms
        total += ms
    return total, groups


# the names of the training kernels: the layer GEMM (f32 and bf16), the
# pool (f32 and bf16 input), Adam
_TRAIN_KERNELS = (("tf32x3", "wgmma_bf16", "bf16mma"), ("pool_kernel", "pool_bf16"),
                  ("adam_kernel",))


def _kernel_events(events) -> tuple:
    """The (layer, pool, Adam) kernel launches a trace's events hold."""
    counts = [0, 0, 0]
    for e in events:
        low = e.key.lower()
        if e.device_time_total <= 0:
            continue
        for i, needles in enumerate(_TRAIN_KERNELS):
            if any(n in low for n in needles):
                counts[i] += e.count
                break
    return tuple(counts)


def traced_until_whole(call, counted, label: str) -> tuple:
    """torch.profiler's events of ``call()``, traced after a traced warm-up
    call, and traced again (up to PROFILER_TRACES traces) while they hold
    fewer layer, pool or Adam kernel launches than ``counted(result)``, the
    launch counters' (layer, pool, Adam) over the traced call: a trace
    drops kernel events now and then. ``call`` restarts from the same state
    snapshot every time, synchronises, and returns its result → (events,
    the last traced call's result)."""
    for attempt in range(1, PROFILER_TRACES + 1):
        results = []
        events = traced_events(lambda: results.append(call()))
        seen, want = _kernel_events(events), counted(results[-1])
        if all(a >= b for a, b in zip(seen, want)):
            break
        log(f"{label}: trace {attempt} of {PROFILER_TRACES} holds (layer, pool, Adam) kernel "
            f"launches {seen}, the counters {want}: "
            + ("traced again from the same state" if attempt < PROFILER_TRACES
               else "kept, short"))
    return events, results[-1]


def _differing(a: dict, b: dict) -> list:
    """The names of the tensors of two same-keyed dicts that differ in a bit."""
    import torch

    return sorted(k for k in a if not torch.equal(a[k], b[k]))


def variant_steps(card: str, gen: str) -> tuple:
    """Phase 9a: each variant's step from one seeded state, VARIANT_STEPS
    steps through the kernels, the same again under torch.profiler after a
    traced warm-up from the same state (to see whether a step repeats bit
    for bit, and where its device time goes; ``traced_until_whole``),
    then as many plain (the weights restored before each run), on phase
    6's crops with injected noise; for V1, the resume file's save and load
    timed on its live state → (launches of the layer, pool and Adam
    kernels in the first kernel run, warm ms per variant)."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import (
        RadarCropDataset,
        epoch_batch_indices,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.train.optim import adam_init
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
        PCAAState,
        _ckpt_payload,
        build_pcaa,
        make_train_step,
        restore_resume_tree,
        resume_tree,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import (
        load_train_state,
        save_train_state,
    )

    x_np, y_np = RadarCropDataset(SPLIT.TRAIN, gen).load_all()
    x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
    perm = torch.from_numpy(
        epoch_batch_indices(len(x_np), TRAIN_B, shuffle=True, rng=np.random.default_rng(SEED))
    ).long().cuda()
    rng = np.random.default_rng(SEED + 9)
    noise = (torch.from_numpy(rng.normal(size=(VARIANT_STEPS, TRAIN_B, 32)).astype(np.float32)
                              ).cuda(),
             torch.from_numpy(rng.uniform(size=(VARIANT_STEPS, TRAIN_B, 1)).astype(np.float32)
                              ).cuda())
    launches, warm = [0, 0, 0], {}
    for variant, dph in ABLATION:
        cfg = full_width()
        mods, state = build_pcaa(cfg, variant_spec(variant, dph), device="cuda")
        start = _ckpt_payload(mods)
        n_params = sum(p.numel() for p in mods.parameters())
        centroids, generator = state.centroids, state.generator

        def run_path(fused: bool) -> dict:
            """VARIANT_STEPS steps from ``start`` and zero Adam states."""
            mods.load_state_dict(start)
            state = PCAAState(adam_init(mods.g.named_parameters()),
                              adam_init(mods.d.named_parameters()), centroids, generator)
            step = make_train_step(mods, cfg.replace(FUSED_POINTNET=fused, FUSED_ADAM=fused))
            r = dict(losses=[], ms=[], counts=[])
            for i in range(VARIANT_STEPS):
                idx = perm[i]
                reset_train_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, x[idx], y[idx], i, (noise[0][i], noise[1][i]))
                torch.cuda.synchronize()
                r["ms"].append(1e3 * (time.perf_counter() - t0))
                r["counts"].append(train_counts())
                r["losses"].append({k: float(v) for k, v in m.items()})
                if i == 0 and fused:  # the first step's gradients: mu = (1 - b1) g
                    r["mu"] = {f"{side}.{k}": v.clone() for side, opt in
                               (("g", state.opt_g), ("d", state.opt_d))
                               for k, v in opt.mu.items()}
            r["state"] = state
            return r

        runs = {}
        for path, fused in (("kernel", True), ("again", True), ("plain", False)):
            if path == "again":
                events, r = traced_until_whole(
                    lambda: run_path(True),
                    lambda r: tuple(map(sum, zip(*r["counts"]))), f"phase 9a: {variant}")
                r["busy"] = _busy_ms(events, VARIANT_STEPS)
            else:
                r = run_path(fused)
            runs[path] = r
            state = r.pop("state")
            if dph:  # every path into the head is detached: it never moves
                for k, v in mods.d["disc_head"].state_dict().items():
                    assert torch.equal(v, start[f"d.disc_head.{k}"]), k
                assert state.opt_d.count == VARIANT_STEPS
        want = (4, 1, 0 if variant == "V3" else 4)
        for path in ("kernel", "again"):
            assert all(c == want for c in runs[path]["counts"]), runs[path]["counts"]
        assert all(c == (0, 0, 0) for c in runs["plain"]["counts"]), runs["plain"]["counts"]
        launches = [a + VARIANT_STEPS * b for a, b in zip(launches, want)]
        worst = 0.0
        for i, (k, p) in enumerate(zip(runs["kernel"]["losses"], runs["plain"]["losses"])):
            for key in ("rec_loss", "d_loss", "sup_loss", "tot_loss"):
                assert np.isfinite(k[key]) and np.isfinite(p[key]), (variant, i, key)
                gap = abs(k[key] - p[key]) / max(abs(p[key]), 1.0)
                worst = max(worst, gap)
                assert gap <= LOSS_RTOL, (variant, i, key, k[key], p[key])
            assert (k["rec_loss"] == 0.0) == (variant == "V3"), (variant, k["rec_loss"])
        repeat = runs["kernel"]["losses"] == runs["again"]["losses"]
        grads = _differing(runs["kernel"]["mu"], runs["again"]["mu"])
        busy, groups = runs["again"]["busy"]
        name = variant + ("+DPH" if dph else "")
        warm[name] = {path: sum(runs[path]["ms"][1:]) / (VARIANT_STEPS - 1)
                      for path in ("kernel", "plain")}
        log(f"phase 9a: {name} step ({n_params / 1e6:.1f}M parameters, B = {TRAIN_B}): ms per "
            f"step kernel {[round(t, 2) for t in runs['kernel']['ms']]}, plain "
            f"{[round(t, 2) for t in runs['plain']['ms']]}; warm kernel "
            f"{warm[name]['kernel']:.2f} ms, plain {warm[name]['plain']:.2f} ms; launches "
            f"(layer, pool, adam) per step {want}; losses kernel vs plain within {worst:.3e} "
            f"(bound {LOSS_RTOL})" + ("; DPH weights equal their init" if dph else "")
            + f" [{card}]")
        log(f"phase 9a: {name} kernel steps repeated from the same state: losses "
            f"{'bitwise equal' if repeat else 'DIFFER'}; first-step gradients (Adam mu) differ "
            f"in {len(grads)} of {len(runs['kernel']['mu'])} leaves {grads[:6]}; device time "
            f"{busy:.2f} ms a step (torch.profiler), by kind "
            + ", ".join(f"{g} {ms:.2f}" for g, ms in sorted(groups.items(), key=lambda g: -g[1]))
            + f" [{card}]")
        if variant == "V1":  # the resume file of a full-width V1 state, alone
            opts = {"opt_g": state.opt_g, "opt_d": state.opt_d}
            path = os.path.join(WORK, "resume_timing", "train_state.msgpack")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_train_state(resume_tree(mods, opts, state.generator, centroids=state.centroids),
                             0, {}, path)
            save_s = time.perf_counter() - t0
            before = _ckpt_payload(mods)
            t0 = time.perf_counter()
            restore_resume_tree(load_train_state(path)[0], mods, opts, state.generator,
                                centroids=state.centroids)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            assert not _differing(before, _ckpt_payload(mods))
            moments = 2 * sum(4 * v.numel() for opt in opts.values() for v in opt.mu.values())
            log(f"phase 9a: V1 resume file {os.path.getsize(path) / 1e9:.3f} GB "
                f"({4 * n_params / 1e9:.3f} GB of parameters, {moments / 1e9:.3f} GB of Adam "
                f"moments): save (card to host, msgpack, write) {save_s:.2f} s, load (read, "
                f"msgpack, host to card) {load_s:.2f} s, the state restored bit for bit "
                f"[{card}]")
            shutil.rmtree(os.path.dirname(path))
            del opts, before
        del mods, state, start, runs
        gc.collect()
        torch.cuda.empty_cache()
    return launches, warm


def ablation_driver(card: str, raw: str) -> dict:
    """Phase 9b: the port's sequential ablation driver trains V1-V4 for one
    epoch on a 6-class subset of phase 8's raw tracks with the kernels on
    (cuDNN deterministic), then a second call skips every run and writes no
    splits; each folder is
    scored by ``pcaa_inference`` through the inference kernel and then plain
    → launches of the training kernels and of the inference kernel."""

    import torch

    from opensetgaitrecognition_pcaa_tpu_torch import config as port_config
    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
    from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import pcaa_inference
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_infer as pn
    from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_pcaa_ablation as rpa

    gen = os.path.join(WORK, "gen_ablation")
    models = os.path.join(WORK, "models_ablation")
    argv = ["--data-path", raw, "--gen-data-path", gen, "--models-path", models,
            "--model-name-base", ABLATION_BASE, "--n-training-classes", str(N_SEEN),
            "--n-tests", "1", "--variants", "V1", "V2", "V3", "V4", "--epochs", "1"]
    names = [f"{ABLATION_BASE}{v}.{N_SEEN}.1" for v in ("V1", "V2", "V3", "V4")]
    files = {"V1": ("E", "D", "G", "GPH", "ML"), "V2": ("E", "D", "G"), "V3": ("E", "D"),
             "V4": ("E", "D", "G", "GPH")}
    writes = []
    real_generate = rpa.generate_splits

    def counted_generate(**kw):
        writes.append(kw["train_classes"])
        return real_generate(**kw)

    # the kernels are switched on through the driver's base configuration
    rpa.default_config = lambda **kw: port_config.default_config(
        FUSED_POINTNET=True, FUSED_ADAM=True, **kw)
    rpa.generate_splits = counted_generate
    try:
        out = {}
        for call in ("fresh", "again"):
            reset_train_counts()
            pn.pointnet_pool_infer.launches = 0
            buf = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # repeatable folders: a 1-epoch V1 is near-degenerate (its Youden
            # threshold at its top test score), and cuDNN's default
            # backward-filter made some runs' folders score apart
            with contextlib.redirect_stdout(buf), cudnn_deterministic():
                rpa.main(argv)
            torch.cuda.synchronize()
            out[call] = dict(s=time.perf_counter() - t0, text=buf.getvalue(),
                             counts=train_counts(), infer=pn.pointnet_pool_infer.launches)
    finally:
        rpa.default_config = port_config.default_config
        rpa.generate_splits = real_generate
    steps = len(RadarCropDataset(SPLIT.TRAIN, gen)) // TRAIN_B
    want = (4 * 4 * steps, 4 * steps, 3 * 4 * steps)  # V3's step launches no Adam kernel
    assert out["fresh"]["counts"] == want, (out["fresh"]["counts"], want)
    assert out["fresh"]["infer"] == 0
    assert len(writes) == 1, writes
    for name in names:
        assert f"=== training {name} ===" in out["fresh"]["text"], name
        assert f"=== skipping completed {name} ===" in out["again"]["text"], name
        tags = files[name.split(".")[0][-2:]]
        want_files = {"config.json", "metrics.jsonl", "discriminator_means.npy",
                      "run_complete.json"} | {f"{name}_{tag}.msgpack" for tag in tags}
        assert set(os.listdir(os.path.join(models, name))) == want_files, name
    assert "=== training" not in out["again"]["text"]
    assert out["again"]["counts"] == (0, 0, 0)
    accs = [line.split(": ", 1)[1] for line in out["fresh"]["text"].splitlines()
            if "best_valid_acc=" in line]
    log(f"phase 9b: run_pcaa_ablation (kernels on) trained {', '.join(names)}: 1 epoch of "
        f"{steps} steps each, splits of classes {writes[0]}, in {out['fresh']['s']:.2f} s "
        f"with the splits' write and the run folders; launches (layer, pool, adam) "
        f"{out['fresh']['counts']}; {accs}; the second call skipped all four runs, wrote no "
        f"splits and took {out['again']['s']:.3f} s [{card}]")

    runs = {}
    for path in ("kernel", "plain"):
        root = os.path.join(WORK, f"models_ablation_{path}")
        for name in names:
            shutil.copytree(os.path.join(models, name), os.path.join(root, name))
        pn.pointnet_pool_infer.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = pcaa_inference(
            names, ks=KS, models_path=root, figures_path=os.path.join(WORK, f"fig_abl_{path}"),
            generate_dataset=False, dump_calibration=True, device="cuda",
            use_kernel=path == "kernel",
        )
        torch.cuda.synchronize()
        runs[path] = dict(root=root, s=time.perf_counter() - t0,
                          launches=pn.pointnet_pool_infer.launches, logs=logs)
    assert runs["kernel"]["launches"] > 0 and runs["plain"]["launches"] == 0
    exempt = {}
    for name in names:
        dirs = [os.path.join(runs[p]["root"], name) for p in ("kernel", "plain")]
        cals = [dict(np.load(os.path.join(d, "calibration.npz"))) for d in dirs]
        for key in ("log_threshold", "test_ll", "unseen_ll"):
            assert np.isfinite(cals[0][key]).all(), (name, key)
        exempt[name] = compare_decisions(cals[0], cals[1], dirs[0], dirs[1])
    f1 = {name.split(".")[0][-2:]: [round(runs["kernel"]["logs"][name][k]["f1_micro"], 4)
                                    for k in KS] for name in names}
    log(f"phase 9b: pcaa_inference of the 4 folders, ks={list(KS)}: via kernel "
        f"{runs['kernel']['s']:.2f} s ({runs['kernel']['launches']} launches), plain "
        f"{runs['plain']['s']:.2f} s; decisions equal, knife-edge windows exempt {exempt}; "
        f"f1_micro {f1} [{card}]")
    c = out["fresh"]["counts"]
    return dict(layer=c[0], pool=c[1], adam=c[2], infer=runs["kernel"]["launches"])


def _run_record(run_dir: str) -> tuple:
    """→ (metrics.jsonl lines without their wall clock, {module file: bytes})."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [{k: v for k, v in json.loads(line).items() if k != "_wall"} for line in f]
    blobs = {}
    for name in sorted(os.listdir(run_dir)):
        if name.endswith(".msgpack") and not name.startswith("train_state"):
            with open(os.path.join(run_dir, name), "rb") as f:
                blobs[name] = f.read()
    return lines, blobs


def _compare_runs(straight: str, resumed: str) -> str:
    """How a resumed run's per-epoch metrics and module files compare with
    the straight run's: bitwise, or the largest relative gap of each
    epoch's metrics and the largest gap of the weights."""
    from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import unpackb

    (lines_a, files_a), (lines_b, files_b) = _run_record(straight), _run_record(resumed)
    assert [r["_step"] for r in lines_a] == [r["_step"] for r in lines_b]
    assert files_a.keys() == files_b.keys()
    if lines_a == lines_b and files_a == files_b:
        return "bitwise equal"
    gaps = [max([abs(a[k] - b[k]) / max(abs(a[k]), 1e-12) for k in a], default=0.0)
            for a, b in zip(lines_a, lines_b)]
    weights = 0.0
    for name in files_a:
        stack = [(unpackb(files_a[name]), unpackb(files_b[name]))]
        while stack:
            a, b = stack.pop()
            if isinstance(a, dict):
                stack += [(a[k], b[k]) for k in a]
            else:
                weights = max(weights, float(np.abs(a - b).max()))
    return ("NOT bitwise equal: metrics of epochs 0, 1 within "
            + ", ".join(f"{g:.3e}" for g in gaps)
            + f" relative; module weights within {weights:.3e} absolute")


def orced_repeat(card: str, gen_orced: str) -> str:
    """One full-width ORCED step twice from the same state, batch and eps:
    are its losses and gradients (Adam mu after one step) bit for bit the
    same?"""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
    from opensetgaitrecognition_pcaa_tpu_torch.train.optim import adam_init
    from opensetgaitrecognition_pcaa_tpu_torch.train.orced import (
        build_orced,
        make_orced_train_step,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import _ckpt_payload

    x_np, y_np = RadarCropDataset(SPLIT.TRAIN, gen_orced).load_all()
    x = torch.from_numpy(x_np[:TRAIN_B]).cuda()
    y = torch.from_numpy(y_np[:TRAIN_B]).cuda()
    eps = torch.from_numpy(np.random.default_rng(SEED + 10).normal(
        size=(TRAIN_B, 32)).astype(np.float32)).cuda()
    mods, state = build_orced(full_width(), device="cuda")
    start = _ckpt_payload(mods)
    step = make_orced_train_step(mods, full_width())
    out = []
    for _ in range(2):
        mods.load_state_dict(start)
        state.opt = adam_init(mods.named_parameters())
        _, m = step(state, x, y, 0.5, eps)
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.clone() for k, v in state.opt.mu.items()}))
    same = out[0][0] == out[1][0]
    grads, n = _differing(out[0][1], out[1][1]), len(out[0][1])
    del mods, state, start, step, out
    gc.collect()
    torch.cuda.empty_cache()
    return (f"losses {'bitwise equal' if same else 'DIFFER'}; gradients (Adam mu) differ in "
            f"{len(grads)} of {n} leaves {grads[:6]}")


def resume_phase(card: str, gen: str, gen_orced: str) -> dict:
    """Phase 9c: full-width V1 (kernels on, phase 6's crops) and ORCED (a
    quarter of phase 8's crops), each 2 epochs straight against 1 epoch
    with SAVE_RESUME_STATE and a second call that resumes from it →
    launches of the training kernels in the PCAA runs."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.train.orced import train_orced
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import train_pcaa

    launches = [0, 0, 0]
    for kind in ("pcaa", "orced"):
        if kind == "pcaa":
            cfg = full_width(GEN_DATA_PATH=gen, MODEL_NAME="RESUME_V1", FUSED_POINTNET=True,
                             FUSED_ADAM=True, CHECKPOINT_FREQUENCY=1)

            def train(c):
                return train_pcaa(c, VARIATION.V1, verbose=False, device="cuda")
        else:
            cfg = full_width(GEN_DATA_PATH=gen_orced, MODEL_NAME="RESUME_ORCED",
                             SUBSAMPLE_FACTOR=ORCED_RESUME_SUBSAMPLE, CHECKPOINT_FREQUENCY=1)

            def train(c):
                return train_orced(c, verbose=False, device="cuda")
        seconds, dirs = {}, {}
        # the straight run writes no resume state: it would not change its path
        for run, calls in (("straight", ((2, False),)), ("resumed", ((1, True), (2, True)))):
            c = cfg.replace(MODELS_PATH=os.path.join(WORK, f"models_resume_{run}"))
            dirs[run] = c.run_dir()
            reset_train_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for epochs, save in calls:
                out = train(c.replace(EPOCHS=epochs, SAVE_RESUME_STATE=save))
            torch.cuda.synchronize()
            seconds[run] = time.perf_counter() - t0
            launches = [a + b for a, b in zip(launches, train_counts())]
            for k, v in out.items():
                assert np.isfinite(v), (kind, run, k, v)
        verdict = _compare_runs(dirs["straight"], dirs["resumed"])
        size = os.path.getsize(os.path.join(dirs["resumed"], "train_state.msgpack"))
        log(f"phase 9c: {kind.upper()}{' V1' if kind == 'pcaa' else ''} resume at full width: "
            f"2 epochs straight {seconds['straight']:.2f} s; 1 epoch with the resume state "
            f"written, then a second call resuming for epoch 1, {seconds['resumed']:.2f} s; "
            f"per-epoch metrics and module files of the resumed run against the straight "
            f"one: {verdict}; resume file {size / 1e9:.3f} GB [{card}]")
        for run in dirs.values():
            shutil.rmtree(run)
    log(f"phase 9c: the ORCED step repeated from the same state, batch and eps: "
        f"{orced_repeat(card, gen_orced)} [{card}]")
    return dict(layer=launches[0], pool=launches[1], adam=launches[2])


def ablation_phase(card: str, gen: str) -> dict:
    """Phase 9 → launches of each kernel on its paths (9a's kernel steps,
    9b's driver and scoring, 9c's PCAA runs)."""
    t0 = time.perf_counter()
    step_launches, _ = variant_steps(card, gen)
    driver = ablation_driver(card, os.path.join(WORK, "raw"))
    resumed = resume_phase(card, gen, os.path.join(WORK, "gen_orced"))
    out = {k: step_launches[i] + driver[k] + resumed[k]
           for i, k in enumerate(("layer", "pool", "adam"))}
    out["infer"] = driver["infer"]
    log(f"phase 9: {time.perf_counter() - t0:.1f} s [{card}]")
    return out


def infer_counts() -> tuple:
    from opensetgaitrecognition_pcaa_tpu_torch.ops import chamfer_kernel as ck
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_infer as pn

    return pn.pointnet_pool_infer.launches, ck.seq_chamfer_kernel.launches


def reset_infer_counts() -> None:
    from opensetgaitrecognition_pcaa_tpu_torch.ops import chamfer_kernel as ck
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_infer as pn

    pn.pointnet_pool_infer.launches = ck.seq_chamfer_kernel.launches = 0


def serve_ms_of(request, n_requests: int) -> list:
    """Host ms of ``SERVE_WARM_CALLS`` more calls of ``request(r)``, cycling
    over the requests; each call's answer reaches the host."""
    ms = []
    for i in range(SERVE_WARM_CALLS):
        t0 = time.perf_counter()
        request(i % n_requests)
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def serve_artifacts(serve_dir: str) -> int:
    """``--serve-artifacts DIR``, phase 10's fresh process: with only the
    port imported, load ``DIR/pcaa.osgr`` and ``DIR/orced.osgr`` on the
    card, answer 3 requests of each (``windows.npy``; ``crops.npy`` with
    ``eps.npy``), then load the PCAA artifact on the CPU and answer the
    first request again; write ``DIR/served.json``."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.infer.serving import load_serving_artifact

    assert not {"jax", "opensetgaitrecognition_pcaa_tpu"} & set(sys.modules)
    windows = np.load(os.path.join(serve_dir, "windows.npy"))
    crops = np.load(os.path.join(serve_dir, "crops.npy"))
    eps = np.load(os.path.join(serve_dir, "eps.npy"))
    torch.zeros(1, device="cuda")  # the CUDA context, apart from the loads' times
    torch.cuda.synchronize()
    out = {}
    for kind, requests in (("pcaa", windows), ("orced", crops)):
        t0 = time.perf_counter()
        art = load_serving_artifact(os.path.join(serve_dir, f"{kind}.osgr"), device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0

        def answer(r: int):
            return art.decide(requests[r]) if kind == "pcaa" else art.decide(requests[r],
                                                                             eps=eps[r])

        reset_infer_counts()
        answers, ms = [], []
        for r in range(len(requests)):
            t0 = time.perf_counter()
            answers.append([a.tolist() for a in answer(r)])
            ms.append(1e3 * (time.perf_counter() - t0))
        launches = infer_counts()
        warm = sorted(serve_ms_of(lambda r: answer(r), len(requests)))
        out[kind] = dict(load_s=load_s, ms=ms, answers=answers, launches=launches,
                         warm_ms=warm[len(warm) // 2])
        log(f"phase 10 (fresh process): {kind} artifact loaded on the card in {load_s:.2f} s; "
            f"answers {[a[:2] for a in answers]}; launches (PointNet, Chamfer) {launches}; "
            f"ms per request {[round(t, 2) for t in ms]}, then the median of "
            f"{SERVE_WARM_CALLS} more {out[kind]['warm_ms']:.2f}")
        del art
    # the first load in a process pays for the deserializer's set-up; a
    # second load of the same file shows the load alone
    t0 = time.perf_counter()
    load_serving_artifact(os.path.join(serve_dir, "pcaa.osgr"), device="cuda")
    torch.cuda.synchronize()
    out["pcaa"]["reload_s"] = time.perf_counter() - t0
    reset_infer_counts()
    t0 = time.perf_counter()
    art = load_serving_artifact(os.path.join(serve_dir, "pcaa.osgr"), device="cpu")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = art.decide(windows[0])
    out["pcaa_cpu"] = dict(load_s=load_s, ms=1e3 * (time.perf_counter() - t0),
                           answer=[a.tolist() for a in got], launches=infer_counts())
    with open(os.path.join(serve_dir, "served.json"), "w") as f:
        json.dump(out, f)
    return 0


def artifact_phase(card: str, serve_ms: list) -> dict:
    """Phase 10a-b: the PCAA artifact of phase 3's folder through the
    ``export_serving`` command and the ORCED artifact of phase 7b's
    folder, exported, then served by a fresh process against the
    in-process decisions → launches of the PointNet and Chamfer kernels."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
    from opensetgaitrecognition_pcaa_tpu_torch.infer.orced import (
        orced_inference,
        orced_inference_setup,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.infer import serving
    from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import pcaa_inference_setup
    from opensetgaitrecognition_pcaa_tpu_torch.infer.serving import (
        export_orced_decision,
        load_serving_artifact,
        make_orced_forward_fn,
        make_pcaa_decision_fn,
        orced_decide_host,
    )

    gen = os.path.join(WORK, "gen")
    serve_dir = os.path.join(WORK, "serve")
    os.makedirs(serve_dir)
    k = 6

    # --- 10a. PCAA: export through the command line, in a process of its own ---
    models = os.path.join(WORK, "models_kernel")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "opensetgaitrecognition_pcaa_tpu_torch.scripts.export_serving",
         "--model-names", NAME, "--models-path", models, "--ks", str(k),
         "--no-generate-dataset"], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    cli_s = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    path = os.path.join(models, NAME, f"serving_decision_k{k}.osgr")
    shutil.copy(path, os.path.join(serve_dir, "pcaa.osgr"))
    pcaa_meta = load_serving_artifact(path, device="cpu").meta
    cal = dict(np.load(os.path.join(models, NAME, "calibration.npz")))
    thr = pcaa_meta["log_threshold"]
    log(f"phase 10a: export_serving --ks {k}: {proc.stdout.strip()}; {cli_s:.2f} s with the "
        f"process's start; {os.path.getsize(path) / 1e6:.2f} MB; threshold {thr!r} (phase 3: "
        f"{float(cal['log_threshold'])!r}) [{card}]")

    x_test, labels = RadarCropDataset(SPLIT.TEST, gen, sequential=True).load_all()
    starts = window_starts(labels, k)
    requests = [starts[4 * r:4 * r + 4] for r in range(3)]  # phase 4's windows
    windows = np.stack([np.stack([x_test[s:s + k] for s in req]) for req in requests])
    np.save(os.path.join(serve_dir, "windows.npy"), windows)

    # --- 10b. ORCED: export in process, statistics against orced_inference -------
    orced_src = os.path.join(WORK, "models_orced_src")
    steps = {}

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            steps[name] = time.perf_counter() - t0
            return out
        return call

    # the trace (and the weights' move to the host) and the write, timed apart
    real = serving._export, serving._write_artifact
    serving._export, serving._write_artifact = timed("trace", real[0]), timed("write", real[1])
    reset_infer_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        path, orced_meta = export_orced_decision(ORCED_NAME, models_path=orced_src,
                                                 generate_dataset=False, device="cuda")
    finally:
        serving._export, serving._write_artifact = real
    export_s = time.perf_counter() - t0
    export_launches = infer_counts()
    shutil.copy(path, os.path.join(serve_dir, "orced.osgr"))
    log(f"phase 10b: export_orced_decision {export_s:.2f} s: the trace and the weights' move to "
        f"the host {steps['trace']:.2f} s, the write {steps['write']:.2f} s, the rest (set-up, "
        f"the train pass at batch {ORCED_B}, launches (PointNet, Chamfer) {export_launches}) "
        f"{export_s - steps['trace'] - steps['write']:.2f} s; "
        f"{os.path.getsize(path) / 1e6:.1f} MB; ops {orced_meta['ops']} [{card}]")
    stats_models = os.path.join(WORK, "models_orced_stats")
    shutil.copytree(os.path.join(orced_src, ORCED_NAME), os.path.join(stats_models, ORCED_NAME))
    reset_infer_counts()
    orced_inference([ORCED_NAME], device="cuda", models_path=stats_models,
                    figures_path=os.path.join(WORK, "fig_orced_stats"), generate_dataset=False,
                    batch_size=ORCED_B, dump_calibration=True, confusion_png=False)
    stats_launches = infer_counts()
    ocal = dict(np.load(os.path.join(stats_models, ORCED_NAME, "orced_calibration.npz")))
    gap = 0.0
    for key in ("means_z", "stds_z", "thresholds_re"):
        np.testing.assert_allclose(np.asarray(orced_meta[key]), ocal[key], rtol=1e-6, atol=0)
        gap = max(gap, float(np.max(np.abs(np.asarray(orced_meta[key]) - ocal[key])
                                    / np.maximum(np.abs(ocal[key]), 1e-300))))
    log(f"phase 10b: the artifact's class statistics equal orced_inference(dump_calibration="
        f"True)'s at seed 0 within {gap:.3e} relative (rtol 1e-6)")
    x_crops, _ = RadarCropDataset(SPLIT.TEST, gen).load_all()
    crops = x_crops[:3 * SERVE_CROPS].reshape((3, SERVE_CROPS) + x_crops.shape[1:])
    eps = np.random.default_rng(SEED + 11).standard_normal(
        (3, SERVE_CROPS, orced_meta["latent_dim"])).astype(np.float32)
    np.save(os.path.join(serve_dir, "crops.npy"), crops)
    np.save(os.path.join(serve_dir, "eps.npy"), eps)

    # --- the fresh process ---------------------------------------------------------
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                           "--serve-artifacts", serve_dir], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    fresh_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(line)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(os.path.join(serve_dir, "served.json")) as f:
        served = json.load(f)
    log(f"phase 10: the fresh process took {fresh_s:.2f} s with its start")

    # PCAA: the in-process decisions on the same windows at the artifact's threshold
    _, encoder, means = pcaa_inference_setup(NAME, VARIATION.V4, device="cuda",
                                             models_path=models, generate_dataset=False)
    decide = make_pcaa_decision_fn(encoder, pcaa_meta["n_labels"], k)
    in_process = sorted(serve_ms_of(
        lambda r: [t.cpu() for t in decide(means, thr, torch.from_numpy(windows[r]).cuda())], 3))
    exempt = 0
    for r, req in enumerate(requests):
        want = [t.cpu().numpy() for t in decide(means, thr, torch.from_numpy(windows[r]).cuda())]
        edge = np.array([(np.abs(cal["test_ll"][s:s + k] - thr) < KNIFE_EDGE).any()
                         for s in req])
        got = [np.asarray(a) for a in served["pcaa"]["answers"][r]]
        for g, w in zip(got, want):
            assert ((g == w) | edge).all(), (r, g, w)
        exempt += int(edge.sum())
    cpu = [np.asarray(a) for a in served["pcaa_cpu"]["answer"]]
    edge = np.array([(np.abs(cal["test_ll"][s:s + k] - thr) < KNIFE_EDGE).any()
                     for s in requests[0]])
    for g, w in zip(cpu, served["pcaa"]["answers"][0]):
        assert ((g == np.asarray(w)) | edge).all(), (g, w)
    pcaa_launches = served["pcaa"]["launches"]
    assert pcaa_launches == [3, 0], pcaa_launches
    assert served["pcaa_cpu"]["launches"] == [0, 0]
    log(f"phase 10a: the artifact's decisions and counts equal make_pcaa_decision_fn's "
        f"({exempt} knife-edge windows exempt); loaded on the CPU in "
        f"{served['pcaa_cpu']['load_s']:.2f} s, the first request again in "
        f"{served['pcaa_cpu']['ms']:.1f} ms, the same decisions; card ms per request "
        f"{[round(t, 2) for t in served['pcaa']['ms']]} through the artifact (fresh process) "
        f"against {[round(t, 2) for t in serve_ms]} in process (phase 4); warm, the median "
        f"of {SERVE_WARM_CALLS} calls: {served['pcaa']['warm_ms']:.2f} ms through the "
        f"artifact, {in_process[len(in_process) // 2]:.2f} ms in process; load "
        f"{served['pcaa']['load_s']:.2f} s, again after the ORCED artifact's "
        f"{served['pcaa']['reload_s']:.2f} s [{card}]")

    # ORCED: make_orced_forward_fn + orced_decide_host with the artifact's statistics
    _, e, d = orced_inference_setup(ORCED_NAME, device="cuda", models_path=orced_src,
                                    generate_dataset=False)
    forward = make_orced_forward_fn(e, d)
    stat_args = (orced_meta["means_z"], orced_meta["stds_z"], orced_meta["thresholds_re"],
                 orced_meta["n_labels"])
    in_process = sorted(serve_ms_of(lambda r: orced_decide_host(
        *forward(torch.from_numpy(crops[r]).cuda(), torch.from_numpy(eps[r]).cuda()),
        *stat_args), 3))
    exempt = 0
    for r in range(3):
        preds, z, re = forward(torch.from_numpy(crops[r]).cuda(), torch.from_numpy(eps[r]).cuda())
        want, _, _ = orced_decide_host(preds, z, re, *stat_args)
        cal_like = dict(means_z=np.asarray(orced_meta["means_z"]),
                        stds_z=np.asarray(orced_meta["stds_z"]),
                        thresholds_re=np.asarray(orced_meta["thresholds_re"]),
                        n_labels=orced_meta["n_labels"], test_preds=preds.cpu().numpy(),
                        test_z=z.cpu().numpy(), test_re=re.cpu().numpy())
        edge = orced_knife_edge(cal_like, "test")
        got = np.asarray(served["orced"]["answers"][r][0])
        assert got.shape == (SERVE_CROPS,) and ((got == want) | edge).all(), (r, got, want)
        exempt += int(edge.sum())
    orced_launches = served["orced"]["launches"]
    assert orced_launches == [3, 3], orced_launches
    log(f"phase 10b: the artifact's decisions equal make_orced_forward_fn + orced_decide_host's "
        f"({exempt} knife-edge crops exempt); launches (PointNet, Chamfer) {orced_launches}; "
        f"ms per request {[round(t, 2) for t in served['orced']['ms']]} through the artifact "
        f"(fresh process; phase 7d's in-process figure above); warm, the median of "
        f"{SERVE_WARM_CALLS} calls: {served['orced']['warm_ms']:.2f} ms through the artifact, "
        f"{in_process[len(in_process) // 2]:.2f} ms in process; load "
        f"{served['orced']['load_s']:.2f} s [{card}]")
    del encoder, e, d, forward
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        pointnet=(export_launches[0] + stats_launches[0] + pcaa_launches[0]
                  + orced_launches[0]),
        chamfer=export_launches[1] + stats_launches[1] + orced_launches[1],
    )


def driver_phase(card: str) -> dict:
    """Phase 10c-e: ``run_orced``, ``run_pointsubsampling`` (the training
    kernels on) and ``run_inference_scenarios`` on phase 8's raw tracks and
    phase 9b's folders, each called again to skip what is done, then
    ``collect_results`` → launches of each kernel."""

    import torch

    from opensetgaitrecognition_pcaa_tpu_torch import config as port_config
    from opensetgaitrecognition_pcaa_tpu_torch.config import SCENARIO
    from opensetgaitrecognition_pcaa_tpu_torch.scripts import collect_results
    from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_inference_scenarios
    from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_orced
    from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_pointsubsampling as rps
    from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import module_path

    raw = os.path.join(WORK, "raw")
    models = os.path.join(WORK, "models_drivers")

    def call(main, argv, module=None) -> dict:
        """One driver call → its seconds, output, split writes and launches."""
        writes = []
        real = module.generate_splits if module else None
        if module:
            module.generate_splits = lambda **kw: writes.append(kw["nmax_points"]) or real(**kw)
        reset_infer_counts()
        reset_train_counts()
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                main(argv)
        finally:
            if module:
                module.generate_splits = real
        torch.cuda.synchronize()
        return dict(s=time.perf_counter() - t0, text=buf.getvalue(), writes=writes,
                    infer=infer_counts(), train=train_counts())

    # --- 10c. run_orced ------------------------------------------------------------------
    argv = ["--data-path", raw, "--gen-data-path", os.path.join(WORK, "gen_drivers"),
            "--models-path", models, "--n-training-classes", str(N_SEEN), "--n-tests", "1",
            "--epochs", "1"]
    name = f"ORCED_.{N_SEEN}.1"
    fresh, again = call(run_orced.main, argv, run_orced), call(run_orced.main, argv, run_orced)
    assert f"=== training {name} ===" in fresh["text"], fresh["text"]
    assert os.path.exists(os.path.join(models, name, "run_complete.json"))
    assert f"=== skipping completed {name} ===" in again["text"]
    assert fresh["writes"] == [150] and again["writes"] == []
    assert "=== training" not in again["text"] and again["train"] == (0, 0, 0)
    acc = [line for line in fresh["text"].splitlines() if "best_valid_acc=" in line]
    log(f"phase 10c: run_orced trained {name} (1 epoch) in {fresh['s']:.2f} s with the splits' "
        f"write and the run folder; {acc}; the second call skipped it, wrote no splits and "
        f"took {again['s']:.3f} s [{card}]")

    # --- 10d. run_pointsubsampling, the training kernels on ----------------------------
    argv = ["--data-path", raw, "--gen-data-path", os.path.join(WORK, "gen_points"),
            "--models-path", models, "--figures-path", os.path.join(WORK, "fig_points"),
            "--n-training-classes", str(N_SEEN), "--n-tests", "1", "--n-points-subs", "50",
            "--epochs", "1", "--ks", "1", "6"]
    names = [f"PCAA_npts_V4_{n}.{N_SEEN}.1" for n in (50,)]
    rps.default_config = lambda **kw: port_config.default_config(
        FUSED_POINTNET=True, FUSED_ADAM=True, **kw)
    try:
        fresh = call(rps.main, argv, rps)
        assert fresh["writes"] == [50], fresh["writes"]
        assert all(f"=== training {n} ===" in fresh["text"] for n in names), fresh["text"]
        for n in names:
            for k in (1, 6):
                with open(os.path.join(models, n, f"naive_seq_log_{k}.json")) as f:
                    assert np.isfinite(json.load(f)["f1_micro"]), (n, k)
        assert all(c > 0 for c in fresh["train"]) and fresh["infer"][0] > 0, fresh
        e_file = module_path(os.path.join(models, names[0]), names[0], "E")
        mtime = os.stat(e_file).st_mtime_ns
        os.remove(os.path.join(models, names[0], "naive_seq_log_6.json"))
        rescore = call(rps.main, argv, rps)
        assert f"=== re-running inference for {names[0]} ===" in rescore["text"]
        assert "=== training" not in rescore["text"] and rescore["train"] == (0, 0, 0)
        assert rescore["writes"] == [50] and rescore["infer"][0] > 0
        assert os.stat(e_file).st_mtime_ns == mtime
        assert os.path.exists(os.path.join(models, names[0], "naive_seq_log_6.json"))
        skip = call(rps.main, argv, rps)
        assert all(f"=== skipping completed {n} ===" in skip["text"] for n in names)
        assert skip["writes"] == [] and skip["infer"] == (0, 0) and skip["train"] == (0, 0, 0)
    finally:
        rps.default_config = port_config.default_config
    f1 = {n: [round(json.load(open(os.path.join(models, n, f"naive_seq_log_{k}.json")))
                    ["f1_micro"], 4) for k in (1, 6)] for n in names}
    log(f"phase 10d: run_pointsubsampling (kernels on) trained and scored {names} in "
        f"{fresh['s']:.2f} s: launches (layer, pool, adam) {fresh['train']}, (PointNet, "
        f"Chamfer) {fresh['infer']}, f1_micro at ks 1, 6 {f1}; with one log deleted it "
        f"re-scored {names[0]} without training in {rescore['s']:.2f} s ({rescore['infer'][0]} "
        f"launches, its E file untouched); a third call skipped both in {skip['s']:.3f} s "
        f"[{card}]")

    # --- 10e. run_inference_scenarios over phase 9b's folders, then collect_results ------
    abl_models = os.path.join(WORK, "models_ablation_kernel")
    abl_names = sorted(os.listdir(abl_models))
    abl_names = [abl_names[0], abl_names[-1]]  # V1 and V4: the projection heads' two variants
    argv = ["--data-path", raw, "--models-path", abl_models, "--figures-path",
            os.path.join(WORK, "fig_scenarios"), "--model-names", *abl_names, "--ks", "6", "1"]
    scen = call(run_inference_scenarios.main, argv)
    assert scen["infer"][0] > 0, scen
    f1 = {}
    for n in abl_names:
        files = set(os.listdir(os.path.join(abl_models, n)))
        for s in SCENARIO:
            for k in (6, 1):
                suffix = f"{k}_scenarios{s.value}"
                want = {f"naive_seq_log_{suffix}.json", f"final_preds_{suffix}.npy",
                        f"final_labels_{suffix}.npy"}
                assert want <= files, (n, want - files)
                with open(os.path.join(abl_models, n, f"naive_seq_log_{suffix}.json")) as f:
                    log_ = json.load(f)
                assert all(np.isfinite(log_[m]) for m in ("f1_micro", "f1_macro")), (n, suffix)
                f1.setdefault(n.split(".")[0][-2:], []).append(round(log_["f1_micro"], 3))
    rows = collect_results.collect(abl_models)
    assert set(abl_names) <= {r["run"] for r in rows}, rows
    table = collect_results.to_markdown(rows)
    log(f"phase 10e: run_inference_scenarios over {len(abl_names)} folders x 3 scenarios, ks "
        f"6 1, in {scen['s']:.2f} s (splits written on the first pass; {scen['infer'][0]} "
        f"PointNet launches); f1_micro per scenario and k {f1}; collect_results: "
        f"{len(rows)} rows, {table.count(chr(10))} lines [{card}]")
    return dict(layer=fresh["train"][0], pool=fresh["train"][1], adam=fresh["train"][2],
                infer=fresh["infer"][0] + rescore["infer"][0] + scen["infer"][0])


def serving_driver_phase(card: str, serve_ms: list) -> dict:
    """Phase 10 → launches of each kernel on its paths."""
    t0 = time.perf_counter()
    art = artifact_phase(card, serve_ms)
    drv = driver_phase(card)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s [{card}]")
    return dict(infer=art["pointnet"] + drv["infer"], chamfer=art["chamfer"],
                layer=drv["layer"], pool=drv["pool"], adam=drv["adam"])


def bf16_counts() -> tuple:
    """Launches of the bf16 variants: layer, pool, Adam (m bf16), Adam (m
    and v bf16)."""
    from opensetgaitrecognition_pcaa_tpu_torch.ops import adam
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_train as pt

    return (pt.fused_layer.launches_bf16, pt.fused_pool.launches_bf16,
            adam.adam_update_.launches_m16, adam.adam_update_.launches_mv16)


def copy_counts() -> tuple:
    """Launches of the Adam kernel writing the bf16 copy of w: m bf16; m
    and v bf16."""
    from opensetgaitrecognition_pcaa_tpu_torch.ops import adam

    return adam.adam_update_.launches_m16_w16, adam.adam_update_.launches_mv16_w16


def reset_bf16_counts() -> None:
    from opensetgaitrecognition_pcaa_tpu_torch.ops import adam
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_train as pt

    pt.fused_layer.launches_bf16 = pt.fused_pool.launches_bf16 = 0
    adam.adam_update_.launches_m16 = adam.adam_update_.launches_mv16 = 0
    adam.adam_update_.launches_v16 = 0
    adam.adam_update_.launches_m16_w16 = adam.adam_update_.launches_mv16_w16 = 0


def ptxas_report(log: str, needle: str) -> list:
    """nvcc's ``-Xptxas -v`` lines (registers, shared memory, spills) and any
    ptxas line on wgmma or setmaxnreg, for the entry functions whose mangled
    name holds ``needle``."""
    lines, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
            continue
        hit = needle in entry and ("registers" in line or "spill" in line)
        if hit or "wgmma" in line or "setmaxnreg" in line:
            lines.append(f"{entry}: {line.strip()}" if hit else line.strip())
    return lines


def traced_events(fn):
    """torch.profiler's ``key_averages`` of one call of ``fn`` (which
    synchronises), traced after a traced warm-up call: a trace's first
    launches go missing now and then, three traces running at times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
        for _ in range(2):
            fn()
            prof.step()
    return traced[-1]


def device_ms(fn, names, calls: int = 5) -> tuple:
    """torch.profiler over ``calls`` calls of ``fn`` after one warm-up →
    (device ms a call of the kernel whose name holds one of ``names``,
    launched once a call, and device ms a call of every kernel)."""
    import torch

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    run()
    for _ in range(PROFILER_TRACES):  # a trace that still misses kernels is taken again
        events = traced_events(run)
        mine = [e for e in events if any(n in e.key for n in names)]
        if sum(e.count for e in mine) == calls:
            break
    mine_ms = sum(e.device_time_total for e in mine) / calls / 1e3
    total_ms = sum(e.device_time_total for e in events) / calls / 1e3
    if mine_ms == 0:
        # no trace held the kernel (seen on the H100 for the bf16 pool, three
        # traces running): the device time of the whole call by CUDA events
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        mine_ms = total_ms = start.elapsed_time(end) / calls
        log(f"device_ms: torch.profiler saw no {names} kernel in {PROFILER_TRACES} traces; "
            f"CUDA events around the call instead: {mine_ms:.4f} ms")
    assert mine_ms > 0, f"no device time of {names}"
    return mine_ms, total_ms


def time_bf16_pointnet(card: str) -> dict:
    """The bf16 layer kernel at the step's four widths (72,000 rows) and the
    bf16 pool at (480, 150, 1024), each against its plain version in the
    order plain, kernel, kernel, plain (CUDA events, 5 calls a turn); at
    layer 3's shape the layer without its affine (the identity prologue)
    beside it; cuBLAS's bf16 GEMM alone at the four shapes (``gemm_ms``:
    bf16 h and W^T in, f32 out, no prologue and no statistics, so a
    yardstick of the MMAs and not a ``library_ms``); two launches of each
    kernel bitwise equal; torch.profiler's device time of the kernel alone
    and of the wrapper's whole call (its padding, W^T cast and statistics
    reduction included). Times per layer and their mean per launch, with
    the bounds: bf16 operations at 989 TFLOP/s or the bytes, whichever is
    larger."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_train as pt

    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, device="cuda", generator=g) * scale + shift

    def affine(c):
        return torch.stack([randn(c, scale=0.3, shift=0.5), randn(c, scale=0.1, shift=0.5),
                            randn(c, scale=0.3)]).contiguous()

    rows = TRAIN_B * 30 * 150
    order = ("plain", "kernel", "kernel", "plain")
    out = dict(layers=[], layer_ms=0.0, layer_plain_ms=0.0)
    flops = moved = 0
    for c_in, c_out in BF16_LAYER_WIDTHS:
        h = randn(rows, c_in, scale=2.0, shift=0.5).to(bf16)
        a = None if c_in == 4 else affine(c_in)
        w = randn(c_in, c_out, scale=c_in ** -0.5)
        b = randn(c_out, scale=0.1)
        first, second = pt.fused_layer(h, a, w, b), pt.fused_layer(h, a, w, b)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(first, second)), (c_in, c_out)
        t = alternate({"kernel": lambda: pt.fused_layer(h, a, w, b),
                       "plain": lambda: pt.fused_layer_ref(h, a, w, b)}, order, reps=5)
        hp, _, wp, _ = pt.pad_layer(h, a, w, b, multiple=8)
        wt = wp.t().to(bf16).contiguous()
        gemm = cuda_ms(lambda: torch.mm(hp, wt.t(), out_dtype=torch.float32), reps=5)
        kdev, cdev = device_ms(lambda: pt.fused_layer(h, a, w, b), ("layer_kernel", "gemm_kernel"))
        f = 2 * rows * c_in * c_out
        m = nbytes(h, w, b, *first) + (0 if a is None else nbytes(a))
        bms, by = bound(f, m, BF16_FLOPS)
        flops, moved = flops + f, moved + m
        out["layers"].append(dict(shape=[rows, c_in, c_out], ms=t["kernel"], plain_ms=t["plain"],
                                  gemm_ms=gemm, kernel_device_ms=kdev, call_device_ms=cdev,
                                  bound_ms=bms, bound_by=by))
        out["layer_ms"] += t["kernel"] / len(BF16_LAYER_WIDTHS)
        out["layer_plain_ms"] += t["plain"] / len(BF16_LAYER_WIDTHS)
        log(f"phase 11a: bf16 layer at ({rows}, {c_in}->{c_out}): kernel {t['kernel']:.4f} ms, "
            f"plain {t['plain']:.4f} ms; bound {bms:.4f} ms by {by}, "
            f"{100 * bms / t['kernel']:.1f}% of the kernel's time; device time (profiler) of "
            f"the kernel {kdev:.4f} ms, of the wrapper's call {cdev:.4f} ms; two launches "
            f"bitwise equal [{card}]")
        log(f"phase 11a: gemm_ms {gemm:.4f} at ({rows}, {c_in}->{c_out}): cuBLAS bf16 GEMM alone "
            f"(torch.mm, f32 out; no prologue, no statistics) [{card}]")
        del first, second, hp, wt
    # the prologue's share at layer 3's shape: the same layer with the
    # identity prologue (no normalize, no ELU) in turns with the affine one
    t = alternate({"affine": lambda: pt.fused_layer(h, a, w, b),
                   "identity": lambda: pt.fused_layer(h, None, w, b)},
                  ("affine", "identity", "identity", "affine"), reps=5)
    out["layer3_affine_ms"], out["layer3_identity_ms"] = t["affine"], t["identity"]
    log(f"phase 11a: bf16 layer at ({rows}, 1024->1024): affine prologue {t['affine']:.4f} ms, "
        f"identity prologue {t['identity']:.4f} ms: the prologue's share "
        f"{100 * (1 - t['identity'] / t['affine']):.1f}% [{card}]")
    del h, w, b
    bms, by = bound(flops, moved, BF16_FLOPS)
    out["layer_bound_ms"], out["layer_bound_by"] = bms / len(BF16_LAYER_WIDTHS), by
    log(f"phase 11a: the 4 bf16 layers of a step: kernel {4 * out['layer_ms']:.3f} ms, plain "
        f"{4 * out['layer_plain_ms']:.3f} ms; bound {bms:.3f} ms by {by} "
        f"({flops / 1e9:.1f} GFLOP at 989 TFLOP/s, {moved / 1e6:.1f} MB), "
        f"{100 * bms / (4 * out['layer_ms']):.1f}% of the kernel's time; per launch: kernel "
        f"{out['layer_ms']:.4f} ms, plain {out['layer_plain_ms']:.4f} ms [{card}]")

    y = randn(TRAIN_B * 30, 150, 1024, scale=2.0, shift=0.5).to(bf16)
    a = affine(1024)
    first, second = pt.fused_pool(y, a), pt.fused_pool(y, a)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    t = alternate({"kernel": lambda: pt.fused_pool(y, a), "plain": lambda: pt.fused_pool_ref(y, a)},
                  order, reps=5)
    kdev, _ = device_ms(lambda: pt.fused_pool(y, a), ("pool",))
    # per element: normalize (3 operations), ELU, sum, in f32 on the CUDA cores
    bms, by = bound(6 * y.numel(), nbytes(y, a) + TRAIN_B * 30 * 1024 * 4)
    out.update(pool_ms=t["kernel"], pool_plain_ms=t["plain"], pool_device_ms=kdev,
               pool_bound_ms=bms, pool_bound_by=by)
    log(f"phase 11a: bf16 pool at ({TRAIN_B * 30}, 150, 1024): kernel {t['kernel']:.4f} ms, "
        f"plain {t['plain']:.4f} ms; bound {bms:.4f} ms by {by}, "
        f"{100 * bms / t['kernel']:.1f}% of the kernel's time; device time (profiler) "
        f"{kdev:.4f} ms; two launches bitwise equal [{card}]")
    return out


def check_bf16_kernels(card: str) -> dict:
    """Phase 11a: the bf16 variants against their plain versions at the
    training path's shapes and at ragged and padded ones, times in the
    order plain, kernel, kernel, plain; the bf16 autograd Function on the
    card against the same Function on the CPU. → per kernel dict(err, ms,
    plain_ms, bound_ms, bound_by, library_ms)."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.ops import _build, adam
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_train as pt

    # the bf16 kernels' ptxas report: registers, shared memory, no spills
    report = ptxas_report(_build.BUILD_LOGS.get("pointnet_train", ""), "bf16")
    for line in report:
        log(f"phase 11a: nvcc pointnet_train {line}")
    spills = [line for line in report if "spill" in line]
    assert spills and all("0 bytes spill stores, 0 bytes spill loads" in s for s in spills), spills

    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, device="cuda", generator=g) * scale + shift

    def affine(c):
        return torch.stack([randn(c, scale=0.3, shift=0.5), randn(c, scale=0.1, shift=0.5),
                            randn(c, scale=0.3)]).contiguous()

    rows = TRAIN_B * 30 * 150
    out = {}
    err = 0.0
    # the training widths, ragged rows, N = 1, then the widths the wrapper
    # pads to multiples of 8: NFEATURES = 5 and POINTNET_OUT_DIM = 30
    for n, c_in, c_out in ((rows, 4, 512), (rows, 512, 512), (rows, 512, 1024),
                           (rows, 1024, 1024), (2 * 3 * 37, 4, 512), (2 * 3 * 37, 512, 1024),
                           (2 * 3 * 1, 4, 512), (2 * 3 * 1, 512, 1024), (rows, 5, 512),
                           (2 * 3 * 37, 5, 15), (2 * 3 * 37, 15, 15), (2 * 3 * 37, 15, 30),
                           (2 * 3 * 37, 30, 30)):
        h = randn(n, c_in, scale=2.0, shift=0.5).to(bf16)
        a = None if c_in in (4, 5) else affine(c_in)
        w = randn(c_in, c_out, scale=c_in ** -0.5)
        b = randn(c_out, scale=0.1)
        before = pt.fused_layer.launches_bf16
        got = pt.fused_layer(h, a, w, b)
        torch.cuda.synchronize()
        assert pt.fused_layer.launches_bf16 == before + 1, (n, c_in, c_out)
        assert got[0].dtype == bf16 and tuple(got[0].shape) == (n, c_out)
        want = pt.fused_layer_ref(h, a, w, b)
        torch.testing.assert_close(got[0].float(), want[0].float(), **BF16_STEP)
        for u, v in zip(got[1:], want[1:]):
            torch.testing.assert_close(u, v, rtol=1e-4, atol=1e-4)
        e = max(float((u.float() - v.float()).abs().max()) for u, v in zip(got, want))
        err = max(err, e)
        log(f"phase 11a: bf16 layer kernel vs plain at ({n}, {c_in}->{c_out}): max |diff| "
            f"{e:.3e}")
        del h, got, want

    pool_err = 0.0
    for frames, n in ((TRAIN_B * 30, 150), (2 * 3, 37)):
        y = randn(frames, n, 1024, scale=2.0, shift=0.5).to(bf16)
        a = affine(1024)
        before = pt.fused_pool.launches_bf16
        got = pt.fused_pool(y, a)
        torch.cuda.synchronize()
        assert pt.fused_pool.launches_bf16 == before + 1 and got.dtype == torch.float32
        want = pt.fused_pool_ref(y, a)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        e = float((got - want).abs().max())
        pool_err = max(pool_err, e)
        log(f"phase 11a: bf16 pool kernel vs plain at ({frames}, {n}, 1024): max |diff| {e:.3e}")
        del y
    t = time_bf16_pointnet(card)
    out["layer"] = dict(err=err, ms=t["layer_ms"], plain_ms=t["layer_plain_ms"], library_ms=None,
                        bound_ms=t["layer_bound_ms"], bound_by=t["layer_bound_by"],
                        bound_route="bf16")
    out["pool"] = dict(err=pool_err, ms=t["pool_ms"], plain_ms=t["pool_plain_ms"],
                       bound_ms=t["pool_bound_ms"], bound_by=t["pool_bound_by"],
                       bound_route="f32", library_ms=None)

    s1, s2 = adam.adam_scalars(3, 1e-4, 0.9, 0.99)
    coeffs = dict(s1=s1, s2=s2, b1=0.9, b2=0.99, eps=1e-8)
    for variant in ("m16", "mv16", "v16"):  # m bf16; m and v bf16; v bf16
        counter = "launches_" + variant
        for shape in ((2047, 1025), (9000, 18000)):  # 2,098,175 elements: n % 4 == 3
            leaf = [randn(*shape, scale=1e-2), randn(*shape), randn(*shape, scale=1e-3),
                    torch.rand(shape, device="cuda", generator=g) * 1e-4]
            if variant != "v16":
                leaf[2] = leaf[2].to(bf16)
            if variant != "m16":
                leaf[3] = leaf[3].to(bf16)
            ref = [t.clone() for t in leaf]
            before = getattr(adam.adam_update_, counter)
            adam.adam_update_(*leaf, **coeffs)
            torch.cuda.synchronize()
            assert getattr(adam.adam_update_, counter) == before + 1
            adam.adam_update_ref_(*ref, **coeffs)
            for u, v in zip(leaf[1:], ref[1:]):
                assert u.dtype == v.dtype and torch.equal(u, v), (variant, shape)
            log(f"phase 11a: Adam ({variant}) kernel vs plain on a {shape} leaf: bitwise equal")
        t = alternate({"kernel": lambda: adam.adam_update_(*leaf, **coeffs),
                       "plain": lambda: adam.adam_update_ref_(*ref, **coeffs)},
                      ("plain", "kernel", "kernel", "plain"), reps=5)
        # per element 13 operations; reads g, w, m, v and writes w, m, v
        moved = nbytes(*leaf) + nbytes(*leaf[1:])
        bms, by = bound(13 * leaf[0].numel(), moved)
        out["adam_" + variant] = dict(err=0.0, ms=t["kernel"], plain_ms=t["plain"], bound_ms=bms,
                                      bound_by=by, bound_route="f32", library_ms=None)
        log(f"phase 11a: Adam ({variant}) on the 9000 x 18000 leaf: kernel {t['kernel']:.3f} ms, "
            f"plain {t['plain']:.3f} ms (bitwise); bound {bms:.3f} ms by {by} "
            f"({moved / 1e9:.2f} GB) [{card}]")
        del leaf, ref
    torch.cuda.empty_cache()

    # the bf16 autograd Function at the published widths on 2 x 30 frames:
    # forward through the kernels and backward through cuBLAS's bf16 GEMMs
    # on the card, against the same Function on the CPU (plain versions,
    # f32 GEMMs of the bf16 values): rtol 1e-2, atol 1e-2 of each output's
    # scale (a bias's: its layer's W gradient's), bf16 values one rounding
    # step apart moving what follows
    rng = np.random.default_rng(SEED + 11)
    widths = ((4, 512), (512, 512), (512, 1024), (1024, 1024))
    x = rng.normal(size=(2, 30, 150, 4)).astype(np.float32)
    layers = [((rng.uniform(-1, 1, (a, c)) / np.sqrt(a)).astype(np.float32),
               rng.uniform(-0.1, 0.1, c).astype(np.float32),
               (1 + 0.2 * rng.normal(size=c)).astype(np.float32),
               (0.1 * rng.normal(size=c)).astype(np.float32)) for a, c in widths]
    cot = rng.normal(size=(2, 30, 1024)).astype(np.float32)
    results = []
    for device in ("cuda", "cpu"):
        params = [[torch.tensor(a, device=device, requires_grad=True) for a in layer]
                  for layer in layers]
        xt = torch.tensor(x, device=device, requires_grad=True)
        pooled, means, variances = pt.pointnet_pool_train(xt, params, bf16)
        torch.sum(pooled * torch.from_numpy(cot).to(device)).backward()
        results.append([t.detach().cpu() for t in [pooled, *means, *variances, xt.grad]
                        + [p.grad for layer in params for p in layer]])
    worst = 0.0
    for i, (got, want) in enumerate(zip(*results)):
        scale = float(want.abs().max())
        if i >= 10 and (i - 10) % 4 == 1:
            # a dense bias ahead of a train-mode BatchNorm: a zero gradient
            # up to the rounding of a sum over the rows, held against the
            # scale of its layer's W gradient
            scale = float(results[1][i - 1].abs().max())
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2 * scale + 1e-6, msg=str(i))
        worst = max(worst, float((got - want).abs().max()) / max(scale, 1e-30))
    log(f"phase 11a: the bf16 PointNet Function at (2, 30, 150, 4), widths 4-512-512-1024-1024: "
        f"card (kernels, bf16 cuBLAS backward) vs CPU (plain): pooled, statistics and the 17 "
        f"gradients within {worst:.3e} of their scale (bound rtol 1e-2, atol 1e-2 of the scale)")
    return out


def _moments(v, fn):
    """``fn`` over a second moment: a tensor, or a factored leaf's dict."""
    return {k: fn(t) for k, t in v.items()} if isinstance(v, dict) else fn(v)


def _snapshot(mods, opts) -> tuple:
    """A copy of the modules' state and of the Adam states ``opts``."""
    return ({k: v.clone() for k, v in mods.state_dict().items()},
            [(o.count, {k: v.clone() for k, v in o.mu.items()},
              {k: _moments(v, lambda t: t.clone()) for k, v in o.nu.items()}) for o in opts])


def _restore(mods, opts, snap: tuple, caches=()) -> None:
    """Put ``_snapshot``'s copy back, in place, and refresh the bf16
    weight caches ``caches`` (each ``(cache, parameters by name)``)."""
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import refresh_cache_

    mods.load_state_dict(snap[0])
    for o, (count, mu, nu) in zip(opts, snap[1]):
        o.count = count
        for k in mu:
            o.mu[k].copy_(mu[k])
            if isinstance(nu[k], dict):
                for f in nu[k]:
                    o.nu[k][f].copy_(nu[k][f])
            else:
                o.nu[k].copy_(nu[k])
    for cache, params in caches:
        refresh_cache_(cache, params)


def _timed_and_profiled(step_fn, n_timed: int, mods, opts, label: str, caches=(),
                        keep_snapshot: bool = False) -> dict:
    """``n_timed`` steps on the host clock (the first pays set-up), then 3
    under torch.profiler, from a snapshot of ``mods`` and the Adam states
    ``opts`` that every trace restarts from (``traced_until_whole``; the
    weight caches ``caches`` refreshed from it) → ms per step, losses,
    launch counts (f32 layer, pool, Adam; bf16 layer, pool, Adam m16, Adam
    mv16; Adam m16 and mv16 with the bf16 copy of w) per step, device ms a
    step and by kind, peak memory over the timed steps, and with
    ``keep_snapshot`` the snapshot (the state after the timed steps)."""
    import torch

    r = dict(ms=[], losses=[], counts=[])

    def run(i, rec):
        reset_train_counts()
        reset_bf16_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step_fn(i)
        torch.cuda.synchronize()
        rec["ms"].append(1e3 * (time.perf_counter() - t0))
        rec["counts"].append(train_counts() + bf16_counts() + copy_counts())
        rec["losses"].append({k: float(v) for k, v in m.items()})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_timed):
        run(i, r)
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    snap = _snapshot(mods, opts)

    def traced() -> dict:
        _restore(mods, opts, snap, caches)
        rec = dict(ms=[], losses=[], counts=[])
        for i in range(n_timed, n_timed + 3):
            run(i, rec)
        return rec

    def counted(rec) -> tuple:  # (layer, pool, Adam) over the traced steps, f32 and bf16
        c = [sum(col) for col in zip(*rec["counts"])]
        return c[0] + c[3], c[1] + c[4], c[2] + sum(c[5:])

    events, rec = traced_until_whole(traced, counted, label)
    if keep_snapshot:
        r["snapshot"] = snap
    del snap
    for key in ("ms", "losses", "counts"):
        r[key] += rec[key]
    r["busy"] = _busy_ms(events, 3)
    r["warm_ms"] = sum(r["ms"][1:n_timed]) / (n_timed - 1)
    return r


def bf16_steps(card: str, gen: str) -> list:
    """Phase 11b: the full-width V4 step at B = 16 from one seeded state on
    phase 6's crops with injected noise: f32, bf16 and bf16 + nu16 through
    the kernels, and bf16 + nu16 plain; then the ORCED step (no kernel) at
    f32 and at bf16 + nu16 on the same crops with injected eps → the bf16
    variants' launches in the kernel runs (layer, pool, Adam m16, Adam
    mv16)."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import (
        RadarCropDataset,
        epoch_batch_indices,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.train.orced import (
        build_orced,
        make_orced_train_step,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
        VARIANTS,
        build_pcaa,
        make_train_step,
    )

    x_np, y_np = RadarCropDataset(SPLIT.TRAIN, gen).load_all()
    x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
    perm = torch.from_numpy(
        epoch_batch_indices(len(x_np), TRAIN_B, shuffle=True, rng=np.random.default_rng(SEED))
    ).long().cuda()
    n = BF16_TIMED_STEPS + 3
    assert len(perm) >= n, len(perm)
    rng = np.random.default_rng(SEED + 12)
    noise = (torch.from_numpy(rng.normal(size=(n, TRAIN_B, 32)).astype(np.float32)).cuda(),
             torch.from_numpy(rng.uniform(size=(n, TRAIN_B, 1)).astype(np.float32)).cuda())
    eps = torch.from_numpy(rng.normal(size=(n, TRAIN_B, 32)).astype(np.float32)).cuda()
    bf16 = dict(COMPUTE_DTYPE="bfloat16")
    nu16 = dict(COMPUTE_DTYPE="bfloat16", BF16_ADAM_NU=True)
    # (f32 layer, pool, Adam; bf16 layer, pool, Adam m16, Adam mv16; Adam
    # m16 and mv16 with the copy of w) per step
    want = {"f32": (4, 1, 4, 0, 0, 0, 0, 0, 0), "bf16": (0, 0, 0, 4, 1, 4, 0, 0, 0),
            "bf16+nu16": (0, 0, 0, 4, 1, 0, 4, 0, 0), "bf16+nu16 plain": (0,) * 9}
    runs = {}
    for name, flags, fused in (("f32", {}, True), ("bf16", bf16, True), ("bf16+nu16", nu16, True),
                               ("bf16+nu16 plain", nu16, False)):
        cfg = full_width(FUSED_POINTNET=fused, FUSED_ADAM=fused, **flags)
        mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cuda")
        step = make_train_step(mods, cfg)
        n_params = sum(p.numel() for p in mods.parameters())

        def step_fn(i, step=step, state=state):
            return step(state, x[perm[i]], y[perm[i]], i, (noise[0][i], noise[1][i]))[1]

        r = runs[name] = _timed_and_profiled(step_fn, BF16_TIMED_STEPS, mods,
                                             (state.opt_g, state.opt_d), f"phase 11b: {name}")
        assert all(c == want[name] for c in r["counts"]), (name, r["counts"])
        for m in r["losses"]:
            assert all(np.isfinite(v) for v in m.values()), (name, m)
        busy, groups = r["busy"]
        log(f"phase 11b: V4 step {name} ({n_params / 1e6:.1f}M parameters, B = {TRAIN_B}): ms "
            f"per step {[round(t, 2) for t in r['ms'][:BF16_TIMED_STEPS]]}, warm mean "
            f"{r['warm_ms']:.2f} ms, {TRAIN_B / (r['warm_ms'] / 1e3):.1f} train windows/s, peak "
            f"memory {r['peak_gb']:.2f} GB; device time {busy:.2f} ms a step (torch.profiler, 3 "
            f"warm steps), by kind "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(groups.items(), key=lambda g: -g[1]))
            + f"; launches per step {want[name]} [{card}]")
        del mods, state, step, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    worst = 0.0
    for i, (k, p) in enumerate(zip(runs["bf16+nu16"]["losses"], runs["bf16+nu16 plain"]["losses"])):
        for key in ("rec_loss", "d_loss", "sup_loss", "tot_loss"):
            gap = abs(k[key] - p[key]) / max(abs(p[key]), 1.0)
            worst = max(worst, gap)
            assert gap <= BF16_LOSS_RTOL, (i, key, k[key], p[key])
    log(f"phase 11b: bf16 + nu16 losses kernel vs plain agree within {worst:.3e} (relative to "
        f"max(|plain|, 1); bound {BF16_LOSS_RTOL}); first step rec_loss f32 "
        f"{runs['f32']['losses'][0]['rec_loss']:.6f}, bf16 {runs['bf16']['losses'][0]['rec_loss']:.6f}, "
        f"bf16 + nu16 {runs['bf16+nu16']['losses'][0]['rec_loss']:.6f}")
    launches = [0, 0, 0, 0]
    for name in ("bf16", "bf16+nu16"):
        for c in runs[name]["counts"]:
            launches = [a + b for a, b in zip(launches, c[3:7])]

    for name, flags in (("ORCED f32", {}), ("ORCED bf16+nu16", nu16)):
        cfg = full_width(**flags)
        mods, state = build_orced(cfg, device="cuda")
        step = make_orced_train_step(mods, cfg)

        def step_fn(i, step=step, state=state):
            return step(state, x[perm[i]], y[perm[i]], 0.5, eps[i])[1]

        r = runs[name] = _timed_and_profiled(step_fn, BF16_TIMED_STEPS, mods, (state.opt,),
                                             f"phase 11b: {name}")
        assert all(c == (0,) * 9 for c in r["counts"]), (name, r["counts"])
        for m in r["losses"]:
            assert all(np.isfinite(v) for v in m.values()), (name, m)
        busy, groups = r["busy"]
        log(f"phase 11b: {name} step (B = {TRAIN_B}): ms per step "
            f"{[round(t, 2) for t in r['ms'][:BF16_TIMED_STEPS]]}, warm mean {r['warm_ms']:.2f} "
            f"ms, {TRAIN_B / (r['warm_ms'] / 1e3):.1f} train windows/s, peak memory "
            f"{r['peak_gb']:.2f} GB; device time {busy:.2f} ms a step, by kind "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(groups.items(), key=lambda g: -g[1]))
            + f" [{card}]")
        del mods, state, step, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    del x, y, perm, noise, eps
    return launches


def bf16_driver(card: str) -> dict:
    """Phase 11c: ``run_pcaa_ablation --compute-dtype bfloat16
    --bf16-adam-nu`` with the kernels on, V4 for one epoch on a 6-class
    subset of phase 8's raw tracks; then ``pcaa_inference`` scores the
    folder through the (f32) inference kernel → launches of the bf16
    variants and of the inference kernel."""

    import torch

    from opensetgaitrecognition_pcaa_tpu_torch import config as port_config
    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, Config
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
    from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import pcaa_inference
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_infer as pn
    from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_pcaa_ablation as rpa
    from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import load_params

    raw = os.path.join(WORK, "raw")
    gen = os.path.join(WORK, "gen_bf16")
    models = os.path.join(WORK, "models_bf16")
    name = f"{BF16_NAME_BASE}V4.{N_SEEN}.1"
    rpa.default_config = lambda **kw: port_config.default_config(
        FUSED_POINTNET=True, FUSED_ADAM=True, **kw)
    try:
        reset_train_counts()
        reset_bf16_counts()
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rpa.main(["--data-path", raw, "--gen-data-path", gen, "--models-path", models,
                      "--model-name-base", BF16_NAME_BASE, "--n-training-classes", str(N_SEEN),
                      "--n-tests", "1", "--variants", "V4", "--epochs", "1",
                      "--compute-dtype", "bfloat16", "--bf16-adam-nu"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = bf16_counts()
        f32_counts = train_counts()
    finally:
        rpa.default_config = port_config.default_config
    steps = len(RadarCropDataset(SPLIT.TRAIN, gen)) // TRAIN_B
    assert counts == (4 * steps, steps, 0, 4 * steps), (counts, steps)
    assert f32_counts == (0, 0, 0), f32_counts
    run_dir = os.path.join(models, name)
    cfg = Config.load(os.path.join(run_dir, "config.json"))
    assert cfg.COMPUTE_DTYPE == "bfloat16" and cfg.BF16_ADAM_NU
    enc = load_params(os.path.join(run_dir, f"{name}_E.msgpack"))
    kernel = enc["params"]["GaitBackbone_0"]["PointNetBlock_0"]["TorchDense_0"]["kernel"]
    assert kernel.dtype == np.float32 and np.isfinite(kernel).all()
    acc = [line.split(": ", 1)[1] for line in buf.getvalue().splitlines()
           if "best_valid_acc=" in line]
    log(f"phase 11c: run_pcaa_ablation --compute-dtype bfloat16 --bf16-adam-nu (kernels on) "
        f"trained {name}: 1 epoch of {steps} steps in {seconds:.2f} s with the splits' write; "
        f"bf16 launches (layer, pool, adam m16, adam mv16) {counts}, f32 launches {f32_counts}; "
        f"{acc} [{card}]")
    pn.pointnet_pool_infer.launches = 0
    t0 = time.perf_counter()
    logs = pcaa_inference([name], ks=KS, models_path=models,
                          figures_path=os.path.join(WORK, "fig_bf16"), generate_dataset=False,
                          dump_calibration=True, device="cuda", use_kernel=True)
    torch.cuda.synchronize()
    infer = pn.pointnet_pool_infer.launches
    assert infer > 0
    cal = dict(np.load(os.path.join(run_dir, "calibration.npz")))
    for key in ("log_threshold", "test_ll", "unseen_ll"):
        assert np.isfinite(cal[key]).all(), key
    log(f"phase 11c: pcaa_inference scored the bf16-trained folder through the inference kernel "
        f"in {time.perf_counter() - t0:.2f} s ({infer} launches): f1_micro "
        f"{[round(logs[name][k]['f1_micro'], 4) for k in KS]} [{card}]")
    return dict(layer=counts[0], pool=counts[1], adam_mv16=counts[3], infer=infer)


def bf16_phase(card: str, gen: str) -> tuple:
    """Phase 11 → (the bf16 variants' checks, their launches on the main
    paths of 11b and 11c, the inference kernel's launches in 11c)."""
    t0 = time.perf_counter()
    checks = check_bf16_kernels(card)
    step_launches = bf16_steps(card, gen)
    drv = bf16_driver(card)
    launches = dict(layer=step_launches[0] + drv["layer"], pool=step_launches[1] + drv["pool"],
                    adam_m16=step_launches[2], adam_mv16=step_launches[3] + drv["adam_mv16"])
    log(f"phase 11: {time.perf_counter() - t0:.1f} s [{card}]")
    return checks, launches, drv["infer"]


def _grid_call(module, argv: list, kernels: bool) -> dict:
    """One call of a driver's ``main`` (the training kernels on through its
    base configuration where ``kernels``), output captured, split writes
    counted → its seconds, output, writes, launches (f32 layer, pool, Adam;
    Adam v bf16) and peak device memory above what was allocated before."""

    import torch

    from opensetgaitrecognition_pcaa_tpu_torch import config as port_config
    from opensetgaitrecognition_pcaa_tpu_torch.ops import adam

    writes = []
    real = module.generate_splits
    module.generate_splits = lambda **kw: writes.append(kw["train_classes"]) or real(**kw)
    if kernels:
        module.default_config = lambda **kw: port_config.default_config(
            FUSED_POINTNET=True, FUSED_ADAM=True, **kw)
    reset_train_counts()
    reset_bf16_counts()
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            module.main(argv)
        torch.cuda.synchronize()
    finally:
        module.generate_splits = real
        module.default_config = port_config.default_config
    return dict(s=time.perf_counter() - t0, text=buf.getvalue(), writes=writes,
                counts=train_counts() + (adam.adam_update_.launches_v16,),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9 - base_gb)


def _epoch_metrics(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _busy_share(trainer, layer_launches: int) -> tuple:
    """One warm grid epoch of ``trainer``, one on the host clock, then one
    traced by ``traced_events`` (retaken where it still misses launches of
    the f32 layer kernel, the ``tf32x3`` engine's GEMM) → (device ms of an
    epoch, host ms of an epoch, busy share)."""
    import torch

    def epoch():
        trainer.run_epoch(0)
        torch.cuda.synchronize()

    epoch()
    t0 = time.perf_counter()
    epoch()
    host_ms = 1e3 * (time.perf_counter() - t0)
    for _ in range(PROFILER_TRACES):
        events = traced_events(epoch)
        seen = sum(e.count for e in events if "tf32x3" in e.key)
        if seen == layer_launches:
            break
    assert seen == layer_launches, (seen, layer_launches)
    device_ms = sum(e.device_time_total for e in events) / 1e3
    return device_ms, host_ms, device_ms / host_ms


def _hold_grid_to_solo(trainer, cfg, split) -> float:
    """One epoch of ``trainer`` against its run 1 trained alone: the solo
    ``train_epoch`` from the same seed (weights and noise generator) on the
    same split and permutation (the grid's host draw) → the largest loss gap
    of any step relative to max(|solo|, 1); every gap within LOSS_RTOL and
    the correct counts equal."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import epoch_batch_indices
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
        VARIANTS,
        build_pcaa,
        make_epoch_fns,
    )

    trainer.run_epoch(0)
    grid = {k: v.cpu().numpy() for k, v in trainer.last_epoch_steps[0].items()}
    mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cuda")
    x, y = (torch.from_numpy(a).cuda() for a in split)
    perm = epoch_batch_indices(len(split[0]), cfg.BATCH_SIZE, shuffle=True,
                               rng=np.random.default_rng(cfg.SEED))
    _, m = make_epoch_fns(mods, cfg)[0](state, x, y, perm)
    worst = 0.0
    for key, v in m.items():
        want = v.cpu().numpy()
        if key == "n_correct":
            assert np.array_equal(grid[key], want), (grid[key], want)
            continue
        gap = float(np.max(np.abs(grid[key] - want) / np.maximum(np.abs(want), 1.0)))
        assert gap <= LOSS_RTOL, (key, grid[key], want)
        worst = max(worst, gap)
    del mods, state, m, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def grid_phase(card: str) -> dict:
    """Phase 12: the ``--grid`` mode of both drivers on phase 8's raw tracks
    at the published widths, 6 classes, 2 splits, 1 epoch (each grid run is
    its solo run bit for bit on the CPU, ``tests/test_torch_grid.py``); the
    grid's busy share; the grid at f32 with ``--bf16-adam-nu`` on 1 split;
    a second call of each grid skipping both splits → launches of the
    training kernels (f32 layer, pool, Adam; Adam v bf16)."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
    from opensetgaitrecognition_pcaa_tpu_torch.parallel.grid import GridPCAATrainer
    from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_orced
    from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_pcaa_ablation as rpa

    t_phase = time.perf_counter()
    raw = os.path.join(WORK, "raw")
    runs = [f"{GRID_BASE}V4.{N_SEEN}.{i + 1}" for i in range(2)]

    def argv(tag, *extra, n_tests=2):
        return ["--data-path", raw, "--gen-data-path", os.path.join(WORK, f"gen_{tag}"),
                "--models-path", os.path.join(WORK, f"models_{tag}"), "--n-training-classes",
                str(N_SEEN), "--n-tests", str(n_tests), "--epochs", "1", *extra]

    def finite(models: str, names) -> None:
        for r in names:
            rec = _epoch_metrics(os.path.join(WORK, models, r))
            assert rec and all(np.isfinite(v) for e in rec for v in e.values()), r

    pcaa = ("--model-name-base", GRID_BASE, "--variants", "V4")
    # --- 12a. the PCAA grid chunk -----------------------------------------------------------
    grid = _grid_call(rpa, argv("grid", *pcaa, "--grid"), kernels=True)
    assert "=== grid-training V4 n_tr=6 (splits [1, 2] lockstep, unsharded) ===" in grid["text"]
    gens = [os.path.join(WORK, f"gen_grid_grid{N_SEEN}_{i}") for i in range(2)]
    steps = [len(RadarCropDataset(SPLIT.TRAIN, g)) // TRAIN_B for g in gens]
    want = (4 * sum(steps), sum(steps), 4 * sum(steps), 0)
    assert grid["counts"] == want, grid["counts"]
    assert len(grid["writes"]) == 2
    finite("models_grid", runs)
    accs = [line.strip() for line in grid["text"].splitlines() if "best valid accs" in line]
    log(f"phase 12a: run_pcaa_ablation --grid (kernels on) trained {runs} as one chunk, 1 epoch "
        f"of {steps} steps, in {grid['s']:.2f} s with the 2 splits' write and the run folders; "
        f"peak device memory {grid['peak_gb']:.2f} GB for the chunk of 2; launches (layer, pool, "
        f"adam, adam v16) {grid['counts']}; epoch losses finite; {accs} [{card}]")

    # the grid's device busy share, GRID_PROFILE_STEPS steps a run
    data = [RadarCropDataset(SPLIT.TRAIN, g).load_all() for g in gens]
    cut = [(x[:GRID_PROFILE_STEPS * TRAIN_B], y[:GRID_PROFILE_STEPS * TRAIN_B]) for x, y in data]
    cfgs = [full_width(FUSED_POINTNET=True, FUSED_ADAM=True).replace(SEED=i) for i in range(2)]
    trainer = GridPCAATrainer(cfgs, VARIATION.V4, cut, device="cuda")
    solo_gap = _hold_grid_to_solo(trainer, cfgs[0], cut[0])
    log(f"phase 12a: grid run 1's {GRID_PROFILE_STEPS} steps against its solo train_epoch "
        f"(same seed, split and permutation): losses within {solo_gap:.3e} (relative to "
        f"max(|solo|, 1); bound {LOSS_RTOL}), correct counts equal [{card}]")
    busy = _busy_share(trainer, 4 * GRID_PROFILE_STEPS * 2)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 12a: device busy share over {GRID_PROFILE_STEPS} V4 steps a run (f32, kernels "
        f"on, torch.profiler's device time over the host clock of an unprofiled epoch): "
        f"2 runs in a grid {busy[0]:.2f} of {busy[1]:.2f} ms = {busy[2]:.3f} [{card}]")

    # --- 12b. the grid at f32 with --bf16-adam-nu, 1 split: the Adam kernel with v bf16 -----
    nu16 = _grid_call(rpa, argv("grid", *pcaa, "--grid", "--bf16-adam-nu",
                                "--models-path", os.path.join(WORK, "models_grid_nu16"),
                                n_tests=1), kernels=True)
    assert nu16["counts"] == (4 * steps[0], steps[0], 0, 4 * steps[0]), nu16["counts"]
    finite("models_grid_nu16", runs[:1])
    log(f"phase 12b: run_pcaa_ablation --grid --bf16-adam-nu at f32 (kernels on), 1 split: "
        f"{nu16['s']:.2f} s, peak {nu16['peak_gb']:.2f} GB; launches (layer, pool, adam, adam "
        f"v16) {nu16['counts']} [{card}]")

    # --- 12c. the ORCED grid chunk -----------------------------------------------------------
    ogrid = _grid_call(run_orced, argv("ogrid", "--grid"), kernels=False)
    assert "=== grid-training ORCED n_tr=6 (splits [1, 2] lockstep, unsharded) ===" \
        in ogrid["text"]
    assert ogrid["counts"] == (0, 0, 0, 0)
    finite("models_ogrid", [f"ORCED_.{N_SEEN}.{i + 1}" for i in range(2)])
    log(f"phase 12c: run_orced --grid trained 2 runs as one chunk, 1 epoch, in "
        f"{ogrid['s']:.2f} s with the splits' write and the run folders; peak "
        f"{ogrid['peak_gb']:.2f} GB for the chunk; epoch losses finite [{card}]")

    # --- 12d. second calls: both splits skipped before any is written ------------------
    for module, args, kernels in ((rpa, argv("grid", *pcaa, "--grid"), True),
                                  (run_orced, argv("ogrid", "--grid"), False)):
        again = _grid_call(module, args, kernels)
        assert "    skipping completed splits [1, 2]" in again["text"], again["text"]
        assert again["writes"] == [] and "=== grid-training" not in again["text"]
        assert again["counts"] == (0, 0, 0, 0)
        log(f"phase 12d: {module.__name__.split('.')[-1]} --grid again: both splits skipped, "
            f"none written, {again['s']:.3f} s")
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s [{card}]")
    c = [grid["counts"][i] + nu16["counts"][i] for i in range(4)]
    return dict(layer=c[0], pool=c[1], adam=c[2], adam_v16=c[3])


def precision_gate() -> int:
    """``--precision-gate``: the quality gate of the bf16 tiers on the card,
    by the paired-seed method of ``tools/gate_optimizer_quality.py``: V4 on
    a synthetic split (10 subjects x 10 tracks, 8 train classes) for
    GATE_EPOCHS epochs at the published widths, the kernels on, for each
    of GATE_SEEDS seeds under f32, bf16 and bf16 + nu16; best valid
    accuracy and windows/s per seed, the paired deltas against f32; one
    JSON line at the end."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
    from opensetgaitrecognition_pcaa_tpu_torch.data.splits import generate_splits
    from opensetgaitrecognition_pcaa_tpu_torch.data.synthetic import (
        generate_synthetic_raw_dataset,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.infer.common import ieee_f32
    from opensetgaitrecognition_pcaa_tpu_torch.ops import _build
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import train_pcaa

    card = card_name()
    log(card)
    ieee_f32()
    _build.load_libraries(("pointnet_train", "adam"))
    work = os.path.join(WORK, "gate")
    shutil.rmtree(work, ignore_errors=True)
    raw, gen = os.path.join(work, "raw"), os.path.join(work, "gen")
    generate_synthetic_raw_dataset(raw, n_subjects=10, tracks_per_scenario=10)
    generate_splits(train_classes=list(range(8)), data_path=raw, gen_data_path=gen,
                    verbose=False)
    out = {name: {"accs": [], "wps": []} for name in GATE_CONFIGS}
    for seed in range(GATE_SEEDS):
        for name, flags in GATE_CONFIGS.items():
            cfg = Config(TRAIN_CLASSES=tuple(range(8)), MODEL_NAME=f"gate_{seed}_V4",
                         GEN_DATA_PATH=gen, MODELS_PATH=os.path.join(work, name),
                         EPOCHS=GATE_EPOCHS, CHECKPOINT_FREQUENCY=1, SEED=seed,
                         FUSED_POINTNET=True, FUSED_ADAM=True, **flags)
            r = train_pcaa(cfg, VARIATION.V4, verbose=False, resume=False, device="cuda")
            torch.cuda.empty_cache()
            out[name]["accs"].append(float(r["best_valid_accuracy"]))
            out[name]["wps"].append(float(r["windows_per_sec"]))
        log(f"gate seed {seed}: " + ", ".join(
            f"{n} acc {out[n]['accs'][-1]:.4f} {out[n]['wps'][-1]:.1f} w/s" for n in out)
            + f" [{card}]")
    base = np.array(out["f32"]["accs"])
    for name, r in out.items():
        r["paired_delta_vs_f32"] = [round(float(v), 4) for v in np.array(r["accs"]) - base]
        r["mean_paired_delta_vs_f32"] = round(float((np.array(r["accs"]) - base).mean()), 4)
    log(json.dumps({"precision_gate": out, "epochs": GATE_EPOCHS, "card": card}))
    return 0


def _tree_mb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs) / 1e6


def add_v4_modules(run_dir: str, cfg) -> None:
    """Phase 3's folder holds the encoder and the means, all that inference
    reads: add a V4 run's other modules (G fed by the GPH's 2·latent, D,
    GPH) from seeded inits, saved by the port."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.convert import (
        decoder_variables,
        discriminator_variables,
        head_variables,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import (
        CGDecoder,
        CGDiscriminator,
        ProjectionHead,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import module_path, save_params

    init = torch.Generator().manual_seed(SEED + 20)
    latent = cfg.SUP_LATENT_DIM
    modules = {
        "G": (CGDecoder(2 * latent, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES, generator=init),
              decoder_variables),
        "D": (CGDiscriminator(latent, cfg.n_classes, generator=init), discriminator_variables),
        "GPH": (ProjectionHead(latent, 2 * latent, generator=init), head_variables),
    }
    for tag, (module, to_variables) in modules.items():
        save_params(to_variables(module.state_dict()), module_path(run_dir, cfg.MODEL_NAME, tag))


def reference_phase(card: str, gen: str) -> dict:
    """Phase 13: the reference run-folder export and import at the
    published widths, then inference on the imported folders through the
    kernels → launches of the PointNet and Chamfer kernels in 13c-d.

    a. ``export_reference_run`` writes phase 3's V4 folder (E with its
       head, G, D, GPH, means), phase 7b's OR-CED folder (E, G, ML) and
       phase 9b's V1 folder (E, D, G, GPH, ML, means) as reference
       folders; the V1 one through ``python -m`` in a subprocess;
    b. ``import_reference_run`` reads each back: every module file and
       ``discriminator_means.npy`` byte-equal to the source's,
       ``config.json`` equal but for ``MODELS_PATH`` (and, for the driver's
       V1 run, the fields the reference's config.pkl does not carry); the
       decoder's unit permutation timed alone in both directions;
    c. ``pcaa_inference`` of the imported V4 folder through the kernel:
       decisions equal to phase 3's kernel run, latents' max |diff| printed;
    d. ``orced_inference`` of the imported OR-CED folder with phase 7c's
       pinned eps at batch 64: decisions equal to phase 7c's kernel run."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, VARIATION, Config
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
    from opensetgaitrecognition_pcaa_tpu_torch.infer.orced import orced_inference
    from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import (
        _encode_split,
        pcaa_inference,
        pcaa_inference_setup,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.ops import chamfer_kernel as ck
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_infer as pn
    from opensetgaitrecognition_pcaa_tpu_torch.scripts import export_reference_run as ex
    from opensetgaitrecognition_pcaa_tpu_torch.scripts import import_reference_run as im
    from opensetgaitrecognition_pcaa_tpu_torch.transplant import (
        orced_decoder_state_dict,
        torch_cg_decoder_to_flax,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import load_params, module_path

    t_phase = time.perf_counter()
    # --- 13a. export -----------------------------------------------------------------
    sources = {"V4": os.path.join(WORK, "models_ref_src", NAME),
               "ORCED": os.path.join(WORK, "models_orced_src", ORCED_NAME),
               "V1": os.path.join(WORK, "models_ablation", f"{ABLATION_BASE}V1.{N_SEEN}.1")}
    shutil.copytree(os.path.join(WORK, "models_src", NAME), sources["V4"])
    add_v4_modules(sources["V4"], Config.load(os.path.join(sources["V4"], "config.json")))
    reference = os.path.join(WORK, "reference")
    exported = {}
    for kind, run in sources.items():
        t0 = time.perf_counter()
        if kind == "V1":
            proc = subprocess.run(
                [sys.executable, "-m",
                 "opensetgaitrecognition_pcaa_tpu_torch.scripts.export_reference_run",
                 "--run", run, "--out-models", reference],
                cwd=REPO, capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr[-4000:]
            dst = os.path.join(reference, os.path.basename(run))
            how = "python -m, a fresh interpreter"
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                dst = ex.export_reference_run(run, reference)
            how = "in process"
        seconds = time.perf_counter() - t0
        exported[kind] = dst
        log(f"phase 13a: export_reference_run {kind} ({how}): {seconds:.2f} s, "
            f"{_tree_mb(dst):.1f} MB in {sorted(os.listdir(dst))} from {_tree_mb(run):.1f} MB "
            f"[{card}]")

    # --- 13b. import -----------------------------------------------------------------
    imported = os.path.join(WORK, "imported")
    carried = set(ex._BASE_KEYS) | set(ex._ORCED_KEYS) | {
        "DEC_MLP_SIZE", "DTC_FILTERS", "TRAIN_CLASSES", "TRAIN_SCENARIOS", "DATA_PATH",
        "GEN_DATA_PATH"}
    for kind, dst in exported.items():
        src_cfg = Config.load(os.path.join(sources[kind], "config.json"))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cfg = im.import_reference_run(dst, imported, DATA_PATH=src_cfg.DATA_PATH,
                                          GEN_DATA_PATH=src_cfg.GEN_DATA_PATH)
        seconds = time.perf_counter() - t0
        run_dir = cfg.run_dir()
        files = sorted(f for f in os.listdir(run_dir) if f != "config.json")
        want = sorted(f for f in os.listdir(sources[kind])
                      if f.endswith(".msgpack") or f == "discriminator_means.npy")
        assert files == want, (kind, files, want)
        for fname in files:
            with open(os.path.join(sources[kind], fname), "rb") as a, \
                    open(os.path.join(run_dir, fname), "rb") as b:
                assert a.read() == b.read(), (kind, fname)
        got = Config.load(os.path.join(run_dir, "config.json")).to_dict()
        differ = sorted(k for k, v in src_cfg.to_dict().items()
                        if k != "MODELS_PATH" and got[k] != v)
        assert not set(differ) & carried, (kind, differ)
        assert kind == "V1" or not differ, (kind, differ)
        log(f"phase 13b: import_reference_run {kind}: {seconds:.2f} s; {len(files)} files "
            f"byte-equal to the source's ({', '.join(files)}); config.json equal but for "
            f"MODELS_PATH" + (f" and {differ}, which the reference's config.pkl does not "
                              f"carry" if differ else "") + f" [{card}]")
    cfg = Config.load(os.path.join(sources["V4"], "config.json"))
    dec_sd = im._load_state_dict(os.path.join(exported["V4"], f"{NAME}_G.pt"))
    t0 = time.perf_counter()
    dec = torch_cg_decoder_to_flax(dec_sd, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES)
    inverse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = orced_decoder_state_dict({"params": dec}, cfg.NSTEPS, cfg.NMAX, cfg.NFEATURES)
    forward_s = time.perf_counter() - t0
    assert torch.equal(back["dense5.weight"], dec_sd["dense5.weight"])
    log(f"phase 13b: the decoder maps alone, dense5 {tuple(dec_sd['dense5.weight'].shape)} f32 "
        f"({dec_sd['dense5.weight'].numel() * 4 / 1e6:.0f} MB): reference to run folder "
        f"(unit permutation + transposes) {inverse_s:.2f} s, back {forward_s:.2f} s [{card}]")
    del dec_sd, dec, back

    # --- 13c. pcaa_inference on the imported V4 folder ---------------------------------
    pn.pointnet_pool_infer.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = pcaa_inference(
        [NAME], ks=KS, models_path=imported, figures_path=os.path.join(WORK, "figures_imported"),
        variation=VARIATION.V4, generate_dataset=False, dump_calibration=True, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    v4_launches = pn.pointnet_pool_infer.launches
    assert v4_launches > 0, "pcaa_inference of the imported folder launched no kernel"
    phase3, mine = os.path.join(WORK, "models_kernel", NAME), os.path.join(imported, NAME)
    want, got = (dict(np.load(os.path.join(d, "calibration.npz"))) for d in (phase3, mine))
    ll_gap = max(float(np.abs(got[k] - want[k]).max()) for k in ("test_ll", "unseen_ll"))
    for key in ("test_preds", "test_labels", "unseen_preds", "unseen_labels", "is_val"):
        np.testing.assert_array_equal(got[key], want[key])
    for k in KS:
        for stem in ("final_preds", "final_labels"):
            a = np.load(os.path.join(phase3, f"{stem}_{k}.npy"))
            b = np.load(os.path.join(mine, f"{stem}_{k}.npy"))
            assert a.shape == b.shape and (a == b).all(), f"{stem}_{k}: decisions differ"
    lat_err = 0.0
    for split in (SPLIT.TEST, SPLIT.UNSEEN):
        ds = RadarCropDataset(split, gen, sequential=True)
        fvs = []
        for models in (os.path.join(WORK, "models_kernel"), imported):
            _, encoder, _ = pcaa_inference_setup(NAME, VARIATION.V4, device="cuda",
                                                 models_path=models, generate_dataset=False)
            fvs.append(_encode_split(encoder, ds, "cuda", use_kernel=True)[0])
        lat_err = max(lat_err, float(np.abs(fvs[0] - fvs[1]).max()))
    del encoder
    log(f"phase 13c: pcaa_inference of the imported V4 folder via kernel: {seconds:.2f} s, "
        f"{v4_launches} launches, f1_micro {[round(logs[NAME][k]['f1_micro'], 4) for k in KS]}; "
        f"decisions equal to phase 3's kernel run for ks {list(KS)}; latents max |diff| "
        f"{lat_err:.3e}, log-likelihoods max |diff| {ll_gap:.3e} [{card}]")

    # --- 13d. orced_inference on the imported OR-CED folder -----------------------------
    eps = orced_eps(gen, cfg.SUP_LATENT_DIM)
    pn.pointnet_pool_infer.launches = ck.seq_chamfer_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    figures = os.path.join(WORK, "figures_orced_imported")
    logs = orced_inference(
        [ORCED_NAME], device="cuda", models_path=imported, figures_path=figures,
        generate_dataset=False, batch_size=ORCED_B, eps_streams=eps, dump_calibration=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    orced_launches = (pn.pointnet_pool_infer.launches, ck.seq_chamfer_kernel.launches)
    assert orced_launches[0] > 0 and orced_launches[1] > 0, orced_launches
    for stem in ("preds", "labels"):
        a = np.load(os.path.join(WORK, "figures_orced_kernel", ORCED_NAME,
                                 f"ensemble_ood_final_{stem}_fixed.npy"))
        b = np.load(os.path.join(figures, ORCED_NAME, f"ensemble_ood_final_{stem}_fixed.npy"))
        assert a.shape == b.shape and (a == b).all(), f"OR-CED {stem} differ"
    want, got = (dict(np.load(os.path.join(d, ORCED_NAME, "orced_calibration.npz")))
                 for d in (os.path.join(WORK, "models_orced_kernel"), imported))
    z_gap = max(float(np.abs(got[f"{s}_z"] - want[f"{s}_z"]).max())
                for s in ("train", "test", "unseen"))
    re_gap = max(float(np.abs(got[f"{s}_re"] - want[f"{s}_re"]).max())
                 for s in ("train", "test", "unseen"))
    log(f"phase 13d: orced_inference of the imported OR-CED folder via kernels: {seconds:.2f} s, "
        f"launches (PointNet, Chamfer) {orced_launches}, {len(b)} decisions equal to phase 7c's "
        f"kernel run, f1_micro {logs[ORCED_NAME]['f1_micro']:.4f}; latents max |diff| "
        f"{z_gap:.3e}, rec errors max |diff| {re_gap:.3e} [{card}]")
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s [{card}]")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(pointnet=v4_launches + orced_launches[0], chamfer=orced_launches[1])


# phase 14 (data and tensor parallelism): the sub-phases, each (name, run
# kind, DP, MP) on 2 ranks of gloo sharing the card, and the steps each
# runs from one seeded state with injected noise
MESH_CASES = (("14a", "pcaa", 2, 1), ("14b", "pcaa", 1, 2), ("14c", "orced", 2, 1))
MESH_STEPS = 3
MESH_BACKEND = "gloo"  # the ranks share one card; nccl needs a card per rank
MESH_TIMEOUT = 600  # s: a rank that fails stops the others at once, a hang at this
# a sharded run against one rank: the losses of MESH_STEPS steps relative
# to max(|one rank|, 1) (f32 sums in other orders; on an H100, 1.1e-7 to
# 2.9e-6 at 2 and 4 ranks); after the first step, each Adam first moment
# ((1 - b1) times its gradient) within rtol 1e-3 and 1e-4 of its leaf's
# largest magnitude, tests/test_torch_dp.py's bound for two f32 gradients,
# and each running statistic to the same bound. Not after the last step:
# from the second step on, Adam turns the sum order's noise in a gradient
# that is 0 up to rounding (a bias ahead of a BatchNorm) into a step of lr
# either way, which moves the next running means by up to lr, and a
# Chamfer tie can flip a reconstruction gradient (on an H100: up to 1.5e-3
# of a leaf's scale after 3 steps, the losses within 6e-7)
MESH_LOSS_RTOL = 1e-5
MOMENT_RTOL, MOMENT_ATOL_OF_SCALE = 1e-3, 1e-4


def _mesh_cfg(kind: str, dp: int, mp: int):
    """Phase 14's configuration: the published widths, B = 16, the training
    kernels on for PCAA (OR-CED's trainer reaches none, as in JAX)."""
    kernels = dict(FUSED_POINTNET=True, FUSED_ADAM=True) if kind == "pcaa" else {}
    return full_width(DP_DEVICES=dp, MP_DEVICES=mp, EPOCHS=1, **kernels)


def _run_tree(mods, opts, mesh, specs) -> dict:
    """A run's whole state_dict (``modules``) and the first moments of each
    Adam state of ``opts``, on the card: gathered over the model group
    where the run is sharded (every rank calls it)."""
    from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import gather_state, sub_specs

    if mesh is None:
        return {"modules": mods.state_dict(), **{n: opt.mu for n, (opt, _) in opts.items()}}
    return {"modules": gather_state(mods.state_dict(), specs, mesh),
            **{n: gather_state(opt.mu, sub_specs(specs, prefix), mesh)
               for n, (opt, prefix) in opts.items()}}


def _mesh_steps(kind: str, cfg, data: dict, keep_tree: bool = False) -> tuple:
    """MESH_STEPS steps of ``cfg``'s run (on its mesh of ranks where
    DP × MP > 1) from ``cfg.SEED``'s state, the batches and noise of
    ``data`` → (this rank's global metrics per step, its training-kernel
    launches (the layer's per output width, Adam's per leaf shape), its
    seconds and peak device memory; where ``keep_tree``, the run's whole
    state after the first step (``_run_tree``) on the host, else None)."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.infer.common import ieee_f32
    from opensetgaitrecognition_pcaa_tpu_torch.ops import adam
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_train as pt
    from opensetgaitrecognition_pcaa_tpu_torch.train.orced import (
        build_orced,
        make_orced_epoch_fns,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
        VARIANTS,
        build_pcaa,
        make_epoch_fns,
        place_state,
        run_mesh,
    )

    ieee_f32()
    t0 = time.perf_counter()
    mesh = run_mesh(cfg)
    if kind == "pcaa":
        mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cuda")
        opts = {"opt_g": (state.opt_g, "g."), "opt_d": (state.opt_d, "d.")}
    else:
        mods, state = build_orced(cfg, device="cuda")
        opts = {"opt": (state.opt, "")}
    specs = place_state(mods, opts, mesh, cfg.MP_MIN_DIM)
    cuda = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reset_train_counts()
    pt.fused_layer.widths.clear()
    adam.adam_update_.shapes.clear()
    epoch = (make_epoch_fns if kind == "pcaa" else make_orced_epoch_fns)(mods, cfg, mesh)[0]
    # the epoch in two calls, 1 step and the rest: a step's index within its
    # call picks its supervision, which SUPERVISION_FREQUENCY 1 gives every step
    assert cfg.SUPERVISION_FREQUENCY == 1

    def steps(sl: slice) -> tuple:
        nonlocal state
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if kind == "pcaa":
            state, m = epoch(state, cuda["x"], cuda["y"], cuda["perm"][sl],
                             noise=(cuda["z0"][sl], cuda["alphas"][sl]))
        else:
            state, m = epoch(state, cuda["x"], cuda["y"], cuda["perm"][sl], 0.5,
                             noise=cuda["eps"][sl])
        torch.cuda.synchronize()
        return m, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9

    first, first_s, first_gb = steps(slice(0, 1))
    # the state after the first step, whose Adam first moments are (1 - b1)
    # times its gradients, on the host where ``keep_tree``
    tree = _run_tree(mods, opts, mesh, specs)
    tree = {part: {k: v.to("cpu", copy=True) for k, v in leaves.items()}
            for part, leaves in tree.items()} if keep_tree else None
    rest, rest_s, rest_gb = steps(slice(1, None))
    out = dict(metrics={k: torch.cat([first[k], rest[k]]).cpu().numpy().tolist() for k in first},
               counts=train_counts(), widths=dict(pt.fused_layer.widths),
               adam_shapes=dict(adam.adam_update_.shapes), build_s=build_s,
               steps_s=first_s + rest_s, peak_gb=max(first_gb, rest_gb))
    del mods, state, first, rest, cuda
    gc.collect()
    torch.cuda.empty_cache()
    return out, tree


def _noise_grad(key: str) -> bool:
    """An Adam leaf whose gradient is f32 noise about 0: a dense or conv
    bias ahead of a train-mode BatchNorm (the PointNet's, the TCN's, the
    mean learner's first three)."""
    parts = key.split(".")
    return parts[-1] == "bias" and ("pointnet.dense." in key or ".conv." in key or (
        parts[0] == "mean_learner" and parts[1] == "dense" and parts[2] in "012"))


def _hold_state(name: str, got: dict, want: dict) -> dict:
    """A sharded run's gathered state (``_run_tree``) against one rank's
    after the same first step: each Adam first moment and running statistic
    within MOMENT_RTOL and MOMENT_ATOL_OF_SCALE of its leaf's largest
    magnitude; a leaf of ``_noise_grad`` below MOMENT_ATOL_OF_SCALE of its
    weight's moment's largest magnitude on both sides → the largest gaps
    relative to their leaf's scale, the number of leaves held and the
    (at most 5 worst) leaves outside their bound, for the caller to fail
    on after logging."""
    gaps = dict(moment_gap=0.0, stats_gap=0.0, held=0)
    outside = []

    def hold(kind, key, g, w, scale):
        assert g.shape == w.shape, (name, key, g.shape, w.shape)
        gaps["held"] += 1
        excess = float(((g - w).abs() - MOMENT_RTOL * w.abs()).max())
        if excess > MOMENT_ATOL_OF_SCALE * scale:
            outside.append((key, excess / max(scale, 1e-30)))
        gaps[kind] = max(gaps[kind], float((g - w).abs().max()) / max(scale, 1e-30))

    for opt in (k for k in want if k != "modules"):
        for key, w in want[opt].items():
            g = got[opt][key]
            if _noise_grad(key):
                scale = float(want[opt][key[:-len("bias")] + "weight"].abs().max())
                noise = max(float(g.abs().max()), float(w.abs().max()))
                gaps["held"] += 1
                if noise > MOMENT_ATOL_OF_SCALE * scale:
                    outside.append((f"{opt}/{key} (noise)", noise / scale))
                continue
            hold("moment_gap", f"{opt}/{key}", g, w, float(w.abs().max()))
    for key, w in want["modules"].items():
        if key.endswith((".mean", ".var")):  # the running statistics
            hold("stats_gap", key, got["modules"][key], w, float(w.abs().max()))
    gaps["outside"] = sorted(outside, key=lambda t: -t[1])[:5]
    return gaps


def _mesh_ranks(cases: list, data: dict) -> list:
    """Phase 14's ranks (``launch``): each case's steps in turn; after each,
    rank 0 runs the same steps on one rank (no mesh) and holds the gathered
    state after the first step to it (``_hold_state``) → every rank's
    ``_mesh_steps`` results,
    rank 0's with the one-rank run's (``one``) and the state's gaps
    (``state``), gathered on rank 0."""
    import torch.distributed as dist

    mine = []
    for kind, cfg in cases:
        rank0 = dist.get_rank() == 0
        out, tree = _mesh_steps(kind, cfg, data[kind], keep_tree=rank0)
        if rank0:
            out["one"], one_tree = _mesh_steps(kind, _mesh_cfg(kind, 1, 1), data[kind], True)
            out["state"] = _hold_state(kind, tree, one_tree)
            del one_tree
        del tree
        mine.append(out)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out


def _mesh_data() -> dict:
    """Phase 14's batches (phase 6's train crops) and noise, by run kind."""
    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset

    x, y = RadarCropDataset(SPLIT.TRAIN, os.path.join(WORK, "gen")).load_all()
    n = MESH_STEPS * TRAIN_B
    rng = np.random.default_rng(SEED + 14)
    base = dict(x=x[:n], y=y[:n], perm=np.arange(n).reshape(MESH_STEPS, TRAIN_B))
    return {"pcaa": dict(base, z0=rng.normal(size=(MESH_STEPS, TRAIN_B, 32)).astype(np.float32),
                         alphas=rng.uniform(size=(MESH_STEPS, TRAIN_B, 1)).astype(np.float32)),
            "orced": dict(base, eps=rng.normal(size=(MESH_STEPS, TRAIN_B, 32)).astype(np.float32))}


def _hold_to_one_rank(ranks: list) -> tuple:
    """Every rank's losses against rank 0's one-rank run of the same steps
    (``_mesh_ranks``) → (the largest gap relative to max(|one rank|, 1),
    whether every rank's correct counts equal the one rank's), for
    ``_report_mesh_case`` to hold to MESH_LOSS_RTOL."""
    worst, counts_equal = 0.0, True
    for key, want in ranks[0]["one"]["metrics"].items():
        for rank in ranks:
            got = np.asarray(rank["metrics"][key])
            if key == "n_correct":
                counts_equal &= bool(np.array_equal(got, want))
                continue
            gap = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))
            worst = max(worst, gap if np.isfinite(gap) else np.inf)
    return worst, counts_equal


def check_mesh_kernels(card: str) -> dict:
    """Phase 14's kernel shapes against the plain versions, before its ranks
    start: the layer kernel, f32 and bf16, at a DP 2 rank's rows (36,000)
    and full widths (14a), and at 14b's column shards (4->256, 512->256,
    512->512, 1024->512) on 72,000 rows, each called with and without
    ``sums``: y and the column sums per row (Σy/n, Σy²/n) held to
    ``fused_layer_ref(..., sums=True)`` at phase 6a's tolerance (y at bf16
    at phase 11a's), y equal between the two calls and ``stats_from_sums``
    of the sums equal bit for bit to the kernel's own mean and var; the
    Adam kernel on 14b's largest decoder shard, (9000, 9000), at phase 6a's
    tolerance → the largest |diff| of the f32 layer, the bf16 layer and
    Adam."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.ops import adam
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_train as pt

    g = torch.Generator(device="cuda").manual_seed(SEED + 14)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, device="cuda", generator=g) * scale + shift

    dp_rows, mp_rows = TRAIN_B // 2 * 30 * 150, TRAIN_B * 30 * 150
    shapes = [(dp_rows, 4, 512), (dp_rows, 512, 512), (dp_rows, 512, 1024),
              (dp_rows, 1024, 1024), (mp_rows, 4, 256), (mp_rows, 512, 256),
              (mp_rows, 512, 512), (mp_rows, 1024, 512)]
    err = dict(layer=0.0, layer_bf16=0.0)
    for dtype, key, counter, y_tol in (
            (torch.float32, "layer", "launches", dict(rtol=1e-4, atol=1e-4)),
            (torch.bfloat16, "layer_bf16", "launches_bf16", BF16_STEP)):
        for rows, c_in, c_out in shapes:
            h = randn(rows, c_in, scale=2.0, shift=0.5).to(dtype)
            a = None if c_in == 4 else torch.stack([
                randn(c_in, scale=0.3, shift=0.5), randn(c_in, scale=0.1, shift=0.5),
                randn(c_in, scale=0.3)]).contiguous()
            w = randn(c_in, c_out, scale=c_in ** -0.5)
            b = randn(c_out, scale=0.1)
            before = getattr(pt.fused_layer, counter)
            y, mean, var = pt.fused_layer(h, a, w, b)
            y_sums, sums = pt.fused_layer(h, a, w, b, sums=True)
            torch.cuda.synchronize()
            assert getattr(pt.fused_layer, counter) == before + 2, (rows, c_in, c_out)
            assert sums.dtype == torch.float64 and tuple(sums.shape) == (2, c_out)
            assert torch.equal(y, y_sums), (dtype, rows, c_in, c_out)
            s_mean, s_var = pt.stats_from_sums(sums, rows)
            assert torch.equal(s_mean, mean) and torch.equal(s_var, var), (dtype, rows, c_in, c_out)
            y_ref, sums_ref = pt.fused_layer_ref(h, a, w, b, sums=True)
            torch.testing.assert_close(y.float(), y_ref.float(), **y_tol)
            torch.testing.assert_close(sums / rows, sums_ref / rows, rtol=1e-4, atol=1e-4)
            e = max(float((y.float() - y_ref.float()).abs().max()),
                    float(((sums - sums_ref) / rows).abs().max()))
            err[key] = max(err[key], e)
            log(f"phase 14: {'f32' if dtype == torch.float32 else 'bf16'} layer kernel with and "
                f"without sums vs plain at ({rows}, {c_in}->{c_out}): max |diff| {e:.3e}; "
                f"stats_from_sums equal to the kernel's mean and var")
            del h, y, y_sums, y_ref
    s1, s2 = adam.adam_scalars(3, 1e-4, 0.9, 0.99)
    coeffs = dict(s1=s1, s2=s2, b1=0.9, b2=0.99, eps=1e-8)
    shape = (9000, 9000)
    leaf = [randn(*shape, scale=1e-2), randn(*shape), randn(*shape, scale=1e-3),
            torch.rand(shape, device="cuda", generator=g) * 1e-4]
    ref = [t.clone() for t in leaf]
    before = adam.adam_update_.launches
    adam.adam_update_(*leaf, **coeffs)
    torch.cuda.synchronize()
    assert adam.adam_update_.launches == before + 1
    adam.adam_update_ref_(*ref, **coeffs)
    for u, v in zip(leaf[1:], ref[1:]):
        torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-9)
    err["adam"] = max(float((u - v).abs().max()) for u, v in zip(leaf[1:], ref[1:]))
    log(f"phase 14: Adam kernel vs plain on a {shape} decoder shard: max |diff| "
        f"{err['adam']:.3e} (rtol 1e-6, atol 1e-9) [{card}]")
    del leaf, ref
    torch.cuda.empty_cache()
    return err


def _report_mesh_case(label: str, kind: str, dp: int, mp: int, per_rank: list,
                      card: str) -> list:
    """Log a sharded run against its one-rank run → its faults, for the
    caller to fail on once every case is logged: losses beyond
    MESH_LOSS_RTOL, a correct count that differs, leaves of the state
    outside their bound (``_hold_state``)."""
    one, state = per_rank[0]["one"], per_rank[0]["state"]
    worst, counts_equal = _hold_to_one_rank(per_rank)
    log(f"{label}: {kind.upper()} at DP {dp} x MP {mp}, {MESH_STEPS} steps of B = {TRAIN_B} "
        f"({TRAIN_B // dp} crops, {TRAIN_B // dp * 30 * 150} PointNet rows a rank a step): "
        f"losses within {worst:.3e} of one rank's (relative to max(|one rank|, 1); bound "
        f"{MESH_LOSS_RTOL}), correct counts {one['metrics']['n_correct']} (equal on every "
        f"rank: {counts_equal}); gathered state after step 1 "
        f"against one rank's: {state['held']} leaves, Adam first moments within "
        f"{state['moment_gap']:.3e} of their leaf's scale (bound rtol {MOMENT_RTOL}, atol "
        f"{MOMENT_ATOL_OF_SCALE} of the scale), running statistics within "
        f"{state['stats_gap']:.3e} of theirs (same bound); per rank: launches (layer, pool, adam) "
        f"{[r['counts'] for r in per_rank]}, layer launches per output width "
        f"{[dict(sorted(r['widths'].items())) for r in per_rank]}, Adam kernel leaves "
        f"{[sorted(r['adam_shapes']) for r in per_rank]}; build s "
        f"{[round(r['build_s'], 2) for r in per_rank]}, steps s "
        f"{[round(r['steps_s'], 3) for r in per_rank]} (one rank {one['steps_s']:.3f}), peak GB "
        f"{[round(r['peak_gb'], 2) for r in per_rank]} (one rank {one['peak_gb']:.2f}) [{card}]")
    faults = []
    if worst > MESH_LOSS_RTOL:
        faults.append(f"{label}: losses {worst:.3e} from one rank's")
    if not counts_equal:
        faults.append(f"{label}: correct counts differ")
    if state["outside"]:
        faults.append(f"{label}: leaves outside their bound {state['outside']}")
    return faults


def mesh_phase(card: str) -> tuple:
    """Phase 14: the kernels at its shapes (``check_mesh_kernels``), then
    one run of the port over 2 ranks (``parallel/mesh.py``, processes of
    gloo sharing the card) at the published widths, B = 16: V4 at DP 2
    (14a) and MP 2 (14b) with the training kernels, OR-CED at DP 2 (14c),
    each MESH_STEPS steps held to the same steps on one rank: losses within
    MESH_LOSS_RTOL, correct counts equal, the gathered Adam first moments
    and running statistics (``_hold_state``) → (the ranks' launches of the
    f32 layer, pool and Adam kernels, the kernels' largest errors)."""
    from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import launch

    t_phase = time.perf_counter()
    err = check_mesh_kernels(card)
    data = _mesh_data()
    cases = [(kind, _mesh_cfg(kind, dp, mp)) for _, kind, dp, mp in MESH_CASES]
    t0 = time.perf_counter()
    ranks = launch(_mesh_ranks, 2, cases, data, backend=MESH_BACKEND, timeout=MESH_TIMEOUT)
    launch_s = time.perf_counter() - t0
    log(f"phase 14: 2 ranks, backend {MESH_BACKEND!r} (the ranks share cuda:0), "
        f"{launch_s:.1f} s from the launch to rank 0's result [{card}]")
    totals = dict(layer=0, pool=0, adam=0)
    faults = []
    for i, (name, kind, dp, mp) in enumerate(MESH_CASES):
        per_rank = [r[i] for r in ranks]
        for rank in per_rank:
            for k, c in zip(("layer", "pool", "adam"), rank["counts"]):
                totals[k] += c
        widths = [dict(sorted(r["widths"].items())) for r in per_rank]
        shapes = [sorted(r["adam_shapes"]) for r in per_rank]
        if kind == "pcaa":
            # every step: 4 layers, 1 pool, the 4 big decoder leaves (their shards at MP 2)
            assert all(r["counts"] == (4 * MESH_STEPS, MESH_STEPS, 4 * MESH_STEPS)
                       for r in per_rank), [r["counts"] for r in per_rank]
            want_widths = {512 // mp: 2 * MESH_STEPS, 1024 // mp: 2 * MESH_STEPS}
            assert all(w == want_widths for w in widths), widths
            assert all(len(s) == 4 and all(sh[0] in (2250 // mp, 4500 // mp, 9000 // mp,
                                                     18000 // mp) for sh in s)
                       for s in shapes), shapes
        else:
            assert all(r["counts"] == (0, 0, 0) for r in per_rank)
        faults += _report_mesh_case(f"phase {name}", kind, dp, mp, per_rank, card)
    assert not faults, faults
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return totals, err
# --- phase 15: BF16_WEIGHT_CACHE, DEFERRED_DECODER_UPDATE, FACTORED_ADAM_NU ---------


def check_adam_copy(card: str) -> dict:
    """Phase 15a: the Adam kernel writing the bf16 copy of w, with m bf16
    and with m and v bf16, against its plain version on the 9000 x 18000
    decoder leaf and on a ragged one (2047 x 1025, n % 4 == 3): w, m, v and
    the copy bitwise equal; timed on the big leaf in the order plain,
    kernel, kernel, plain → each variant's record entry."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.ops import adam

    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    bf16 = torch.bfloat16
    s1, s2 = adam.adam_scalars(3, 1e-4, 0.9, 0.99)
    coeffs = dict(s1=s1, s2=s2, b1=0.9, b2=0.99, eps=1e-8)
    out = {}
    for variant in ("m16", "mv16"):
        counter = f"launches_{variant}_w16"
        for shape in ((2047, 1025), (9000, 18000)):
            leaf = [torch.randn(shape, device="cuda", generator=g) * 1e-2,
                    torch.randn(shape, device="cuda", generator=g),
                    (torch.randn(shape, device="cuda", generator=g) * 1e-3).to(bf16),
                    torch.rand(shape, device="cuda", generator=g) * 1e-4,
                    torch.zeros(shape, device="cuda", dtype=bf16)]
            if variant == "mv16":
                leaf[3] = leaf[3].to(bf16)
            ref = [t.clone() for t in leaf]
            before = getattr(adam.adam_update_, counter)
            adam.adam_update_(*leaf[:4], w16=leaf[4], **coeffs)
            torch.cuda.synchronize()
            assert getattr(adam.adam_update_, counter) == before + 1, variant
            adam.adam_update_ref_(*ref[:4], w16=ref[4], **coeffs)
            for name, u, v in zip(("w", "m", "v", "w16"), leaf[1:], ref[1:]):
                assert u.dtype == v.dtype and torch.equal(u, v), (variant, shape, name)
            assert torch.equal(leaf[4], leaf[1].to(bf16)), (variant, shape)
            log(f"phase 15a: Adam ({variant}) with the bf16 copy of w, kernel vs plain on a "
                f"{shape} leaf: w, m, v and the copy bitwise equal")
        t = alternate({"kernel": lambda: adam.adam_update_(*leaf[:4], w16=leaf[4], **coeffs),
                       "plain": lambda: adam.adam_update_ref_(*ref[:4], w16=ref[4], **coeffs)},
                      ("plain", "kernel", "kernel", "plain"), reps=5)
        # per element 13 operations; reads g, w, m, v and writes w, m, v and the copy
        moved = nbytes(*leaf[:4]) + nbytes(*leaf[1:])
        bms, by = bound(13 * leaf[0].numel(), moved)
        out[variant] = dict(err=0.0, ms=t["kernel"], plain_ms=t["plain"], bound_ms=bms,
                            bound_by=by, bound_route="f32", library_ms=None)
        log(f"phase 15a: Adam ({variant}) + bf16 copy on the 9000 x 18000 leaf: kernel "
            f"{t['kernel']:.4f} ms, plain {t['plain']:.4f} ms (bitwise); bound {bms:.4f} ms by "
            f"{by} ({moved / 1e9:.3f} GB, {moved / leaf[0].numel():.0f} B an element; "
            f"{100 * bms / t['kernel']:.1f}% of the kernel's time) [{card}]")
        del leaf, ref
    torch.cuda.empty_cache()
    return out


def _train_data(gen: str, n: int) -> dict:
    """Phase 6's train crops on the card, the first ``n`` batches of one
    seeded shuffle, and injected noise for them (z0, alphas, ORCED eps)."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import (
        RadarCropDataset,
        epoch_batch_indices,
    )

    x_np, y_np = RadarCropDataset(SPLIT.TRAIN, gen).load_all()
    perm = epoch_batch_indices(len(x_np), TRAIN_B, shuffle=True, rng=np.random.default_rng(SEED))
    assert len(perm) >= n, (len(perm), n)
    rng = np.random.default_rng(SEED + 15)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    return dict(x=dev(x_np), y=dev(y_np), perm=dev(perm[:n]).long(),
                z0=dev(rng.normal(size=(n, TRAIN_B, 32)).astype(np.float32)),
                alphas=dev(rng.uniform(size=(n, TRAIN_B, 1)).astype(np.float32)),
                eps=dev(rng.normal(size=(n, TRAIN_B, 32)).astype(np.float32)))


def _state_diff(a: tuple, b: tuple) -> tuple:
    """Two ``_snapshot``s → (the largest |difference| of any parameter,
    running statistic or moment, the names of the leaves that differ)."""
    def flat(snap):
        out = {f"modules.{k}": v for k, v in snap[0].items()}
        for i, (count, mu, nu) in enumerate(snap[1]):
            out[f"opt{i}.count"] = count
            out.update({f"opt{i}.mu.{k}": v for k, v in mu.items()})
            for k, v in nu.items():
                items = v.items() if isinstance(v, dict) else [("", v)]
                out.update({f"opt{i}.nu.{k}.{f}".rstrip("."): t for f, t in items})
        return out

    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    worst, differ = 0.0, []
    for k in fa:
        u, v = fa[k], fb[k]
        if isinstance(u, int):
            same, gap = u == v, float(abs(u - v))
        else:
            same = u.dtype == v.dtype and bool((u == v).all())
            gap = 0.0 if same else float((u.float() - v.float()).abs().max())
        if not same:
            differ.append(k)
            worst = max(worst, gap)
    return worst, differ


def _loss_gap(a: list, b: list) -> float:
    return max(abs(x[k] - y[k]) for x, y in zip(a, b) for k in x)


def _cache_gate(label: str, on: dict, off: dict, rerun_off) -> str:
    """Cache on against off: losses and every parameter, running statistic
    and moment equal bitwise; where not, no wider than two runs with the
    cache off (``rerun_off()`` runs the second), naming what differs."""
    loss_gap = _loss_gap(on["losses"], off["losses"])
    worst, differ = _state_diff(on["snapshot"], off["snapshot"])
    if loss_gap == 0.0 and not differ:
        return "losses and every parameter, statistic and moment bitwise equal"
    again = rerun_off()
    base_loss = _loss_gap(again["losses"], off["losses"])
    base, base_differ = _state_diff(again["snapshot"], off["snapshot"])
    assert loss_gap <= base_loss and worst <= base, (
        label, loss_gap, base_loss, worst, base, differ[:8], base_differ[:8])
    return (f"not bitwise: losses {loss_gap:.3e} apart, state {worst:.3e} in {len(differ)} "
            f"leaves ({differ[:4]}), no wider than two runs with the cache off (losses "
            f"{base_loss:.3e}, state {base:.3e} in {len(base_differ)} leaves: {base_differ[:4]})")


def _step_run(kind: str, cfg, data: dict, label: str) -> dict:
    """One seeded V4 (``kind`` "pcaa") or ORCED state at ``cfg``:
    CACHE_STEPS steps on the host clock, then 3 under torch.profiler
    (``_timed_and_profiled``) → its record, with the snapshot after the
    CACHE_STEPS steps, the parameter count and the run's own peak memory
    (``peak_gb`` less what was allocated before the run was built: the
    data, and the snapshots of the runs it is compared with)."""
    import torch

    held = torch.cuda.memory_allocated()

    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.train.orced import (
        build_orced,
        make_orced_train_step,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
        VARIANTS,
        build_pcaa,
        make_train_step,
    )

    x, y, perm = data["x"], data["y"], data["perm"]
    if kind == "pcaa":
        mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cuda")
        step = make_train_step(mods, cfg)
        opts, cache = (state.opt_g, state.opt_d), (state.cast_g, dict(mods.g.named_parameters()))

        def step_fn(i):
            return step(state, x[perm[i]], y[perm[i]], i, (data["z0"][i], data["alphas"][i]))[1]
    else:
        mods, state = build_orced(cfg, device="cuda")
        step = make_orced_train_step(mods, cfg)
        opts, cache = (state.opt,), (state.cast, dict(mods.named_parameters()))

        def step_fn(i):
            return step(state, x[perm[i]], y[perm[i]], 0.5, data["eps"][i])[1]

    r = _timed_and_profiled(step_fn, CACHE_STEPS, mods, opts, label, caches=(cache,),
                            keep_snapshot=True)
    r["peak_gb"] -= held / 1e9
    r["n_params"] = sum(p.numel() for p in mods.parameters())
    r["cache_mb"] = sum(t.numel() * t.element_size() for t in cache[0].values()) / 1e6
    for m in r["losses"]:
        assert all(np.isfinite(v) for v in m.values()), (label, m)
    r["losses"] = r["losses"][:CACHE_STEPS]
    del mods, state, step, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return r


def _report_step(label: str, r: dict, card: str) -> None:
    busy, groups = r["busy"]
    log(f"{label}: ms per step {[round(t, 2) for t in r['ms'][:CACHE_STEPS]]}, warm mean "
        f"{r['warm_ms']:.2f} ms (host clock); device time {busy:.2f} ms a step "
        f"(torch.profiler, 3 warm steps), elementwise {groups.get('elementwise', 0.0):.2f} ms, "
        f"by kind " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(groups.items(),
                                                                  key=lambda g: -g[1]))
        + f"; peak memory {r['peak_gb']:.3f} GB above what was held before; cache {r['cache_mb']:.1f} MB; launches per "
        f"step {r['counts'][0]} [{card}]")


def cache_steps(card: str, data: dict) -> dict:
    """Phase 15b-c: the full-width V4 step at bf16 and at bf16 + nu16 with
    FUSED_POINTNET and FUSED_ADAM on, and the ORCED step at bf16, each from
    one seeded state for CACHE_STEPS steps with BF16_WEIGHT_CACHE on and
    with it off: the gate (``_cache_gate``), ms per step (host clock and
    device time), the elementwise passes' device time and peak memory → the
    Adam kernel's launches with the copy on the cache-on runs' timed
    steps (m16, mv16)."""
    launches = [0, 0]
    bf16 = dict(COMPUTE_DTYPE="bfloat16")
    nu16 = dict(COMPUTE_DTYPE="bfloat16", BF16_ADAM_NU=True)
    # (f32 layer, pool, Adam; bf16 layer, pool, Adam m16, mv16; with the copy m16, mv16)
    want = {("bf16", False): (0, 0, 0, 4, 1, 4, 0, 0, 0), ("bf16", True): (0, 0, 0, 4, 1, 0, 0, 4, 0),
            ("bf16+nu16", False): (0, 0, 0, 4, 1, 0, 4, 0, 0),
            ("bf16+nu16", True): (0, 0, 0, 4, 1, 0, 0, 0, 4)}
    for kind, name, flags, phase in (("pcaa", "bf16", bf16, "15b"), ("pcaa", "bf16+nu16", nu16, "15b"),
                                     ("orced", "bf16", bf16, "15c")):
        fused = dict(FUSED_POINTNET=True, FUSED_ADAM=True) if kind == "pcaa" else {}
        runs = {}
        for cache in (False, True):
            cfg = full_width(BF16_WEIGHT_CACHE=cache, **fused, **flags)
            label = f"phase {phase}: {'V4' if kind == 'pcaa' else 'ORCED'} step {name}, cache " \
                    f"{'on' if cache else 'off'}"
            r = runs[cache] = _step_run(kind, cfg, data, label)
            if kind == "pcaa":
                assert all(c == want[(name, cache)] for c in r["counts"]), (label, r["counts"])
            else:
                assert all(c == (0,) * 9 for c in r["counts"]), (label, r["counts"])
            if cache:
                for c in r["counts"]:
                    launches[0] += c[7]
                    launches[1] += c[8]
            _report_step(label, r, card)
        verdict = _cache_gate(
            f"phase {phase} {name}", runs[True], runs[False],
            lambda: _step_run(kind, full_width(**fused, **flags), data, f"phase {phase}: rerun"))
        on, off = runs[True], runs[False]
        log(f"phase {phase}: {'V4' if kind == 'pcaa' else 'ORCED'} {name}, cache on vs off over "
            f"{CACHE_STEPS} steps: {verdict}; warm ms {on['warm_ms']:.2f} vs {off['warm_ms']:.2f} "
            f"(host clock), device {on['busy'][0]:.2f} vs {off['busy'][0]:.2f} ms, elementwise "
            f"{on['busy'][1].get('elementwise', 0.0):.2f} vs "
            f"{off['busy'][1].get('elementwise', 0.0):.2f} ms, peak "
            f"{on['peak_gb']:.3f} vs {off['peak_gb']:.3f} GB [{card}]")
    return dict(m16=launches[0], mv16=launches[1])


def deferred_steps(card: str, data: dict) -> None:
    """Phase 15d: V4 with DEFERRED_DECODER_UPDATE against the plain schedule
    from one seeded state, one epoch of CACHE_STEPS batches (the flush at
    its end): at f32 (FUSED_POINTNET on) losses and the whole state bitwise
    equal; at bf16 + nu16 + cache losses within rtol 0.05, atol 0.05, the
    correct counts within 2 and the Adam counts equal (JAX's bounds)."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
        VARIANTS,
        build_pcaa,
        make_epoch_fns,
    )

    perm = data["perm"][:CACHE_STEPS]
    noise = (data["z0"][:CACHE_STEPS], data["alphas"][:CACHE_STEPS])
    nu16 = dict(COMPUTE_DTYPE="bfloat16", BF16_ADAM_NU=True, BF16_WEIGHT_CACHE=True)
    for name, flags in (("f32", {}), ("bf16+nu16+cache", nu16)):
        out = {}
        for deferred in (False, True):
            cfg = full_width(FUSED_POINTNET=True, DEFERRED_DECODER_UPDATE=deferred, **flags)
            mods, state = build_pcaa(cfg, VARIANTS[VARIATION.V4], device="cuda")
            train_epoch, _ = make_epoch_fns(mods, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = train_epoch(state, data["x"], data["y"], perm, noise)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            out[deferred] = dict(
                metrics={k: v.cpu().numpy() for k, v in m.items()}, seconds=seconds,
                snapshot=_snapshot(mods, (state.opt_g, state.opt_d)))
            del mods, state, train_epoch
            gc.collect()
            torch.cuda.empty_cache()
        a, b = out[False], out[True]
        losses = [k for k in a["metrics"] if k != "n_correct"]
        gap = max(float(np.abs(a["metrics"][k] - b["metrics"][k]).max()) for k in losses)
        worst, differ = _state_diff(a["snapshot"], b["snapshot"])
        counts = [c for c, _, _ in a["snapshot"][1]], [c for c, _, _ in b["snapshot"][1]]
        if name == "f32":
            equal = gap == 0.0 and not differ and np.array_equal(a["metrics"]["n_correct"],
                                                                 b["metrics"]["n_correct"])
            assert equal, (gap, worst, differ[:8])
            verdict = "losses and every parameter, statistic and moment bitwise equal"
        else:
            for k in losses:
                np.testing.assert_allclose(b["metrics"][k], a["metrics"][k], rtol=0.05, atol=0.05,
                                           err_msg=k)
            np.testing.assert_allclose(b["metrics"]["n_correct"], a["metrics"]["n_correct"],
                                       atol=2.0)
            assert counts[0] == counts[1], counts
            verdict = (f"losses within {gap:.3e} (rtol 0.05, atol 0.05), Adam counts {counts[1]} "
                       f"equal, state {worst:.3e} apart")
        log(f"phase 15d: V4 {name} deferred vs plain schedule, {CACHE_STEPS} steps and the "
            f"flush: {verdict}; epoch {b['seconds']:.2f} s deferred, {a['seconds']:.2f} s plain "
            f"(host clock, first steps pay set-up) [{card}]")


def factored_steps(card: str, data: dict) -> None:
    """Phase 15e: V4 (FUSED_POINTNET on) and ORCED with FACTORED_ADAM_NU at
    f32 and at bf16: the factored update of the 9000 x 18000 decoder leaf
    after step 1 held to an f64 evaluation of the same formulas from the
    gradient the step handed Adam (r and c within rtol 1e-5; the weight's
    step within rtol 1e-5 of it plus the f32 rounding of the stored
    weight); the optimizer state's drop against full f32 nu; ms per step
    over CACHE_STEPS steps (host clock, synchronized)."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.train import orced as orced_mod
    from opensetgaitrecognition_pcaa_tpu_torch.train import pcaa as pcaa_mod

    leaf = "decoder.dense.4.weight"  # the (18000, 9000) decoder matrix
    for kind, name, flags in (("pcaa", "f32", {}), ("pcaa", "bf16", dict(COMPUTE_DTYPE="bfloat16")),
                              ("orced", "f32", {}), ("orced", "bf16", dict(COMPUTE_DTYPE="bfloat16"))):
        module = pcaa_mod if kind == "pcaa" else orced_mod
        fused = dict(FUSED_POINTNET=True) if kind == "pcaa" else {}
        cfg = full_width(FACTORED_ADAM_NU=True, **fused, **flags)
        b2 = cfg.B2 if kind == "pcaa" else cfg.B1  # ORCED's betas=(B1, B1)
        if kind == "pcaa":
            mods, state = pcaa_mod.build_pcaa(cfg, pcaa_mod.VARIANTS[VARIATION.V4], device="cuda")
            step = pcaa_mod.make_train_step(mods, cfg)
            opt, params = state.opt_g, dict(mods.g.named_parameters())

            def step_fn(i):
                return step(state, data["x"][data["perm"][i]], data["y"][data["perm"][i]], i,
                            (data["z0"][i], data["alphas"][i]))[1]
        else:
            mods, state = orced_mod.build_orced(cfg, device="cuda")
            step = orced_mod.make_orced_train_step(mods, cfg)
            opt, params = state.opt, dict(mods.named_parameters())

            def step_fn(i):
                return step(state, data["x"][data["perm"][i]], data["y"][data["perm"][i]], 0.5,
                            data["eps"][i])[1]
        assert isinstance(opt.nu[leaf], dict)
        full_nu = sum(p.numel() * 4 for p in params.values())
        kept_nu = sum(sum(t.numel() * t.element_size() for t in
                          (v.values() if isinstance(v, dict) else [v])) for v in opt.nu.values())
        n_factored = sum(isinstance(v, dict) for v in opt.nu.values())
        captured = {}
        update = module.adam_update_

        def capture(st, ps, grads, **kw):  # the gradient Adam is handed at step 1
            if st is opt and not captured:
                captured.update(g=grads[leaf].clone(), w0=ps[leaf].detach().clone())
            return update(st, ps, grads, **kw)

        module.adam_update_ = capture
        try:
            ms = []
            for i in range(CACHE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step_fn(i)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                assert all(np.isfinite(float(v)) for v in m.values()), m
                if i == 0:
                    w1 = params[leaf].detach().clone()
                    r1, c1_ = opt.nu[leaf]["r"].clone(), opt.nu[leaf]["c"].clone()
        finally:
            module.adam_update_ = update
        # the same formulas in f64 (train/optim.py; JAX scale_by_adam_factored), count 1
        g = captured["g"].double()
        sq = g * g + 1e-30
        r = (1 - b2) * sq.sum(dim=0)
        c = (1 - b2) * sq.sum(dim=1)
        bc1, bc2 = 1 - cfg.B1, 1 - b2
        vhat = (r[None, :] / (bc2 * r.sum())) * c[:, None]
        delta = -cfg.LR * (((1 - cfg.B1) * g / bc1) / (torch.sqrt(vhat) + 1e-8))
        got = w1.double() - captured["w0"].double()
        spacing = torch.abs(torch.nextafter(w1, torch.full_like(w1, float("inf"))) - w1).double()
        step_err = float(((got - delta).abs() - 1e-5 * delta.abs() - spacing).max())
        rc_err = max(float(((r1.double() - r).abs() / r.abs()).max()),
                     float(((c1_.double() - c).abs() / c.abs()).max()))
        assert rc_err <= 1e-5, (kind, name, rc_err)
        assert step_err <= 0.0, (kind, name, step_err)
        log(f"phase 15e: {'V4' if kind == 'pcaa' else 'ORCED'} {name} with FACTORED_ADAM_NU: "
            f"the (18000, 9000) leaf after step 1 against f64: r and c within {rc_err:.3e} "
            f"relative (rtol 1e-5), the weight's step within rtol 1e-5 plus the stored weight's "
            f"f32 spacing (worst margin {step_err:.3e}); {n_factored} leaves factored, second "
            f"moments {kept_nu / 1e6:.1f} MB against {full_nu / 1e6:.1f} MB of full f32 nu "
            f"({(full_nu - kept_nu) / 1e6:.1f} MB less); ms per step "
            f"{[round(t, 2) for t in ms]} (host clock) [{card}]")
        del mods, state, step, step_fn, opt, params, captured, g, sq, vhat, delta, got
        gc.collect()
        torch.cuda.empty_cache()


def _checkpoint_gap(dir_a: str, dir_b: str, name: str) -> tuple:
    """Two run folders' module files → (largest |difference|, the leaves
    that differ)."""
    from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import load_params

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix.rstrip("/"), np.asarray(tree)

    worst, differ = 0.0, []
    for tag in ("E", "D", "G", "GPH"):
        a = dict(leaves(load_params(os.path.join(dir_a, name, f"{name}_{tag}.msgpack"))))
        b = dict(leaves(load_params(os.path.join(dir_b, name, f"{name}_{tag}.msgpack"))))
        assert a.keys() == b.keys(), tag
        for k in a:
            if not np.array_equal(a[k], b[k]):
                differ.append(f"{tag}:{k}")
                worst = max(worst, float(np.abs(a[k].astype(np.float64) - b[k]).max()))
    return worst, differ


def cache_driver(card: str, raw: str) -> dict:
    """Phase 15f: ``run_pcaa_ablation --variants V4 --compute-dtype bfloat16
    --bf16-weight-cache --n-training-classes 6 --n-tests 1 --epochs 1``
    (kernels on) against the same call without the flag: the module files
    under the 15b gate → the Adam kernel's launches with the copy (m16)."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch import config as port_config
    from opensetgaitrecognition_pcaa_tpu_torch.config import Config
    from opensetgaitrecognition_pcaa_tpu_torch.scripts import run_pcaa_ablation as rpa

    base = "SMOKE_CACHE_"
    name = f"{base}V4.{N_SEEN}.1"
    gen = os.path.join(WORK, "gen_cache")
    rpa.default_config = lambda **kw: port_config.default_config(
        FUSED_POINTNET=True, FUSED_ADAM=True, **kw)

    def call(tag: str, flags: list) -> tuple:
        models = os.path.join(WORK, f"models_cache_{tag}")
        shutil.rmtree(models, ignore_errors=True)
        reset_train_counts()
        reset_bf16_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rpa.main(["--data-path", raw, "--gen-data-path", gen, "--models-path", models,
                      "--model-name-base", base, "--n-training-classes", str(N_SEEN),
                      "--n-tests", "1", "--variants", "V4", "--epochs", "1",
                      "--compute-dtype", "bfloat16", *flags])
        torch.cuda.synchronize()
        return models, time.perf_counter() - t0, bf16_counts() + copy_counts()

    try:
        off, s_off, c_off = call("off", [])
        on, s_on, c_on = call("on", ["--bf16-weight-cache"])
        worst, differ = _checkpoint_gap(on, off, name)
        if differ:
            again, _, _ = call("off2", [])
            base_worst, base_differ = _checkpoint_gap(again, off, name)
            assert worst <= base_worst, (worst, base_worst, differ[:8], base_differ[:8])
            verdict = (f"not bitwise: {len(differ)} leaves within {worst:.3e}, no wider than two "
                       f"calls without the flag ({base_worst:.3e}, {len(base_differ)} leaves)")
        else:
            verdict = "the module files' leaves bitwise equal"
    finally:
        rpa.default_config = port_config.default_config
    cfg = Config.load(os.path.join(on, name, "config.json"))
    assert cfg.BF16_WEIGHT_CACHE and cfg.COMPUTE_DTYPE == "bfloat16"
    # (bf16 layer, pool, Adam m16, mv16, with the copy m16, mv16)
    assert c_on[0] > 0 and c_on[2] == 0 and c_on[4] == c_off[2] > 0 and c_on[5] == 0, (c_on, c_off)
    log(f"phase 15f: run_pcaa_ablation --compute-dtype bfloat16 --bf16-weight-cache (kernels on) "
        f"vs without the flag: {verdict}; {s_on:.2f} s vs {s_off:.2f} s with the splits' write; "
        f"launches (bf16 layer, pool, Adam m16, mv16, with the copy m16, mv16) {c_on} vs {c_off} "
        f"[{card}]")
    return dict(m16=c_on[4], mv16=c_on[5])


def options_phase(card: str, gen: str, raw: str) -> tuple:
    """Phase 15: the Adam kernel's bf16 copy (15a), BF16_WEIGHT_CACHE on the
    V4 and ORCED steps (15b-c), DEFERRED_DECODER_UPDATE (15d),
    FACTORED_ADAM_NU (15e) and ``--bf16-weight-cache`` in the driver (15f),
    with cuDNN deterministic on both sides of every comparison → (15a's
    checks, the copy's launches on the main paths of 15b and 15f)."""
    t0 = time.perf_counter()
    checks = check_adam_copy(card)
    with cudnn_deterministic():
        data = _train_data(gen, CACHE_STEPS + 3)
        steps = cache_steps(card, data)
        deferred_steps(card, data)
        factored_steps(card, data)
        del data
        drv = cache_driver(card, raw)
    launches = {k: steps[k] + drv[k] for k in ("m16", "mv16")}
    log(f"phase 15: {time.perf_counter() - t0:.1f} s [{card}]")
    return checks, launches


def mesh_nccl() -> int:
    """``--mesh-nccl``: phase 14's runs on every card of the machine (4)
    with NCCL, rank r on ``cuda:r``: V4 at DP 4 and at DP 2 x MP 2 (the
    kernels on), OR-CED at DP 2 x MP 2, each held to the same steps on one
    rank as phase 14 holds its gloo ranks."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.infer.common import ieee_f32
    from opensetgaitrecognition_pcaa_tpu_torch.ops import _build
    from opensetgaitrecognition_pcaa_tpu_torch.parallel.mesh import launch

    card = card_name()
    n = torch.cuda.device_count()
    log(f"{card}; {n} cards")
    if n != 4:
        print(f"chip_smoke --mesh-nccl: needs 4 cards, found {n}", file=sys.stderr)
        return 1
    ieee_f32()
    _build.load_libraries(("pointnet_train", "adam"))
    shutil.rmtree(WORK, ignore_errors=True)
    write_crops(os.path.join(WORK, "gen"), np.random.default_rng(SEED + 2),
                (("train", range(N_SEEN), TRAIN_CROPS_PER_TRACK[0]),))
    data = _mesh_data()
    layouts = (("pcaa", 4, 1), ("pcaa", 2, 2), ("orced", 2, 2))
    cases = [(kind, _mesh_cfg(kind, dp, mp)) for kind, dp, mp in layouts]
    t0 = time.perf_counter()
    ranks = launch(_mesh_ranks, n, cases, data, backend="nccl", timeout=MESH_TIMEOUT)
    log(f"--mesh-nccl: {n} ranks on cuda:0-{n - 1}, backend 'nccl', "
        f"{time.perf_counter() - t0:.1f} s from the launch to rank 0's result")
    faults = []
    for i, (kind, dp, mp) in enumerate(layouts):
        faults += _report_mesh_case("--mesh-nccl", kind, dp, mp, [r[i] for r in ranks], card)
    assert not faults, faults
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
    return 0


GRID_CARD_RUNS = 4  # --grid-cards: runs in a chunk, one a card on a 4-card machine


def _cards_busy(trainer, n: int) -> tuple:
    """One warm epoch of ``trainer``, one on the host clock, then one
    traced by torch.profiler (retaken where a card that holds a run shows
    no kernel) → (host ms of an epoch, each card's kernel ms in the traced
    epoch, each card's busy share: its kernel ms over the host ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def epoch():
        trainer.run_epoch(0)
        for i in range(n):
            torch.cuda.synchronize(i)

    epoch()
    t0 = time.perf_counter()
    epoch()
    host_ms = 1e3 * (time.perf_counter() - t0)
    used = {d.index for d in trainer.run_devices}
    for _ in range(PROFILER_TRACES):
        traced = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traced.append(p.events())) as prof:
            for _ in range(2):
                epoch()
                prof.step()
        kernel_ms = [0.0] * n
        for e in traced[-1]:
            if e.device_type == DeviceType.CUDA:
                kernel_ms[e.device_index] += (e.time_range.end - e.time_range.start) / 1e3
        if all(kernel_ms[i] > 0 for i in used):
            break
    assert all(kernel_ms[i] > 0 for i in used), kernel_ms
    return host_ms, kernel_ms, [ms / host_ms for ms in kernel_ms]


def grid_cards() -> int:
    """``--grid-cards``: whether a grid chunk spread over the cards (the
    drivers' ``--grid`` on a machine of several, ``parallel/grid.py``)
    trains faster than the same runs on one card, or only holds more.
    GRID_CARD_RUNS V4 runs (f32, the training kernels on, seeds 0.., phase
    6's 144 train crops: 9 steps of B = 16 an epoch): one run alone on
    cuda:0 (a chunk of one; ``--grid-runs-per-device 1`` on one card
    trains GRID_CARD_RUNS such chunks in turn), the runs as one chunk on
    cuda:0, and as one chunk over every card (run r on cuda:r % n) → for
    each, the host seconds of a warm epoch, each card's busy share
    (torch.profiler's kernel time on that card over the host clock of an
    unprofiled epoch) and each card's peak memory."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
    from opensetgaitrecognition_pcaa_tpu_torch.infer.common import ieee_f32
    from opensetgaitrecognition_pcaa_tpu_torch.ops import _build
    from opensetgaitrecognition_pcaa_tpu_torch.parallel.grid import GridPCAATrainer

    card = card_name()
    n = torch.cuda.device_count()
    log(f"{card}; {n} cards")
    ieee_f32()
    _build.load_libraries(("pointnet_train", "adam"))
    shutil.rmtree(WORK, ignore_errors=True)
    gen = os.path.join(WORK, "gen")
    write_crops(gen, np.random.default_rng(SEED + 2),
                (("train", range(N_SEEN), TRAIN_CROPS_PER_TRACK[0]),))
    split = RadarCropDataset(SPLIT.TRAIN, gen).load_all()
    steps = len(split[0]) // TRAIN_B
    cards = [f"cuda:{i}" for i in range(n)]
    epochs = {}
    for label, runs, mesh in (("1 run on cuda:0", 1, None),
                              (f"{GRID_CARD_RUNS} runs on cuda:0", GRID_CARD_RUNS, None),
                              (f"{GRID_CARD_RUNS} runs over {n} cards", GRID_CARD_RUNS, cards)):
        cfgs = [full_width(FUSED_POINTNET=True, FUSED_ADAM=True).replace(SEED=i)
                for i in range(runs)]
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        t0 = time.perf_counter()
        trainer = GridPCAATrainer(cfgs, VARIATION.V4, [split] * runs, mesh=mesh, device="cuda:0")
        build_s = time.perf_counter() - t0
        host_ms, kernel_ms, busy = _cards_busy(trainer, n)
        peak = [torch.cuda.max_memory_allocated(d) / 1e9 for d in cards]
        epochs[label] = host_ms
        log(f"--grid-cards: {label}: a warm epoch of {steps} steps a run in {host_ms:.1f} ms "
            f"({host_ms / (runs * steps):.2f} ms a run-step); per card kernel ms "
            f"{[round(ms, 1) for ms in kernel_ms]}, busy share {[round(b, 3) for b in busy]}, "
            f"peak GB {[round(p, 2) for p in peak]}; built in {build_s:.1f} s [{card}]")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    one = epochs["1 run on cuda:0"]
    log(f"--grid-cards: {GRID_CARD_RUNS} runs an epoch: {GRID_CARD_RUNS} chunks of 1 on one "
        f"card {GRID_CARD_RUNS * one:.1f} ms, 1 chunk on one card "
        f"{epochs[f'{GRID_CARD_RUNS} runs on cuda:0']:.1f} ms, 1 chunk over {n} cards "
        f"{epochs[f'{GRID_CARD_RUNS} runs over {n} cards']:.1f} ms [{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
    return 0


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def chamfer_timing_only() -> int:
    """``--chamfer-timing``: build the Chamfer kernel of the tree this file
    lies in and time it as phase 7a does, one JSON line at the end. To
    compare two trees, copy this file into each and run both in one call."""
    from opensetgaitrecognition_pcaa_tpu_torch.ops import _build

    card = card_name()
    log(card)
    _build.load_libraries(("chamfer",))
    for line in _build.BUILD_LOGS.get("chamfer", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  nvcc chamfer: {line.strip()}")
    log(json.dumps({"chamfer_timing": time_chamfer(card), "card": card, "tree": REPO}))
    return 0


def pointnet_bf16_timing() -> int:
    """``--pointnet-bf16-timing``: build the train-mode PointNet kernels of
    the tree this file lies in and time the bf16 layer and pool as phase
    11a does, one JSON line at the end. To compare two trees, copy this file
    into each and run both in one call."""
    from opensetgaitrecognition_pcaa_tpu_torch.infer.common import ieee_f32
    from opensetgaitrecognition_pcaa_tpu_torch.ops import _build

    card = card_name()
    log(card)
    ieee_f32()
    _build.load_libraries(("pointnet_train",))
    for line in ptxas_report(_build.BUILD_LOGS.get("pointnet_train", ""), "bf16"):
        log(f"  nvcc pointnet_train: {line}")
    log(json.dumps({"pointnet_bf16_timing": time_bf16_pointnet(card), "card": card,
                    "tree": REPO}))
    return 0


def codec_timing() -> int:
    """``--codec-timing``: the run-folder codec of the tree this file lies
    in, on arrays of the full-width decoder's shapes: ``save_params`` and
    ``load_params`` of the G file (860 MB) and of parameters + two moments
    (2.6 GB, a resume file's arrays), host clock, the median of 3; one JSON
    line at the end. To compare two trees, copy this file into each and run
    both in one call."""
    from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import load_params, save_params

    card = card_name()
    log(card)
    size = 30 * 150 * 4
    widths = (64, size // 16, size // 8, size // 4, size // 2, size)
    decoder = {f"TorchDense_{i}": {"kernel": np.full((a, b), 0.5, np.float32),
                                   "bias": np.full((b,), 0.5, np.float32)}
               for i, (a, b) in enumerate(zip(widths, widths[1:]))}
    trees = {"G": {"params": decoder},
             "state": {"params": decoder, "mu": decoder, "nu": decoder}}
    path = os.path.join(WORK, "codec", "T.msgpack")
    out = {"card": card, "tree": REPO}
    for name, tree in trees.items():
        times = {"save": [], "load": []}
        for _ in range(3):
            t0 = time.perf_counter()
            save_params(tree, path)
            times["save"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            load_params(path)
            times["load"].append(time.perf_counter() - t0)
        out[name] = {"bytes": os.path.getsize(path),
                     **{k: sorted(v)[1] for k, v in times.items()}}
        os.remove(path)
    log(json.dumps({"codec_timing": out}))
    return 0


def infer_kernel_phase(card: str) -> tuple:
    """Phase 2: the eval PointNet kernel against its plain version at the
    main path's shapes and at shapes that cut its tiles, then both timed at
    (256, 30, 150), each device kernel of one such call from torch.profiler,
    and the kernel timed at the serving batch, 4 windows x 6 crops → (max
    |diff|, {"kernel", "plain", "serve_kernel": ms, "per_kernel": [[name,
    ms]]}, bounds)."""
    import torch
    from torch.autograd import DeviceType

    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_infer as pn

    g = torch.Generator().manual_seed(SEED)
    d = 1024

    def make_folded(c: int, d: int) -> dict:
        out = {}
        for i, (a, b) in enumerate([(c, d // 2), (d // 2, d // 2), (d // 2, d), (d, d)], start=1):
            out[f"w{i}"] = ((torch.rand(a, b, generator=g) * 2 - 1) / a**0.5).cuda()
            out[f"b{i}"] = ((torch.rand(b, generator=g) * 2 - 1) / a**0.5).cuda()
        return out

    folded = make_folded(4, d)
    max_err = 0.0
    # the main path's frames, then shapes that cut the kernel's tiles: 97
    # frames of N = 37 (4656 padded rows, not a multiple of 256), N = 1,
    # D = 512, and C = 5 (channels padded to 8); then the widths the JAX
    # wrapper takes beyond 512 and 1024: D = 32 and 64 (the JAX tests'
    # POINTNET_OUT_DIM), 200, 1536, and D = 30 with C = 3 and D = 201 with
    # C = 5, whose widths the wrapper pads to multiples of 4
    for shape, fw in (((16, 30, 150, 4), folded), ((1, 97, 37, 4), folded),
                      ((2, 3, 1, 4), folded), ((4, 9, 150, 4), make_folded(4, 512)),
                      ((2, 3, 37, 5), make_folded(5, d)), ((4, 12, 64, 4), make_folded(4, 32)),
                      ((4, 12, 64, 4), make_folded(4, 64)), ((2, 3, 37, 4), make_folded(4, 200)),
                      ((2, 3, 150, 4), make_folded(4, 1536)), ((2, 3, 37, 3), make_folded(3, 30)),
                      ((2, 3, 37, 5), make_folded(5, 201))):
        x = torch.randn(shape, generator=g).cuda()
        before = pn.pointnet_pool_infer.launches
        got = pn.pointnet_pool_infer(x, fw)
        torch.cuda.synchronize()
        assert pn.pointnet_pool_infer.launches == before + 1, shape
        want = pn.pointnet_pool_ref(x, fw)
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        log(f"phase 2: kernel vs plain at {shape}, D={fw['w4'].shape[1]}: max |diff| {err:.3e}")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    x = torch.randn((256, 30, 150, 4), generator=g).cuda()
    pn_ms = alternate(
        {"kernel": lambda: pn.pointnet_pool_infer(x, folded),
         "plain": lambda: pn.pointnet_pool_ref(x, folded)},
        ("plain", "kernel", "kernel", "plain"), reps=5,
    )
    # per point, a multiply-add for every weight of the 4 layers
    weights = sum(folded[f"w{i}"].numel() for i in range(1, 5))
    pn_bound = tensor_core_bound(2 * 256 * 30 * 150 * weights,
                                 nbytes(x, *folded.values()) + 256 * 30 * d * 4)
    log(f"phase 2: PointNet+pool at (256, 30, 150), D=1024: kernel {pn_ms['kernel']:.2f} ms, "
        f"plain {pn_ms['plain']:.2f} ms; bound f32 {pn_bound['bound_f32_ms']:.2f} ms "
        f"({100 * pn_bound['bound_f32_ms'] / pn_ms['kernel']:.1f}% of the kernel's time), 3xTF32 "
        f"{pn_bound['bound_3xtf32_ms']:.2f} ms "
        f"({100 * pn_bound['bound_3xtf32_ms'] / pn_ms['kernel']:.1f}%) [{card}]")
    # one (256, 30, 150) call under torch.profiler: each device kernel in order
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pn.pointnet_pool_infer(x, folded)
        torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    pn_ms["per_kernel"] = [[name[:90], (b - a) / 1e3] for a, b, name in kernels]
    for name, ms in pn_ms["per_kernel"]:
        log(f"phase 2: (256, 30, 150) device kernel {ms:.3f} ms  {name}")
    xs = x[:SERVE_BATCH].contiguous()
    pn_ms["serve_kernel"] = cuda_ms(lambda: pn.pointnet_pool_infer(xs, folded), 20)
    serve_bound = tensor_core_bound(2 * SERVE_BATCH * 30 * 150 * weights,
                                    nbytes(xs, *folded.values()) + SERVE_BATCH * 30 * d * 4)
    log(f"phase 2: PointNet+pool at the serving batch ({SERVE_BATCH}, 30, 150): kernel "
        f"{pn_ms['serve_kernel']:.3f} ms, 3xTF32 bound {serve_bound['bound_3xtf32_ms']:.3f} ms "
        f"({100 * serve_bound['bound_3xtf32_ms'] / pn_ms['serve_kernel']:.1f}%) [{card}]")
    return max_err, pn_ms, pn_bound


P4T_MIX = {"crops": 48, "classes": 6, "frames": [60, 100], "points": [40, 220]}
P4T_DIMS = {"NMAX": 150, "NSTEPS": 30, "CROP_STEP": 6}
P4T_CELL = "pcaa_v4_p4t.train_b16"


def p4t_phase(card: str) -> None:
    """Phase 16 (the module docstring); one JSON line of the kernels' rows."""
    import torch

    from benchmark import harness, traffic
    from benchmark.cells import train_pcaa_p4t as p4t_cell
    from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
    from opensetgaitrecognition_pcaa_tpu_torch.infer.common import ieee_f32
    from opensetgaitrecognition_pcaa_tpu_torch.models.p4t import P4TEncoder
    from opensetgaitrecognition_pcaa_tpu_torch.ops import _build
    from opensetgaitrecognition_pcaa_tpu_torch.ops import p4t_group as pg
    from opensetgaitrecognition_pcaa_tpu_torch.ops import p4t_linear as pl
    from opensetgaitrecognition_pcaa_tpu_torch.ops import p4t_tube as pt
    from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
        VARIANTS,
        build_pcaa,
        make_epoch_fns,
    )

    t_phase = time.perf_counter()
    ieee_f32()
    _build.load_libraries(("p4t_group", "p4t_tube", "p4t_linear"))
    linear_rows = p4t_linear_phase(card)
    for name in ("p4t_group", "p4t_tube"):
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  nvcc {name}: {line.strip()}")
    pg.furthest_point_sample.launches = pg.ball_query.launches = pt.tube_embed.launches = 0
    crops = torch.from_numpy(traffic.crops(P4T_MIX, P4T_DIMS, SEED)[0]).cuda()
    b, t_len, n, _ = 16, 30, 150, 4
    m, k, d = 75, 32, 1024
    fills = []
    for i in range(0, crops.shape[0], b):
        x = crops[i:i + b].contiguous()
        anchor = pg.furthest_point_sample(x[:, 0::2], m)
        assert torch.equal(anchor, pg.furthest_point_sample_ref(x[:, 0::2], m)), "fps"
        ball = pg.ball_query(x, anchor, 0.7, k)
        assert torch.equal(ball, pg.ball_query_ref(x, anchor, 0.7, k, 3, 2, 1)), "ball"
        a = torch.gather(x[:, 0::2, :, :3], 2, anchor[..., None].expand(-1, -1, -1, 3))
        nb = x[:, pg.neighbour_frames(t_len, 15, 3, 2, 1).reshape(-1).cuda()]
        nb = nb.reshape(b, 15, 1, 3, n, 4)
        inside = pg.sq_dist(nb, a[:, :, :, None, None, :]) < pg.radius_sq(0.7)
        fills.append(inside.sum(dim=-1).clamp(max=k).float())
    fill = torch.cat(fills)
    log(f"phase 16: fps and ball query bitwise to plain on {crops.shape[0]} crops; mean ball "
        f"fill {float(fill.mean()):.3f} of {k}, full {float((fill == k).float().mean()):.4f}, "
        f"empty {float((fill == 0).float().mean()):.4f} [{card}]")

    x = crops[:b].contiguous()
    anchor = pg.furthest_point_sample(x[:, 0::2], m)
    ball = pg.ball_query(x, anchor, 0.7, k)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    w_d = (torch.rand((d, 4), generator=gen, device="cuda") - 0.5).requires_grad_()
    w_f = (2 * torch.rand((d, 1), generator=gen, device="cuda") - 1).requires_grad_()
    w = torch.cat([w_d, w_f], 1).detach().contiguous()
    out = pt.tube_embed(x, anchor, ball, w_d, w_f)
    best, arg = pt.tube_forward_ref(x, anchor, ball, w, 3, 2, 1)
    assert torch.equal(out, best), "tube forward"
    g = torch.randn(out.shape, device="cuda", generator=gen)
    dw = torch.cat(torch.autograd.grad(out, (w_d, w_f), g, retain_graph=True), 1)
    dw_ref = pt.tube_backward_ref(x, anchor, ball, g, arg, 3, 2, 1)
    bwd_err = float((dw - dw_ref).abs().max() / dw_ref.abs().max())
    assert bwd_err < 1e-5, bwd_err
    log(f"phase 16: tube forward bitwise to plain; weight gradient within {bwd_err:.2e} of "
        f"plain (max |diff| over max |plain|) [{card}]")

    tokens, rows, frames = b * 15 * m, b * 15 * m * 3 * k, b * 15
    crop_bytes = 4 * b * t_len * n * 4
    idx_bytes = 8 * (tokens + rows)
    fns = {
        "p4t_fps": (lambda: pg.furthest_point_sample(x[:, 0::2], m),
                    lambda: pg.furthest_point_sample_ref(x[:, 0::2], m),
                    bound(frames * (m - 1) * n * 9, frames * (4 * n * 3 + 8 * m))),
        "p4t_ball_query": (lambda: pg.ball_query(x, anchor, 0.7, k),
                           lambda: pg.ball_query_ref(x, anchor, 0.7, k, 3, 2, 1),
                           bound(0, crop_bytes * 3 / 4 + 8 * tokens + 8 * rows)),
        "p4t_tube forward": (lambda: pt.tube_embed(x, anchor, ball, w_d.detach(), w_f.detach()),
                             lambda: pt.tube_forward_ref(x, anchor, ball, w, 3, 2, 1),
                             bound(2 * rows * 5 * d, crop_bytes + idx_bytes + 20 * d
                                   + 5 * tokens * d)),
        "p4t_tube backward": (lambda: torch.autograd.grad(out, (w_d, w_f), g, retain_graph=True),
                              lambda: pt.tube_backward_ref(x, anchor, ball, g, arg, 3, 2, 1),
                              bound(2 * tokens * 5 * d, crop_bytes + idx_bytes + 20 * d
                                    + 5 * tokens * d)),
    }
    rows_out = []
    for name, (kernel, plain, (bound_ms, bound_by)) in fns.items():
        ms = alternate({"plain": plain, "kernel": kernel}, ("plain", "kernel", "kernel", "plain"),
                       20)
        row = dict(kernel=name, ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bound_ms,
                   bound_by=bound_by, share=bound_ms / ms["kernel"])
        rows_out.append(row)
        log(f"phase 16: {name}: kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {100 * row['share']:.1f}% of it [{card}]")

    enc = P4TEncoder(6, generator=torch.Generator().manual_seed(SEED)).cuda()
    torch.cuda.reset_peak_memory_stats()

    def fwd_bwd():
        logits, fv = enc(x)
        torch.autograd.grad(logits.sum() + fv.sum(), list(enc.parameters()))

    step_ms = cuda_ms(fwd_bwd, 5)
    log(f"phase 16: the P4Transformer encoder at B 16 ({tokens} tokens), forward and backward: "
        f"{step_ms:.2f} ms, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"[{card}]")
    del enc

    # the launches of one training step of the cell's model on the main path
    cell = harness.load_context(P4T_CELL, SEED, "cuda")
    cfg = p4t_cell.config(cell)
    variant = dataclasses.replace(VARIANTS[VARIATION.V4], use_disc_head=True)
    mods, state = build_pcaa(cfg, variant, device="cuda", encoder=p4t_cell.spec(cell))
    train_epoch = make_epoch_fns(mods, cfg)[0]
    labels = torch.from_numpy(traffic.crops(P4T_MIX, P4T_DIMS, SEED)[1]).cuda()
    pg.furthest_point_sample.launches = pg.ball_query.launches = pt.tube_embed.launches = 0
    pl.p4t_linear.launches = 0
    state, _ = train_epoch(state, crops, labels, torch.arange(b)[None])
    torch.cuda.synchronize()
    launches = {"fps": pg.furthest_point_sample.launches, "ball": pg.ball_query.launches,
                "tube": pt.tube_embed.launches, "linear": pl.p4t_linear.launches}
    # the dense products: 4 a block, each 2 launches forward and 4 backward, 5 blocks
    assert launches == {"fps": 1, "ball": 1, "tube": 2, "linear": 120}, launches
    log(f"phase 16: one make_epoch_fns step of {P4T_CELL}'s model at B {b}: launches {launches} "
        f"(the tube's forward and backward; 5 blocks x 4 dense products x 6) [{card}]")
    del mods, state
    log(json.dumps({"p4t_kernels": rows_out, "p4t_linear": linear_rows,
                    "encoder_fwd_bwd_ms": step_ms, "mean_ball_fill": float(fill.mean()),
                    "launches": launches}))
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s [{card}]")


# the blocks' dense products at the cell's shapes: (in, out, bias) of to_qkv,
# to_out, ff1, ff2; 18,000 tokens a step (16 crops x 15 frames x 75 anchors)
# and one crop's 1,125, a ragged row count
P4T_LINEAR_SHAPES = ((1024, 3072, False), (1024, 1024, True), (1024, 2048, True),
                     (2048, 1024, True))
P4T_LINEAR_ROWS = (18_000, 1_125)


def p4t_linear_phase(card: str) -> list:
    """Phase 16a: the dense products of ``csrc/p4t_linear.cu`` at the cell's
    shapes against f64: each within ``ops/tf32x3.py::error_bound`` and its
    largest error within ``CUBLAS_ERROR_MULTIPLE`` times cuBLAS f32's on the
    same inputs, a limit that the same product in single-pass TF32 (cuBLAS
    with TF32 allowed, the control) must exceed; the bias gradient within
    the bound of its sequential sums; bitwise across two calls; then at
    18,000 rows each product timed cuBLAS, kernel, kernel, cuBLAS by CUDA
    events beside its 3xTF32 bound, with its launches and the device time of
    each of its kernels (torch.profiler); → the rows of the record."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType

    from opensetgaitrecognition_pcaa_tpu_torch.ops import _build
    from opensetgaitrecognition_pcaa_tpu_torch.ops import p4t_linear as pl
    from opensetgaitrecognition_pcaa_tpu_torch.ops.tf32x3 import error_bound

    def tf32(fn):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    _build.load_libraries(("p4t_linear",))
    for line in _build.BUILD_LOGS.get("p4t_linear", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  nvcc p4t_linear: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows_out = []
    for rows in P4T_LINEAR_ROWS:
        for in_, out, with_bias in P4T_LINEAR_SHAPES:
            x = torch.randn((rows, in_), generator=gen, device="cuda")
            w = (2 * torch.rand((out, in_), generator=gen, device="cuda") - 1) / in_ ** 0.5
            b = (2 * torch.rand((out,), generator=gen, device="cuda") - 1) / in_ ** 0.5 \
                if with_bias else None
            dy = torch.randn((rows, out), generator=gen, device="cuda") / out ** 0.5
            mine = {"forward": lambda: pl.forward_product(x, w, b),
                    "input_grad": lambda: pl.input_grad(dy, w),
                    "weight_grad": lambda: pl.weight_grad(dy, x, with_bias)}
            cublas = {"forward": lambda: F.linear(x, w, b),
                      "input_grad": lambda: torch.mm(dy, w),
                      "weight_grad": lambda: (torch.mm(dy.t(), x),
                                              dy.sum(0) if with_bias else None)}
            x64, w64, dy64 = x.double(), w.double(), dy.double()
            exact = {"forward": x64 @ w64.t() + (b.double() if with_bias else 0),
                     "input_grad": dy64 @ w64,
                     "weight_grad": (dy64.t() @ x64, dy64.sum(0) if with_bias else None)}
            # the operands of each product's bound, and the forward's bias add
            operands = {"forward": (x, w.t()), "input_grad": (dy, w), "weight_grad": (dy.t(), x)}
            slack = {"forward": 2.0 ** -24 * exact["forward"].abs(), "input_grad": 0,
                     "weight_grad": 0}
            for name in mine:
                got, again, plain, control = (mine[name](), mine[name](), cublas[name](),
                                              tf32(cublas[name]))
                got, again, plain, control, want = (
                    [t] if torch.is_tensor(t) else list(t)
                    for t in (got, again, plain, control, exact[name]))
                row = dict(rows=rows, in_=in_, out=out, product=name,
                           bitwise=all(a is None or torch.equal(a, c)
                                       for a, c in zip(got, again)))
                for tag, g, p, c, e in zip(("", "db_"), got, plain, control, want):
                    if g is None:
                        continue
                    row[tag + "err"] = float((g.double() - e).abs().max())
                    row[tag + "cublas_err"] = float((p.double() - e).abs().max())
                    row[tag + "scale"] = float(e.abs().max())
                    if not tag:
                        row["tf32_err"] = float((c.double() - e).abs().max())
                row["limit"] = pl.CUBLAS_ERROR_MULTIPLE[name] * row["cublas_err"]
                row["within_bound"] = bool(((got[0].double() - want[0]).abs()
                                            <= error_bound(*operands[name]) + slack[name]).all())
                if "db_err" in row:
                    # a thread's sums: 8 values a stage, the stages of its
                    # slice, 2 butterfly steps, then the slices in order
                    adds = 8 + -(-rows // pl.TILE_K) + 2 + pl.MAX_SPLITS
                    row["db_limit"] = float((adds * 2.0 ** -24 * dy64.abs().sum(0)).min())
                    row["db_within"] = bool(((got[1].double() - want[1]).abs()
                                             <= adds * 2.0 ** -24 * dy64.abs().sum(0)).all())
                log(f"phase 16a: {name} rows {rows} ({in_} -> {out}): max |err| "
                    f"{row['err']:.3e}, cuBLAS f32 {row['cublas_err']:.3e}, single-pass TF32 "
                    f"{row['tf32_err']:.3e}, limit {row['limit']:.3e} (|ref| up to "
                    f"{row['scale']:.3e}); within error_bound {row['within_bound']}"
                    + (f"; db {row['db_err']:.3e}, sum {row['db_cublas_err']:.3e}, within its "
                       f"bound {row['db_within']}" if "db_err" in row else "")
                    + f"; bitwise {row['bitwise']} [{card}]")
                assert row["bitwise"], row
                assert row["within_bound"], row
                assert row["err"] <= row["limit"] < row["tf32_err"], row
                assert row.get("db_within", True), row
                if rows == P4T_LINEAR_ROWS[0]:
                    flops = 2 * rows * in_ * out
                    moved = {"forward": rows * (in_ + out) + out * in_ + out,
                             "input_grad": rows * (in_ + out) + out * in_,
                             "weight_grad": rows * (in_ + out) + out * in_ + out}[name]
                    bound_ms, bound_by = bound(3 * flops, 4 * moved, TF32_FLOPS)
                    ms = alternate({"cublas": cublas[name], "kernel": mine[name]},
                                   ("cublas", "kernel", "kernel", "cublas"), 10)
                    pl.p4t_linear.launches = 0
                    with torch.profiler.profile(
                            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                        mine[name]()
                        torch.cuda.synchronize()
                    per_kernel = {}
                    for e in prof.events():
                        if e.device_type == DeviceType.CUDA:
                            key = e.name.split("<")[-1][:48] if "gemm_kernel" in e.name \
                                else e.name[:48]
                            per_kernel[key] = per_kernel.get(key, 0.0) + (
                                e.time_range.end - e.time_range.start) / 1e3
                    row.update(ms=ms["kernel"], cublas_ms=ms["cublas"], bound_3xtf32_ms=bound_ms,
                               bound_by=bound_by, share=bound_ms / ms["kernel"],
                               launches=pl.p4t_linear.launches, per_kernel_ms=per_kernel)
                    log(f"phase 16a: {name} ({in_} -> {out}) at {rows} rows: kernel "
                        f"{ms['kernel']:.4f} ms, cuBLAS f32 {ms['cublas']:.4f} ms, 3xTF32 bound "
                        f"{bound_ms:.4f} ms ({bound_by}), {100 * row['share']:.1f}% of it; "
                        f"{row['launches']} launches {per_kernel} [{card}]")
                rows_out.append(row)
            del x, w, b, dy, x64, w64, dy64, exact, slack
    timed = [r for r in rows_out if "ms" in r]
    for name in ("forward", "input_grad", "weight_grad"):
        mine = [r for r in timed if r["product"] == name]
        log(f"phase 16a: {name}, the 4 shapes a block: kernel {sum(r['ms'] for r in mine):.4f} "
            f"ms, cuBLAS f32 {sum(r['cublas_ms'] for r in mine):.4f} ms, 3xTF32 bound "
            f"{sum(r['bound_3xtf32_ms'] for r in mine):.4f} ms [{card}]")
    return rows_out


def pointnet_infer_timing() -> int:
    """``--pointnet-infer-timing``: build the eval PointNet kernel of the
    tree this file lies in and run phase 2 (checks and timings), then phase
    4's in-process serving call at its batch of 4 windows x 6 crops on a
    seeded full-width encoder (host clock around each request, which ends
    in the decisions' copy to the host: the median of 25 after 5 warm-up
    requests); one JSON line at the end. To compare two trees, copy this
    file into each and run both in one call."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.infer.common import ieee_f32
    from opensetgaitrecognition_pcaa_tpu_torch.infer.serving import make_pcaa_decision_fn
    from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGEncoder
    from opensetgaitrecognition_pcaa_tpu_torch.ops import _build

    card = card_name()
    log(card)
    ieee_f32()
    _build.load_libraries(("pointnet_infer",))
    for line in _build.BUILD_LOGS.get("pointnet_infer", "").splitlines():
        if "registers" in line or "spill" in line or "wgmma" in line.lower():
            log(f"  nvcc pointnet_infer: {line.strip()}")
    max_err, pn_ms, pn_bound = infer_kernel_phase(card)
    encoder = CGEncoder(N_SEEN, in_features=4, sup_latent_dim=32, pointnet_out_dim=1024,
                        dtc_filters=(16, 32, 64, 128, 256, 512), use_projection_head=True,
                        generator=torch.Generator().manual_seed(SEED)).cuda().eval()
    decide = make_pcaa_decision_fn(encoder, N_SEEN, 6)
    rng = np.random.default_rng(SEED)
    means = rng.normal(size=(N_SEEN, 32))
    windows = torch.from_numpy(rng.normal(size=(4, 6, 30, 150, 4)).astype(np.float32)).cuda()
    serve_ms = []
    for i in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decisions, _ = decide(means, 0.0, windows)
        decisions.cpu()
        if i >= 5:
            serve_ms.append(1e3 * (time.perf_counter() - t0))
    log(f"phase 4: in-process serving, (4, 6, 30, 150, 4) a request: median "
        f"{float(np.median(serve_ms)):.3f} ms of 25 [{card}]")
    log(json.dumps({"pointnet_infer_timing": {
        "max_abs_err": max_err, **pn_ms, "bound_3xtf32_ms": pn_bound["bound_3xtf32_ms"],
        "serve_request_ms": float(np.median(serve_ms)), "serve_request_ms_all": serve_ms},
        "card": card, "tree": REPO}))
    return 0


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    if sys.argv[1:] == ["--chamfer-timing"]:
        return chamfer_timing_only()
    if sys.argv[1:] == ["--codec-timing"]:
        return codec_timing()
    if sys.argv[1:] == ["--pointnet-bf16-timing"]:
        return pointnet_bf16_timing()
    if sys.argv[1:] == ["--pointnet-infer-timing"]:
        return pointnet_infer_timing()
    if sys.argv[1:] == ["--precision-gate"]:
        return precision_gate()
    if sys.argv[1:] == ["--p4t"]:
        p4t_phase(card_name())
        return 0
    if sys.argv[1:] == ["--mesh-nccl"]:
        return mesh_nccl()
    if sys.argv[1:] == ["--grid-cards"]:
        return grid_cards()
    if sys.argv[1:2] == ["--serve-artifacts"]:
        return serve_artifacts(sys.argv[2])
    from opensetgaitrecognition_pcaa_tpu_torch.config import SPLIT, VARIATION, Config
    from opensetgaitrecognition_pcaa_tpu_torch.data.dataset import RadarCropDataset
    from opensetgaitrecognition_pcaa_tpu_torch.infer.common import ieee_f32
    from opensetgaitrecognition_pcaa_tpu_torch.infer.fast_encoder import fused_encoder_apply
    from opensetgaitrecognition_pcaa_tpu_torch.infer.pcaa import (
        _encode_split,
        _window_vote,
        pcaa_inference,
        pcaa_inference_setup,
    )
    from opensetgaitrecognition_pcaa_tpu_torch.infer.serving import make_pcaa_decision_fn
    from opensetgaitrecognition_pcaa_tpu_torch.ops import _build
    from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_infer as pn

    # --- 1. card, precision, build ------------------------------------------
    t_phase = time.perf_counter()
    card = card_name()

    def phase_done(n: int) -> None:
        """Log phase ``n``'s seconds (phases 9-14 log their own)."""
        nonlocal t_phase
        log(f"phase {n}: {time.perf_counter() - t_phase:.1f} s [{card}]")
        t_phase = time.perf_counter()

    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    ieee_f32()
    t0 = time.perf_counter()
    sources = ("pointnet_infer", "pointnet_train", "adam", "chamfer")
    _build.load_libraries(sources)
    log(f"phase 1: built csrc/{{{','.join(sources)}}}.cu in {time.perf_counter() - t0:.1f} s")
    for name in sources:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  nvcc {name}: {line.strip()}")

    phase_done(1)

    # --- 2. kernel vs plain --------------------------------------------------
    max_err, pn_ms, pn_bound = infer_kernel_phase(card)

    phase_done(2)

    # --- 3. the slice ----------------------------------------------------------
    shutil.rmtree(WORK, ignore_errors=True)
    gen = os.path.join(WORK, "gen")
    write_crops(gen, np.random.default_rng(SEED))
    cfg = Config(
        NMAX=150, NSTEPS=30, NFEATURES=4, POINTNET_OUT_DIM=1024,
        DTC_FILTERS=(16, 32, 64, 128, 256, 512), SUP_LATENT_DIM=32,
        TRAIN_CLASSES=tuple(range(N_SEEN)), MODEL_NAME=NAME, GEN_DATA_PATH=gen,
    )
    test_x, _ = RadarCropDataset(SPLIT.TEST, gen, sequential=True).load_all()
    n_crops = len(test_x) + len(RadarCropDataset(SPLIT.UNSEEN, gen).filenames)
    src = os.path.join(WORK, "models_src")
    make_run_folder(src, cfg, test_x)
    runs = {}
    for path in ("kernel", "plain"):
        models = os.path.join(WORK, f"models_{path}")
        shutil.copytree(os.path.join(src, NAME), os.path.join(models, NAME))
        pn.pointnet_pool_infer.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = pcaa_inference(
            [NAME], ks=KS, models_path=models, figures_path=os.path.join(WORK, "figures"),
            generate_dataset=False, dump_calibration=True, device="cuda",
            use_kernel=path == "kernel",
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = pn.pointnet_pool_infer.launches
        run_dir = os.path.join(models, NAME)
        for k in KS:
            for stem in (f"naive_seq_log_{k}.json", f"final_preds_{k}.npy",
                         f"final_labels_{k}.npy"):
                assert os.path.exists(os.path.join(run_dir, stem)), stem
            preds = np.load(os.path.join(run_dir, f"final_preds_{k}.npy"))
            assert len(preds) > 0 and preds.min() >= 0 and preds.max() <= cfg.n_classes
        assert os.path.exists(os.path.join(run_dir, "naive_seq_log_subsampled0.json"))
        cal = dict(np.load(os.path.join(run_dir, "calibration.npz")))
        for key in ("log_threshold", "test_ll", "unseen_ll"):
            assert not np.isnan(cal[key]).any(), key
        runs[path] = dict(dir=run_dir, cal=cal, launches=launches)
        log(f"phase 3: pcaa_inference via {path}: {n_crops} crops, ks={list(KS)}, "
            f"{seconds:.2f} s, kernel launches {launches}, "
            f"f1_micro {[round(logs[NAME][k]['f1_micro'], 4) for k in KS]} [{card}]")
    main_launches = runs["kernel"]["launches"]
    assert main_launches > 0, "the main path never launched the kernel"
    assert runs["plain"]["launches"] == 0
    exempt = compare_decisions(
        runs["kernel"]["cal"], runs["plain"]["cal"], runs["kernel"]["dir"], runs["plain"]["dir"]
    )
    log(f"phase 3: decisions equal; {exempt} windows (over ks) hold a crop within "
        f"{KNIFE_EDGE} of the threshold and are exempt")
    _, encoder, means = pcaa_inference_setup(
        NAME, VARIATION.V4, device="cuda", models_path=os.path.join(WORK, "models_kernel"),
        generate_dataset=False,
    )
    lat_err = 0.0
    for split in (SPLIT.TEST, SPLIT.UNSEEN):
        ds = RadarCropDataset(split, gen, sequential=True)
        fv_k, pred_k = _encode_split(encoder, ds, "cuda", use_kernel=True)
        fv_p, pred_p = _encode_split(encoder, ds, "cuda", use_kernel=False)
        assert np.isfinite(fv_k).all() and fv_k.shape == (len(ds), cfg.SUP_LATENT_DIM)
        lat_err = max(lat_err, float(np.abs(fv_k - fv_p).max()))
        np.testing.assert_allclose(fv_k, fv_p, rtol=0, atol=1e-4)
    log(f"phase 3: latents kernel vs plain: max |diff| {lat_err:.3e} (atol 1e-4); "
        f"latent std across crops {float(fv_k.std(axis=0).mean()):.3e}")

    phase_done(3)

    # --- 4. serve ----------------------------------------------------------------
    cal = runs["kernel"]["cal"]
    k = 6
    thr = float(cal["log_threshold"])
    ds = RadarCropDataset(SPLIT.TEST, gen, sequential=True)
    x_all, labels = ds.load_all()
    starts = window_starts(labels, k)
    assert len(starts) >= 12, len(starts)
    decide = make_pcaa_decision_fn(encoder, int(cal["n_labels"]), k)
    edge_test, _ = knife_edge(cal)
    serve_ms, exempt = [], 0
    pn.pointnet_pool_infer.launches = 0
    for r in range(3):
        req = starts[4 * r:4 * r + 4]
        idx = np.concatenate([np.arange(s, s + k) for s in req])
        windows = torch.from_numpy(x_all[idx].reshape((4, k) + x_all.shape[1:])).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decisions, n_above = decide(means, thr, windows)
        decisions = decisions.cpu().numpy()
        serve_ms.append(1e3 * (time.perf_counter() - t0))
        want, _ = _window_vote(
            cal["test_ll"][idx], cal["test_preds"][idx], labels[idx], k, thr,
            int(cal["n_labels"]),
        )
        edge = np.array([edge_test[s:s + k].any() for s in req])
        assert decisions.shape == (4,)
        assert ((decisions == np.array(want)) | edge).all(), (decisions, want)
        exempt += int(edge.sum())
    serve_launches = pn.pointnet_pool_infer.launches
    assert serve_launches == 3, serve_launches
    main_launches += serve_launches
    log(f"phase 4: served 3 requests of (4, {k}, 30, 150, 4); decisions equal to "
        f"_window_vote ({exempt} knife-edge windows exempt); kernel launches "
        f"{serve_launches}; ms per request {[round(t, 2) for t in serve_ms]} [{card}]")

    phase_done(4)

    # --- 5. encoder throughput ---------------------------------------------------
    xb = torch.from_numpy(np.resize(x_all, (256,) + x_all.shape[1:])).cuda()
    enc_ms = alternate(
        {"kernel": lambda: fused_encoder_apply(encoder, xb, use_kernel=True),
         "plain": lambda: fused_encoder_apply(encoder, xb, use_kernel=False)},
        ("plain", "kernel", "kernel", "plain"), reps=3,
    )
    wps = {p: 256 / (ms / 1e3) for p, ms in enc_ms.items()}
    log(f"phase 5: encoder at batch 256: {wps['kernel']:.1f} windows/s via kernel, "
        f"{wps['plain']:.1f} windows/s via plain [{card}]")
    del xb, encoder
    gc.collect()
    torch.cuda.empty_cache()

    phase_done(5)

    # --- 6. training -------------------------------------------------------------
    write_crops(gen, np.random.default_rng(SEED + 2), (
        ("train", range(N_SEEN), TRAIN_CROPS_PER_TRACK[0]),
        ("valid", range(N_SEEN), TRAIN_CROPS_PER_TRACK[1]),
    ))
    checks = check_train_kernels(card)
    train_launches = train_phase(card, gen)
    main_launches += train_launches["infer"]

    phase_done(6)

    # --- 7. OR-CED inference and serving -----------------------------------------
    checks["chamfer"] = check_chamfer_kernel(card)
    orced_launches = orced_phase(card, gen)
    main_launches += orced_launches["pointnet"]

    phase_done(7)

    # --- 8. OR-CED from raw tracks: splits, training, scoring ------------------------
    orced_train_launches = orced_training_phase(card)
    main_launches += orced_train_launches["pointnet"]
    orced_launches["chamfer"] += orced_train_launches["chamfer"]

    phase_done(8)

    # --- 9. the PCAA ablation: every variant's step, the driver, the resume ------------
    ablation_launches = ablation_phase(card, gen)
    main_launches += ablation_launches["infer"]
    for k in ("layer", "pool", "adam"):
        train_launches[k] += ablation_launches[k]

    # --- 10. the serving artifacts, the remaining drivers ------------------------------
    serving_launches = serving_driver_phase(card, serve_ms)
    main_launches += serving_launches["infer"]
    orced_launches["chamfer"] += serving_launches["chamfer"]
    for k in ("layer", "pool", "adam"):
        train_launches[k] += serving_launches[k]

    # --- 11. bf16 training: the bf16 kernels, the steps, the driver ------------------
    bf16_checks, bf16_launches, bf16_infer = bf16_phase(card, gen)
    main_launches += bf16_infer

    # --- 12. the drivers' --grid mode ---------------------------------------------------
    grid_launches = grid_phase(card)
    for k in ("layer", "pool", "adam"):
        train_launches[k] += grid_launches[k]

    # --- 13. the reference run-folder export and import, inference on the imports ---------
    ref_launches = reference_phase(card, gen)
    main_launches += ref_launches["pointnet"]
    orced_launches["chamfer"] += ref_launches["chamfer"]

    # --- 14. data and tensor parallelism: one run over 2 ranks --------------------------
    mesh_launches, mesh_err = mesh_phase(card)
    for k in ("layer", "pool", "adam"):
        train_launches[k] += mesh_launches[k]
    # max_abs_err: the kernels at phase 14's shapes too
    for c, k in ((checks["layer"], "layer"), (checks["adam"], "adam"),
                 (bf16_checks["layer"], "layer_bf16")):
        c["err"] = max(c["err"], mesh_err[k])

    # --- 15. the weight cache, the deferred decoder write, factored Adam ----------------
    copy_checks, copy_launches = options_phase(card, gen, os.path.join(WORK, "raw"))

    # --- 16. the P4Transformer kernels ------------------------------------------------------
    p4t_phase(card)

    checks["infer"] = dict(err=max_err, ms=pn_ms["kernel"], plain_ms=pn_ms["plain"],
                           library_ms=None, **pn_bound)
    src = "opensetgaitrecognition_pcaa_tpu_torch/csrc/"
    tpu = "opensetgaitrecognition_pcaa_tpu/ops/pallas/"
    kernels = [
        ("pointnet_pool_infer", "pointnet_infer.cu", "pointnet_infer.py:58", main_launches,
         checks["infer"]),
        ("pointnet_pool_train/_layer_kernel", "pointnet_train.cu", "pointnet_train.py:61",
         train_launches["layer"], checks["layer"]),
        ("pointnet_pool_train/_pool_kernel", "pointnet_train.cu", "pointnet_train.py:154",
         train_launches["pool"], checks["pool"]),
        ("fused_adam_tree_update/_adam_block_kernel", "adam.cu", "adam_kernel.py:60",
         train_launches["adam"], checks["adam"]),
        ("seq_chamfer_pallas/_chamfer_frame_kernel", "chamfer.cu", "chamfer_kernel.py:35",
         orced_launches["chamfer"], checks["chamfer"]),
        ("pointnet_pool_train/_layer_kernel (bf16)", "pointnet_train.cu", "pointnet_train.py:61",
         bf16_launches["layer"], bf16_checks["layer"]),
        ("pointnet_pool_train/_pool_kernel (bf16 input)", "pointnet_train.cu",
         "pointnet_train.py:154", bf16_launches["pool"], bf16_checks["pool"]),
        ("fused_adam_tree_update/_adam_block_kernel (m bf16)", "adam.cu", "adam_kernel.py:60",
         bf16_launches["adam_m16"], bf16_checks["adam_m16"]),
        ("fused_adam_tree_update/_adam_block_kernel (m, v bf16)", "adam.cu", "adam_kernel.py:60",
         bf16_launches["adam_mv16"], bf16_checks["adam_mv16"]),
        ("fused_adam_tree_update/_adam_block_kernel (v bf16)", "adam.cu", "adam_kernel.py:60",
         grid_launches["adam_v16"], bf16_checks["adam_v16"]),
        ("fused_adam_tree_update/_adam_block_kernel (m bf16) + bf16 copy of w", "adam.cu",
         "adam_kernel.py:60", copy_launches["m16"], copy_checks["m16"]),
        ("fused_adam_tree_update/_adam_block_kernel (m, v bf16) + bf16 copy of w", "adam.cu",
         "adam_kernel.py:60", copy_launches["mv16"], copy_checks["mv16"]),
    ]
    for name, _, _, launches, _ in kernels:
        assert launches > 0, f"the main path never launched {name}"
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src + source, "replaces": tpu + replaces,
         "launches": launches, "max_abs_err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
         "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": c["library_ms"],
         "bound_route": c["bound_route"]}
        for name, source, replaces, launches, c in kernels
    ]}
    log(f"chip_smoke: phases 1-16 in {time.perf_counter() - t_start:.1f} s [{card}]")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
