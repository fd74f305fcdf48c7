#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Drives the port's main paths, V4 open-set inference and in-process serving,
V4 training, and OR-CED open-set inference and serving, at the full width
of the published models (NMAX=150, NSTEPS=30, C=4, PointNet width 1024,
TCN filters 16..512, latent 32; decoder S = 18000, 215.2M parameters),
with seeded random weights and seeded crop files. Phases:

1. the card's name and power limit; TF32 off; the CUDA kernels' nvcc
   builds, all sources at once;
2. the PointNet kernel against its plain PyTorch version at the main
   path's shapes and at shapes that cut its tiles (97 frames of N = 37,
   N = 1, D = 512, C = 5; rtol 1e-4, atol 1e-4), and both timed at
   (256, 30, 150);
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
      and an f64 oracle (rtol 1e-3) at (64, 30, 150, 150) and at ragged,
      five-channel, one-point, two-tile and N = M = 704 shapes; timed
      against plain and torch.cdist at (64, 30, 150, 4);
   b. a run folder (E, G, ML) from seeded inits, saved by the port;
   c. ``orced_inference`` through the kernels, then plain, with the same
      pinned eps at batch 64: latents within atol 1e-4, rec errors within
      rtol 1e-3, decisions equal except knife-edge crops;
   d. ``make_orced_forward_fn`` + ``orced_decide_host`` answer 3 requests
      of 16 test crops, with the decisions of ``orced_apply_ood``.

It exits non-zero, with no result line, when there is no CUDA card or a
phase fails. The line before the last is the per-kernel JSON record (its
``launches`` counts each kernel's launches on the main paths, each path
driven with the counts at 0: phases 3, 4, 6c, 7c and 7d for the PointNet
inference kernel, 6b's kernel steps and 6c for the training kernels, 7c
and 7d for the Chamfer kernel; ``bound_ms`` is the larger of the
operations over 67 TFLOP/s and the bytes over 3.35 TB/s, the H100 SXM's
published f32 and HBM3 peaks, except for the two PointNet layer kernels,
which run three TF32 tensor-core passes per operation: for them both that
f32 bound and the 3xTF32 bound (3 x operations over 495 TFLOP/s) are
printed and the lower goes into ``bound_ms``, ``bound_route`` naming it;
the layer kernel's times and bound are per launch, the mean of a step's
four layers), the last ``{"ok": true, "device": {...}}``.
Files go to ``build/chip_smoke/``.
"""

import gc
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
# Chamfer kernel vs plain: the kernel rounds each distance as the plain
# pairwise_sq_dists does, so only the order of the sums differs; measured
# gap 2.8e-7 relative (see PERF.md), held at 35 times that. The f64 oracle
# is held at the JAX package's Chamfer parity bound, rtol 1e-3: two f32
# paths of xx + yy - 2xy cancel apart by up to about 2e-4 relative.
CHAMFER_TOL = dict(rtol=1e-5, atol=1e-6)
RE_EDGE = 1e-3  # rec error within this relative distance of its threshold
P_EDGE = 1e-6  # latent score within this distance of 0.95
# Published peaks of the H100 SXM (NVIDIA data sheet, 700 W): f32 outside
# the tensor cores, dense TF32 on the tensor cores and HBM3 bandwidth;
# bound_ms is the larger of the operations over a peak and the bytes over
# the bandwidth
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


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
    knife-edge crop in either run; return the number of such windows."""
    for key in ("test_labels", "unseen_labels", "is_val"):
        np.testing.assert_array_equal(cal_a[key], cal_b[key])
    edge_test, edge_unseen = (a | b for a, b in zip(knife_edge(cal_a), knife_edge(cal_b)))
    exempt_total = 0
    for k in KS:
        edge = [edge_test[s:s + k].any() for s in window_starts(cal_a["test_labels"], k)]
        edge += [
            edge_unseen[s:s + k].any()
            for s in window_starts(cal_a["unseen_labels"], k, ~cal_a["is_val"])
        ]
        edge = np.array(edge, bool)
        for stem in ("final_preds", "final_labels"):
            a = np.load(os.path.join(dir_a, f"{stem}_{k}.npy"))
            b = np.load(os.path.join(dir_b, f"{stem}_{k}.npy"))
            assert a.shape == b.shape == edge.shape, (stem, k, a.shape, b.shape, edge.shape)
            bad = (a != b) & ~edge
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
    for n, c_in, c_out, timed in ((rows, 4, 512, True), (rows, 512, 512, True),
                                  (rows, 512, 1024, True), (rows, 1024, 1024, True),
                                  (2 * 3 * 37, 4, 512, False), (2 * 3 * 37, 512, 1024, False),
                                  (2 * 3 * 1, 4, 512, False), (2 * 3 * 1, 512, 1024, False)):
        h = randn(n, c_in, scale=2.0, shift=0.5)
        a = None if c_in == 4 else affine(c_in)
        w = randn(c_in, c_out, scale=c_in ** -0.5)
        b = randn(c_out, scale=0.1)
        got = pt.fused_layer(h, a, w, b)
        torch.cuda.synchronize()
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


def check_chamfer_kernel(card: str) -> dict:
    """Phase 7a: the Chamfer kernel against its plain version and an f64
    oracle at the main path's shape, ragged shapes, five channels, one
    point, two tiles of points and N = M = 704; timed against plain and torch.cdist at the main
    path's shape. → dict(err, ms, plain_ms, bound_ms, bound_by,
    library_ms)."""
    import torch

    from opensetgaitrecognition_pcaa_tpu_torch.ops import chamfer_kernel as ck
    from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer import frame_chamfer, seq_chamfer

    g = torch.Generator(device="cuda").manual_seed(SEED)
    err = rel = 0.0
    for b, t, n, m, c in ((ORCED_B, 30, 150, 150, 4), (3, 5, 37, 53, 4), (3, 5, 37, 53, 5),
                          (2, 3, 1, 1, 4), (2, 3, 1, 9, 4), (1, 2, 1500, 2100, 4),
                          (4, 6, 704, 704, 4)):
        preds, gts = chamfer_inputs(g, b, t, n, m, c)
        got = ck.frame_chamfer_kernel(preds, gts)
        torch.cuda.synchronize()
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

    def cdist():  # the yardstick: one library call for the distances
        d = torch.cdist(gts, preds) ** 2
        return d.amin(2).sum(2) + d.amin(3).sum(2)

    torch.testing.assert_close(cdist(), frame_chamfer(preds, gts), rtol=1e-3, atol=1e-3)
    ms = alternate({"kernel": lambda: ck.seq_chamfer_kernel(preds, gts, avg_out=False),
                    "plain": lambda: seq_chamfer(preds, gts, avg_out=False),
                    "library": cdist},
                   ("plain", "kernel", "library", "library", "kernel", "plain"), reps=20)
    f, n, c = ORCED_B * 30, 150, 4
    # per pair: the dot (2C), |x|^2 + |y|^2 - 2 x.y (2) and the two minima (2)
    bms, by = bound(f * n * n * (2 * c + 4), nbytes(preds, gts) + f * 4)
    log(f"phase 7a: Chamfer at ({ORCED_B}, 30, 150, 4): kernel {ms['kernel']:.4f} ms, plain "
        f"{ms['plain']:.4f} ms, cdist + amin {ms['library']:.4f} ms; bound {bms:.4f} ms "
        f"({by}); max relative gap to plain {rel:.3e} (bound rtol 1e-5, atol 1e-6) [{card}]")
    return dict(err=err, ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=bms, bound_by=by,
                bound_route="f32", library_ms=ms["library"])


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
    rng = np.random.default_rng(SEED + 6)
    eps = {key: rng.normal(size=(len(RadarCropDataset(split, gen)), cfg.SUP_LATENT_DIM))
           .astype(np.float32)
           for key, split in (("train", SPLIT.TRAIN), ("test", SPLIT.TEST),
                              ("unseen", SPLIT.UNSEEN))}

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
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

    # --- 2. kernel vs plain --------------------------------------------------
    g = torch.Generator().manual_seed(SEED)
    d, h = 1024, 512

    def make_folded(c: int, d: int) -> dict:
        out = {}
        for i, (a, b) in enumerate([(c, d // 2), (d // 2, d // 2), (d // 2, d), (d, d)], start=1):
            out[f"w{i}"] = ((torch.rand(a, b, generator=g) * 2 - 1) / a**0.5).cuda()
            out[f"b{i}"] = ((torch.rand(b, generator=g) * 2 - 1) / a**0.5).cuda()
        return out

    folded = make_folded(4, d)
    max_err = 0.0
    # the main path's frames, then shapes that cut the kernel's tiles: 97
    # frames of N = 37 (4656 padded rows, not a multiple of 128), N = 1,
    # D = 512, and C = 5 (channels padded to 8)
    for shape, fw in (((16, 30, 150, 4), folded), ((1, 97, 37, 4), folded),
                      ((2, 3, 1, 4), folded), ((4, 9, 150, 4), make_folded(4, 512)),
                      ((2, 3, 37, 5), make_folded(5, d))):
        x = torch.randn(shape, generator=g).cuda()
        got = pn.pointnet_pool_infer(x, fw)
        torch.cuda.synchronize()
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
    del x

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

    # --- 6. training -------------------------------------------------------------
    write_crops(gen, np.random.default_rng(SEED + 2), (
        ("train", range(N_SEEN), TRAIN_CROPS_PER_TRACK[0]),
        ("valid", range(N_SEEN), TRAIN_CROPS_PER_TRACK[1]),
    ))
    checks = check_train_kernels(card)
    train_launches = train_phase(card, gen)
    main_launches += train_launches["infer"]

    # --- 7. OR-CED inference and serving -----------------------------------------
    checks["chamfer"] = check_chamfer_kernel(card)
    orced_launches = orced_phase(card, gen)
    main_launches += orced_launches["pointnet"]

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
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
