"""The traffic generator: seeded synthetic radar crops from a mix's
parameters (``traffic/<mix>.json``).

A frozen copy of the synthetic mmGait-like track model and the crop
preprocessing (the program's ``data/synthetic.py`` and
``data/preprocess.py``), kept here so that the yardstick does not move when
the program does: each subject (class) walks with its own stride, speed,
height, sway, Doppler and power; every frame holds 40-220 points of
(x, y, z, Doppler), padded by repeating random points or subsampled to
NMAX, centred, and cut into ``NSTEPS``-frame crops every ``CROP_STEP``
frames. Everything is drawn from the seed; nothing is written to disk.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_SCENARIOS = ({"sway_mult": 1.0, "arm": 1.0}, {"sway_mult": 0.6, "arm": 0.2},
              {"sway_mult": 0.8, "arm": 0.5})


def _signature(rng: np.random.Generator) -> Dict[str, float]:
    return {
        "stride_freq": rng.uniform(0.7, 1.6),
        "speed": rng.uniform(0.8, 1.8),
        "height": rng.uniform(1.4, 1.95),
        "sway": rng.uniform(0.05, 0.30),
        "doppler_amp": rng.uniform(0.5, 2.5),
        "spread": rng.uniform(0.15, 0.45),
        "power_base": rng.uniform(1.0, 8.0),
    }


def track(sig: Dict[str, float], tweaks: Dict[str, float], n_frames: int, nmax: int,
          points: Tuple[int, int], rng: np.random.Generator,
          frame_rate: float = 10.0) -> np.ndarray:
    """One walking track → ``(n_frames, nmax, 4)`` f32 frames of (x, y, z,
    Doppler), each padded with repeated random points or subsampled to
    ``nmax`` and centred."""
    out = np.empty((n_frames, nmax, 4), np.float32)
    phase, direction = rng.uniform(0, 2 * np.pi), rng.uniform(0, 2 * np.pi)
    pos = rng.uniform(-3, 3, size=2)
    step = sig["speed"] / frame_rate * np.array([np.cos(direction), np.sin(direction)])
    for t in range(n_frames):
        gait = np.sin(2 * np.pi * sig["stride_freq"] * t / frame_rate + phase)
        pos = pos + step
        sway = sig["sway"] * tweaks["sway_mult"] * gait
        n = int(rng.integers(*points))
        theta = rng.uniform(0, 2 * np.pi, n)
        radial = rng.normal(0, sig["spread"], n)
        z = rng.uniform(0.1, sig["height"], n)
        limb = np.where(z < 0.6 * sig["height"], 1.0, 0.3 * tweaks["arm"])
        doppler = sig["speed"] + sig["doppler_amp"] * gait * limb + rng.normal(0, 0.15, n)
        feats = np.stack([pos[0] + radial * np.cos(theta) + sway, pos[1] + radial * np.sin(theta),
                          z, doppler], axis=1)
        if n < nmax:
            cloud = np.concatenate([feats, feats[rng.choice(n, nmax - n)]], axis=0)
        else:
            cloud = feats[rng.choice(n, nmax, replace=False)]
        out[t] = cloud - cloud.mean(axis=0)
    return out


def crops_of(frames: np.ndarray, nsteps: int, step: int) -> np.ndarray:
    """Windows of ``nsteps`` frames every ``step`` frames (the reference's
    exclusive-end count: a track of exactly ``nsteps`` frames gives none)."""
    starts = np.arange(len(frames) - nsteps, step=step)
    return frames[starts[:, None] + np.arange(nsteps)[None, :]]


def tracks_by_class(mix: Dict, dims: Dict, seed: int, per_class: int) -> List[List[np.ndarray]]:
    """For each of ``mix["classes"]`` subjects, tracks (each an array of its
    crops) until the subject has at least ``per_class`` crops."""
    master = np.random.default_rng([seed, 0])
    out = []
    for subject in range(mix["classes"]):
        sig = _signature(np.random.default_rng([seed, 1, subject]))
        tracks, have = [], 0
        while have < per_class:
            rng = np.random.default_rng([seed, 2, subject, len(tracks)])
            frames = track(sig, _SCENARIOS[len(tracks) % 3], int(master.integers(*mix["frames"])),
                           dims["NMAX"], tuple(mix["points"]), rng)
            crops = crops_of(frames, dims["NSTEPS"], dims["CROP_STEP"])
            if len(crops):
                tracks.append(crops)
                have += len(crops)
        out.append(tracks)
    return out


def crops(mix: Dict, dims: Dict, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """``mix["crops"]`` labelled crops ``(n, NSTEPS, NMAX, 4)`` f32 and
    ``(n,)`` int64 labels, the classes as even as the count allows, in a
    seeded order."""
    n, k = mix["crops"], mix["classes"]
    by_class = tracks_by_class(mix, dims, seed, -(-n // k))
    x = [np.concatenate(t)[: n // k + (c < n % k)] for c, t in enumerate(by_class)]
    y = np.concatenate([np.full(len(a), c, np.int64) for c, a in enumerate(x)])
    order = np.random.default_rng([seed, 3]).permutation(n)
    return np.concatenate(x)[order], y[order]

