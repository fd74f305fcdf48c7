"""Synthetic mmGait-like raw dataset generator.

Port of ``opensetgaitrecognition_pcaa_tpu/data/synthetic.py:28-134``,
numpy, pickle and hashlib: the same seed writes the same tracks. The real
mmGait10 recordings are not distributed with the repository, so this writes
raw tracks in the frame-dict schema the preprocessing reads
(``cardinality``, ``elements``, ``z_coord``, ``dopplers``, ``powers``), laid
out as ``<data_path>/target{subject}/<scenario>/pc_tr{track}.pkl``. Each
subject has its own gait signature (stride frequency, torso height, sway,
Doppler modulation) with per-scenario changes, so that a classifier can
tell subjects apart.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Sequence

import numpy as np

from opensetgaitrecognition_pcaa_tpu_torch.config import ALL_SCENARIOS, SCENARIO


def _subject_signature(rng: np.random.Generator) -> dict:
    return {
        "stride_freq": rng.uniform(0.7, 1.6),  # Hz of gait cycle
        "speed": rng.uniform(0.8, 1.8),  # m/s walking speed
        "height": rng.uniform(1.4, 1.95),  # torso z extent
        "sway": rng.uniform(0.05, 0.30),  # lateral sway amplitude
        "doppler_amp": rng.uniform(0.5, 2.5),
        "spread": rng.uniform(0.15, 0.45),  # body point scatter
        "power_base": rng.uniform(1.0, 8.0),
    }


_SCENARIO_TWEAKS = {
    SCENARIO.FREE_WALK.value: dict(sway_mult=1.0, arm=1.0),
    SCENARIO.HANDS_IN_POCKETS.value: dict(sway_mult=0.6, arm=0.2),
    SCENARIO.SMARTPHONE.value: dict(sway_mult=0.8, arm=0.5),
}


def make_track_frames(
    sig: dict,
    scenario: str,
    n_frames: int,
    rng: np.random.Generator,
    frame_rate: float = 10.0,
    min_points: int = 40,
    max_points: int = 220,
) -> list:
    """One walking track: a list of ragged frame dicts."""
    tweaks = _SCENARIO_TWEAKS[scenario]
    frames = []
    phase = rng.uniform(0, 2 * np.pi)
    direction = rng.uniform(0, 2 * np.pi)
    pos = rng.uniform(-3, 3, size=2)
    for t in range(n_frames):
        tt = t / frame_rate
        gait = np.sin(2 * np.pi * sig["stride_freq"] * tt + phase)
        pos = pos + sig["speed"] / frame_rate * np.array(
            [np.cos(direction), np.sin(direction)]
        )
        sway = sig["sway"] * tweaks["sway_mult"] * gait

        n_pts = int(rng.integers(min_points, max_points))
        # body scatter: torso cylinder + limb lobes modulated by gait phase
        theta = rng.uniform(0, 2 * np.pi, n_pts)
        radial = rng.normal(0, sig["spread"], n_pts)
        xy = np.stack(
            [
                pos[0] + radial * np.cos(theta) + sway,
                pos[1] + radial * np.sin(theta),
            ],
            axis=1,
        )
        z = rng.uniform(0.1, sig["height"], n_pts)
        # limbs swing → doppler spread keyed to gait phase and height
        limb_factor = np.where(z < 0.6 * sig["height"], 1.0, 0.3 * tweaks["arm"])
        doppler = (
            sig["speed"]
            + sig["doppler_amp"] * gait * limb_factor
            + rng.normal(0, 0.15, n_pts)
        )
        power = sig["power_base"] * np.exp(rng.normal(0, 0.5, n_pts))

        frames.append(
            {
                "cardinality": np.array([n_pts]),
                "elements": xy.astype(np.float64),
                "z_coord": z.astype(np.float64),
                "dopplers": doppler.astype(np.float64),
                "powers": power.astype(np.float64),
            }
        )
    return frames


def generate_synthetic_raw_dataset(
    data_path: str,
    n_subjects: int = 10,
    tracks_per_scenario: int = 4,
    frames_per_track: tuple = (60, 100),
    scenarios: Sequence[SCENARIO] = ALL_SCENARIOS,
    seed: int = 1234,
) -> None:
    """Write pickled raw tracks under ``data_path`` (idempotent per seed)."""
    master = np.random.default_rng(seed)
    for subj in range(n_subjects):
        sig = _subject_signature(np.random.default_rng(seed + 1000 + subj))
        for scenario in scenarios:
            scen_dir = os.path.join(data_path, f"target{subj}", scenario.value)
            os.makedirs(scen_dir, exist_ok=True)
            for track in range(tracks_per_scenario):
                # a process-stable scenario hash: Python's builtin hash()
                # of a str changes from process to process (PYTHONHASHSEED)
                scen_h = int.from_bytes(
                    hashlib.md5(scenario.value.encode()).digest()[:4], "little"
                )
                rng = np.random.default_rng(
                    seed + subj * 10_000 + scen_h % 997 + track
                )
                n_frames = int(master.integers(*frames_per_track))
                frames = make_track_frames(sig, scenario.value, n_frames, rng)
                with open(os.path.join(scen_dir, f"pc_tr{track}.pkl"), "wb") as f:
                    pickle.dump(frames, f)
