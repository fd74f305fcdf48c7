"""Run configuration: enums and the immutable run config.

The port's own copy of ``opensetgaitrecognition_pcaa_tpu/config.py``,
standard library only. The field names, defaults and the JSON layout of
``config.json`` are the JAX package's, so a run folder written by either
package loads in the other (``tests/test_torch_config.py`` holds the two
files byte for byte). Enums are the port's own: a JAX ``SCENARIO`` is not
a port ``SCENARIO``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from enum import Enum
from typing import Optional, Tuple


class SPLIT(Enum):
    """Dataset split names."""

    TRAIN = "train"
    VALID = "valid"
    TEST = "test"
    UNSEEN = "unseen"


class SCENARIO(Enum):
    """Walking scenarios of mmGait10."""

    FREE_WALK = "free_walk"
    HANDS_IN_POCKETS = "hands_in_pockets"
    SMARTPHONE = "smartphone"


class VARIATION(Enum):
    """PCAA ablation variants; V4 is the published PCAA."""

    BASE = "BASE"
    V1 = "V1"
    V2 = "V2"
    V3 = "V3"
    V4 = "V4"


ALL_SCENARIOS: Tuple[SCENARIO, ...] = (
    SCENARIO.FREE_WALK,
    SCENARIO.HANDS_IN_POCKETS,
    SCENARIO.SMARTPHONE,
)

# Number of subjects in mmGait10.
N_SUBJECTS = 10


@dataclasses.dataclass(frozen=True)
class Config:
    """Immutable hyperparameter set for one training/eval run; the JAX
    package's fields, in its order (see its ``config.py`` for each
    framework-only knob). The port runs them all, ``FACTORED_ADAM_NU``,
    ``DEFERRED_DECODER_UPDATE`` and ``BF16_WEIGHT_CACHE`` included, and
    refuses the combinations the JAX package refuses."""

    # shapes
    NMAX: int = 150
    NSTEPS: int = 30
    CROP_STEP: int = 6
    NFEATURES: int = 4

    # network widths
    POINTNET_OUT_DIM: int = 1024
    DTC_FILTERS: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    SUP_LATENT_DIM: int = 32
    DEC_MLP_SIZE: int = 30 * 150 * 4

    # optimizer
    LR: float = 1e-4
    B1: float = 0.9
    B2: float = 0.99

    # run set-up
    TRAIN_CLASSES: Tuple[int, ...] = ()
    TRAIN_SCENARIOS: Tuple[str, ...] = tuple(s.value for s in ALL_SCENARIOS)
    BATCH_SIZE: int = 16
    SUBSAMPLE_FACTOR: float = 1.0
    EPOCHS: int = 50
    CHECKPOINT_FREQUENCY: int = 5
    GP_WEIGHT: float = 15.0
    ADV_WEIGHT: float = 1.0
    SUPERVISION_FREQUENCY: int = 1
    MODEL_NAME: str = ""
    NOTES: str = ""

    # ORCED loss weights
    TRIPLET_W: float = 1.0
    CE_W: float = 1.0
    REC_W: float = 1.0
    KL_W: float = 1.0
    TRIPLET_MARGIN: float = 0.5

    # written by the grid drivers
    Openness: Optional[float] = None

    # framework-only knobs
    COMPUTE_DTYPE: str = "float32"
    FUSED_POINTNET: bool = False  # the train-mode PointNet kernel
    BF16_ADAM_NU: bool = False
    FUSED_ADAM: bool = False  # the Adam kernel on the large decoder leaves
    FACTORED_ADAM_NU: bool = False
    DEFERRED_DECODER_UPDATE: bool = False
    BF16_WEIGHT_CACHE: bool = False
    SAVE_RESUME_STATE: bool = False
    SEED: int = 0
    DATA_PATH: str = os.path.join("data", "raw_tracks")
    GEN_DATA_PATH: str = os.path.join("data", "generated_dataset")
    MODELS_PATH: str = "models"
    FIGURES_PATH: str = "figures"
    DP_DEVICES: int = 1
    MP_DEVICES: int = 1
    MP_MIN_DIM: int = 128

    @property
    def n_classes(self) -> int:
        return len(self.TRAIN_CLASSES)

    @property
    def decoder_mlp_size(self) -> int:
        """The decoder's output size, which tracks NMAX."""
        return self.NSTEPS * self.NFEATURES * self.NMAX

    @property
    def scenarios(self) -> Tuple[SCENARIO, ...]:
        return tuple(SCENARIO(s) for s in self.TRAIN_SCENARIOS)

    def run_dir(self) -> str:
        return os.path.join(self.MODELS_PATH, self.MODEL_NAME)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for key in ("DTC_FILTERS", "TRAIN_CLASSES", "TRAIN_SCENARIOS"):
            d[key] = list(d[key])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        for key in ("DTC_FILTERS", "TRAIN_CLASSES"):
            if key in kw:
                kw[key] = tuple(kw[key])
        if "TRAIN_SCENARIOS" in kw:
            kw["TRAIN_SCENARIOS"] = tuple(
                s.value if isinstance(s, SCENARIO) else str(s) for s in kw["TRAIN_SCENARIOS"]
            )
        return cls(**kw)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def default_config(**overrides) -> Config:
    """The reference defaults with ``overrides`` applied (the drivers' base
    configuration)."""
    return Config().replace(**overrides)


def variation_from_model_name(model_name: str) -> VARIATION:
    """The ablation variant from a run name: the two characters before the
    first '.' select V1..V4, anything else is BASE."""
    tag = model_name.split(".")[0][-2:]
    try:
        return VARIATION(tag)
    except ValueError:
        return VARIATION.BASE
