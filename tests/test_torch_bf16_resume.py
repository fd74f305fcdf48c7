"""The resume state of a bf16 run, on the CPU.

``COMPUTE_DTYPE="bfloat16"`` with ``BF16_ADAM_NU``: an interrupted run of
``train_pcaa`` (V1: the mean learner's running statistics ride in the
state) and of ``train_orced`` equals a straight run bit for bit (per-epoch
metrics, module files and the final resume state, as
``tests/test_torch_resume.py`` holds the f32 runs), with both Adam moment
trees stored as bf16 in ``train_state.msgpack`` in flax's layout and read
back as bf16. A bf16 run's state is refused by an f32 run of the same
name (its moments' dtypes differ) rather than cast.
"""

import os

import pytest
import torch

from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION
from opensetgaitrecognition_pcaa_tpu_torch.train.run_folder import load_train_state
from tests.test_torch_resume import _cfg, _folder, _train, arrays, one_torch_thread  # noqa: F401

BF16 = dict(COMPUTE_DTYPE="bfloat16", BF16_ADAM_NU=True, SAVE_RESUME_STATE=True)


@pytest.mark.parametrize("kind,variation", [("pcaa", VARIATION.V1), ("orced", None)],
                         ids=["pcaa_V1", "orced"])
def test_interrupted_bf16_run_equals_straight_run(tmp_path, arrays, kind, variation):  # noqa: F811
    name = "BF16_" + (variation.value if variation else "ORCED")
    straight = _cfg(tmp_path / "straight", name, EPOCHS=2, **BF16)
    _train(kind, straight, variation, arrays)
    resumed = _cfg(tmp_path / "resumed", name, EPOCHS=1, **BF16)
    _train(kind, resumed, variation, arrays)
    tree, next_epoch, _ = load_train_state(os.path.join(resumed.run_dir(), "train_state.msgpack"))
    assert next_epoch == 1
    opts = ("opt_g", "opt_d") if kind == "pcaa" else ("opt",)
    for opt in opts:
        for moment in ("mu", "nu"):
            leaves = tree[opt][moment].values()
            assert leaves and all(isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
                                  for v in leaves), (opt, moment)
    _train(kind, resumed.replace(EPOCHS=2), variation, arrays)
    want, got = _folder(straight.run_dir()), _folder(resumed.run_dir())
    assert [r["_step"] for r in got[0]] == [0, 1]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2].keys() == want[2].keys()
    for f in want[2]:
        assert got[2][f] == want[2][f], f


def test_bf16_state_is_refused_by_an_f32_run(tmp_path, arrays):  # noqa: F811
    cfg = _cfg(tmp_path, "MIX_V4", EPOCHS=1, **BF16)
    _train("pcaa", cfg, VARIATION.V4, arrays)
    f32 = cfg.replace(EPOCHS=2, COMPUTE_DTYPE="float32", BF16_ADAM_NU=False)
    with pytest.raises(ValueError, match="saved torch.bfloat16, run torch.float32"):
        _train("pcaa", f32, VARIATION.V4, arrays)
