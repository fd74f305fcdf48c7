"""Run-folder files between the two packages, and the parameter maps.

The port reads and writes ``<NAME>_E.msgpack`` with its own msgpack codec;
every check here is bit-exact in values, dtypes and keys.
"""

import jax
import numpy as np
import pytest

from opensetgaitrecognition_pcaa_tpu.models import CGEncoder as FlaxCGEncoder
from opensetgaitrecognition_pcaa_tpu.train import run_folder as jax_run_folder

from opensetgaitrecognition_pcaa_tpu_torch.convert import (
    encoder_state_dict,
    encoder_variables,
)
from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGEncoder
from opensetgaitrecognition_pcaa_tpu_torch.train import run_folder

from tests.test_torch_models import SMALL, flax_encoder_vars


def _assert_trees_identical(got, want):
    assert isinstance(got, dict) and isinstance(want, dict)
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_identical(got[key], want[key])
        else:
            g, w = np.asarray(got[key]), np.asarray(want[key])
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module", params=[False, True], ids=["nohead", "head"])
def enc_vars(request):
    x = np.random.default_rng(0).normal(size=(2, 4, 6, 4)).astype(np.float32)
    enc = FlaxCGEncoder(n_out_labels=3, use_projection_head=request.param, **SMALL)
    tree = flax_encoder_vars(enc, x)
    # leaves of several dtypes and a numpy scalar, as flax trees may hold
    tree["extra"] = {
        "steps": np.arange(5, dtype=np.int64),
        "half": np.linspace(0, 1, 7).astype(np.float16),
        "scalar": np.float32(0.25),
    }
    return tree


def test_jax_save_port_load(enc_vars, tmp_path):
    path = str(tmp_path / "run" / "RUN_E.msgpack")
    jax_run_folder.save_params(enc_vars, path)
    _assert_trees_identical(run_folder.load_params(path), jax.device_get(enc_vars))


def test_port_save_jax_load(enc_vars, tmp_path):
    ours = str(tmp_path / "port" / "RUN_E.msgpack")
    theirs = str(tmp_path / "jax" / "RUN_E.msgpack")
    run_folder.save_params(enc_vars, ours)
    jax_run_folder.save_params(enc_vars, theirs)
    _assert_trees_identical(jax_run_folder.load_params(ours), enc_vars)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_convert_round_trip(enc_vars):
    tree = {k: enc_vars[k] for k in ("params", "batch_stats")}
    sd = encoder_state_dict(tree)
    enc = CGEncoder(3, in_features=4, use_projection_head="MLP_head" in tree["params"], **SMALL)
    enc.load_state_dict(sd)  # strict: every key of the port's module is mapped
    _assert_trees_identical(encoder_variables(enc.state_dict()), tree)


def test_large_and_byte_swapped_arrays_write_the_flax_bytes(tmp_path):
    """Arrays whose payloads take the 16- and 32-bit length forms, a
    big-endian array and an empty one: the port's chunked write gives the
    bytes of the JAX package's ``save_params``, and its read gives writable
    arrays with the values."""
    rng = np.random.default_rng(3)
    tree = {"a": {"big": rng.normal(size=(300, 300)).astype(np.float32),
                  "mid": rng.normal(size=2000).astype(np.float32),
                  "swapped": np.arange(6, dtype=">i4"),
                  "empty": np.zeros((0, 3), np.float32)},
            "b": np.float64(1.5)}
    path, theirs = str(tmp_path / "T.msgpack"), str(tmp_path / "jax" / "T.msgpack")
    run_folder.save_params(tree, path)
    jax_run_folder.save_params(tree, theirs)
    with open(path, "rb") as a, open(theirs, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert data == run_folder.packb(run_folder._sorted_tree(tree))
    got = run_folder.load_params(path)
    _assert_trees_identical(got, jax_run_folder.load_params(theirs))
    assert got["a"]["big"].flags.writeable
