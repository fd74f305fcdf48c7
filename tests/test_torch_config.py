"""The port's own ``Config`` against the JAX package's: the same fields
write the same ``config.json``, byte for byte, and each package loads the
other's file."""

import dataclasses

import pytest

from opensetgaitrecognition_pcaa_tpu import config as jax_config

from opensetgaitrecognition_pcaa_tpu_torch import config

FIELDS = {
    "defaults": {},
    "run": dict(MODEL_NAME="RUN_V4", TRAIN_CLASSES=(0, 2, 5), DTC_FILTERS=(8, 8, 16),
                TRAIN_SCENARIOS=("smartphone",), SUBSAMPLE_FACTOR=0.5, Openness=0.125,
                FUSED_POINTNET=True, FUSED_ADAM=True, GEN_DATA_PATH="gen", LR=3e-4),
}


def test_fields_and_defaults_are_the_jax_package_s():
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(jax_config.Config)]
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(config.Config)]
    assert got == want
    assert config.N_SUBJECTS == jax_config.N_SUBJECTS
    for enum in ("SPLIT", "SCENARIO", "VARIATION"):
        assert ([(e.name, e.value) for e in getattr(config, enum)]
                == [(e.name, e.value) for e in getattr(jax_config, enum)])
    assert [s.value for s in config.ALL_SCENARIOS] == [s.value for s in jax_config.ALL_SCENARIOS]


@pytest.mark.parametrize("case", list(FIELDS), ids=list(FIELDS))
def test_config_json_is_byte_equal_and_loads_across(case, tmp_path):
    fields = FIELDS[case]
    ours, theirs = str(tmp_path / "port" / "config.json"), str(tmp_path / "jax" / "config.json")
    cfg = config.Config(**fields)
    jcfg = jax_config.Config(**fields)
    cfg.save(ours)
    jcfg.save(theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert config.Config.load(theirs) == cfg
    assert jax_config.Config.load(ours) == jcfg
    assert cfg.scenarios == tuple(config.SCENARIO(s) for s in cfg.TRAIN_SCENARIOS)
    assert cfg.run_dir() == jcfg.run_dir() and cfg.n_classes == jcfg.n_classes


@pytest.mark.parametrize("name", ["RUN_V4", "x.V1.3", "orced.3.1", "v4"])
def test_variation_from_model_name(name):
    assert (config.variation_from_model_name(name).value
            == jax_config.variation_from_model_name(name).value)
