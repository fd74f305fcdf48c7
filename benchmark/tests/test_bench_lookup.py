"""The lookups by name through which a configuration enters as new files:
kernel parts (``benchmark/kernels/<part>.json``), model weights
(``benchmark/reference/<model>.py``) and FLOP counts
(``benchmark/flops/<family>.py``). The existing ones give what the
literal tables gave; a name with no file raises an error that names the
file it looked for."""

import importlib.util
import os
import re

import pytest

from benchmark import flops, harness, tracing
from benchmark.reference import params
from benchmark.tests.conftest import TINY

PUBLISHED = harness.load_context("pcaa_v4.train_b16", 1, "cpu").dims


def test_kernel_parts_are_the_literal_table():
    assert tracing.PORT_KERNELS == {
        "pointnet_train": ("tf32x3", "stats_kernel", "pool_kernel", "wgmma_bf16", "pool_bf16"),
        "pointnet_infer": ("tf32x3", "group_mean_kernel"),
        "adam": ("adam_kernel",),
        "chamfer": ("chamfer_kernel", "chamfer_any_kernel"),
    }


@pytest.mark.parametrize("model", ["pcaa_v4", "orced", "pcaa_v4_encoder"])
@pytest.mark.parametrize("dims", [PUBLISHED, {**PUBLISHED, **TINY}], ids=["published", "tiny"])
def test_leaves_by_name_are_the_models(model, dims):
    assert params.leaves(model, dims, 6) == params.MODELS[model](dims, 6)


def test_an_unknown_part_names_its_file():
    path = os.path.join(tracing.KERNELS, "no_such_part.json")
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        tracing.short_of([], {"no_such_part": 0}, {"no_such_part": 0})
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        tracing.is_port_kernel("adam_kernel", "no_such_part")


def test_an_unknown_model_names_both_places():
    here = os.path.dirname(params.__file__)
    with pytest.raises(FileNotFoundError) as err:
        params.leaves("no_such_model", PUBLISHED, 6)
    assert params.__file__ in str(err.value) and "MODELS" in str(err.value)
    assert os.path.join(here, "no_such_model.py") in str(err.value)


def test_an_unknown_family_names_its_file():
    path = os.path.join(flops.HERE, "no_such_family.py")
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        flops.family("no_such_family")
    for name, count in (("train_mfu", lambda m: m.step_flops(PUBLISHED, 16, "no_such_family", 6)),
                        ("eval_mfu", lambda m: m.crop_flops(PUBLISHED, 6, "no_such_family"))):
        spec = importlib.util.spec_from_file_location(
            "m_" + name, os.path.join(harness.HERE, "metrics", name + ".py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        with pytest.raises(FileNotFoundError, match=re.escape(path)):
            count(module)
