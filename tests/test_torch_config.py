"""The port's config (``yolofastest_torch.configs``) equals the JAX
package's, field by field, for every preset.  The first port module that
runs, so it starts the pool of JAX references (``tests/_jax_refs.py``) and
the multi-process checks of later modules (``tests/_background.py``),
though it reads nothing from them."""

import dataclasses

import pytest

from tests._background import (dryrun_two_ranks, finetune_sets,  # noqa: F401 (fixtures)
                               mlir_programs, port_exports, recipe_outputs,
                               spatial_processes, two_rank_processes)
from tests._jax_refs import jax_refs  # noqa: F401 (a fixture)
from yolofastest_torch.configs import config as tcfg
from yolofastest_tpu.configs import config as jcfg

pytestmark = pytest.mark.usefixtures("jax_refs", "dryrun_two_ranks", "spatial_processes",
                                     "two_rank_processes", "port_exports", "mlir_programs",
                                     "recipe_outputs", "finetune_sets")

PRESETS = ["256x320", "512x640", "lite-256x320", "lite-512x640"]


@pytest.mark.parametrize("name", PRESETS)
def test_preset_fields_equal(name):
    ours, theirs = tcfg.get_config(name), jcfg.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.io.input_hw == theirs.io.input_hw
    assert ours.io.head_hw == theirs.io.head_hw
    assert ours.io.num_out == theirs.io.num_out
    assert ours.to_json() == theirs.to_json()


@pytest.mark.parametrize("name", PRESETS)
def test_json_round_trip(name):
    cfg = tcfg.get_config(name, conf_thre=0.4, max_det=32)
    back = tcfg.Config.from_json(cfg.to_json())
    assert back == cfg
    assert dataclasses.asdict(back) == dataclasses.asdict(
        jcfg.Config.from_json(cfg.to_json()))


def test_overrides_and_unknown_preset():
    assert tcfg.get_config("512x640", nms_thre=0.3).io.nms_thre == 0.3
    assert set(tcfg._PRESETS) == set(jcfg._PRESETS)
    with pytest.raises(KeyError, match="unknown config preset"):
        tcfg.get_config("1024x1280")
