"""The port's copies of the asset libraries equal the JAX package's: every
indenter height map of ``assets/shapes.py`` bit for bit at the demos' small
and default sizes, and every robot preset of ``assets/robots.py`` field by
field."""

import dataclasses

import numpy as np
import pytest

from _torch_bins import setup_torch
from tacex_tpu.assets import robots as jrobots
from tacex_tpu.assets import shapes as jshapes
from tacex_tpu_torch.assets import robots as trobots
from tacex_tpu_torch.assets import shapes as tshapes

setup_torch()

NAMES = sorted(jshapes.SHAPE_LIBRARY)


def test_the_library_holds_the_same_26_shapes():
    assert list(tshapes.SHAPE_LIBRARY) == list(jshapes.SHAPE_LIBRARY) and len(NAMES) == 26
    assert tshapes.FAR == jshapes.FAR


@pytest.mark.parametrize("res", [(48, 64), (240, 320)], ids=["48x64", "240x320"])
@pytest.mark.parametrize("name", NAMES)
def test_height_map_equals_jax(name, res):
    hm_t = tshapes.shape_height_map(name, res)
    hm_j = jshapes.shape_height_map(name, res)
    assert hm_t.dtype == hm_j.dtype == np.float32 and hm_t.shape == res
    assert np.array_equal(hm_t, hm_j)


def _cfgs(module) -> dict:
    return {k: v for k, v in vars(module).items() if k.endswith("_CFG")}


def test_robot_presets_equal_jax():
    cfgs_t, cfgs_j = _cfgs(trobots), _cfgs(jrobots)
    assert sorted(cfgs_t) == sorted(cfgs_j) and len(cfgs_j) == 7
    for name, cfg_j in cfgs_j.items():
        assert dataclasses.asdict(cfgs_t[name]) == dataclasses.asdict(cfg_j), name
    assert sorted(trobots.ALL_ROBOT_CFGS) == sorted(jrobots.ALL_ROBOT_CFGS)
    for name, cfg_j in jrobots.ALL_ROBOT_CFGS.items():
        assert dataclasses.asdict(trobots.ALL_ROBOT_CFGS[name]) == dataclasses.asdict(cfg_j)
    assert [f.name for f in dataclasses.fields(trobots.FrankaGelSightCfg)] == \
        [f.name for f in dataclasses.fields(jrobots.FrankaGelSightCfg)]
