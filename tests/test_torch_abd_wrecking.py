"""The ``wrecking_balls`` sample of the UIPC scene API on the port against
its JAX scene, for 2 steps on the CPU (``_torch_abd_examples``): six affine
bodies with body-body contact in the split ABD world, positions within
``_torch_uipc_api.ATOL`` (1.5e-5 m; the two sides agree to ~1e-8 here),
and the broad phase's ``abd_`` counts.
"""

import numpy as np

import _torch_abd_examples as ex
from _torch_bins import setup_torch
from _torch_uipc_api import ATOL

setup_torch()


def test_wrecking_balls_matches_jax_scene():
    out = ex.port("wrecking_balls")
    x_j, overflow_j = ex.jax_wrecking_balls()
    assert out["x"].shape == x_j.shape == (1, 116, 3)
    np.testing.assert_allclose(out["x"], x_j, atol=ATOL, rtol=0)
    assert {k: v.tolist() for k, v in out["overflow"].items()} == {k: v.tolist() for k, v in overflow_j.items()}
    assert sorted(out["overflow"]) == ["abd_ee", "abd_vt_body"] and out["ms_per_step"] > 0
