"""Two FEM examples of the UIPC scene API on the port against their JAX
scenes, at their own envs, meshes and settings for 2 steps on the CPU:
``hello_uipc`` (one tet on the ground, 4 envs) and
``periodically_pressed_tetrahedron`` (an apex pressed by sin(pi t), 2
envs); the scenes and how they run are in ``_torch_uipc_examples``.
Positions are held within ``_torch_uipc_api.ATOL`` (1.5e-5 m).
"""

import numpy as np
import pytest

import _torch_uipc_examples as ex
from _torch_bins import setup_torch
from _torch_uipc_api import ATOL

setup_torch()


@pytest.mark.parametrize("script, jax_scene", [
    ("examples/libuipc_samples/hello_uipc_torch.py", ex.jax_hello),
    ("examples/libuipc_samples/periodically_pressed_tetrahedron_torch.py", ex.jax_pressed_tet),
], ids=["hello_uipc", "pressed_tetrahedron"])
def test_example_matches_jax_scene(script, jax_scene):
    out = ex.port(script)
    x_j = jax_scene()
    assert out["x"].shape == x_j.shape
    np.testing.assert_allclose(out["x"], x_j, atol=ATOL, rtol=0)
    assert np.isfinite(out["x"]).all() and out["ms_per_step"] > 0
