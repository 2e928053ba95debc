"""The port's textured UIPC task ``TacEx-Ball-Rolling-Uipc-Textured-v0``
against the JAX package: one step from a carried-over pressed state at 2
envs (``_torch_uipc``'s tolerances), and the filmed marker texture on the
deformed gel, the port's of JAX's post-step surface against JAX's
(``FILM_ATOL``).
"""

import numpy as np
import pytest
import torch

import jax

from _torch_bins import setup_torch
from _torch_uipc import N, check_markers, check_step, check_tactile, frame_on_jax_state, grid_cam_jax, one_step

setup_torch()

ENV_ID = "TacEx-Ball-Rolling-Uipc-Textured-v0"
# The texture steps from 0.6 to 0.15 within a texel, so a UV off by d moves
# a value by up to 0.45 (tw - 1) d: the UV planes of 2.6 mm triangles seen
# from 28.5 mm carry d ~ 1e-6 of f32 rounding
FILM_ATOL = 1e-3


@pytest.fixture(scope="module")
def stepped():
    return one_step(ENV_ID)


def test_one_step_matches_jax(stepped):
    check_step(stepped)


def test_marker_flow_matches_jax_as_sets(stepped):
    check_markers(stepped)


@pytest.fixture(scope="module")
def film_j(stepped):
    env_j, _, out_j, _, _ = stepped
    return np.asarray(jax.jit(lambda s: env_j._film_texture_frame(grid_cam_jax(env_j, s)))(out_j[0]))


def test_filmed_texture_matches_jax(stepped, film_j):
    """The deformed gel's camera-frame surface, rasterized with its UVs and
    textured: the port's frame of JAX's surface against JAX's, within
    FILM_ATOL. Off the gel the frame is the dark case (0.3); the dots (0.15)
    move with the gel."""
    env_j, env_t, out_j, _, _ = stepped
    _, grid_cam = frame_on_jax_state(stepped)
    film_t = env_t._film_texture_frame(grid_cam).numpy()
    assert film_t.shape == film_j.shape == (N, 24, 32, 3)
    np.testing.assert_allclose(film_t, film_j, atol=FILM_ATOL)
    assert film_j.min() < 0.3 and film_j.max() > 0.55, "the frame shows no dots on the gray gel"
    np.testing.assert_array_equal(env_t._film_tex.numpy(), np.asarray(env_j._film_tex))


def test_vision_obs_matches_jax(stepped, film_j):
    """The observation is the tactile image modulated by the filmed texture:
    the port's, of JAX's post-step tactile frame and JAX's filmed frame,
    under the bin rule; the step's own within the LUT spread."""
    env_t = stepped[1]
    base = stepped[3][0].base

    def vision(sensor_out, grid_cam):
        film = torch.from_numpy(film_j)
        return env_t._observations(base, {**sensor_out, "filmed_rgb": film})["vision_obs"]

    check_tactile(stepped, vision)
    vis = stepped[3][1]["vision_obs"]
    assert bool(torch.isfinite(vis).all()) and float(vis.min()) < 0.5 * float(vis.max())
