"""The UIPC ball-rolling task with the embedded dense gel surface
(``gel_resolution="low", gel_embed_surface="extremely_high"``, the second
config of ``scripts/benchmarking/benchmark_embedded_gel.py``) against the
JAX package: the coarse solve's 51x41 contact-face grid carries the depth
map and the marker flow. One step from a carried-over pressed state at 2
envs, with ``_torch_uipc``'s tolerances."""

import pytest

from _torch_bins import setup_torch
from _torch_uipc import check_markers, check_step, check_tactile, one_step, pair

setup_torch()

ENV_ID = "TacEx-Ball-Rolling-Tactile-RGB-Uipc-v0"
EMBED = dict(gel_embed_surface="extremely_high")


@pytest.fixture(scope="module")
def stepped():
    return one_step(ENV_ID, **EMBED)


def test_embedded_surface_is_bound(stepped):
    env_j, env_t, _, _, _ = stepped
    assert env_t.embed.shape == env_j.embed.shape == (51, 41)
    assert env_t.marker_flow.num_bound == env_j.marker_flow.num_bound > 50
    assert pair(ENV_ID, **EMBED)[1] is env_t


def test_one_step_matches_jax(stepped):
    check_step(stepped)


def test_marker_flow_matches_jax_as_sets(stepped):
    check_markers(stepped)


def test_tactile_image_matches_jax(stepped):
    check_tactile(stepped)
