"""FEM elasticity: stable Neo-Hookean tets (batched over envs, PyTorch).

Port of ``tacex_tpu/physics/soft/fem.py``. The gel's constitutive model is
the inversion-safe Neo-Hookean of Smith et al. 2018,

    Psi(F) = mu/2 (I_C - 3) + lambda/2 (J - alpha)^2,  alpha = 1 + mu/lambda,

with no log or square root of J, so a Newton solve with plain backtracking
stays NaN-free for inverted elements. The rest-shape helpers are numpy
(host precompute, copied); the energy is torch and takes a leading batch of
envs, so one autograd graph gives every env's gradient and Hessian-vector
product. ``J = det(F)`` is the closed-form 3x3 cofactor expansion: a few
elementwise ops whose second derivative is plain, where ``torch.linalg.det``
is an LU factorisation of many launches.
"""

from __future__ import annotations

import numpy as np
import torch


def lame_params(youngs_modulus, poisson_ratio):
    e, nu = youngs_modulus, poisson_ratio
    mu = e / (2.0 * (1.0 + nu))
    lam = e * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam


def precompute_rest(points: np.ndarray, tets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(Dm_inv (T, 3, 3), rest_volume (T,)) for the rest configuration."""
    p = points[tets]  # (T, 4, 3)
    dm = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]], axis=-1)  # (T,3,3)
    vol = np.abs(np.linalg.det(dm)) / 6.0
    return np.linalg.inv(dm).astype(np.float32), vol.astype(np.float32)


def lumped_masses(points: np.ndarray, tets: np.ndarray, density) -> np.ndarray:
    """(V,) lumped vertex masses (quarter of each incident tet)."""
    _, vol = precompute_rest(points, tets)
    m = np.zeros(len(points), np.float32)
    for c in range(4):
        np.add.at(m, tets[:, c], density * vol / 4.0)
    return m


def deformation_gradients(x: torch.Tensor, tets: torch.Tensor, dm_inv: torch.Tensor) -> torch.Tensor:
    """F (..., T, 3, 3) for vertex positions x (..., V, 3); ``tets`` (T, 4)."""
    p = x.index_select(-2, tets.reshape(-1)).unflatten(-2, tets.shape)  # (..., T, 4, 3)
    ds = torch.stack([p[..., 1, :] - p[..., 0, :], p[..., 2, :] - p[..., 0, :], p[..., 3, :] - p[..., 0, :]], dim=-1)
    return ds @ dm_inv


def det3(f: torch.Tensor) -> torch.Tensor:
    """det of (..., 3, 3) matrices by the cofactor expansion along row 0."""
    return (
        f[..., 0, 0] * (f[..., 1, 1] * f[..., 2, 2] - f[..., 1, 2] * f[..., 2, 1])
        - f[..., 0, 1] * (f[..., 1, 0] * f[..., 2, 2] - f[..., 1, 2] * f[..., 2, 0])
        + f[..., 0, 2] * (f[..., 1, 0] * f[..., 2, 1] - f[..., 1, 1] * f[..., 2, 0])
    )


def stable_neo_hookean_energy(
    x: torch.Tensor,  # (..., V, 3)
    tets: torch.Tensor,  # (T, 4)
    dm_inv: torch.Tensor,  # (T, 3, 3)
    rest_vol: torch.Tensor,  # (T,)
    mu,  # float or (T,)
    lam,  # float or (T,)
) -> torch.Tensor:
    """Total elastic energy of each env -> (...,)."""
    f = deformation_gradients(x, tets, dm_inv)
    ic = (f * f).sum((-2, -1))
    j = det3(f)
    alpha = 1.0 + mu / lam
    psi = 0.5 * mu * (ic - 3.0) + 0.5 * lam * (j - alpha) ** 2
    return (rest_vol * psi).sum(-1)
