"""Mixed-resolution FEM surfaces: a dense face grid embedded in a coarse solve.

Port of ``tacex_tpu/physics/soft/embed.py``. The FEM solution is piecewise
linear, so a dense contact-face grid bound once to the coarse mesh's face
(exact bilinear or triangle-barycentric weights in the rest layout, numpy,
copied) follows the coarse solve at the cost of a gather and a weighted
sum a step: tactile depth and marker flow sample thousands of surface
points while the solve stays coarse.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.device import DEFAULT_DEVICE, resolve


class EmbeddedFaceGrid:
    """Dense (eh, ew) face grid bound bilinearly into a coarse face grid.

    Args:
      coarse_grid_ids: (gh, gw) vertex ids of the coarse contact-face grid
        (row-major, as built by the UIPC envs).
      rest_points: (V, 3) coarse rest vertex positions (the face grid must
        be axis-aligned regular in x/y at a constant z).
      embed_res: (eh, ew) dense grid resolution (vertex counts).
      face_tris: optional (T, 3) GLOBAL-vertex-id triangles of the coarse
        contact face. When given, each dense point uses TRIANGLE
        barycentric weights split along the same diagonal as the coarse
        surface — the embedded surface is then EXACTLY the coarse FEM
        field refined (no bilinear twist term). Without it, bilinear.
    """

    def __init__(
        self,
        coarse_grid_ids: np.ndarray,
        rest_points: np.ndarray,
        embed_res: tuple[int, int],
        face_tris: np.ndarray | None = None,
        device=DEFAULT_DEVICE,
    ):
        ids = np.asarray(coarse_grid_ids)
        gh, gw = ids.shape
        eh, ew = int(embed_res[0]), int(embed_res[1])
        self.shape = (eh, ew)
        P = np.asarray(rest_points)

        # fractional cell coordinates of each dense point in the coarse grid
        u = np.linspace(0.0, gh - 1.0, eh)
        v = np.linspace(0.0, gw - 1.0, ew)
        uu, vv = np.meshgrid(u, v, indexing="ij")
        i0 = np.clip(np.floor(uu).astype(np.int64), 0, gh - 2)
        j0 = np.clip(np.floor(vv).astype(np.int64), 0, gw - 2)
        fu = (uu - i0)[..., None]
        fv = (vv - j0)[..., None]

        corner_ids = np.stack(
            [
                ids[i0, j0], ids[i0, j0 + 1], ids[i0 + 1, j0], ids[i0 + 1, j0 + 1]
            ],
            axis=-1,
        )  # (eh, ew, 4) = [a, b, c, d] at (0,0), (0,1), (1,0), (1,1)
        if face_tris is None:
            w = np.concatenate(
                [
                    (1 - fu) * (1 - fv),
                    (1 - fu) * fv,
                    fu * (1 - fv),
                    fu * fv,
                ],
                axis=-1,
            )  # (eh, ew, 4)
        else:
            # per-cell diagonal orientation from the coarse face split
            tri_sets = [frozenset(t) for t in np.asarray(face_tris).tolist()]
            pair_in_tri = set()
            for s in tri_sets:
                for x_ in s:
                    for y_ in s:
                        if x_ < y_:
                            pair_in_tri.add((x_, y_))
            a = corner_ids[..., 0]
            d = corner_ids[..., 3]
            diag_ad = np.zeros(a.shape, bool)
            for p in np.ndindex(a.shape):
                lo, hi = sorted((int(a[p]), int(d[p])))
                diag_ad[p] = (lo, hi) in pair_in_tri
            fu2, fv2 = fu[..., 0], fv[..., 0]
            w = np.zeros(corner_ids.shape, np.float64)
            # diagonal a-d: tris (a, b, d) for fv >= fu, (a, c, d) for fu > fv
            upper = fv2 >= fu2
            w_ad = np.zeros_like(w)
            w_ad[..., 0] = np.where(upper, 1 - fv2, 1 - fu2)
            w_ad[..., 1] = np.where(upper, fv2 - fu2, 0.0)
            w_ad[..., 2] = np.where(upper, 0.0, fu2 - fv2)
            w_ad[..., 3] = np.where(upper, fu2, fv2)
            # diagonal b-c: tris (a, b, c) for fu+fv <= 1, (b, d, c) beyond
            lowr = fu2 + fv2 <= 1.0
            w_bc = np.zeros_like(w)
            w_bc[..., 0] = np.where(lowr, 1 - fu2 - fv2, 0.0)
            w_bc[..., 1] = np.where(lowr, fv2, 1 - fu2)
            w_bc[..., 2] = np.where(lowr, fu2, 1 - fv2)
            w_bc[..., 3] = np.where(lowr, 0.0, fu2 + fv2 - 1.0)
            w = np.where(diag_ad[..., None], w_ad, w_bc)
        dev = resolve(device)
        self.corner_ids = torch.as_tensor(corner_ids.reshape(-1), dtype=torch.int64, device=dev)  # (P*4,)
        self.weights = torch.as_tensor(w.reshape(-1, 4), dtype=torch.float32, device=dev)
        # dense rest positions (for sensor-frame offsets / marker binding)
        self.rest_points = np.einsum(
            "pk,pkd->pd", w.reshape(-1, 4), P[corner_ids.reshape(-1, 4)]
        ).astype(np.float32)
        # grid triangulation of the dense surface (two tris per cell),
        # oriented to match the coarse face (+z outward for the gel pad)
        tris = []
        for a in range(eh - 1):
            for b in range(ew - 1):
                p00 = a * ew + b
                p01 = p00 + 1
                p10 = p00 + ew
                p11 = p10 + 1
                tris += [[p00, p01, p11], [p00, p11, p10]]
        self.triangles = np.asarray(tris, np.int32)

    def positions(self, x: torch.Tensor) -> torch.Tensor:
        """(N, V, 3) coarse vertices -> (N, eh*ew, 3) dense face points."""
        corners = x.index_select(-2, self.corner_ids).unflatten(-2, (-1, 4))  # (N, P, 4, 3)
        return torch.einsum("pk,...pkd->...pd", self.weights, corners)
