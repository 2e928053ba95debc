"""Gmsh .msh tetrahedral mesh loading (numpy; a copy of
``tacex_tpu/physics/soft/msh_io.py`` over the port's ``mesh.py``).

Counterpart of the reference's ``spawn_from_msh`` utility (reference
source/tacex_uipc/tacex_uipc/utils/spawn_from_msh.py) which spawns gel
assets from fTetWild-produced ``.msh`` files. Supports the ASCII MSH 2.2 and
4.1 formats (nodes + 4-node tetrahedra), returning a :class:`TetMesh`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .mesh import TetMesh, extract_surface


def load_msh(path: str | Path) -> TetMesh:
    """Parse an ASCII Gmsh .msh file into a TetMesh (tets only)."""
    lines = Path(path).read_text().splitlines()
    it = iter(range(len(lines)))
    version = None
    nodes: dict[int, tuple[float, float, float]] = {}
    tets: list[tuple[int, int, int, int]] = []

    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line == "$MeshFormat":
            version = float(lines[i + 1].split()[0])
            i += 2
        elif line == "$Nodes":
            if version is not None and version >= 4.0:
                i = _parse_nodes_v4(lines, i + 1, nodes)
            else:
                i = _parse_nodes_v2(lines, i + 1, nodes)
        elif line == "$Elements":
            if version is not None and version >= 4.0:
                i = _parse_elements_v4(lines, i + 1, tets)
            else:
                i = _parse_elements_v2(lines, i + 1, tets)
        else:
            i += 1

    if not nodes or not tets:
        raise ValueError(f"no tetrahedra found in {path}")

    ids = sorted(nodes)
    remap = {nid: k for k, nid in enumerate(ids)}
    points = np.asarray([nodes[n] for n in ids], np.float32)
    tet_arr = np.asarray([[remap[a], remap[b], remap[c], remap[d]] for a, b, c, d in tets], np.int32)

    # orientation: positive volumes
    p = points
    d1 = p[tet_arr[:, 1]] - p[tet_arr[:, 0]]
    d2 = p[tet_arr[:, 2]] - p[tet_arr[:, 0]]
    d3 = p[tet_arr[:, 3]] - p[tet_arr[:, 0]]
    vol = np.einsum("ij,ij->i", np.cross(d1, d2), d3)
    flip = vol < 0
    tet_arr[flip, 1], tet_arr[flip, 2] = tet_arr[flip, 2].copy(), tet_arr[flip, 1].copy()

    tris = extract_surface(tet_arr, points)
    return TetMesh(
        points=points,
        tets=tet_arr,
        surface_tris=tris.astype(np.int32),
        surface_verts=np.unique(tris).astype(np.int32),
    )


def _parse_nodes_v2(lines, i, nodes):
    n = int(lines[i].strip())
    for k in range(n):
        parts = lines[i + 1 + k].split()
        nodes[int(parts[0])] = (float(parts[1]), float(parts[2]), float(parts[3]))
    return i + 1 + n


def _parse_elements_v2(lines, i, tets):
    n = int(lines[i].strip())
    for k in range(n):
        parts = lines[i + 1 + k].split()
        etype = int(parts[1])
        if etype == 4:  # 4-node tetrahedron
            ntags = int(parts[2])
            vs = parts[3 + ntags : 7 + ntags]
            tets.append(tuple(int(v) for v in vs))
    return i + 1 + n


def _parse_nodes_v4(lines, i, nodes):
    header = lines[i].split()
    num_blocks, total = int(header[0]), int(header[1])
    i += 1
    for _ in range(num_blocks):
        bh = lines[i].split()
        n_in_block = int(bh[3])
        i += 1
        tags = [int(lines[i + k]) for k in range(n_in_block)]
        i += n_in_block
        for k in range(n_in_block):
            parts = lines[i + k].split()
            nodes[tags[k]] = (float(parts[0]), float(parts[1]), float(parts[2]))
        i += n_in_block
    return i


def _parse_elements_v4(lines, i, tets):
    header = lines[i].split()
    num_blocks = int(header[0])
    i += 1
    for _ in range(num_blocks):
        bh = lines[i].split()
        etype, n_in_block = int(bh[2]), int(bh[3])
        i += 1
        for k in range(n_in_block):
            parts = lines[i + k].split()
            if etype == 4:
                tets.append(tuple(int(v) for v in parts[1:5]))
        i += n_in_block
    return i
