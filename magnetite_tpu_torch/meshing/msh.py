"""Gmsh MSH 4.1 ASCII parser -> Mesh.

Replaces the reference's line-by-line state machine (src/mesher.rs:536-704)
with block-wise numpy parsing of the $Nodes/$Elements sections:

  * nodes: per-entity-block tag list + coordinate list; nodes are placed at
    dense index ``tag - 1`` (Gmsh writes contiguous tags for these meshes;
    non-contiguous tags are remapped, which the reference would mis-index)
  * elements: only 2D entity blocks (triangles, element type 2) are kept;
    1-based node tags -> 0-based indices
  * orientation is normalized afterwards by the caller
    (meshing.core.normalize_orientation)
"""

from __future__ import annotations

import numpy as np

from ..errors import MesherError
from .core import Mesh


def parse_msh(text: str) -> Mesh:
    """Parse MSH 4.1 ASCII content into a Mesh (orientation NOT yet fixed).

    Uses the native C++ parser (magnetite_tpu.native) when available; the
    numpy implementation below is the reference/fallback path.
    """
    from ..native import msh_parse as native_msh_parse

    try:
        native = native_msh_parse(text)
    except ValueError as err:
        raise MesherError(str(err))
    if native is not None:
        coords, tris = native
        if tris.size and (tris.min() < 0 or tris.max() >= coords.shape[0]):
            raise MesherError("element node index out of range in mesh file")
        return Mesh(coords=coords, tris=tris)
    return _parse_msh_numpy(text)


def _parse_msh_numpy(text: str) -> Mesh:
    lines = text.split("\n")
    i = 0
    n_lines = len(lines)
    node_tags: list[np.ndarray] = []
    node_coords: list[np.ndarray] = []
    tri_blocks: list[np.ndarray] = []

    while i < n_lines:
        line = lines[i].strip()
        if line == "$Nodes":
            i += 1
            header = lines[i].split()
            num_blocks = int(header[0])
            i += 1
            for _ in range(num_blocks):
                dim, _tag, _parametric, block_n = (
                    int(tok) for tok in lines[i].split()
                )
                i += 1
                if block_n:
                    tags = np.array(
                        [int(lines[i + k]) for k in range(block_n)],
                        dtype=np.int64,
                    )
                    i += block_n
                    coords = np.array(
                        [lines[i + k].split() for k in range(block_n)],
                        dtype=np.float64,
                    )
                    i += block_n
                    node_tags.append(tags)
                    node_coords.append(coords[:, :2])
        elif line == "$Elements":
            i += 1
            header = lines[i].split()
            num_blocks = int(header[0])
            i += 1
            for _ in range(num_blocks):
                dim, _tag, elem_type, block_n = (
                    int(tok) for tok in lines[i].split()
                )
                i += 1
                if dim == 2:
                    if elem_type != 2:
                        raise MesherError(
                            f"unsupported 2D element type {elem_type} "
                            "(only 3-node triangles)"
                        )
                    rows = np.array(
                        [lines[i + k].split() for k in range(block_n)],
                        dtype=np.int64,
                    )
                    tri_blocks.append(rows[:, 1:4] - 1)
                i += block_n
        elif line.startswith("$") and not line.startswith("$End"):
            # skip any other section wholesale
            section = line[1:]
            end = f"$End{section}"
            i += 1
            while i < n_lines and lines[i].strip() != end:
                i += 1
        i += 1

    if not node_tags:
        raise MesherError("mesh file has no $Nodes section")
    if not tri_blocks:
        raise MesherError("mesh file has no 2D elements")

    tags = np.concatenate(node_tags)
    coords_raw = np.concatenate(node_coords, axis=0)
    tris = np.concatenate(tri_blocks, axis=0)

    max_tag = int(tags.max())
    if max_tag == tags.size and tags.min() == 1:
        # contiguous tags: dense placement by tag-1
        coords = np.empty((tags.size, 2), dtype=np.float64)
        coords[tags - 1] = coords_raw
    else:
        # sparse tags: remap through a lookup table
        order = np.argsort(tags)
        coords = coords_raw[order]
        remap = np.full(max_tag, -1, dtype=np.int64)
        remap[tags[order] - 1] = np.arange(tags.size)
        tris = remap[tris]
        if (tris < 0).any():
            raise MesherError("element references unknown node tag")

    if tris.min() < 0 or tris.max() >= coords.shape[0]:
        raise MesherError("element node index out of range in mesh file")

    return Mesh(coords=coords, tris=tris.astype(np.int32))


def parse_msh_file(path: str) -> Mesh:
    try:
        with open(path, "r") as f:
            text = f.read()
    except OSError as err:
        raise MesherError(f"Unable to open auto-generated mesh file: {err}")
    return parse_msh(text)
