"""Gmsh ``.geo`` script generation from vertex loops.

Emits the same modeling commands the reference generates
(src/mesher.rs:306-472): numbered Points for the outer loop then each inner
loop with running index offsets, Lines closing each loop, one ``Line Loop``
per loop, a single ``Plane Surface(1)`` subtracting the holes, and the mesh
settings block (first-order elements, MeshAdapt/Delaunay algorithm 1,
characteristic length bounds, ``Mesh 2``).

The reference reverses the surface's loop list when there are <= 2 loops and
keeps it forward otherwise (src/mesher.rs:425-431) -- an ordering quirk that
is irrelevant to Gmsh (the first loop is outer by plane-surface semantics
only when listed first). We always list the outer loop first, which is the
normalized behavior; pass ``compat_loop_order=True`` to byte-match the
reference's output.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def build_geo(
    loops: Sequence[np.ndarray],
    characteristic_length_min: float,
    characteristic_length_max: float,
    compat_loop_order: bool = False,
) -> str:
    """Render the .geo script for [outer, inner...] loops."""
    lines: list[str] = []
    out = lines.append

    out("// Define outer points")
    offsets = []
    counter = 0
    for li, loop in enumerate(loops):
        if li == 1:
            out("")
            out("// Define inner points")
        offsets.append(counter)
        for vi, (x, y) in enumerate(loop):
            out(f"Point({counter + vi}) = {{ {_fmt(x)}, {_fmt(y)}, 0, 1.0 }};")
        counter += len(loop)

    out("")
    out("// Connect points")
    for li, loop in enumerate(loops):
        out("")
        out(f"// Point connections for surface {li}")
        off = offsets[li]
        n = len(loop)
        for i in range(1, n):
            out(f"Line({off + i - 1}) = {{ {off + i - 1}, {off + i} }};")
        out(f"Line({off + n - 1}) = {{ {off + n - 1}, {off} }};")

    out("")
    out("//Register loops")
    for li, loop in enumerate(loops):
        off = offsets[li]
        ids = ", ".join(str(off + i) for i in range(len(loop)))
        out(f"Line Loop({li + 1}) = {{ {ids} }};")

    out("")
    out("//Define surface")
    order = list(range(len(loops)))
    if compat_loop_order and len(loops) <= 2:
        order = order[::-1]
    surface_ids = ", ".join(str(i + 1) for i in order)
    out(f"Plane Surface(1) = {{ {surface_ids} }};")

    out("")
    out("// Define Mesh Settings")
    out("Mesh.ElementOrder = 1;")
    out("Mesh.Algorithm  = 1;")
    out(f"Mesh.CharacteristicLengthMin = {_fmt(characteristic_length_min)};")
    out(f"Mesh.CharacteristicLengthMax = {_fmt(characteristic_length_max)};")
    out("Mesh 2;")
    out("")
    return "\n".join(lines)


def _fmt(value: float) -> str:
    """Shortest round-trip float formatting (what Rust's Display emits)."""
    return repr(float(value))
