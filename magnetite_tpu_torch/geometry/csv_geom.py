"""CSV geometry front-end.

One CSV file = one vertex loop; the header row must contain ``x`` and ``y``
columns (any order, extra columns ignored); each data row is one vertex, in
connection order (reference: src/mesher.rs:253-299). The first CSV on the
command line is the OUTER loop, the rest are INNER holes
(reference ordering contract: readme.md:130-136, src/mesher.rs:948-959).
"""

from __future__ import annotations

import numpy as np

from ..errors import InputError


def parse_csv(csv_file: str) -> np.ndarray:
    """Parse one CSV vertex-loop file -> [V, 2] float64."""
    try:
        with open(csv_file, "r") as f:
            contents = f.read()
    except OSError:
        raise InputError(f"Unable to open csv file {csv_file}")

    headers: list[str] = []
    verts: list[tuple[float, float]] = []
    for line in contents.split("\n"):
        if not line.strip():
            continue
        if not headers:
            headers = [h.strip() for h in line.split(",")]
            if "x" not in headers or "y" not in headers:
                raise InputError("Error in csv file: Missing x and/or y field")
            x_idx = headers.index("x")
            y_idx = headers.index("y")
        else:
            fields = line.split(",")
            try:
                verts.append((float(fields[x_idx]), float(fields[y_idx])))
            except (ValueError, IndexError):
                raise InputError(
                    f"Non-float value in csv points: {line!r}"
                )
    return np.asarray(verts, dtype=np.float64).reshape(-1, 2)
