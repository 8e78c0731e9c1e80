"""Gmsh subprocess meshing backend (optional; used when gmsh is installed).

Mirrors the reference's flow (src/mesher.rs:481-519): write a ``.geo``
script, run ``gmsh <geo> -2 -o <msh>``, parse the MSH output. Unlike the
reference, temp files live in a private temp directory (the reference writes
``geom.geo``/``geom.msh`` into the CWD and deletes them, src/mesher.rs:487,
516, 701) and the gmsh exit status is actually checked.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np

from ..errors import MesherError
from ..geometry.geo_writer import build_geo
from .core import Mesh
from .msh import parse_msh_file


def gmsh_available() -> bool:
    return shutil.which("gmsh") is not None


def triangulate(
    loops: list[np.ndarray],
    characteristic_length_min: float,
    characteristic_length_max: float,
    keep_files_in: str | None = None,
) -> Mesh:
    """Mesh via the gmsh binary. Raises MesherError if gmsh is missing/fails."""
    geo_text = build_geo(
        loops, characteristic_length_min, characteristic_length_max
    )
    workdir = keep_files_in or tempfile.mkdtemp(prefix="magnetite_gmsh_")
    geo_path = os.path.join(workdir, "geom.geo")
    msh_path = os.path.join(workdir, "geom.msh")
    try:
        with open(geo_path, "w") as f:
            f.write(geo_text)
        try:
            proc = subprocess.run(
                ["gmsh", geo_path, "-2", "-o", msh_path],
                capture_output=True,
                text=True,
            )
        except OSError as err:
            raise MesherError(f"Gmsh failed: {err}")
        if proc.returncode != 0:
            raise MesherError(
                f"Gmsh exited with status {proc.returncode}:\n{proc.stderr}"
            )
        mesh = parse_msh_file(msh_path)
        return mesh
    finally:
        if keep_files_in is None:
            shutil.rmtree(workdir, ignore_errors=True)
