"""Shared cases of the port's structured sharding tests: the same generator
grids in both packages, and the JAX package's sharded solves over the
tests' virtual CPU devices (tests/conftest.py provides 8)."""

from __future__ import annotations

import functools

import jax
import numpy as np

E_MOD, NU, THICK = 69e9, 0.33, 0.5

# 17 x 32 wrapped plate and 17 x 33 rectangle: both coarsen (17 rows); the
# plate's cols divide by 2 and 4, the rectangle's pad on a 2-D mesh
GRIDS = {
    "plate_17x32": lambda gen: gen.plate_with_hole_mesh(16, 32),
    "rect_17x33": lambda gen: gen.rect_mesh(32, 16, width=2.0),
}


@functools.lru_cache(maxsize=None)
def grid_case(name: str):
    """((JAX mesh, bca, metadata), (port mesh, bca, metadata)) of a grid in
    tension (tensile_bcs_for_rect), each built by its own package."""
    import magnetite_tpu.config
    from magnetite_tpu.meshing import generators as jgen
    from magnetite_tpu_torch.config import ModelMetadata
    from magnetite_tpu_torch.meshing import generators as pgen

    jmesh = GRIDS[name](jgen)
    pmesh = GRIDS[name](pgen)
    return (
        (jmesh, jgen.tensile_bcs_for_rect(jmesh.coords),
         magnetite_tpu.config.ModelMetadata(E_MOD, NU, THICK, 0.0, 0.05)),
        (pmesh, pgen.tensile_bcs_for_rect(pmesh.coords),
         ModelMetadata(E_MOD, NU, THICK, 0.0, 0.05)),
    )


def jax_mesh(shape, names):
    n = int(np.prod(shape))
    return jax.make_mesh(tuple(shape), tuple(names), devices=jax.devices()[:n])


def cpu_mesh(s: int):
    from magnetite_tpu_torch.parallel.pipeline import DeviceMesh

    return DeviceMesh(("cpu",) * s, "rows")


def cpu_mesh_2d(nr: int, nc: int):
    from magnetite_tpu_torch.parallel.pipeline import DeviceMesh2D

    return DeviceMesh2D(("cpu",) * (nr * nc), (nr, nc))


def grid_of(tiles, shape) -> np.ndarray:
    """Row-major tiles [..., rl, cl] (tensors) as the whole padded grid."""
    nr, nc = shape
    rows = [np.concatenate([t.numpy() for t in tiles[i * nc:(i + 1) * nc]], axis=-1)
            for i in range(nr)]
    return np.concatenate(rows, axis=-2)


def assert_close_to(got: np.ndarray, want: np.ndarray, rel: float, what: str) -> None:
    """max|got - want| <= rel * max|want| (never an atol of 0)."""
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel:.0e} x {scale:.3e}"
