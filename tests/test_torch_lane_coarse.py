"""The structured material sweep's coarsest-level solve and the packed lane
stencils, against the JAX package, on the CPU.

`lane_coarse_smooth3` (kernels/lane_coarse_kernel.py) replaces the loop
that smooths the material V-cycle's coarsest level 48 times; its plain
version is held to the JAX package's `_lane_material_vcycle` called with
that level alone (a one-level hierarchy is exactly its coarse smoothing),
on the 9x17 coarsest level of `rect_mesh(32, 16, width=2.0)` and the 9x16
coarsest level of the wrapped `plate_with_hole_mesh(16, 32)`, 4 lanes, f64,
at 1e-11 of max|e| (the bar of the wrapped V-cycle in
tests/test_torch_grid_material_sweep.py). The levels come from the port's
setup (held to the JAX package's array by array there) and enter both
packages as numpy arrays. `pack_lane_stencils` feeds the plain matvecs the
layout the kernels read; held to the JAX functions at 1e-12 of the scale of
the same computation with every term in absolute value. The route choice
of the coarse wrapper is pure Python and checked shape by shape.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magnetite_tpu.meshing import generators as jgen
from magnetite_tpu.parallel import sweep as js
from magnetite_tpu_torch.kernels import cuda_lib
from magnetite_tpu_torch.kernels import lane_coarse_kernel as lc
from magnetite_tpu_torch.kernels import lane_stencil_kernel as lk
from magnetite_tpu_torch.parallel import sweep as ps
from tests.test_torch_grid_sweep import port_bca, port_mesh
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

LEVELS = {  # name: (mesh, shape of its coarsest level)
    "rect-9x17": (lambda: jgen.rect_mesh(32, 16, width=2.0), (9, 17)),
    "wrapped-9x16": (lambda: jgen.plate_with_hole_mesh(16, 32), (9, 16)),
}
NB, SWEEPS, OMEGA = 4, 48, 0.7


@functools.lru_cache(maxsize=None)
def coarsest(name):
    """(coarsest _MaterialLevel of the port's f64 setup, wrap)."""
    mesh = LEVELS[name][0]()
    bca = jgen.tensile_bcs_for_rect(mesh.coords, pull=0.01)
    pm, pb = port_mesh(mesh), port_bca(bca)
    rows, cols = mesh.grid_shape
    coords, tris, free_g = ps._grid_arrays(pm, pb, rows, cols, torch.device("cpu"))
    _, levels, _ = ps._material_sweep_setup(coords, tris, free_g, rows, cols, mesh.wrap_cols)
    return levels[-1], bool(mesh.wrap_cols)


def lane_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    e, nu, t = rng.uniform(40e9, 250e9, NB), rng.uniform(0.22, 0.38, NB), rng.uniform(0.2, 1, NB)
    return (e, nu, t), rng.standard_normal((2, *shape, NB))


@pytest.mark.parametrize("name", list(LEVELS))
def test_coarse_smoother_matches_jax_coarsest_level(name):
    level, wrap = coarsest(name)
    assert tuple(level.sa.shape[-2:]) == LEVELS[name][1]
    mat, r = lane_inputs(LEVELS[name][1], 21)
    j_level = js._MaterialLevel(*(jnp.asarray(s.numpy()) for s in level))
    jw = js.material_weights(*(jnp.asarray(x) for x in mat))
    j_dinv = js._lane_material_center_inv(j_level, *jw)
    ref = np.asarray(js._lane_material_vcycle((j_level,), (j_dinv,), *jw, wrap,
                                              coarse_sweeps=SWEEPS, omega=OMEGA)(jnp.asarray(r)))
    pw = ps.material_weights(*(torch.from_numpy(x) for x in mat))
    dinv = ps._lane_material_center_inv(level, *pw)
    got = lc.lane_coarse_smooth3_plain(level, dinv, pw, torch.from_numpy(r), wrap, SWEEPS, OMEGA)
    assert np.abs(got.numpy() - ref).max() <= 1e-11 * np.abs(ref).max()
    # packed stencils through the wrapper: the same bits on the CPU
    packed = lk.pack_lane_stencils(level)
    again = lc.lane_coarse_smooth3(packed, dinv, pw, torch.from_numpy(r), wrap, SWEEPS, OMEGA)
    assert torch.equal(again, got)
    # and the port's one-level V-cycle is that solve
    vc = ps._lane_material_vcycle((packed,), (dinv,), *pw, wrap)(torch.from_numpy(r))
    assert torch.equal(vc, got)


@pytest.mark.parametrize("wrap", [False, True], ids=["zero_cols", "wrapped"])
@pytest.mark.parametrize("sets", [1, 3])
def test_packed_stencils_match_jax(sets, wrap):
    rng = np.random.default_rng(22 + sets)
    rows, cols, nb = 9, 16, 5
    st = [rng.standard_normal((9, 2, 2, rows, cols)) for _ in range(4 if sets == 3 else 1)]
    w = [rng.uniform(0.5, 2.0, nb) for _ in range(3)]
    u = rng.standard_normal((2, rows, cols, nb))
    tw, tu = tuple(map(torch.from_numpy, w)), torch.from_numpy(u)
    if sets == 3:
        packed = lk.pack_lane_stencils(tuple(map(torch.from_numpy, st)))
        assert tuple(packed.data.shape) == (rows, cols, 9, 2, 2, 4) and packed.sets == 3
        got = lk.lane_stencil_matvec3(packed, tw, tu, wrap)
        ref = np.asarray(js._lane_material_matvec(
            js._MaterialLevel(*(jnp.asarray(s) for s in st)), *(jnp.asarray(x) for x in w),
            jnp.asarray(u), wrap))
        scale = lk.lane_material_matvec_plain(
            lk.pack_lane_stencils(tuple(torch.from_numpy(np.abs(s)) for s in st)), tw,
            torch.from_numpy(np.abs(u)), wrap).max()
    else:
        packed = lk.pack_lane_stencils(torch.from_numpy(st[0]))
        assert tuple(packed.data.shape) == (rows, cols, 9, 2, 2) and packed.sets == 1
        got = lk.lane_stencil_matvec(packed, tu, wrap)
        ref = np.asarray(js._lane_stencil_matvec(jnp.asarray(st[0]), jnp.asarray(u), wrap))
        scale = lk.lane_stencil_matvec_plain(lk.pack_lane_stencils(torch.from_numpy(
            np.abs(st[0]))), torch.from_numpy(np.abs(u)), wrap).max()
    assert packed.data.is_contiguous()
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * float(scale)
    # unpacking gives the JAX layout back exactly
    back = lk.unpack_lane_stencils(packed)
    for a, b in zip(back if sets == 3 else (back,), st):
        assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape,routes", [
    ((9, 17), ("fused", "fused")),  # the bench grid's coarsest level
    ((9, 16), ("fused", "fused")),  # the wrapped plate's
    ((10, 16), ("fused", "fused")),  # (1, 2)'s 320 threads, past (3, 7) / (2, 3)
    ((8, 21), ("per-sweep", "per-sweep")),  # 336 threads a slab of (1, 2)
    ((17, 33), ("per-sweep", "per-sweep")),  # the 17x33 level
    ((1, 160), ("fused", "per-sweep")),  # f64's stencils and e pass 227 KB
], ids=["9x17", "9x16", "10x16", "8x21", "17x33", "1x160"])
def test_coarse_route_by_shape(shape, routes, dtype):
    es = torch.empty((), dtype=dtype).element_size()
    want = routes[es == 8]
    assert lc.lane_coarse_route(*shape, es) == want
    plan = lc.lane_coarse_plan(*shape, es)
    assert (plan is None) == (want == "per-sweep")
    if plan is not None:
        cap = {(m, lanes): c for m, lanes, c in lc.GEOMETRIES[es]}[plan.m, plan.lanes]
        assert plan.threads % 32 == 0
        assert plan.threads >= -(-shape[0] // plan.m) * shape[1] * plan.lanes
        assert plan.threads <= cap and plan.smem <= lc.MAX_SMEM


@pytest.mark.parametrize("shape,es,want", [
    ((9, 17), 4, (3, 7, 384)),  # 3 row groups x 17 columns x 7 lanes = 357 threads
    ((9, 16), 4, (3, 7, 352)),
    ((9, 17), 8, (2, 3, 256)),  # 5 row groups (the last one row) x 17 x 3 = 255
    ((9, 16), 8, (2, 3, 256)),
    ((10, 16), 4, (1, 2, 320)),  # (3, 7): 4 x 16 x 7 = 448 threads, past its 384
    ((12, 12), 4, (3, 7, 352)),
    ((12, 12), 8, (2, 3, 224)),  # 6 x 12 x 3 = 216 threads
    ((5, 32), 8, (1, 2, 320)),  # (2, 3): 3 x 32 x 3 = 288 threads, past its 256
], ids=["9x17-f32", "9x16-f32", "9x17-f64", "9x16-f64", "10x16-f32", "12x12-f32", "12x12-f64",
        "5x32-f64"])
def test_coarse_plan_sizes_the_new_block(shape, es, want):
    """The first geometry the level fits; the block's threads and shared
    memory as the CUDA source counts them (e with M - 1 spare rows)."""
    plan = lc.lane_coarse_plan(*shape, es)
    assert (plan.m, plan.lanes, plan.threads) == want
    rows, cols = shape
    smem = (rows * cols * (144 + 16 // es)
            + 2 * (rows + plan.m + 1) * (cols + 2) * plan.lanes * 2
            + 6 * plan.m * plan.threads) * es
    assert plan.smem == smem <= lc.MAX_SMEM


def test_nothing_launches_on_cpu_tensors():
    level, wrap = coarsest("rect-9x17")
    mat, r = lane_inputs((9, 17), 23)
    pw = ps.material_weights(*(torch.from_numpy(x) for x in mat))
    dinv = ps._lane_material_center_inv(level, *pw)
    # the per-sweep route would launch the S = 3 kernel
    entries = ("mt_lane_coarse_smooth3", "mt_lane_stencil_matvec3", "mt_lane_stencil_matvec")
    before = [cuda_lib.launched(e) for e in entries]
    for st in (level, lk.pack_lane_stencils(level)):
        lc.lane_coarse_smooth3(st, dinv, pw, torch.from_numpy(r), wrap, SWEEPS, OMEGA)
    lk.lane_stencil_matvec(lk.pack_lane_stencils(level.sa), torch.from_numpy(r), wrap)
    assert [cuda_lib.launched(e) for e in entries] == before


def test_compiled_material_sweep_holds_packed_stencils():
    """The setup stays in the JAX layout (interop, parity tests); the packed
    copy sits beside it, one per level, and unpacks to it."""
    mesh = LEVELS["rect-9x17"][0]()
    bca = jgen.tensile_bcs_for_rect(mesh.coords, pull=0.01)
    sweep = ps.compile_material_sweep(port_mesh(mesh), port_bca(bca), iterations=2,
                                      dtype=np.float64, device="cpu")
    basis_raw, levels, _ = sweep.setup
    packed_raw, packed_levels = sweep.packed
    assert len(packed_levels) == len(levels) == 2
    for p, lv in zip(packed_levels, levels):
        assert p.sets == 3 and all(torch.equal(a, b)
                                   for a, b in zip(lk.unpack_lane_stencils(p), lv))
    for p, st in zip(packed_raw, basis_raw):
        assert p.sets == 1 and torch.equal(lk.unpack_lane_stencils(p), st)
