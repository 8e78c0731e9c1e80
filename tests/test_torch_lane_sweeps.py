"""The port's block-Jacobi sweeps -- the DIA lanes (`impl="lanes"`) and the
vmap fallback (`impl="vmap"`) -- and `sweep_solve`'s routing, against the
JAX package's, on the CPU.

Both packages' `sweep_solve` run on the same mesh, boundary conditions and
batch (numpy seeds; pulls U(0.005, 0.02) on the right edge, k U(0.5, 2)):
`rect_mesh(6, 4, width=2.0)` (8 lanes, 300 iterations, as the JAX
package's own lanes-against-vmap test), the plate with a hole at h = 0.08
(552 nodes, 27 band offsets; 16 lanes, 400 iterations) and, vmap only,
that plate with its nodes shuffled (numpy seed 7: no band structure).
Both iteration budgets run block-Jacobi CG to convergence (relative
residual ~1e-14 in f64): in the middle of the run, the iterates of two
summation orders part by up to ~1e-6 of max|u| (measured on the plate at
200 iterations, the JAX package's lanes against its own vmap route), so
only converged answers can be held to f64 bars.

Bars. f64: u within 1e-8 of max|u|, von Mises within 1e-7 of its max,
residual_norm within 1e-10 of rhs_norm (both converged at ~1e-14 of it),
rhs_norm within 1e-12 relative. f32: two f32 runs of the same algorithm
part at the f32 floor, so the port is held to the JAX package's f64
answer, no further from it than twice the JAX package's own f32 sweep (u
and von Mises), as tests/test_torch_sweep.py does; its per-lane relative
residual within twice the JAX package's f32 one. The port's lanes against
its vmap: the JAX package's own test's bars (u rtol 1e-8 and atol 1e-10 of
max|u|, von Mises rtol 1e-7).
"""

import functools

import numpy as np
import pytest
import torch

from magnetite_tpu.meshing.generators import rect_mesh, tensile_bcs_for_rect
from magnetite_tpu.parallel import sweep as js
from magnetite_tpu_torch import interop
from magnetite_tpu_torch.errors import SolverError
from magnetite_tpu_torch.parallel import sweep as ps
from tests.torch_cases import jax_plate, shuffled, to_port
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

MESHES = {"rect_6x4": (8, 300), "plate_h0.08": (16, 400), "shuffled_h0.08": (16, 400)}
RUNS = [(m, impl) for m in MESHES for impl in ("lanes", "vmap") if (m, impl) != (
    "shuffled_h0.08", "lanes")]


@functools.lru_cache(maxsize=None)
def make_case(name):
    """(JAX (mesh, bca, md), the port's, batch, iterations) of a mesh."""
    if name == "rect_6x4":
        import magnetite_tpu.config
        import magnetite_tpu_torch.config
        from magnetite_tpu_torch.meshing.generators import rect_mesh as port_rect

        mesh = rect_mesh(6, 4, width=2.0)
        bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
        md = magnetite_tpu.config.ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.05)
        port = (port_rect(6, 4, width=2.0),  # the generator's grid flags as well
                interop.bca_from_arrays(bca.u_known, bca.u_value, bca.f_value),
                magnetite_tpu_torch.config.ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.05))
    else:
        mesh, bca, md = jax_plate(0.08)
        if name.startswith("shuffled"):
            mesh, bca = shuffled(mesh, bca, seed=7)
        port = to_port(mesh, bca, 0.08)
    b, iters = MESHES[name]
    rng = np.random.default_rng(5)
    u_values = np.tile(bca.u_value[None], (b, 1, 1))
    right = np.isclose(mesh.coords[:, 0], mesh.coords[:, 0].max())
    u_values[:, right, 0] = rng.uniform(0.005, 0.02, b)[:, None]
    batch = (u_values, np.zeros_like(u_values), rng.uniform(0.5, 2.0, b))
    return (mesh, bca, md), port, batch, iters


@functools.lru_cache(maxsize=None)
def jax_run(name, impl, dtype):
    jx, _, batch, iters = make_case(name)
    return js.sweep_solve(*jx, *batch, iterations=iters, dtype=np.dtype(dtype), impl=impl)


@functools.lru_cache(maxsize=None)
def port_run(name, impl, dtype):
    _, port, batch, iters = make_case(name)
    return ps.sweep_solve(*port, *batch, iterations=iters, dtype=np.dtype(dtype), impl=impl,
                          device="cpu")


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def dist(a, b):
    return np.abs(_np(a).astype(np.float64) - _np(b).astype(np.float64)).max()


@pytest.mark.parametrize("name,impl", RUNS, ids=[f"{m}-{i}" for m, i in RUNS])
def test_f64_matches_jax(name, impl):
    got, want = port_run(name, impl, "float64"), jax_run(name, impl, "float64")
    u, vm = _np(want.u), _np(want.von_mises)
    assert got.u.dtype == torch.float64 and tuple(got.u.shape) == u.shape
    assert tuple(got.von_mises.shape) == vm.shape
    assert dist(got.u, u) <= 1e-8 * np.abs(u).max()
    assert dist(got.von_mises, vm) <= 1e-7 * np.abs(vm).max()
    rhs = _np(want.rhs_norm)
    assert np.abs(_np(got.rhs_norm) - rhs).max() <= 1e-12 * rhs.max()
    assert np.abs(_np(got.residual_norm) - _np(want.residual_norm)).max() <= 1e-10 * rhs.min()


@pytest.mark.parametrize("name,impl", RUNS, ids=[f"{m}-{i}" for m, i in RUNS])
def test_f32_held_to_jax_f64(name, impl):
    got, jax32 = port_run(name, impl, "float32"), jax_run(name, impl, "float32")
    ref = jax_run(name, impl, "float64")
    assert got.u.dtype == torch.float32 and bool(torch.isfinite(got.u).all())
    for field in ("u", "von_mises"):
        r = getattr(ref, field)
        assert dist(getattr(got, field), r) <= 2.0 * dist(getattr(jax32, field), r), field
    rel = _np(got.residual_norm) / _np(got.rhs_norm)
    rel_j = _np(jax32.residual_norm) / _np(jax32.rhs_norm)
    assert np.isfinite(rel).all() and rel.max() <= 2.0 * rel_j.max()


@pytest.mark.parametrize("name", ["rect_6x4", "plate_h0.08"])
def test_lanes_match_vmap(name):
    """The port's DIA lanes against its vmap route (the JAX package's
    test_sweep_lanes_matches_vmap)."""
    lanes, vmapped = port_run(name, "lanes", "float64"), port_run(name, "vmap", "float64")
    scale = float(vmapped.u.abs().max())
    np.testing.assert_allclose(lanes.u.numpy(), vmapped.u.numpy(), rtol=1e-8,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(lanes.von_mises.numpy(), vmapped.von_mises.numpy(), rtol=1e-7)


def test_vmap_honours_structure():
    """structure=: the JAX package's EllStructure (through interop) gives
    the default answer bit for bit; a structure padded by two slots per row
    reaches the lane ELL matvec at its own width and changes the answer by
    rounding only."""
    import magnetite_tpu_torch.parallel.sweep as sweep_mod
    from magnetite_tpu.fem.assembly import build_ell_structure as jax_ell

    jx, port, batch, _ = make_case("shuffled_h0.08")
    n = jx[0].num_nodes
    js_st = jax_ell(jx[0].tris, n)
    st = interop.ell_structure_from_arrays(js_st.cols, js_st.slot_ids, n, js_st.width)
    kw = dict(iterations=30, dtype=np.float64, impl="vmap", device="cpu")
    base = ps.sweep_solve(*port, *batch, **kw)
    assert torch.equal(ps.sweep_solve(*port, *batch, structure=st, **kw).u, base.u)
    w = st.width
    cols = np.concatenate([st.cols, np.repeat(np.arange(n, dtype=np.int32)[:, None], 2, 1)], 1)
    slots = (st.slot_ids // w) * (w + 2) + st.slot_ids % w
    padded = interop.ell_structure_from_arrays(cols, slots, n, w + 2)
    widths = []
    real = sweep_mod.lane_ell_matvec

    def spy(ell, c, u):
        widths.append(ell.shape[1])
        return real(ell, c, u)

    mp = pytest.MonkeyPatch()
    mp.setattr(sweep_mod, "lane_ell_matvec", spy)
    try:
        got = ps.sweep_solve(*port, *batch, structure=padded, **kw)
    finally:
        mp.undo()
    assert widths and set(widths) == {w + 2}
    assert dist(got.u, base.u) <= 1e-12 * float(base.u.abs().max())


@pytest.mark.parametrize("name", ["rect_6x4", "plate_h0.08"])
def test_bands_zero_outside_so_roll_equals_zero_fill(name):
    """The JAX package's lane operator rolls u (wrapping around); K7 and its
    plain version stand for a product whose terms outside [0, N) are zero.
    They agree only because every assembled band is zero wherever n + off
    leaves [0, N): held here for the lanes route's bands, and the rolled
    product against a zero-filled shift."""
    from magnetite_tpu_torch.fem.dia import build_dia_structure
    from magnetite_tpu_torch.kernels.lane_dia_kernel import lane_dia_matvec_plain

    _, (mesh, _, md), _, _ = make_case(name)
    n = mesh.num_nodes
    dia = build_dia_structure(mesh.tris, n)
    bands = ps._assembled_bands(mesh, md, dia)
    node = np.arange(n)
    for k, off in enumerate(dia.offsets):
        outside = (node + off < 0) | (node + off >= n)
        assert outside.any() == (off != 0)
        assert not bands[k][..., torch.from_numpy(outside)].any(), int(off)
    u = torch.from_numpy(np.random.default_rng(3).standard_normal((2, n, 5)))
    zero_fill = torch.zeros_like(u)
    for k, off in enumerate(int(o) for o in dia.offsets):
        lo, hi = max(0, -off), min(n, n - off)
        shifted = torch.zeros_like(u)
        shifted[:, lo:hi] = u[:, lo + off:hi + off]
        b = bands[k][..., None]
        zero_fill += torch.stack([b[0, 0] * shifted[0] + b[0, 1] * shifted[1],
                                  b[1, 0] * shifted[0] + b[1, 1] * shifted[1]])
    rolled = lane_dia_matvec_plain(bands, tuple(int(o) for o in dia.offsets), u)
    assert float((rolled - zero_fill).abs().max()) <= 1e-12 * float(zero_fill.abs().max())


def _band_hostile_mesh(pkg_mesh, n=600, seed=3):
    """Random triangles over n random nodes: far more than 96 band offsets
    even after renumbering (the route rules only read its connectivity)."""
    rng = np.random.default_rng(seed)
    tris = np.stack([rng.choice(n, 3, replace=False) for _ in range(2 * n)]).astype(np.int32)
    return pkg_mesh(coords=rng.uniform(size=(n, 2)), tris=tris)


def _recorded_route(pkg, mesh, bca, md, impl, monkeypatch, amg_min):
    """The route `pkg`'s sweep_solve takes (its route functions patched to
    record their name), or the error it raises: ("stencil" | "amg" | "amg
    refused" | "lanes" | "vmap" ... | "error: <kind>")."""
    taken = []

    def route(name):
        def fn(*args, **kwargs):
            taken.append(name)
            return name
        return fn

    class Compiled:
        def solve(self, *args):
            return "amg"

    def compile_amg(mesh_, bca_, *args, **kwargs):
        taken.append("amg")
        try:  # what fails on a mesh band-hostile after renumbering
            pkg._banded_mesh_or_raise(mesh_, bca_, 96, "-")
        except (ValueError, SolverError):
            taken.append("amg refused")
            raise
        return Compiled()

    monkeypatch.setattr(pkg, "_sweep_stencil_lanes", route("stencil"))
    monkeypatch.setattr(pkg, "_sweep_lanes", route("lanes"))
    monkeypatch.setattr(pkg, "_sweep_vmap", route("vmap"))
    monkeypatch.setattr(pkg, "compile_unstructured_sweep", compile_amg)
    monkeypatch.setattr(pkg, "_amg_sweep_min_nodes", lambda: amg_min)
    b = 2
    u = np.zeros((b, mesh.num_nodes, 2))
    kwargs = dict(device="cpu") if pkg is ps else {}
    try:
        pkg.sweep_solve(mesh, bca, md, u, u, np.ones(b), iterations=4, impl=impl, **kwargs)
    except (ValueError, SolverError) as err:
        msg = str(err)
        kind = next(k for k in ("stencil sweep unavailable", "not DIA-compatible",
                                "band-hostile") if k in msg)
        taken.append(f"error: {kind}")
    monkeypatch.undo()
    return taken


@pytest.mark.parametrize("impl", ["auto", "stencil", "amg", "lanes", "vmap"])
def test_sweep_solve_routes_match_jax(impl, monkeypatch):
    """For every mesh kind and impl, the port's sweep_solve takes the JAX
    package's route (or raises the same error): a coarsenable grid, a grid
    too small to coarsen, the plate as meshed and shuffled, each below and
    at the AMG threshold (patched to 500 nodes in both packages), and a
    mesh band-hostile even after renumbering at AMG scale (auto falls
    through to vmap)."""
    from magnetite_tpu.bc import BCArrays as JaxBC
    from magnetite_tpu_torch.bc import BCArrays as PortBC
    from magnetite_tpu.meshing.core import Mesh as JaxMesh
    from magnetite_tpu.meshing.generators import plate_with_hole_mesh
    from magnetite_tpu_torch.meshing.generators import (
        plate_with_hole_mesh as port_plate, rect_mesh as port_rect,
    )
    from magnetite_tpu_torch.meshing.core import Mesh as PortMesh

    (jplate, jb, jmd), (pm, pb, pmd), _, _ = make_case("plate_h0.08")
    (jsh, jsb, _), (psh, psb, _), _, _ = make_case("shuffled_h0.08")

    def bcs(mesh, cls):
        n = mesh.num_nodes
        return cls(u_known=np.zeros((n, 2), bool), u_value=np.zeros((n, 2)),
                   f_value=np.zeros((n, 2)))

    kinds = {
        "coarsenable grid": ((plate_with_hole_mesh(16, 32), None), (port_plate(16, 32), None)),
        "small grid": ((rect_mesh(6, 4, width=2.0), None), (port_rect(6, 4, width=2.0), None)),
        "plate": ((jplate, jb), (pm, pb)),
        "shuffled plate": ((jsh, jsb), (psh, psb)),
        "band-hostile": ((_band_hostile_mesh(JaxMesh), None), (_band_hostile_mesh(PortMesh), None)),
    }
    for kind, ((jm, jbc), (port_m, port_bc)) in kinds.items():
        jbc = jbc if jbc is not None else bcs(jm, JaxBC)
        port_bc = port_bc if port_bc is not None else bcs(port_m, PortBC)
        for amg_min in (5000, 500):
            want = _recorded_route(js, jm, jbc, jmd, impl, monkeypatch, amg_min)
            got = _recorded_route(ps, port_m, port_bc, pmd, impl, monkeypatch, amg_min)
            assert got == want, (kind, amg_min, got, want)
