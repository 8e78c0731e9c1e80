"""The hand-written CUDA kernels on the card, against their plain PyTorch
versions, and the port on the card against the port on the CPU: the
banded path, the structured (stencil + multigrid) path, mixed precision
with the double-float band kernel, and the lane-batched design sweeps with
the lane band, lane stencil, fused coarse-smoother and lane ELL kernels.

Every test here needs a CUDA device and skips itself without one. The file
imports no JAX and no other test module (tests/conftest.py imports JAX), so
it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from magnetite_tpu_torch.kernels import cuda_lib

pytestmark = pytest.mark.cuda

OUTER = [[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]]
HOLE = [[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]]


def require_cuda() -> torch.device:
    """Skip the calling test where no CUDA device exists (decided at run
    time, inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def port_plate(h: float):
    """The repo's plate with a hole (examples/unstructured_plate.py), built
    by the port alone."""
    from magnetite_tpu_torch.bc import apply_boundary_conditions
    from magnetite_tpu_torch.config import (
        BoundaryRegion, BoundaryRule, BoundaryTarget, ModelMetadata,
    )
    from magnetite_tpu_torch.meshing.delaunay_backend import triangulate

    mesh = triangulate([np.array(OUTER), np.array(HOLE)], 0.0, h)
    rules = (
        BoundaryRule("left", BoundaryRegion(x_max=1e-6), BoundaryTarget(ux=0.0, uy=0.0)),
        BoundaryRule("right", BoundaryRegion(x_min=3.0 - 1e-6),
                     BoundaryTarget(ux=0.01, fy=0.0)),
    )
    bca = apply_boundary_conditions(mesh.coords, rules)
    return mesh, bca, ModelMetadata(69e9, 0.33, 0.5, 0.0, h)


def random_bands(n: int, offsets, m: int, seed: int) -> np.ndarray:
    """Random DIA bands [D, m, m, n], zero wherever n + offset leaves [0, n)."""
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((len(offsets), m, m, n))
    rows = np.arange(n)
    for k, off in enumerate(offsets):
        bands[k, :, :, (rows + off < 0) | (rows + off >= n)] = 0.0
    return bands

OFFSETS = {2: (-1300, -512, -37, -1, 0, 1, 37, 512, 1300),
           3: (-601, -37, -1, 0, 1, 37, 601)}
DTYPES = [(torch.float64, 1e-12), (torch.float32, 1e-5)]


@pytest.fixture(scope="module")
def fast0():
    from magnetite_tpu_torch.fem.amg import build_amg_setup

    mesh, bca, md = port_plate(0.02)
    setup = build_amg_setup(
        mesh.coords, mesh.tris, md.youngs_modulus, md.poisson_ratio,
        md.part_thickness, (~bca.u_known).astype(np.float64),
    )
    agg, p0, ptc, ptv, _ = setup.fast0
    return agg, p0, ptc, ptv, setup.level_sizes[1][0]


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_dia_kernel_matches_plain(m, dtype, tol):
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec, dia_matvec_blocks

    dev = require_cuda()
    n, offsets = 20000, OFFSETS[m]
    bands = torch.as_tensor(random_bands(n, offsets, m, seed=9), dtype=dtype, device=dev)
    u = torch.as_tensor(np.random.default_rng(10).standard_normal((m, n)),
                        dtype=dtype, device=dev)
    before = cuda_lib.launched("mt_dia_matvec")
    y = dia_matvec(bands, offsets, u)
    torch.cuda.synchronize()
    assert cuda_lib.launched("mt_dia_matvec") == before + 1
    ref = dia_matvec_blocks(bands, offsets, u)
    scale = float(dia_matvec_blocks(bands.abs(), offsets, u.abs()).max())
    # another summation order (one FMA chain per row vs rolled sums):
    # rounding of the row magnitude
    assert float((y - ref).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_transfer_kernels_match_plain_and_are_adjoint(fast0, dtype, tol):
    from magnetite_tpu_torch.kernels.transfer_kernel import (
        prolong0, prolong0_plain, restrict0, restrict0_plain,
    )

    dev = require_cuda()
    agg, p0, ptc, ptv, n1 = fast0
    rng = np.random.default_rng(3)
    ec = torch.as_tensor(rng.standard_normal((n1, 3)), dtype=dtype, device=dev)
    tmp = torch.as_tensor(rng.standard_normal((2, agg.size)), dtype=dtype, device=dev)
    agg_t, ptc_t = torch.as_tensor(agg, device=dev), torch.as_tensor(ptc, device=dev)
    p0_t = torch.as_tensor(p0, dtype=dtype, device=dev)
    ptv_t = torch.as_tensor(ptv, dtype=dtype, device=dev)
    uf, rc = prolong0(ec, agg_t, p0_t), restrict0(tmp, ptc_t, ptv_t)
    torch.cuda.synchronize()
    # another summation order: rounding of each output's magnitude
    assert float((uf - prolong0_plain(ec, agg_t, p0_t)).abs().max()) <= tol * float(
        prolong0_plain(ec.abs(), agg_t, p0_t.abs()).max())
    assert float((rc - restrict0_plain(tmp, ptc_t, ptv_t)).abs().max()) <= tol * float(
        restrict0_plain(tmp.abs(), ptc_t, ptv_t.abs()).max())
    lhs, rhs = float((uf * tmp).sum()), float((ec * rc).sum())
    mag = float((prolong0(ec.abs(), agg_t, p0_t.abs()) * tmp.abs()).sum())
    assert abs(lhs - rhs) <= tol * mag


# the coarse-level band kernel (3x3 blocks; the warps of a block split the
# offsets of 32 nodes; warps and offsets per batch derived from D and N:
# on a 132-SM card N >= 16,896 takes at most 8 warps of 4-offset batches,
# smaller N up to 32 warps of one offset): name -> (N, offsets)
COARSE_CASES = {
    # D = 13: 7 warps of 2 offsets, one warp short; N = 20,001 is no
    # multiple of 32; +-20,500 reach past N on both sides
    "d13_n20001_past_n": (20001, (-20500, -4001, -650, -77, -9, -1, 0, 1, 9, 77, 650, 4001,
                                  20500)),
    # the coarse-level cap (_COARSE_MAX_DIAGS): 8 warps of 10 offsets, the
    # third batch short
    "d80_n20001": (20001, tuple(range(-40, 0)) + tuple(range(0, 40))),
    # 19 warps of 2 offsets, one short (the 1M plate's second level's D)
    "d37_n5003": (5003, tuple(range(-18, 19))),
    # one offset: one warp writes all three components
    "d1_n77": (77, (0,)),
}


@pytest.fixture(scope="module")
def coarse_level():
    """The first banded coarse level of the plate's AMG hierarchy (a real
    3x3 band set: n1 = 1,493, 21 offsets at h = 0.015)."""
    from magnetite_tpu_torch.fem.amg import amg_device_arrays, build_amg_setup

    mesh, bca, md = port_plate(0.015)
    setup = build_amg_setup(
        mesh.coords, mesh.tris, md.youngs_modulus, md.poisson_ratio,
        md.part_thickness, (~bca.u_known).astype(np.float64),
    )
    cb = next(cb for cb in amg_device_arrays(setup, torch.float64, "cpu").coarse_bands
              if cb is not None)
    return cb.bands.numpy(), cb.offsets


@pytest.mark.parametrize("case", [*COARSE_CASES, "amg_coarse_level"])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_coarse_dia_kernel_matches_plain_and_repeats(case, dtype, tol, request):
    """K1's m = 3 kernel against dia_matvec_blocks; a second call on the
    same operands is bitwise the same (the warps' partial sums meet in a
    fixed order, no atomics)."""
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec, dia_matvec_blocks

    dev = require_cuda()
    if case == "amg_coarse_level":
        bands_np, offsets = request.getfixturevalue("coarse_level")
        n = bands_np.shape[-1]
    else:
        n, offsets = COARSE_CASES[case]
        bands_np = random_bands(n, offsets, 3, seed=len(offsets))
    bands = torch.as_tensor(bands_np, dtype=dtype, device=dev)
    u = torch.as_tensor(np.random.default_rng(11).standard_normal((3, n)),
                        dtype=dtype, device=dev)
    before = cuda_lib.launches["mt_dia_matvec", dtype, (3, n)]
    y = dia_matvec(bands, offsets, u)
    again = dia_matvec(bands, offsets, u)
    torch.cuda.synchronize()
    assert cuda_lib.launches["mt_dia_matvec", dtype, (3, n)] == before + 2
    assert torch.equal(y, again)
    ref = dia_matvec_blocks(bands, offsets, u)
    scale = float(dia_matvec_blocks(bands.abs(), offsets, u.abs()).max())
    # another summation order (warp partial sums vs rolled sums): rounding
    # of the row magnitude
    assert float((y - ref).abs().max()) <= tol * scale
    # the V-cycle's call on a node-major field, op(x.T).T
    x = u.T.contiguous()
    assert torch.equal(dia_matvec(bands, offsets, x.T).T, y.T)


def synthetic_transfer(n1: int, w0: int, seed: int, n0_mod4=None):
    """A random aggregation of n1 aggregates of 1..w0 members each (w0 for
    the first), scattered over the fine nodes: agg [n0], p0 [n0, 2, 3] and
    the per-aggregate ELL lists of P0^T, pt0_cols [n1, w0] (padding: col 0,
    zero values) and pt0_vals [n1, w0, 3, 2], as AMGSetup.fast0 lays them
    out. `n0_mod4` picks n0's remainder mod 4 (w0 >= 4)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, w0 + 1, n1)
    sizes[0] = w0
    while n0_mod4 is not None and sizes.sum() % 4 != n0_mod4:
        sizes[-1] = sizes[-1] % w0 + 1
    n0 = int(sizes.sum())
    node = rng.permutation(n0)
    agg = np.empty(n0, dtype=np.int32)
    agg[node] = np.repeat(np.arange(n1), sizes)
    p0 = rng.standard_normal((n0, 2, 3))
    ptc = np.zeros((n1, w0), dtype=np.int32)
    ptv = np.zeros((n1, w0, 3, 2))
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for a in range(n1):
        members = node[start[a]:start[a] + sizes[a]]
        ptc[a, :sizes[a]] = members
        ptv[a, :sizes[a]] = p0[members].transpose(0, 2, 1)
    return agg, p0, ptc, ptv


@pytest.mark.parametrize("w0", [1, 14, 40])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_restrict_team_kernel_matches_plain_and_is_adjoint(w0, dtype, tol):
    """restrict0's teams (the power of two >= w0, at most 32 threads per
    aggregate): one thread per aggregate at w0 = 1, 16-thread teams at the
    1M plate's w0 = 14, 32-thread teams that loop at w0 = 40; n1 = 1,001 is
    a multiple of no team count per 256-thread block."""
    from magnetite_tpu_torch.kernels.transfer_kernel import (
        prolong0, restrict0, restrict0_plain,
    )

    dev = require_cuda()
    n1 = 1001
    agg, p0, ptc, ptv = synthetic_transfer(n1, w0, seed=w0)
    rng = np.random.default_rng(4)
    ec = torch.as_tensor(rng.standard_normal((n1, 3)), dtype=dtype, device=dev)
    tmp = torch.as_tensor(rng.standard_normal((2, agg.size)), dtype=dtype, device=dev)
    agg_t, ptc_t = torch.as_tensor(agg, device=dev), torch.as_tensor(ptc, device=dev)
    p0_t = torch.as_tensor(p0, dtype=dtype, device=dev)
    ptv_t = torch.as_tensor(ptv, dtype=dtype, device=dev)
    before = cuda_lib.launched("mt_restrict0")
    rc = restrict0(tmp, ptc_t, ptv_t)
    torch.cuda.synchronize()
    assert cuda_lib.launched("mt_restrict0") == before + 1
    # another summation order (team partial sums, shuffle tree): rounding of
    # each output's magnitude
    assert float((rc - restrict0_plain(tmp, ptc_t, ptv_t)).abs().max()) <= tol * float(
        restrict0_plain(tmp.abs(), ptc_t, ptv_t.abs()).max())
    lhs, rhs = float((prolong0(ec, agg_t, p0_t) * tmp).sum()), float((ec * rc).sum())
    mag = float((prolong0(ec.abs(), agg_t, p0_t.abs()) * tmp.abs()).sum())
    assert abs(lhs - rhs) <= tol * mag


@pytest.mark.parametrize("n0_mod4", [0, 1, 2, 3])
@pytest.mark.parametrize("agg_aligned", [True, False], ids=["aligned", "agg_offset"])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_prolong_kernel_matches_plain_at_any_n0_and_is_adjoint(n0_mod4, agg_aligned, dtype,
                                                                tol):
    """prolong0 at n0 of every remainder mod 4 (a partial last warp or
    16-byte group, a second u0 row off 16-byte alignment) and with agg one
    element into its storage (no vector loads of it). The restrict0 /
    prolong0 pair stays adjoint."""
    from magnetite_tpu_torch.kernels.transfer_kernel import (
        prolong0, prolong0_plain, restrict0,
    )

    dev = require_cuda()
    n1 = 1001
    agg, p0, ptc, ptv = synthetic_transfer(n1, 14, seed=20 + n0_mod4, n0_mod4=n0_mod4)
    assert agg.size % 4 == n0_mod4
    rng = np.random.default_rng(5)
    ec = torch.as_tensor(rng.standard_normal((n1, 3)), dtype=dtype, device=dev)
    tmp = torch.as_tensor(rng.standard_normal((2, agg.size)), dtype=dtype, device=dev)
    agg_t = torch.as_tensor(np.concatenate([[0], agg]).astype(np.int32), device=dev)
    agg_t = agg_t[1:] if not agg_aligned else agg_t[1:].clone()
    assert (agg_t.data_ptr() % 16 == 0) == agg_aligned
    ptc_t = torch.as_tensor(ptc, device=dev)
    p0_t = torch.as_tensor(p0, dtype=dtype, device=dev)
    ptv_t = torch.as_tensor(ptv, dtype=dtype, device=dev)
    before = cuda_lib.launched("mt_prolong0")
    uf = prolong0(ec, agg_t, p0_t)
    torch.cuda.synchronize()
    assert cuda_lib.launched("mt_prolong0") == before + 1
    # each node's sums in the plain version's order: rounding only
    assert float((uf - prolong0_plain(ec, agg_t, p0_t)).abs().max()) <= tol * float(
        prolong0_plain(ec.abs(), agg_t, p0_t.abs()).max())
    rc = restrict0(tmp, ptc_t, ptv_t)
    lhs, rhs = float((uf * tmp).sum()), float((ec * rc).sum())
    mag = float((prolong0(ec.abs(), agg_t, p0_t.abs()) * tmp.abs()).sum())
    assert abs(lhs - rhs) <= tol * mag


def test_kernels_refuse_what_they_do_not_take():
    from magnetite_tpu_torch.kernels.cuda_lib import KernelError
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec

    dev = require_cuda()
    bands = torch.zeros((1, 2, 2, 64), dtype=torch.float32, device=dev)
    with pytest.raises(KernelError):  # dtype mismatch
        dia_matvec(bands, (0,), torch.zeros((2, 64), dtype=torch.float64, device=dev))
    with pytest.raises(KernelError):  # CPU operand beside a card operand
        dia_matvec(bands, (0,), torch.zeros((2, 64), dtype=torch.float32))
    with pytest.raises(KernelError):  # 4x4 blocks have no instance
        dia_matvec(torch.zeros((1, 4, 4, 64), device=dev), (0,),
                   torch.zeros((4, 64), device=dev))


def assembled_stencil(mesh, dev):
    from magnetite_tpu_torch.fem.stencil import assemble_stencil_structured

    rows, cols = mesh.grid_shape
    return assemble_stencil_structured(
        torch.as_tensor(mesh.coords, device=dev), 69e9, 0.33, 0.5, rows, cols,
        mesh.wrap_cols,
    )


@pytest.mark.parametrize("wrap", [True, False], ids=["annulus_wrap", "rect_cols_101"])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_stencil_kernel_matches_plain(wrap, dtype, tol):
    from magnetite_tpu_torch.kernels.stencil_kernel import stencil_matvec, stencil_matvec_plain
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, rect_mesh

    dev = require_cuda()
    # the annulus wraps its cols; the rectangle's 101 cols are not a
    # multiple of 32, so warps straddle row ends
    mesh = plate_with_hole_mesh(64, 256) if wrap else rect_mesh(100, 40)
    rows, cols = mesh.grid_shape
    st = assembled_stencil(mesh, dev).to(dtype)
    u = torch.as_tensor(np.random.default_rng(12).standard_normal((2, rows, cols)),
                        dtype=dtype, device=dev)
    before = cuda_lib.launched("mt_stencil_matvec")
    y = stencil_matvec(st, u, wrap)
    torch.cuda.synchronize()
    assert cuda_lib.launched("mt_stencil_matvec") == before + 1
    ref = stencil_matvec_plain(st, u, wrap)
    scale = float(stencil_matvec_plain(st.abs(), u.abs(), wrap).max())
    # another summation order: rounding of each output's magnitude
    assert float((y - ref).abs().max()) <= tol * scale


MG_GRIDS = {
    # (mesh, wrap): the annulus wraps its cols; the rectangle's 101 cols are
    # not a multiple of the 16-node tile; 17x32 is the 1M plate's level 5;
    # on the 9x16 annulus a tile's halo wraps onto the tile's own nodes
    "annulus_65x256": (lambda m: m.plate_with_hole_mesh(64, 256), True),
    "rect_41x101": (lambda m: m.rect_mesh(100, 40), False),
    "level5_17x32": (lambda m: m.plate_with_hole_mesh(16, 32), True),
    "narrow_9x16": (lambda m: m.plate_with_hole_mesh(8, 16), True),
}


@pytest.mark.parametrize("grid", sorted(MG_GRIDS))
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_mg_smooth_kernels_match_plain(grid, dtype, tol):
    from magnetite_tpu_torch.fem.multigrid import _center_inverse
    from magnetite_tpu_torch.kernels import mg_smooth_kernel as mgk
    from magnetite_tpu_torch.meshing import generators

    dev = require_cuda()
    make, wrap = MG_GRIDS[grid]
    mesh = make(generators)
    rows, cols = mesh.grid_shape
    st = assembled_stencil(mesh, dev).to(dtype)
    dinv = _center_inverse(st)
    rng = np.random.default_rng(15)
    r, e = (torch.as_tensor(rng.standard_normal((2, rows, cols)), dtype=dtype, device=dev)
            for _ in range(2))
    ec = torch.as_tensor(rng.standard_normal((2, *mgk.coarse_shape(rows, cols, wrap))),
                         dtype=dtype, device=dev)
    neg, ad = -st.abs(), dinv.abs()  # every term adds: the rounding scale
    calls = [
        (lambda: mgk.mg_presmooth(st, dinv, r, wrap), "mt_mg_presmooth",
         mgk.mg_presmooth_plain(st, dinv, r, wrap),
         mgk.mg_presmooth_plain(neg, ad, r.abs(), wrap)),
        (lambda: mgk.mg_postsmooth(st, dinv, r, e, ec, wrap), "mt_mg_postsmooth",
         mgk.mg_postsmooth_plain(st, dinv, r, e, ec, wrap),
         mgk.mg_postsmooth_plain(neg, ad, r.abs(), e.abs(), ec.abs(), wrap)),
        # the coarsest level's smoothing solve: from zero, then from e
        (lambda: mgk.mg_postsmooth(st, dinv, r, None, None, wrap), "mt_mg_postsmooth",
         mgk.mg_postsmooth_plain(st, dinv, r, None, None, wrap),
         mgk.mg_postsmooth_plain(neg, ad, r.abs(), None, None, wrap)),
        (lambda: mgk.mg_postsmooth(st, dinv, r, e, None, wrap), "mt_mg_postsmooth",
         mgk.mg_postsmooth_plain(st, dinv, r, e, None, wrap),
         mgk.mg_postsmooth_plain(neg, ad, r.abs(), e.abs(), None, wrap)),
    ]
    for call, entry, ref, scale in calls:
        before = cuda_lib.launched(entry)
        got = call()
        torch.cuda.synchronize()
        assert cuda_lib.launched(entry) == before + 1
        for g, p, sc in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, ref, scale))):
            # FMA-contracted sums: rounding of each output's magnitude
            assert float((g - p).abs().max()) <= tol * float(sc.max())


def test_mg_smooth_kernels_refuse_what_they_do_not_take():
    from magnetite_tpu_torch.kernels.cuda_lib import KernelError
    from magnetite_tpu_torch.kernels.mg_smooth_kernel import mg_postsmooth, mg_presmooth

    dev = require_cuda()
    st = torch.zeros((9, 2, 2, 17, 32), device=dev)
    dinv = torch.zeros((2, 2, 17, 32), device=dev)
    r = torch.zeros((2, 17, 32), device=dev)
    with pytest.raises(KernelError):  # dtype mismatch
        mg_presmooth(st, dinv, r.double(), True)
    with pytest.raises(KernelError):  # r on another grid
        mg_presmooth(st, dinv, torch.zeros((2, 17, 31), device=dev), True)
    with pytest.raises(KernelError):  # 32 cols do not halve without wrapping
        mg_presmooth(st, dinv, r, False)
    with pytest.raises(KernelError):  # even rows have no coarse grid
        mg_presmooth(st[..., :16, :].contiguous(), dinv[..., :16, :].contiguous(),
                     r[:, :16].contiguous(), True)
    with pytest.raises(KernelError):  # a correction on the wrong coarse grid
        mg_postsmooth(st, dinv, r, r, torch.zeros((2, 9, 15), device=dev), True)
    with pytest.raises(KernelError):  # a CPU operand beside card operands
        mg_postsmooth(st, dinv, r, torch.zeros((2, 17, 32)), None, True)


def test_df_kernel_matches_plain_and_exact_f64():
    from magnetite_tpu_torch.kernels.df_kernel import (
        df_dia_matvec, df_dia_matvec_plain, split_bands,
    )
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec_blocks

    dev = require_cuda()
    n, offsets = 20000, OFFSETS[2]
    bands = torch.as_tensor(random_bands(n, offsets, 2, seed=13), device=dev)
    u = torch.as_tensor(np.random.default_rng(14).standard_normal((2, n)), device=dev)
    hl = split_bands(bands)
    before = cuda_lib.launched("mt_df_dia_matvec")
    y = df_dia_matvec(hl, offsets, u)
    torch.cuda.synchronize()
    assert cuda_lib.launched("mt_df_dia_matvec") == before + 1
    scale = float(dia_matvec_blocks(bands.abs(), offsets, u.abs()).max())
    # the kernel repeats the plain version's f32 operations one for one
    assert float((y - df_dia_matvec_plain(hl, offsets, u)).abs().max()) <= 1e-14 * scale
    # f64-grade: ~2^-46 per term (tests/test_pallas_kernel.py's 1e-13 bar)
    assert float((y - dia_matvec_blocks(bands, offsets, u)).abs().max()) <= 1e-13 * scale


def test_new_kernels_refuse_what_they_do_not_take():
    from magnetite_tpu_torch.kernels.cuda_lib import KernelError
    from magnetite_tpu_torch.kernels.df_kernel import df_dia_matvec
    from magnetite_tpu_torch.kernels.stencil_kernel import stencil_matvec

    dev = require_cuda()
    st = torch.zeros((9, 2, 2, 8, 16), device=dev)
    with pytest.raises(KernelError):  # dtype mismatch
        stencil_matvec(st, torch.zeros((2, 8, 16), dtype=torch.float64, device=dev), True)
    with pytest.raises(KernelError):  # u on another grid
        stencil_matvec(st, torch.zeros((2, 8, 15), device=dev), True)
    with pytest.raises(KernelError):  # f64 bands where hi/lo f32 pairs belong
        df_dia_matvec(torch.zeros((1, 2, 2, 2, 64), dtype=torch.float64, device=dev), (0,),
                      torch.zeros((2, 64), dtype=torch.float64, device=dev))


def test_structured_solve_on_card_matches_cpu():
    from magnetite_tpu_torch import SolverOptions, compile_problem
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect
    from magnetite_tpu_torch.config import ModelMetadata

    require_cuda()
    mesh = plate_with_hole_mesh(32, 64)
    bca = tensile_bcs_for_rect(mesh.coords)
    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.01)
    for opts, bars in (
        (SolverOptions(dtype="float64"), (1e-8, 1e-7)),
        (SolverOptions(dtype="float32", cg_rtol=1e-10), (1e-6, 1e-5)),
    ):
        cpu = compile_problem(mesh, bca, md, opts, device="cpu").solve()
        entries = ("mt_stencil_matvec", "mt_mg_presmooth", "mt_mg_postsmooth")
        before = [cuda_lib.launched(e) for e in entries]
        problem = compile_problem(mesh, bca, md, opts, device="cuda")
        assert (problem.mode, problem.preconditioner) == ("stencil", "multigrid")
        card = problem.solve()
        # the CG operator and both fused V-cycle kernels ran
        after = [cuda_lib.launched(e) for e in entries]
        assert all(a > b for a, b in zip(after, before))
        assert card.residual_rel <= 1e-10
        assert np.abs(card.u - cpu.u).max() <= bars[0] * np.abs(cpu.u).max()
        for field in ("f", "stress", "von_mises"):
            a, b = getattr(card, field), getattr(cpu, field)
            assert np.abs(a - b).max() <= bars[1] * np.abs(b).max(), field


@pytest.mark.parametrize("df", ["on", "interpret"])
def test_mixed_amg_with_df_kernel_on_card_matches_cpu(df):
    """Both df options launch the kernel on the card: the device, not the
    option, picks kernel or plain version."""
    from magnetite_tpu_torch import SolverOptions, compile_problem

    require_cuda()
    mesh, bca, md = port_plate(0.02)
    opts = SolverOptions(dtype="float32", refine="on", cg_rtol=1e-8, df_matvec=df)
    cpu = compile_problem(mesh, bca, md, opts, device="cpu").solve()
    before = cuda_lib.launched("mt_df_dia_matvec")
    problem = compile_problem(mesh, bca, md, opts, device="cuda")
    assert (problem.refine, problem.system.df64, problem.sweeps) == (True, "kernel", 3)
    card = problem.solve()
    assert cuda_lib.launched("mt_df_dia_matvec") > before
    assert abs(card.iterations - cpu.iterations) <= 1
    assert np.abs(card.u - cpu.u).max() <= 1e-6 * np.abs(cpu.u).max()


@pytest.mark.parametrize("kwargs", [{}, {"max_diags": 20}], ids=["dia", "hybrid"])
def test_solve_on_card_matches_cpu(kwargs):
    from magnetite_tpu_torch import SolverOptions, compile_problem

    require_cuda()
    mesh, bca, md = port_plate(0.02)
    opts = SolverOptions(**kwargs)
    cpu = compile_problem(mesh, bca, md, opts, device="cpu").solve()
    entries = ("mt_dia_matvec", "mt_prolong0", "mt_restrict0")
    before = [cuda_lib.launched(e) for e in entries]
    card = compile_problem(mesh, bca, md, opts, device="cuda").solve()
    assert all(cuda_lib.launched(e) > b for e, b in zip(entries, before))
    assert abs(card.iterations - cpu.iterations) <= 1
    # f64 on both, summed in other orders
    assert np.abs(card.u - cpu.u).max() <= 1e-8 * np.abs(cpu.u).max()
    for field in ("f", "stress", "von_mises"):
        a, b = getattr(card, field), getattr(cpu, field)
        assert np.abs(a - b).max() <= 1e-7 * np.abs(b).max(), field


@pytest.mark.parametrize("kwargs", [{}, {"max_diags": 20}], ids=["dia", "hybrid"])
def test_resume_on_card_matches_cpu(tmp_path, kwargs):
    """Files saved by a CPU compile resume on the card: an operator-cache
    hit whose bands, mirrored from the symmetric half on the card, equal the
    CPU's bit for bit, and whose answer matches the CPU's."""
    from magnetite_tpu_torch import SolverOptions, compile_problem, persist

    require_cuda()
    mesh, bca, md = port_plate(0.02)
    cpu_problem = compile_problem(
        mesh, bca, md, SolverOptions(keep_operator_host=True, **kwargs), device="cpu")
    cpu = cpu_problem.solve()
    case = str(tmp_path / "case.npz")
    persist.save_amg(case + ".amg.npz", cpu_problem.amg_setup)
    persist.save_operator(case + ".op.npz", cpu_problem)
    amg = persist.load_amg(case + ".amg.npz")
    problem = compile_problem(
        mesh, bca, md, SolverOptions(**kwargs), amg_setup=amg,
        operator_cache=persist.load_operator(case + ".op.npz"), device="cuda")
    assert problem.timings["operator_cache"] == "hit" and problem.amg_setup is amg
    assert torch.equal(problem.system.bands.cpu(), cpu_problem.system.bands)
    card = problem.solve()
    assert np.abs(card.u - cpu.u).max() <= 1e-6 * np.abs(cpu.u).max()


@pytest.mark.parametrize("structured", [False, True], ids=["amg", "stencil"])
def test_history_and_progress_on_card_match_cpu(structured):
    """residual_history and cg_progress_every on the card: the CPU's
    lengths and iteration numbers, entries within 1e-8 (f64), and the same
    kernel launches as the run without them."""
    from magnetite_tpu_torch import SolverOptions, compile_problem
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect

    require_cuda()
    if structured:
        from magnetite_tpu_torch.config import ModelMetadata

        mesh = plate_with_hole_mesh(32, 64)
        case = (mesh, tensile_bcs_for_rect(mesh.coords), ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.01))
        kernel = "mt_stencil_matvec"
    else:
        case, kernel = port_plate(0.02), "mt_dia_matvec"
    opts = SolverOptions(dtype="float64", residual_history=64, cg_progress_every=4)
    lines = {}

    def run(device, options, key=None):
        seen = []
        import magnetite_tpu_torch.fem.cg as cg

        printer = cg.default_progress_printer
        cg.default_progress_printer = lambda k, r, b: seen.append((int(k), r))
        try:
            before = cuda_lib.launched(kernel)
            res = compile_problem(*case, options, device=device).solve()
        finally:
            cg.default_progress_printer = printer
        lines[key or device] = seen
        return res, cuda_lib.launched(kernel) - before

    cpu, _ = run("cpu", opts)
    card, launches = run("cuda", opts)
    # its own key: this run has no progress lines, and must not replace the card's
    _, plain_launches = run("cuda", SolverOptions(dtype="float64"), "cuda-plain")
    assert launches == plain_launches > 0
    # f64 on both, summed in other orders: the crossing may move by one
    assert abs(card.iterations - cpu.iterations) <= 1
    assert card.residual_history.shape == (min(64, card.iterations),)
    k = min(card.iterations, cpu.iterations, 64)
    got, ref = card.residual_history[:k], cpu.residual_history[:k]
    assert (np.abs(got - ref) <= 1e-8 * np.maximum(ref, 1e-10 * ref.max())).all()
    for device, res in (("cuda", card), ("cpu", cpu)):
        assert [i for i, _ in lines[device]] == list(range(4, res.iterations + 1, 4))


LANE_OFFSETS = (-1300, -512, -200, -199, -37, -1, 0, 1, 37, 199, 200, 512, 1300)
# the C entries of K7's and K8's two routes: ring, direct
K7 = ("mt_lane_dia_ring", "mt_lane_dia_matvec")
K8 = ("mt_lane_dia_ring3", "mt_lane_dia_matvec3")


@pytest.mark.parametrize("nb", [1, 37, 128, 4096])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-6)])
def test_lane_kernel_matches_plain(nb, dtype, tol):
    """K7 on lane fields: N not a multiple of any tile, offsets reaching
    past N (1300 > N / 2 on both sides), any lane count."""
    from magnetite_tpu_torch.kernels.lane_dia_kernel import (
        lane_dia_matvec, lane_dia_matvec_plain,
    )

    dev = require_cuda()
    n = 2011 if nb < 4096 else 997
    bands = torch.as_tensor(random_bands(n, LANE_OFFSETS, 2, seed=20), dtype=dtype, device=dev)
    u = torch.as_tensor(np.random.default_rng(21).standard_normal((2, n, nb)),
                        dtype=dtype, device=dev)
    before = (cuda_lib.launched(*K7), cuda_lib.launched(K7[0]))
    y = lane_dia_matvec(bands, LANE_OFFSETS, u)
    torch.cuda.synchronize()
    # offsets this wide take the direct kernel (lane_window_plan's rule)
    assert (cuda_lib.launched(*K7), cuda_lib.launched(K7[0])) == (before[0] + 1, before[1])
    ref = lane_dia_matvec_plain(bands, LANE_OFFSETS, u)
    scale = float(lane_dia_matvec_plain(bands.abs(), LANE_OFFSETS, u.abs()).max())
    # another summation order (FMA chain per output vs rolled sums)
    assert float((y - ref).abs().max()) <= tol * scale


# the design-sweep plate's 35 band offsets at h = 0.03 (3,774 nodes)
SWEEP_OFFSETS = (-200, -199, -186, -185, -174, -173, -102, -101, -100, -99, -89, -88, -87,
                 -86, -85, -84, -1, 0, 1, 84, 85, 86, 87, 88, 89, 99, 100, 101, 102, 173,
                 174, 185, 186, 199, 200)
RING_CASES = {"plate-b4096": (3774, 4096), "plate-b1000": (3774, 1000),
              "plate-b1": (3774, 1), "n-1001": (1001, 256), "unaligned-u": (3774, 1000)}


@pytest.mark.parametrize("kernel", ["k7", "k8"])
@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lane_ring_kernel_matches_plain(case, dtype, kernel):
    """The ring route of K7 and of K8 (three basis band sets, per-lane
    weights) at the sweep plate's offsets: 4,096, 1,000 and 1 lanes, N a
    multiple of neither the step nor the strip, and a u whose data_ptr is
    not 16-byte aligned (every lane vector takes the scalar path)."""
    from magnetite_tpu_torch.kernels.lane_dia_kernel import (
        lane_dia_matvec, lane_dia_matvec3, lane_dia_matvec3_plain, lane_dia_matvec_plain,
        lane_window_plan,
    )

    dev = require_cuda()
    n, nb = RING_CASES[case]
    sets = 3 if kernel == "k8" else 1
    rng = np.random.default_rng(26)
    u = torch.as_tensor(rng.standard_normal((2, n, nb)), dtype=dtype, device=dev)
    bands = tuple(torch.as_tensor(random_bands(n, SWEEP_OFFSETS, 2, seed=25 + k), dtype=dtype,
                                  device=dev) for k in range(sets))
    w3 = tuple(torch.as_tensor(rng.uniform(0.5, 2.0, nb), dtype=dtype, device=dev)
               for _ in range(3))
    if case == "unaligned-u":
        flat = torch.empty(2 * n * nb + 1, dtype=dtype, device=dev)
        flat[1:].view(2, n, nb).copy_(u)
        u = flat[1:].view(2, n, nb)
        assert u.is_contiguous() and u.data_ptr() % 16 != 0
    plan = lane_window_plan(SWEEP_OFFSETS, n, nb, dtype, sets=sets)
    assert plan.route == "ring"
    if case == "n-1001":
        assert n % plan.rows and n % plan.strip_rows
    if kernel == "k8":
        entries, tol = K8, (1e-13 if dtype == torch.float64 else 1e-5)

        def run(b, v, plain=False):
            fn = lane_dia_matvec3_plain if plain else lane_dia_matvec3
            return fn(b, w3, SWEEP_OFFSETS, v)
    else:
        entries, tol = K7, (1e-13 if dtype == torch.float64 else 1e-6)

        def run(b, v, plain=False):
            fn = lane_dia_matvec_plain if plain else lane_dia_matvec
            return fn(b[0], SWEEP_OFFSETS, v)
    before = (cuda_lib.launched(*entries), cuda_lib.launched(entries[0]))
    y = run(bands, u)
    torch.cuda.synchronize()
    assert (cuda_lib.launched(*entries), cuda_lib.launched(entries[0])) == (before[0] + 1,
                                                                            before[1] + 1)
    ref = run(bands, u, plain=True)
    scale = float(run(tuple(b.abs() for b in bands), u.abs(), plain=True).max())
    # another summation order (FMA chain per output vs rolled sums)
    assert float((y - ref).abs().max()) <= tol * scale


@pytest.mark.parametrize("nb", [1, 37, 128, 4096])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-5)])
def test_material_lane_kernel_matches_plain(nb, dtype, tol):
    """K8's direct kernel: three basis band sets combined with per-lane
    weights, offsets reaching past N."""
    from magnetite_tpu_torch.kernels.lane_dia_kernel import (
        lane_dia_matvec3, lane_dia_matvec3_plain,
    )

    dev = require_cuda()
    n = 2011 if nb < 4096 else 997
    rng = np.random.default_rng(22)
    bands3 = tuple(
        torch.as_tensor(random_bands(n, LANE_OFFSETS, 2, seed=23 + k), dtype=dtype, device=dev)
        for k in range(3)
    )
    w3 = tuple(torch.as_tensor(rng.uniform(0.5, 2.0, nb), dtype=dtype, device=dev)
               for _ in range(3))
    u = torch.as_tensor(rng.standard_normal((2, n, nb)), dtype=dtype, device=dev)
    before = (cuda_lib.launched(*K8), cuda_lib.launched(K8[0]))
    y = lane_dia_matvec3(bands3, w3, LANE_OFFSETS, u)
    torch.cuda.synchronize()
    # offsets this wide take the direct kernel (lane_window_plan's rule)
    assert (cuda_lib.launched(*K8), cuda_lib.launched(K8[0])) == (before[0] + 1, before[1])
    ref = lane_dia_matvec3_plain(bands3, w3, LANE_OFFSETS, u)
    scale = float(lane_dia_matvec3_plain(
        tuple(b.abs() for b in bands3), w3, LANE_OFFSETS, u.abs()).max())
    assert float((y - ref).abs().max()) <= tol * scale


def test_lane_kernels_refuse_what_they_do_not_take():
    from magnetite_tpu_torch.kernels.cuda_lib import KernelError
    from magnetite_tpu_torch.kernels.lane_dia_kernel import lane_dia_matvec, lane_dia_matvec3

    dev = require_cuda()
    bands = torch.zeros((1, 2, 2, 64), device=dev)
    with pytest.raises(KernelError):  # dtype mismatch
        lane_dia_matvec(bands, (0,), torch.zeros((2, 64, 8), dtype=torch.float64, device=dev))
    with pytest.raises(KernelError):  # a single vector where a lane field belongs
        lane_dia_matvec(bands, (0,), torch.zeros((2, 64), device=dev))
    w = torch.ones(8, device=dev)
    with pytest.raises(KernelError):  # weights of another lane count
        lane_dia_matvec3((bands,) * 3, (w, w, torch.ones(7, device=dev)), (0,),
                         torch.zeros((2, 64, 8), device=dev))


@pytest.mark.parametrize("material", [False, True], ids=["load", "material"])
def test_sweep_on_card_matches_cpu(material):
    """A small sweep through the port's entry points, on the card (lane
    kernels) against the CPU (plain versions), at h = 0.04 (a real
    multi-level hierarchy), 64 lanes, f32 V-cycle under f64 CG."""
    from magnetite_tpu_torch.parallel.sweep import (
        compile_unstructured_material_sweep, compile_unstructured_sweep,
    )

    require_cuda()
    mesh, bca, md = port_plate(0.04)
    b = 64
    rng = np.random.default_rng(24)
    if material:
        args = (np.ones(b), np.ones(b), rng.uniform(40e9, 250e9, b),
                rng.uniform(0.22, 0.38, b), rng.uniform(0.2, 1.0, b))
        kernel = K8

        def run(device):
            return compile_unstructured_material_sweep(
                mesh, bca, iterations=20, device=device).solve_factors(*args)
    else:
        args = (rng.uniform(0.5, 2.0, b), np.ones(b), rng.uniform(0.5, 2.0, b))
        kernel = K7

        def run(device):
            return compile_unstructured_sweep(
                mesh, bca, md, iterations=20, device=device).solve_factors(*args)

    cpu = run("cpu")
    before = cuda_lib.launched(*kernel)
    card = run("cuda")
    torch.cuda.synchronize()
    assert cuda_lib.launched(*kernel) > before
    u_cpu, u_card = cpu.u.numpy(), card.u.cpu().numpy()
    assert np.isfinite(u_card).all()
    assert np.abs(u_card - u_cpu).max() <= 1e-5 * np.abs(u_cpu).max()
    rel = (card.residual_norm / card.rhs_norm).cpu().numpy()
    rel_cpu = (cpu.residual_norm / cpu.rhs_norm).numpy()
    assert rel.max() <= max(2.0 * rel_cpu.max(), 1e-4)


def test_sweep_lane_kernel_modes_on_card():
    """The JAX package's `lane_kernel` switch: "interpret" launches the lane
    kernels on the card like "auto"; "off" (the plain versions) is refused
    there."""
    from magnetite_tpu_torch.errors import InputError
    from magnetite_tpu_torch.parallel.sweep import (
        compile_unstructured_material_sweep, compile_unstructured_sweep,
    )

    require_cuda()
    mesh, bca, md = port_plate(0.08)
    b = 8
    ones = np.ones(b)
    load = compile_unstructured_sweep(mesh, bca, md, iterations=4, lane_kernel="interpret")
    mat = compile_unstructured_material_sweep(mesh, bca, iterations=4, lane_kernel="interpret")
    before = (cuda_lib.launched(*K7), cuda_lib.launched(*K8))
    load.solve_factors(ones, ones, ones)
    mat.solve_factors(ones, ones, 69e9 * ones, 0.33 * ones, 0.5 * ones)
    torch.cuda.synchronize()
    assert cuda_lib.launched(*K7) > before[0] and cuda_lib.launched(*K8) > before[1]
    with pytest.raises(InputError, match="lane_kernel='off'"):
        compile_unstructured_sweep(mesh, bca, md, lane_kernel="off")
    with pytest.raises(InputError, match="lane_kernel='off'"):
        compile_unstructured_material_sweep(mesh, bca, lane_kernel="off")


# lane stencil kernel shapes: (rows, cols, wrap, lanes, unaligned u)
LANE_STENCIL_CASES = {
    "bench-33x65-b32": (33, 65, False, 32, False),
    "bench-33x65-b4096": (33, 65, False, 4096, False),
    "bench-33x65-b1000": (33, 65, False, 1000, False),
    "bench-33x65-b1": (33, 65, False, 1, False),
    "wrapped-17x32-b32": (17, 32, True, 32, False),
    "wrapped-33x64-b4096": (33, 64, True, 4096, False),
    "coarse-9x17-b37": (9, 17, False, 37, False),
    "wrapped-9x16-b1": (9, 16, True, 1, False),
    "unaligned-u-17x33-b32": (17, 33, False, 32, True),
}


@pytest.mark.parametrize("sets", [1, 3])
@pytest.mark.parametrize("case", list(LANE_STENCIL_CASES))
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_lane_stencil_kernel_matches_plain(case, dtype, tol, sets):
    """Both instances of the lane stencil kernel (one shared stencil; three
    basis stencils plus the fixed-DOF stencil with per-lane weights) on
    random stencils packed by pack_lane_stencils: wrapped and zero columns,
    one tile of columns or several, B a multiple of the lane slab or not (1
    and 1,000 lanes among them), and a u whose data_ptr is not 16-byte
    aligned (the lane-at-a-time path); each call repeated bit for bit."""
    from magnetite_tpu_torch.kernels.lane_stencil_kernel import (
        lane_material_matvec_plain, lane_stencil_matvec, lane_stencil_matvec3,
        lane_stencil_matvec_plain, pack_lane_stencils,
    )

    dev = require_cuda()
    rows, cols, wrap, nb, unaligned = LANE_STENCIL_CASES[case]
    rng = np.random.default_rng(40)
    st = tuple(torch.as_tensor(rng.standard_normal((9, 2, 2, rows, cols)), dtype=dtype,
                               device=dev) for _ in range(4 if sets == 3 else 1))
    w3 = tuple(torch.as_tensor(rng.uniform(0.5, 2.0, nb), dtype=dtype, device=dev)
               for _ in range(3))
    u = torch.as_tensor(rng.standard_normal((2, rows, cols, nb)), dtype=dtype, device=dev)
    if unaligned:
        flat = torch.empty(u.numel() + 1, dtype=dtype, device=dev)
        flat[1:].view(u.shape).copy_(u)
        u = flat[1:].view(u.shape)
        assert u.is_contiguous() and u.data_ptr() % 16 != 0
    packed = pack_lane_stencils(st if sets == 3 else st[0])
    if sets == 3:
        entry = "mt_lane_stencil_matvec3"

        def run(s, v, plain=False):
            return (lane_material_matvec_plain(s, w3, v, wrap) if plain
                    else lane_stencil_matvec3(packed, w3, v, wrap))
    else:
        entry = "mt_lane_stencil_matvec"

        def run(s, v, plain=False):
            return (lane_stencil_matvec_plain(s[0], v, wrap) if plain
                    else lane_stencil_matvec(packed, v, wrap))
    before = cuda_lib.launched(entry)
    y = run(st, u)
    again = run(st, u)
    torch.cuda.synchronize()
    assert cuda_lib.launched(entry) == before + 2
    assert torch.equal(y, again)
    ref = run(st, u, plain=True)
    scale = float(run(tuple(s.abs() for s in st), u.abs(), plain=True).max())
    assert float((y - ref).abs().max()) <= tol * scale


def test_lane_stencil_kernels_refuse_what_they_do_not_take():
    from magnetite_tpu_torch.kernels.cuda_lib import KernelError
    from magnetite_tpu_torch.kernels.lane_stencil_kernel import (
        PackedStencils, lane_stencil_matvec, lane_stencil_matvec3, pack_lane_stencils,
    )

    dev = require_cuda()
    st = torch.zeros((9, 2, 2, 9, 17), device=dev)
    packed = pack_lane_stencils(st)
    with pytest.raises(KernelError, match="packed"):  # the JAX layout on the card
        lane_stencil_matvec(st, torch.zeros((2, 9, 17, 8), device=dev), False)
    with pytest.raises(KernelError):  # dtype mismatch
        lane_stencil_matvec(packed, torch.zeros((2, 9, 17, 8), dtype=torch.float64, device=dev),
                            False)
    with pytest.raises(KernelError):  # a grid field where a lane field belongs
        lane_stencil_matvec(packed, torch.zeros((2, 9, 17), device=dev), False)
    with pytest.raises(KernelError):  # another grid
        lane_stencil_matvec(packed, torch.zeros((2, 9, 16, 8), device=dev), False)
    with pytest.raises(KernelError, match="packed"):  # S = 1's stencils for S = 3
        lane_stencil_matvec3(packed, (torch.ones(8, device=dev),) * 3,
                             torch.zeros((2, 9, 17, 8), device=dev), False)
    flat = torch.zeros(packed.data.numel() + 1, device=dev)
    with pytest.raises(KernelError, match="aligned"):  # packed stencils off 16 bytes
        lane_stencil_matvec(PackedStencils(flat[1:].view(packed.data.shape)),
                            torch.zeros((2, 9, 17, 8), device=dev), False)
    w = torch.ones(8, device=dev)
    with pytest.raises(KernelError):  # weights of another lane count
        lane_stencil_matvec3(pack_lane_stencils((st,) * 4), (w, w, torch.ones(7, device=dev)),
                             torch.zeros((2, 9, 17, 8), device=dev), False)


def material_coarsest(grid: str, dtype, dev):
    """(coarsest _MaterialLevel, its packed copy, wrap) of the structured
    material sweep compiled on `grid`: rect 33x65 -> 9x17, the wrapped plate
    33x64 -> 9x16, rect 17x33 -> 9x17 with its 17x33 level too."""
    from magnetite_tpu_torch.meshing.generators import (
        plate_with_hole_mesh, rect_mesh, tensile_bcs_for_rect,
    )
    from magnetite_tpu_torch.parallel.sweep import compile_material_sweep

    mesh = {"rect-33x65": lambda: rect_mesh(64, 32, width=2.0),
            "plate-33x64-wrapped": lambda: plate_with_hole_mesh(32, 64),
            "rect-17x33": lambda: rect_mesh(32, 16, width=2.0)}[grid]()
    sweep = compile_material_sweep(mesh, tensile_bcs_for_rect(mesh.coords, pull=0.01),
                                   iterations=2, dtype=str(dtype)[6:], device=dev)
    return sweep.setup[1], sweep.packed[1], bool(mesh.wrap_cols)


@pytest.mark.parametrize("nb", [4096, 1000, 37, 1])
@pytest.mark.parametrize("grid", ["rect-33x65", "plate-33x64-wrapped"])
@pytest.mark.parametrize("dtype,tol,cut", [
    (torch.float64, 1e-12, None), (torch.float64, 1e-12, (5, 32)),
    (torch.float32, 1e-5, None), (torch.float32, 1e-5, (10, 16)),
], ids=["f64", "f64-5x32", "f32", "f32-10x16"])
def test_lane_coarse_smoother_matches_plain(grid, nb, dtype, tol, cut):
    """The fused coarse smoother (48 sweeps in one launch) against its plain
    version at the material sweep's own coarsest levels (9x17, wrapped
    9x16: the first geometry, f32 3 rows x 7 lanes, f64 2 x 3), and at a
    cut of the level above (f32 10x16, f64 5x32: past the first geometry,
    so (1, 2)); real per-lane materials, lane counts no multiple of the
    slab; f32 at 1e-5 and f64 at 1e-12 of max|e| (48 sweeps of sums in
    another order); each call repeated bit for bit."""
    from magnetite_tpu_torch.kernels import lane_coarse_kernel as lc
    from magnetite_tpu_torch.kernels.lane_stencil_kernel import pack_lane_stencils
    from magnetite_tpu_torch.parallel.sweep import _lane_material_center_inv, material_weights

    dev = require_cuda()
    levels, packed, wrap = material_coarsest(grid, dtype, dev)
    level, plevel = levels[-1], packed[-1]
    if cut is not None:
        level = type(level)(*(s[..., : cut[0], : cut[1]].contiguous() for s in levels[-2]))
        plevel = pack_lane_stencils(level)
    rows, cols = level.sa.shape[-2:]
    es = level.sa.element_size()
    assert lc.lane_coarse_route(rows, cols, es) == "fused"
    plan = lc.lane_coarse_plan(rows, cols, es)
    assert (plan.m, plan.lanes) == (lc.GEOMETRIES[es][0][:2] if cut is None else (1, 2))
    rng = np.random.default_rng(42)
    w3 = material_weights(*(torch.as_tensor(rng.uniform(lo, hi, nb), dtype=dtype, device=dev)
                            for lo, hi in ((40e9, 250e9), (0.22, 0.38), (0.2, 1.0))))
    dinv = _lane_material_center_inv(level, *w3)
    r = torch.as_tensor(rng.standard_normal((2, rows, cols, nb)), dtype=dtype, device=dev)
    # the per-sweep route would launch the S = 3 kernel at the level's shape
    coarse = ("mt_lane_coarse_smooth3", "mt_lane_stencil_matvec3")
    before = [cuda_lib.launches[k, dtype, tuple(r.shape)] for k in coarse]
    e = lc.lane_coarse_smooth3(plevel, dinv, w3, r, wrap, 48, 0.7)
    again = lc.lane_coarse_smooth3(plevel, dinv, w3, r, wrap, 48, 0.7)
    torch.cuda.synchronize()
    assert [cuda_lib.launches[k, dtype, tuple(r.shape)] for k in coarse] == [
        before[0] + 2, before[1]]
    assert torch.equal(e, again)
    ref = lc.lane_coarse_smooth3_plain(level, dinv, w3, r, wrap, 48, 0.7)
    assert torch.isfinite(e).all()
    assert float((e - ref).abs().max()) <= tol * float(ref.abs().max())


def test_lane_coarse_smoother_takes_the_per_sweep_route_where_it_does_not_fit():
    """A 17x33 level (1,122 threads a slab) runs as 47 S = 3 launches and
    the torch passes, and matches the plain loop."""
    from magnetite_tpu_torch.kernels import lane_coarse_kernel as lc
    from magnetite_tpu_torch.parallel.sweep import _lane_material_center_inv, material_weights

    dev = require_cuda()
    levels, packed, wrap = material_coarsest("rect-17x33", torch.float64, dev)
    level, plevel = levels[0], packed[0]
    assert lc.lane_coarse_route(17, 33, 8) == "per-sweep"
    rng = np.random.default_rng(43)
    nb = 64
    w3 = material_weights(*(torch.as_tensor(rng.uniform(lo, hi, nb), dtype=torch.float64,
                                            device=dev)
                            for lo, hi in ((40e9, 250e9), (0.22, 0.38), (0.2, 1.0))))
    dinv = _lane_material_center_inv(level, *w3)
    r = torch.as_tensor(rng.standard_normal((2, 17, 33, nb)), device=dev)
    # one per-sweep solve: 47 S = 3 launches at the level's shape, no fused one
    coarse = ("mt_lane_coarse_smooth3", "mt_lane_stencil_matvec3")
    before = [cuda_lib.launches[k, torch.float64, tuple(r.shape)] for k in coarse]
    e = lc.lane_coarse_smooth3(plevel, dinv, w3, r, wrap, 48, 0.7)
    torch.cuda.synchronize()
    assert [cuda_lib.launches[k, torch.float64, tuple(r.shape)] for k in coarse] == [
        before[0], before[1] + 47]
    ref = lc.lane_coarse_smooth3_plain(level, dinv, w3, r, wrap, 48, 0.7)
    assert float((e - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_lane_coarse_smoother_refuses_what_it_does_not_take():
    from magnetite_tpu_torch.kernels.cuda_lib import KernelError
    from magnetite_tpu_torch.kernels.lane_coarse_kernel import lane_coarse_smooth3
    from magnetite_tpu_torch.kernels.lane_stencil_kernel import (
        PackedStencils, pack_lane_stencils,
    )

    dev = require_cuda()
    st = torch.zeros((9, 2, 2, 9, 17), device=dev)
    packed = pack_lane_stencils((st,) * 4)
    w3 = (torch.ones(8, device=dev),) * 3
    dinv = torch.zeros((2, 2, 9, 17, 8), device=dev)
    r = torch.zeros((2, 9, 17, 8), device=dev)
    with pytest.raises(KernelError, match="packed"):  # the JAX layout on the card
        lane_coarse_smooth3((st,) * 4, dinv, w3, r, False, 48, 0.7)
    with pytest.raises(KernelError, match="packed"):  # one stencil, not four
        lane_coarse_smooth3(pack_lane_stencils(st), dinv, w3, r, False, 48, 0.7)
    with pytest.raises(KernelError):  # dtype mismatch
        lane_coarse_smooth3(packed, dinv.double(), w3, r, False, 48, 0.7)
    with pytest.raises(KernelError):  # dinv of another lane count
        lane_coarse_smooth3(packed, dinv[..., :7], w3, r, False, 48, 0.7)
    with pytest.raises(KernelError):  # weights of another lane count
        lane_coarse_smooth3(packed, dinv, (w3[0], w3[1], torch.ones(7, device=dev)), r, False,
                            48, 0.7)
    with pytest.raises(KernelError):  # no sweep
        lane_coarse_smooth3(packed, dinv, w3, r, False, 0, 0.7)
    flat = torch.zeros(packed.data.numel() + 1, device=dev)
    with pytest.raises(KernelError, match="aligned"):  # packed stencils off 16 bytes
        lane_coarse_smooth3(PackedStencils(flat[1:].view(packed.data.shape)), dinv, w3, r,
                            False, 48, 0.7)


@pytest.mark.parametrize("grid", ["rect-17x33", "plate-17x32-wrapped"])
@pytest.mark.parametrize("material", [False, True], ids=["load", "material"])
def test_grid_sweep_on_card_matches_cpu(grid, material):
    """The structured-grid sweeps through their entry points, on the card
    (the lane stencil kernel; the material sweep's coarsest level one fused
    coarse-smoother launch per V-cycle) against the CPU (its plain
    versions), 32 lanes, f64: u within 1e-9 of max|u|."""
    from magnetite_tpu_torch.config import ModelMetadata
    from magnetite_tpu_torch.meshing.generators import (
        plate_with_hole_mesh, rect_mesh, tensile_bcs_for_rect,
    )
    from magnetite_tpu_torch.parallel.sweep import compile_material_sweep, compile_sweep

    require_cuda()
    mesh = rect_mesh(32, 16, width=2.0) if grid == "rect-17x33" else plate_with_hole_mesh(16, 32)
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    b = 32
    rng = np.random.default_rng(41)
    right = np.isclose(mesh.coords[:, 0], mesh.coords[:, 0].max())
    u_values = np.tile(bca.u_value[None], (b, 1, 1))
    u_values[:, right, 0] = rng.uniform(0.005, 0.02, b)[:, None]
    f_values = np.zeros_like(u_values)
    if material:
        args = (u_values, f_values, rng.uniform(40e9, 250e9, b), rng.uniform(0.22, 0.38, b),
                rng.uniform(0.2, 1.0, b))
        kernel = "mt_lane_stencil_matvec3"

        def run(device):
            return compile_material_sweep(mesh, bca, iterations=20, dtype=np.float64,
                                          device=device).solve(*args)
    else:
        args = (u_values, f_values, rng.uniform(0.5, 2.0, b))
        kernel = "mt_lane_stencil_matvec"

        def run(device):
            return compile_sweep(mesh, bca, ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.05),
                                 iterations=20, dtype=np.float64, device=device).solve(*args)

    cpu = run("cpu")
    before = (cuda_lib.launched(kernel), cuda_lib.launched("mt_lane_coarse_smooth3"))
    card = run("cuda")
    torch.cuda.synchronize()
    assert cuda_lib.launched(kernel) > before[0]
    # one fused coarse solve per V-cycle (iterations + 1) on the material sweep
    assert cuda_lib.launched("mt_lane_coarse_smooth3") - before[1] == (21 if material else 0)
    u_cpu, u_card = cpu.u.numpy(), card.u.cpu().numpy()
    assert np.isfinite(u_card).all()
    assert np.abs(u_card - u_cpu).max() <= 1e-9 * np.abs(u_cpu).max()


LANE_ELL_CASES = {  # (nodes, slots per row, lanes, u 16-byte aligned)
    "w12-b4096": (997, 12, 4096, True),
    "w12-b37": (997, 12, 37, True),
    "w12-b1": (997, 12, 1, True),
    "w1-b64": (300, 1, 64, True),
    "w7-b32-unaligned": (501, 7, 32, False),
}


def random_ell(n: int, w: int, seed: int):
    """Random block-ELL rows: distinct random columns in the first slots of
    each row, the rest padding (the row's own node, a zero block)."""
    rng = np.random.default_rng(seed)
    cols = np.repeat(np.arange(n, dtype=np.int32)[:, None], w, 1)
    ell = np.zeros((n, w, 2, 2))
    for row in range(n):
        k = int(rng.integers(1, w + 1))
        cols[row, :k] = np.sort(rng.choice(n, k, replace=False))
        ell[row, :k] = rng.standard_normal((k, 2, 2))
    return ell, cols


@pytest.mark.parametrize("case", list(LANE_ELL_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-6)])
def test_lane_ell_kernel_matches_plain(case, dtype, tol):
    """The lane ELL kernel on random block-ELL operators: W up to 12, B a
    multiple of the lane vector or not, and a u whose data_ptr is not
    16-byte aligned (the scalar path); each call repeated bit for bit."""
    from magnetite_tpu_torch.kernels.lane_ell_kernel import lane_ell_matvec, lane_ell_matvec_plain

    dev = require_cuda()
    n, w, nb, aligned = LANE_ELL_CASES[case]
    ell_np, cols_np = random_ell(n, w, 50)
    ell = torch.as_tensor(ell_np, dtype=dtype, device=dev)
    cols = torch.as_tensor(cols_np, device=dev)
    u = torch.as_tensor(np.random.default_rng(51).standard_normal((2, n, nb)), dtype=dtype,
                        device=dev)
    if not aligned:
        flat = torch.empty(u.numel() + 1, dtype=dtype, device=dev)
        flat[1:].view(u.shape).copy_(u)
        u = flat[1:].view(u.shape)
        assert u.is_contiguous() and u.data_ptr() % 16 != 0
    before = cuda_lib.launched("mt_lane_ell_matvec")
    y, again = lane_ell_matvec(ell, cols, u), lane_ell_matvec(ell, cols, u)
    torch.cuda.synchronize()
    assert cuda_lib.launched("mt_lane_ell_matvec") == before + 2 and torch.equal(y, again)
    ref = lane_ell_matvec_plain(ell, cols, u)
    scale = float(lane_ell_matvec_plain(ell.abs(), cols, u.abs()).max())
    assert float((y - ref).abs().max()) <= tol * scale


def test_lane_ell_kernel_refuses_what_it_does_not_take():
    from magnetite_tpu_torch.kernels.cuda_lib import KernelError
    from magnetite_tpu_torch.kernels.lane_ell_kernel import lane_ell_matvec

    dev = require_cuda()
    ell = torch.zeros((9, 3, 2, 2), device=dev)
    cols = torch.zeros((9, 3), dtype=torch.int32, device=dev)
    u = torch.zeros((2, 9, 8), device=dev)
    with pytest.raises(KernelError):  # dtype mismatch
        lane_ell_matvec(ell, cols, u.double())
    with pytest.raises(KernelError):  # int64 cols
        lane_ell_matvec(ell, cols.long(), u)
    with pytest.raises(KernelError):  # cols of another width
        lane_ell_matvec(ell, cols[:, :2].contiguous(), u)
    with pytest.raises(KernelError):  # a node-major field where a lane field belongs
        lane_ell_matvec(ell, cols, torch.zeros((9, 2), device=dev))
    with pytest.raises(KernelError):  # fewer nodes than the rows
        lane_ell_matvec(ell, cols, torch.zeros((2, 8, 8), device=dev))
    with pytest.raises(KernelError):  # operands on two devices
        lane_ell_matvec(ell.cpu(), cols, u)
    with pytest.raises(KernelError):  # non-contiguous blocks
        lane_ell_matvec(ell.transpose(2, 3), cols, u)


@pytest.mark.parametrize("shuffle", [False, True], ids=["lanes-as-meshed", "vmap-shuffled"])
def test_block_jacobi_sweeps_on_card_match_cpu(shuffle):
    """sweep_solve's DIA lanes (the plate as meshed) and vmap route (its
    nodes shuffled) on the card (K7 / the lane ELL kernel) against the CPU
    (their plain versions), 16 lanes, f64, 400 iterations (converged):
    u within 1e-9 of max|u|."""
    from magnetite_tpu_torch.bc import BCArrays
    from magnetite_tpu_torch.meshing.core import Mesh
    from magnetite_tpu_torch.parallel.sweep import sweep_solve

    require_cuda()
    mesh, bca, md = port_plate(0.08)
    b = 16
    rng = np.random.default_rng(52)
    u_values = np.tile(bca.u_value[None], (b, 1, 1))
    right = np.isclose(mesh.coords[:, 0], 3.0)
    u_values[:, right, 0] = rng.uniform(0.005, 0.02, b)[:, None]
    f_values = np.zeros_like(u_values)
    k_scales = rng.uniform(0.5, 2.0, b)
    kernel = K7
    if shuffle:
        perm = np.random.default_rng(7).permutation(mesh.num_nodes)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        mesh = Mesh(coords=mesh.coords[perm], tris=inv[mesh.tris].astype(np.int32))
        bca = BCArrays(u_known=bca.u_known[perm], u_value=bca.u_value[perm],
                       f_value=bca.f_value[perm])
        u_values, f_values = u_values[:, perm], f_values[:, perm]
        kernel = ("mt_lane_ell_matvec",)

    def run(device):
        return sweep_solve(mesh, bca, md, u_values, f_values, k_scales, iterations=400,
                           dtype=np.float64, device=device)

    cpu = run("cpu")
    before = cuda_lib.launched(*kernel)
    card = run("cuda")
    torch.cuda.synchronize()
    assert cuda_lib.launched(*kernel) == before + 403
    u_cpu, u_card = cpu.u.numpy(), card.u.cpu().numpy()
    assert np.isfinite(u_card).all()
    assert np.abs(u_card - u_cpu).max() <= 1e-9 * np.abs(u_cpu).max()


@pytest.mark.parametrize("case", ["w12", "w1"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-6)])
def test_ell_kernel_matches_plain(case, dtype, tol):
    """The single-vector ELL kernel on random block-ELL operators laid out
    slot-major, against its plain version; each call repeated bit for
    bit."""
    from magnetite_tpu_torch.kernels.ell_kernel import (
        ell_matvec_t, ell_matvec_t_plain, ell_to_slot_major,
    )

    dev = require_cuda()
    n, w = {"w12": (997, 12), "w1": (300, 1)}[case]
    ell_np, cols_np = random_ell(n, w, 60)
    data, cols = ell_to_slot_major(torch.as_tensor(ell_np, dtype=dtype, device=dev),
                                   torch.as_tensor(cols_np, device=dev))
    u = torch.as_tensor(np.random.default_rng(61).standard_normal((2, n)), dtype=dtype,
                        device=dev)
    before = cuda_lib.launched("mt_ell_matvec")
    y, again = ell_matvec_t(data, cols, u), ell_matvec_t(data, cols, u)
    torch.cuda.synchronize()
    assert cuda_lib.launched("mt_ell_matvec") == before + 2 and torch.equal(y, again)
    ref = ell_matvec_t_plain(data, cols, u)
    scale = float(ell_matvec_t_plain(data.abs(), cols, u.abs()).max())
    assert float((y - ref).abs().max()) <= tol * scale


def test_ell_kernel_refuses_what_it_does_not_take():
    from magnetite_tpu_torch.kernels.cuda_lib import KernelError
    from magnetite_tpu_torch.kernels.ell_kernel import ell_matvec_t

    dev = require_cuda()
    data = torch.zeros((3, 2, 2, 9), device=dev)
    cols = torch.zeros((3, 9), dtype=torch.int32, device=dev)
    u = torch.zeros((2, 9), device=dev)
    with pytest.raises(KernelError):  # dtype mismatch
        ell_matvec_t(data, cols, u.double())
    with pytest.raises(KernelError):  # int64 cols
        ell_matvec_t(data, cols.long(), u)
    with pytest.raises(KernelError):  # node-major blocks where slot-major belong
        ell_matvec_t(data.permute(3, 0, 1, 2).contiguous(), cols, u)
    with pytest.raises(KernelError):  # a node-major field
        ell_matvec_t(data, cols, torch.zeros((9, 2), device=dev))
    with pytest.raises(KernelError):  # operands on two devices
        ell_matvec_t(data.cpu(), cols, u)


@pytest.mark.parametrize("kwargs", [{}, {"dtype": "float32", "refine": "on"},
                                    {"preconditioner": "block_jacobi"}],
                         ids=["amg", "mixed", "block_jacobi"])
def test_ell_solve_on_card_matches_cpu(kwargs):
    """operator='ell' on the card: the ELL kernel runs the level-0 operator
    (and with AMG the transfers and the m = 3 band kernel the coarse
    levels, no m = 2 band launch), the CPU's iterations and answer."""
    from magnetite_tpu_torch import SolverOptions, compile_problem

    require_cuda()
    mesh, bca, md = port_plate(0.016)
    opts = SolverOptions(operator="ell", **kwargs)
    cpu = compile_problem(mesh, bca, md, opts, device="cpu").solve()
    before = cuda_lib.launches.copy()
    problem = compile_problem(mesh, bca, md, opts, device="cuda")
    assert problem.mode == "ell"
    card = problem.solve()
    new = cuda_lib.launches - before
    assert cuda_lib.launched("mt_ell_matvec", counts=new) > 0
    assert (cuda_lib.launched("mt_prolong0", counts=new) > 0) == (problem.preconditioner == "amg")
    assert not any(c for (e, _, shape), c in new.items() if e == "mt_dia_matvec" and shape[0] == 2)
    assert abs(card.iterations - cpu.iterations) <= 1
    assert np.abs(card.u - cpu.u).max() <= 1e-8 * np.abs(cpu.u).max()
    for field in ("f", "stress"):
        a, b = getattr(card, field), getattr(cpu, field)
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), field


@pytest.mark.parametrize("dtype,bars", [("float64", (1e-8, 1e-7)), ("float32", (2e-3, 2e-3))])
def test_dense_solve_on_card_matches_cpu(dtype, bars):
    from magnetite_tpu_torch import SolverOptions, compile_problem

    require_cuda()
    mesh, bca, md = port_plate(0.05)
    opts = SolverOptions(dense_cutoff=10_000, dtype=dtype)
    cpu = compile_problem(mesh, bca, md, opts, device="cpu").solve()
    problem = compile_problem(mesh, bca, md, opts, device="cuda")
    assert problem.mode == "dense"
    card = problem.solve()
    assert card.iterations == 0
    assert np.abs(card.u - cpu.u).max() <= bars[0] * np.abs(cpu.u).max()
    for field in ("f", "stress"):
        a, b = getattr(card, field), getattr(cpu, field)
        assert np.abs(a - b).max() <= bars[1] * np.abs(b).max(), field


def assembly_case(kind, h=0.02):
    """(coords, tris, slot ids on the card, n_nodes, n_bands, n_rem, ell,
    material) of the plate's DIA, hybrid (12 bands and a remainder) or ELL
    structure, 0.37 thick."""
    from magnetite_tpu_torch.fem.assembly import build_ell_structure
    from magnetite_tpu_torch.fem.dia import build_dia_structure, build_hybrid_structure

    dev = require_cuda()
    mesh, _, md = port_plate(h)
    n = mesh.num_nodes
    n_rem, ell = 0, kind == "ell"
    if kind == "dia":
        dia = build_dia_structure(mesh.tris, n)
        slot_ids, n_bands = dia.slot_ids, len(dia.offsets)
    elif kind == "hybrid":
        hyb = build_hybrid_structure(mesh.tris, n, max_diags=12)
        slot_ids, n_bands, n_rem = hyb.slot_ids, hyb.n_diags, hyb.n_rem
        assert n_rem > 0
    else:
        ell_s = build_ell_structure(mesh.tris, n)
        slot_ids, n_bands = ell_s.slot_ids, ell_s.cols.shape[1]
    coords = torch.as_tensor(np.asarray(mesh.coords, np.float64), device=dev)
    tris = torch.as_tensor(np.asarray(mesh.tris, np.int64), device=dev)
    ids = torch.as_tensor(np.asarray(slot_ids, np.int64), device=dev)
    # a thickness that is no power of two: each coefficient's division
    # rounds
    mat = (md.youngs_modulus, md.poisson_ratio, 0.37)
    return coords, tris, ids, n, n_bands, n_rem, ell, mat


def sequential_sum(coords, tris, ids, n_slots, mat) -> np.ndarray:
    """[2, 2, S] f64 on the CPU: each slot's pairs added one at a time, in
    pair-major order (p = (3 a + b) E + e), onto 0."""
    from magnetite_tpu_torch.fem.element import pair_block_fields
    from magnetite_tpu_torch.kernels.assembly_kernel import pair_major_slots

    fields = pair_block_fields(coords.cpu(), tris.cpu(), *mat)
    vals = np.stack([f.reshape(-1).numpy() for f in fields])  # [4, 9E] pair-major
    pm = pair_major_slots(ids.cpu(), tris.shape[0]).numpy()
    order = np.argsort(pm, kind="stable")
    lens = np.bincount(pm, minlength=n_slots)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    acc = np.zeros((4, n_slots))
    for r in range(int(lens.max())):
        live = np.nonzero(lens > r)[0]
        acc[:, live] += vals[:, order[starts[live] + r]]
    return acc.reshape(2, 2, n_slots)


@pytest.mark.parametrize("structure", ["dia", "ell"])
def test_assembly_kernel_matches_plain_and_repeats(structure):
    """The device assembly (count, fill and assembly kernels) against its
    plain version (pair_block_fields + four index_add_ + the layout) on the
    card, within 1e-12 of the largest entry, two calls bit for bit (no
    floating-point atomics), one launch of each kernel a call."""
    from magnetite_tpu_torch.kernels.assembly_kernel import (
        assemble_pairs, assemble_pairs_plain,
    )

    coords, tris, ids, n, n_bands, n_rem, ell, mat = assembly_case(structure)
    entries = ("mt_assemble_runs", "mt_assemble_count", "mt_assemble_fill")
    before = [cuda_lib.launched(e) for e in entries]
    got, _ = assemble_pairs(coords, tris, ids, n, n_bands, *mat, ell=ell)
    assert [cuda_lib.launched(e) for e in entries] == [b + 1 for b in before]
    assert torch.equal(got, assemble_pairs(coords, tris, ids, n, n_bands, *mat, ell=ell)[0])
    ref, _ = assemble_pairs_plain(coords, tris, ids, n, n_bands, *mat, ell=ell)
    assert got.shape == ref.shape == (n_bands, 2, 2, n)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["dia", "hybrid", "ell"])
def test_assembly_is_the_sequential_pair_major_sum(kind, dtype):
    """The card's assembly is bit for bit each slot's pairs summed one at a
    time in pair-major order on the CPU (the parent kernel's order), rounded
    once to the output's type, in the operator's layout; two calls agree
    bit for bit."""
    from magnetite_tpu_torch.kernels.assembly_kernel import assemble_pairs, operator_layout

    coords, tris, ids, n, n_bands, n_rem, ell, mat = assembly_case(kind)
    kw = dict(n_rem=n_rem, ell=ell, dtype=dtype)
    bands, rem = assemble_pairs(coords, tris, ids, n, n_bands, *mat, **kw)
    again = assemble_pairs(coords, tris, ids, n, n_bands, *mat, **kw)
    assert torch.equal(bands, again[0]) and torch.equal(rem, again[1])
    flat = torch.from_numpy(sequential_sum(coords, tris, ids, n_bands * n + n_rem, mat))
    want_bands, want_rem = operator_layout(flat, n, n_bands, ell, dtype)
    assert bands.dtype == rem.dtype == dtype
    assert torch.equal(bands.cpu(), want_bands) and torch.equal(rem.cpu(), want_rem)


@pytest.mark.parametrize("kind", ["dia", "ell"])
def test_assembly_runs_match_the_stable_sort(kind):
    """count + cumsum + fill on the card: the bounds are slot_runs' starts,
    each run ordered by pair-major index is slot_runs' run of the
    pair-major slots (the stable sort the parent summed in), and the
    elements' geometry is the plain version's bit for bit."""
    from magnetite_tpu_torch.kernels.assembly_kernel import (
        build_runs, element_geometry, pair_major_slots, slot_runs,
    )

    coords, tris, ids, n, n_bands, _, _, mat = assembly_case(kind)
    n_slots, n_elem = n_bands * n, tris.shape[0]
    bounds, order, geom = build_runs(coords, tris, ids, n_slots, mat[2])
    want_order, want_starts = slot_runs(pair_major_slots(ids, n_elem), n_slots)
    assert torch.equal(bounds.to(torch.int64), want_starts)
    i = order.to(torch.int64)
    key = (i % 9) * n_elem + i // 9  # pair-major index
    # sort each run by key: the runs are contiguous, so sort by (run, key)
    run = torch.repeat_interleave(torch.arange(n_slots, device=i.device),
                                  (bounds[1:] - bounds[:-1]).to(torch.int64))
    ranked = key[torch.argsort(run * (9 * n_elem) + key)]
    assert torch.equal(ranked, want_order)
    assert torch.equal(geom, element_geometry(coords, tris, mat[2]))
    assert torch.equal(geom.cpu(), element_geometry(coords.cpu(), tris.cpu(), mat[2]))


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_two_shard_solve_on_card_matches_cpu(precision):
    """solve_system(device_mesh=) over two shards of cuda:0 against the same
    two shards on the CPU: the band kernel launched at the halo-extended
    shard shape, restrict0 per shard, the same iterations and answer."""
    from magnetite_tpu_torch import SolverOptions
    from magnetite_tpu_torch.fem.solve import solve_system
    from magnetite_tpu_torch.parallel.pipeline import DeviceMesh, compile_sharded_problem

    require_cuda()
    mesh, bca, md = port_plate(0.02)
    kw = {} if precision == "f64" else {"dtype": "float32", "refine": "on"}
    opts = SolverOptions(**kw)
    cpu = solve_system(mesh, bca, md, opts, device_mesh=DeviceMesh(("cpu",) * 2))
    compiled = compile_sharded_problem(mesh, bca, md, opts,
                                       device_mesh=DeviceMesh(("cuda:0",) * 2))
    p = compiled.problem
    before = cuda_lib.launches.copy()
    card = compiled.solve()
    new = cuda_lib.launches - before
    assert {shape[1] for (e, _, shape) in new if e == "mt_dia_matvec" and shape[0] == 2} == {
        p.local_n + 2 * p.halo}
    assert cuda_lib.launched("mt_restrict0", counts=new) > 0
    assert abs(card.iterations - cpu.iterations) <= 1
    assert np.abs(card.u - cpu.u).max() <= 1e-8 * np.abs(cpu.u).max()
    for field in ("f", "stress"):
        a, b = getattr(card, field), getattr(cpu, field)
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), field


@pytest.mark.parametrize("shape", [(8, 5000, 20003), (8, 5001, 20004), (7, 5001, 20004),
                                   (8, 92707, 370828), (8, 500393, 500393)],
                         ids=["k8", "k8-odd-n", "k7-odd-n", "shard", "main"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_ell_kernel_takes_a_longer_field_on_card(dtype, tol, shape):
    """The all-gather path's call: a shard's N rows against the gathered
    field u [2, N_u], N_u > N (4 N, N odd: no multiple of a block; K = 8
    and 7; the h = 0.003 plate's shard), cols global;
    and the 1M plate's ELL mode (N_u = N); each call repeated bit for bit;
    N_u < N is refused."""
    from magnetite_tpu_torch.kernels.cuda_lib import KernelError
    from magnetite_tpu_torch.kernels.ell_kernel import ell_matvec_t, ell_matvec_t_plain

    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    k, n, n_u = shape
    data = torch.randn(k, 2, 2, n, generator=g, device=dev, dtype=torch.float64).to(dtype)
    cols = torch.randint(0, n_u, (k, n), generator=g, device=dev, dtype=torch.int32)
    u = torch.randn(2, n_u, generator=g, device=dev, dtype=torch.float64).to(dtype)
    before = cuda_lib.launched("mt_ell_matvec")
    y = ell_matvec_t(data, cols, u)
    assert cuda_lib.launched("mt_ell_matvec") == before + 1 and tuple(y.shape) == (2, n)
    assert torch.equal(y, ell_matvec_t(data, cols, u))
    ref = ell_matvec_t_plain(data, cols, u)
    scale = float(ell_matvec_t_plain(data.abs(), cols, u.abs()).max())
    assert float((y - ref).abs().max()) <= tol * scale
    with pytest.raises(KernelError):
        ell_matvec_t(data, cols, u[:, : n - 1].contiguous())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_lane_ell_kernel_takes_a_longer_field_on_card(dtype, tol):
    """The all-gather batch solve's call: a shard's N rows against the
    gathered lane fields u [2, N_u, B], N_u > N, cols global, B a multiple
    of the lane vector and not; N_u < N is refused."""
    from magnetite_tpu_torch.kernels.cuda_lib import KernelError
    from magnetite_tpu_torch.kernels.lane_ell_kernel import lane_ell_matvec, lane_ell_matvec_plain

    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(4)
    n, w, n_u = 3000, 8, 12007
    ell = torch.randn(n, w, 2, 2, generator=g, device=dev, dtype=torch.float64).to(dtype)
    cols = torch.randint(0, n_u, (n, w), generator=g, device=dev, dtype=torch.int32)
    for nb in (16, 7):
        u = torch.randn(2, n_u, nb, generator=g, device=dev, dtype=torch.float64).to(dtype)
        before = cuda_lib.launched("mt_lane_ell_matvec")
        y = lane_ell_matvec(ell, cols, u)
        assert cuda_lib.launched("mt_lane_ell_matvec") == before + 1 and tuple(y.shape) == (
            2, n, nb)
        ref = lane_ell_matvec_plain(ell, cols, u)
        scale = float(lane_ell_matvec_plain(ell.abs(), cols, u.abs()).max())
        assert float((y - ref).abs().max()) <= tol * scale
    with pytest.raises(KernelError):
        lane_ell_matvec(ell, cols, u[:, : n - 1].contiguous())


def test_gathered_grid_on_the_host_is_complete():
    """The sharded structured path's answer reaches the host through
    _gather_grid: every tile's copy to the host has landed before the host
    reads it (an asynchronous copy to the CPU returns first), so the host
    grid is the card's bit for bit, call after call."""
    from magnetite_tpu_torch.parallel.stencil_shard import _gather_grid

    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(3)
    tiles = [torch.randn((2, 515, 1026), generator=gen, dtype=torch.float64, device=dev)
             for _ in range(4)]
    cpu = torch.device("cpu")
    for _ in range(5):
        # new values, computed on the card just before the gather reads them
        tiles = [t + 1.0 for t in tiles]
        got = _gather_grid(tiles, (2, 2), [cpu])[cpu]
        assert torch.equal(got, _gather_grid(tiles, (2, 2), [dev])[dev].cpu())


@pytest.mark.parametrize("layout", [2, (2, 2)], ids=["S=2", "2x2"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sharded_structured_solve_on_card_matches_cpu(layout, dtype):
    """compile_sharded_problem on a structured grid over shards of cuda:0
    (rows, or 2 x 2 tiles) against the same layout on the CPU: the stencil
    kernel at the halo-extended tile shape, the fused smoothing kernels on
    the replicated coarse levels, the CPU's answer (f32: refined)."""
    from magnetite_tpu_torch import SolverOptions
    from magnetite_tpu_torch.config import ModelMetadata
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect
    from magnetite_tpu_torch.parallel.pipeline import (
        DeviceMesh, DeviceMesh2D, compile_sharded_problem,
    )

    require_cuda()
    mesh = plate_with_hole_mesh(32, 64)
    bca, md = tensile_bcs_for_rect(mesh.coords), ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.01)
    opts = SolverOptions(dtype=dtype, cg_rtol=1e-8)

    def mesh_on(dev):
        if isinstance(layout, tuple):
            return DeviceMesh2D((dev,) * 4, layout)
        return DeviceMesh((dev,) * layout)

    cpu = compile_sharded_problem(mesh, bca, md, opts, device_mesh=mesh_on("cpu")).solve()
    compiled = compile_sharded_problem(mesh, bca, md, opts, device_mesh=mesh_on("cuda:0"))
    before = cuda_lib.launches.copy()
    card = compiled.solve()
    rl, cl = compiled.problem.reduced[0].shape[-2:]
    tile = (rl + 2, cl + 2 if isinstance(layout, tuple) else cl)
    new = cuda_lib.launches - before
    shapes = {shape[1:] for (e, _, shape) in new if e == "mt_stencil_matvec"}
    assert shapes == {tile} and cuda_lib.launched("mt_mg_postsmooth", counts=new) > 0
    assert abs(card.iterations - cpu.iterations) <= 1
    assert np.abs(card.u - cpu.u).max() <= 1e-6 * np.abs(cpu.u).max()
    assert np.abs(card.stress - cpu.stress).max() <= 1e-5 * np.abs(cpu.stress).max()


def test_lane_sharded_sweeps_on_card_match_unsharded():
    """compile_sweep / compile_unstructured_sweep with device_mesh= over two
    shards of cuda:0: the lane kernels launched twice as often, each lane
    within 1e-12 of the unsharded sweep's (f64)."""
    from magnetite_tpu_torch.config import ModelMetadata
    from magnetite_tpu_torch.meshing.generators import rect_mesh, tensile_bcs_for_rect
    from magnetite_tpu_torch.parallel import sweep as ps
    from magnetite_tpu_torch.parallel.pipeline import DeviceMesh

    require_cuda()
    two = DeviceMesh(("cuda:0",) * 2)
    rng = np.random.default_rng(0)
    b = 64
    grid = rect_mesh(32, 16, width=2.0)
    gb, md = tensile_bcs_for_rect(grid.coords), ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.05)
    u = np.asarray(gb.u_value)[None] * rng.uniform(0.5, 2.0, b)[:, None, None]
    args = (u, np.zeros_like(u), rng.uniform(0.5, 2.0, b))
    mesh, bca, pmd = port_plate(0.04)
    factors = (rng.uniform(0.5, 2.0, b), np.ones(b), rng.uniform(0.5, 2.0, b))
    for kernel, one, sharded, method, a in (
        (("mt_lane_stencil_matvec",),
         ps.compile_sweep(grid, gb, md, iterations=10, dtype=np.float64, device="cuda"),
         ps.compile_sweep(grid, gb, md, iterations=10, dtype=np.float64, device_mesh=two),
         "solve", args),
        (K7,
         ps.compile_unstructured_sweep(mesh, bca, pmd, iterations=10, dtype=np.float64,
                                       device="cuda"),
         None, "solve_factors", factors),
    ):
        if sharded is None:
            sharded = ps.compile_unstructured_sweep(mesh, bca, pmd, iterations=10,
                                                    dtype=np.float64, device_mesh=two,
                                                    amg_setup=one.amg_setup)
        k0 = cuda_lib.launched(*kernel)
        want = getattr(one, method)(*a)
        k1 = cuda_lib.launched(*kernel)
        got = getattr(sharded, method)(*a)
        assert cuda_lib.launched(*kernel) - k1 == 2 * (k1 - k0) > 0
        scale = want.u.abs().amax(dim=(1, 2))
        assert float(((got.u - want.u).abs().amax(dim=(1, 2)) / scale).max()) <= 1e-12


def test_dryrun_multichip_on_card():
    """Every sharded path at tiny shapes over two shards of cuda:0."""
    from magnetite_tpu_torch.dryrun import dryrun_multichip

    require_cuda()
    out = dryrun_multichip(2, device="cuda:0")
    assert out["sweep residual"] < 1e-4
