"""The hand-written CUDA kernels on the card, against their plain PyTorch
versions, and the port on the card against the port on the CPU: the
banded path, the structured (stencil + multigrid) path and mixed precision
with the double-float band kernel.

Every test here needs a CUDA device and skips itself without one. The file
imports no JAX and no other test module (tests/conftest.py imports JAX), so
it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

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
    before = dia_matvec.launches
    y = dia_matvec(bands, offsets, u)
    torch.cuda.synchronize()
    assert dia_matvec.launches == before + 1
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
    before = stencil_matvec.launches
    y = stencil_matvec(st, u, wrap)
    torch.cuda.synchronize()
    assert stencil_matvec.launches == before + 1
    ref = stencil_matvec_plain(st, u, wrap)
    scale = float(stencil_matvec_plain(st.abs(), u.abs(), wrap).max())
    # another summation order: rounding of each output's magnitude
    assert float((y - ref).abs().max()) <= tol * scale


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
    before = df_dia_matvec.launches
    y = df_dia_matvec(hl, offsets, u)
    torch.cuda.synchronize()
    assert df_dia_matvec.launches == before + 1
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
    from magnetite_tpu_torch.kernels.stencil_kernel import stencil_matvec
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
        before = stencil_matvec.launches
        problem = compile_problem(mesh, bca, md, opts, device="cuda")
        assert (problem.mode, problem.preconditioner) == ("stencil", "multigrid")
        card = problem.solve()
        assert stencil_matvec.launches > before
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
    from magnetite_tpu_torch.kernels.df_kernel import df_dia_matvec

    require_cuda()
    mesh, bca, md = port_plate(0.02)
    opts = SolverOptions(dtype="float32", refine="on", cg_rtol=1e-8, df_matvec=df)
    cpu = compile_problem(mesh, bca, md, opts, device="cpu").solve()
    before = df_dia_matvec.launches
    problem = compile_problem(mesh, bca, md, opts, device="cuda")
    assert (problem.refine, problem.df64, problem.sweeps) == (True, "kernel", 3)
    card = problem.solve()
    assert df_dia_matvec.launches > before
    assert abs(card.iterations - cpu.iterations) <= 1
    assert np.abs(card.u - cpu.u).max() <= 1e-6 * np.abs(cpu.u).max()


@pytest.mark.parametrize("kwargs", [{}, {"max_diags": 20}], ids=["dia", "hybrid"])
def test_solve_on_card_matches_cpu(kwargs):
    from magnetite_tpu_torch import SolverOptions, compile_problem
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec
    from magnetite_tpu_torch.kernels.transfer_kernel import prolong0, restrict0

    require_cuda()
    mesh, bca, md = port_plate(0.02)
    opts = SolverOptions(**kwargs)
    cpu = compile_problem(mesh, bca, md, opts, device="cpu").solve()
    kernels = (dia_matvec, prolong0, restrict0)
    before = [k.launches for k in kernels]
    card = compile_problem(mesh, bca, md, opts, device="cuda").solve()
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert abs(card.iterations - cpu.iterations) <= 1
    # f64 on both, summed in other orders
    assert np.abs(card.u - cpu.u).max() <= 1e-8 * np.abs(cpu.u).max()
    for field in ("f", "stress", "von_mises"):
        a, b = getattr(card, field), getattr(cpu, field)
        assert np.abs(a - b).max() <= 1e-7 * np.abs(b).max(), field
