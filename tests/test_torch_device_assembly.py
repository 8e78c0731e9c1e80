"""Device assembly in the port (fem/dia.py::assemble_dia_fused /
assemble_hybrid_fused, fem/solve.py::assemble_ell_arrays_fused, the
assembly kernel's plain version in kernels/assembly_kernel.py, and
`SolverOptions(assembly="device")`) against the JAX package's functions of
the same names on the same inputs; the launch guard of kernels/cuda_lib.py.

Bars: the assembled values within 1e-12 of the largest entry (the same
closed form in the same order, only the summation of a slot's pairs may
differ); solves on the golden bars (tests/test_golden.py:48-55:
displacements within 1e-6 of max|u|, forces and stresses within 1e-5 of
their max) and iterations within +-1.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magnetite_tpu
import magnetite_tpu_torch
from tests.torch_cases import jax_plate, shuffled, to_port
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

H = 0.1  # 431 nodes


@functools.lru_cache(maxsize=None)
def _case(h=H):
    mesh, bca, md = jax_plate(h)
    return (mesh, bca, md), to_port(mesh, bca, h)


def _mesh_tensors(pmesh):
    return (
        torch.from_numpy(np.asarray(pmesh.coords, np.float64)),
        torch.from_numpy(np.asarray(pmesh.tris, np.int64)),
    )


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale


def _material(md):
    return md.youngs_modulus, md.poisson_ratio, md.part_thickness


def test_pair_block_fields_match_jax():
    from magnetite_tpu.fem.element import pair_block_fields as jax_fields
    from magnetite_tpu_torch.fem.element import pair_block_fields

    (mesh, _, md), (pmesh, _, _) = _case()
    coords, tris = _mesh_tensors(pmesh)
    got = pair_block_fields(coords, tris, *_material(md))
    want = jax_fields(jnp.asarray(mesh.coords), jnp.asarray(mesh.tris), *_material(md))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("order", ["meshed", "renumbered"])
def test_assemble_dia_fused_matches_jax(order):
    from magnetite_tpu.fem.dia import assemble_dia_fused as jax_asm
    from magnetite_tpu_torch.fem.dia import assemble_dia_fused, build_dia_structure
    from magnetite_tpu_torch.meshing.reorder import renumber

    (mesh, bca, md), _ = _case()
    if order == "renumbered":  # a shuffled mesh in the band-friendly order
        mesh, bca = shuffled(mesh, bca)
    pmesh, _, _ = to_port(mesh, bca, H)
    if order == "renumbered":
        pmesh = renumber(pmesh)[0]
    dia = build_dia_structure(pmesh.tris, pmesh.num_nodes, max_diags=200)
    coords, tris = _mesh_tensors(pmesh)
    n, d = pmesh.num_nodes, len(dia.offsets)
    got = assemble_dia_fused(coords, tris, *_material(md), torch.from_numpy(dia.slot_ids), n, d)
    want = jax_asm(jnp.asarray(pmesh.coords), jnp.asarray(pmesh.tris), *_material(md),
                   jnp.asarray(dia.slot_ids), n, d)
    _close(got.numpy(), want)


def test_assemble_hybrid_fused_matches_jax():
    from magnetite_tpu.fem.dia import assemble_hybrid_fused as jax_asm
    from magnetite_tpu_torch.fem.dia import assemble_hybrid_fused, build_hybrid_structure

    (mesh, bca, md), (pmesh, _, _) = _case()
    hyb = build_hybrid_structure(pmesh.tris, pmesh.num_nodes, max_diags=12)
    assert hyb.n_rem > 0
    coords, tris = _mesh_tensors(pmesh)
    n, d, r = pmesh.num_nodes, hyb.n_diags, hyb.n_rem
    bands, rem = assemble_hybrid_fused(coords, tris, *_material(md),
                                       torch.from_numpy(hyb.slot_ids), n, d, r)
    w_bands, w_rem = jax_asm(jnp.asarray(mesh.coords), jnp.asarray(mesh.tris), *_material(md),
                             jnp.asarray(hyb.slot_ids), n, d, r)
    scale = max(np.abs(np.asarray(w_bands)).max(), np.abs(np.asarray(w_rem)).max())
    assert np.abs(bands.numpy() - np.asarray(w_bands)).max() <= 1e-12 * scale
    assert np.abs(rem.numpy() - np.asarray(w_rem)).max() <= 1e-12 * scale


def test_assemble_ell_arrays_fused_matches_jax():
    from magnetite_tpu.fem.solve import assemble_ell_arrays_fused as jax_asm
    from magnetite_tpu_torch.fem.assembly import build_ell_structure
    from magnetite_tpu_torch.fem.solve import assemble_ell_arrays_fused

    (mesh, _, md), (pmesh, _, _) = _case()
    ell = build_ell_structure(pmesh.tris, pmesh.num_nodes)
    coords, tris = _mesh_tensors(pmesh)
    n, k = pmesh.num_nodes, ell.cols.shape[1]
    got = assemble_ell_arrays_fused(coords, tris, *_material(md),
                                    torch.from_numpy(np.asarray(ell.slot_ids)), n, k)
    want = jax_asm(jnp.asarray(mesh.coords), jnp.asarray(mesh.tris), *_material(md),
                   jnp.asarray(ell.slot_ids), n, k)
    _close(got.numpy(), want)


def test_slot_runs_order_each_slot_in_pair_major_order():
    from magnetite_tpu_torch.kernels.assembly_kernel import slot_runs

    slots = torch.tensor([3, 0, 3, 1, 0, 3], dtype=torch.int64)
    order, starts = slot_runs(slots, 5)
    assert order.tolist() == [1, 4, 3, 0, 2, 5]
    assert starts.tolist() == [0, 2, 3, 3, 6, 6]


@pytest.mark.parametrize("operator", ["dia", "hybrid", "ell"])
def test_device_assembly_matches_host_assembly(operator):
    from magnetite_tpu_torch.fem.solve import compile_problem

    _, (pmesh, pbca, pmd) = _case()
    kw = {"dia": {}, "hybrid": {"max_diags": 12}, "ell": {"operator": "ell"}}[operator]
    opts = magnetite_tpu_torch.SolverOptions(**kw)
    host = compile_problem(pmesh, pbca, pmd, opts, device="cpu")
    dev = compile_problem(pmesh, pbca, pmd,
                          magnetite_tpu_torch.SolverOptions(assembly="device", **kw),
                          device="cpu")
    assert host.mode == dev.mode == operator
    assert "assemble_device_s" in dev.timings and "assemble_device_s" not in host.timings
    if operator == "ell":
        pairs = [(host.system.data, dev.system.data)]
        assert torch.equal(host.system.cols, dev.system.cols)
    else:
        pairs = [(host.system.bands, dev.system.bands)]
        if operator == "hybrid":
            pairs.append((host.system.rem[0], dev.system.rem[0]))
    scale = max(float(a.abs().max()) for a, _ in pairs)
    for a, b in pairs:
        assert float((a - b).abs().max()) <= 1e-12 * scale
    r_host, r_dev = host.solve(), dev.solve()
    assert abs(r_host.iterations - r_dev.iterations) <= 1
    _close(r_dev.u, r_host.u, 1e-10)


def test_device_assembly_keeps_and_uses_no_operator_cache():
    from magnetite_tpu_torch.fem.solve import compile_problem

    _, (pmesh, pbca, pmd) = _case()
    kept = compile_problem(pmesh, pbca, pmd,
                           magnetite_tpu_torch.SolverOptions(keep_operator_host=True),
                           device="cpu")
    assert kept.operator_host is not None
    dev = compile_problem(
        pmesh, pbca, pmd,
        magnetite_tpu_torch.SolverOptions(assembly="device", keep_operator_host=True),
        operator_cache=kept.operator_host, device="cpu",
    )
    assert dev.operator_host is None and "operator_cache" not in dev.timings
    assert "assemble_device_s" in dev.timings


@functools.lru_cache(maxsize=None)
def _jax_device_solve(h, precision):
    mesh, bca, md = jax_plate(h)
    kw = {"f64": {}, "refined": {"dtype": "float32", "refine": "on"}}[precision]
    opts = magnetite_tpu.SolverOptions(assembly="device", cg_rtol=1e-10,
                                       preconditioner="amg", **kw)
    return magnetite_tpu.fem.solve.solve_system(mesh, bca, md, opts)


@pytest.mark.parametrize("precision", ["f64", "refined"])
def test_device_assembled_solve_matches_jax(precision):
    from magnetite_tpu_torch.fem.solve import compile_problem

    h = 0.04  # 2,179 nodes: the AMG hierarchy coarsens
    want = _jax_device_solve(h, precision)
    _, (pmesh, pbca, pmd) = _case(h)
    kw = {"f64": {}, "refined": {"dtype": "float32", "refine": "on"}}[precision]
    opts = magnetite_tpu_torch.SolverOptions(assembly="device", cg_rtol=1e-10,
                                             preconditioner="amg", **kw)
    problem = compile_problem(pmesh, pbca, pmd, opts, device="cpu")
    got = problem.solve()
    assert problem.timings["amg_levels"][0][0] == pmesh.num_nodes
    assert len(problem.timings["amg_levels"]) > 1
    if precision == "refined":
        assert abs(got.iterations - want.iterations) <= 1
    for name, tol in (("u", 1e-6), ("f", 1e-5), ("stress", 1e-5), ("von_mises", 1e-5)):
        a, b = getattr(got, name), getattr(want, name)
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), name


def test_unknown_assembly_raises():
    from magnetite_tpu_torch.errors import InputError
    from magnetite_tpu_torch.fem.solve import compile_problem

    _, (pmesh, pbca, pmd) = _case()
    with pytest.raises(InputError, match="unknown assembly mode 'gpu'"):
        compile_problem(pmesh, pbca, pmd, magnetite_tpu_torch.SolverOptions(assembly="gpu"),
                        device="cpu")


def test_assembly_wrapper_takes_the_plain_version_on_the_cpu():
    from magnetite_tpu_torch.kernels import assembly_kernel

    (_, _, md), (pmesh, _, _) = _case()
    coords, tris = _mesh_tensors(pmesh)
    slots = torch.arange(9 * tris.shape[0], dtype=torch.int64) % 97
    before = assembly_kernel.assemble_pairs.launches
    got = assembly_kernel.assemble_pairs(coords, tris, slots, 97, *_material(md))
    want = assembly_kernel.assemble_pairs_plain(coords, tris, slots, 97, *_material(md))
    assert torch.equal(got, want) and got.shape == (2, 2, 97)
    assert assembly_kernel.assemble_pairs.launches == before


def test_launch_enters_the_operands_device(monkeypatch):
    """cuda_lib.launch makes the operand's device current around the C
    call and passes that device's stream (a shard on cuda:1 launches on
    cuda:1), with the device guard and the library stubbed on the CPU."""
    from magnetite_tpu_torch.kernels import cuda_lib

    current = []
    entered = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)
            current.append(self.device)

        def __exit__(self, *exc):
            current.pop()

    calls = []

    def entry(*args):
        calls.append((args, current[-1] if current else None))
        return 0

    lib = types.SimpleNamespace(mt_probe=entry, mt_error_string=lambda rc: b"stub")
    monkeypatch.setattr(cuda_lib, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(cuda_lib, "stream_of", lambda t: 1234 + t.device.index)
    operand = types.SimpleNamespace(device=torch.device("cuda", 1))
    cuda_lib.launch("probe", "mt_probe", operand, 7, 8)
    assert entered == [torch.device("cuda", 1)]
    assert calls == [((7, 8, 1235), torch.device("cuda", 1))]
    assert current == []


def test_every_wrapper_launches_through_the_guard():
    """No kernel wrapper calls a C entry itself: each goes through
    cuda_lib.launch, so each enters its operands' device."""
    import pathlib

    import magnetite_tpu_torch.kernels as kernels

    for path in pathlib.Path(kernels.__file__).parent.glob("*.py"):
        if path.name == "cuda_lib.py":
            continue
        src = path.read_text()
        assert "lib.mt_" not in src and "stream_of(" not in src, path.name
        if "_lib.launch(" in src or path.name == "__init__.py":
            continue
        assert "cuda_lib" not in src, path.name
