"""Persistence in the port (magnetite_tpu_torch/persist.py and the resume
path of compile_problem) against the JAX package's.

Case, AMG and operator files round-trip in the port and move between the
packages both ways: a file written by either loads in the other with the
same arrays, and a resumed compile in either package is an operator-cache
hit with no AMG rebuild whose answer holds the bars of
tests/test_golden.py:48-55 against the other package's fresh solve
(displacements within 1e-6 of max|u|; forces and stress within 1e-5 of
their max). Cases: the h = 0.02 plate (multi-level AMG), the h = 0.05
plate shuffled (renumbered), and the h = 0.05 plate with max_diags=20
(hybrid).
"""

import numpy as np
import pytest

import magnetite_tpu
import magnetite_tpu.persist as jax_persist
import magnetite_tpu_torch
import magnetite_tpu_torch.persist as persist
from magnetite_tpu_torch.errors import InputError
from magnetite_tpu_torch.fem.solve import OperatorCache
from tests.torch_cases import jax_plate, shuffled, to_port
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

CASES = {
    # name: (h, shuffle, SolverOptions kwargs, expected mode)
    "h0.02_multilevel_amg": (0.02, False, {}, "dia"),
    "h0.05_shuffled_renumbered": (0.05, True, {}, "dia"),
    "h0.05_hybrid": (0.05, False, {"max_diags": 20}, "hybrid"),
}


def _case(name):
    h, shuffle, kwargs, mode = CASES[name]
    mesh, bca, md = jax_plate(h)
    if shuffle:
        mesh, bca = shuffled(mesh, bca)
    return (mesh, bca, md), to_port(mesh, bca, h), kwargs, mode


def _bars(res, ref):
    assert np.abs(res.u - ref.u).max() <= 1e-6 * np.abs(ref.u).max()
    for field in ("f", "stress"):
        a, b = getattr(res, field), getattr(ref, field)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), field


def _port_save(tmp_path, port_case, kwargs):
    """A fresh port compile kept for saving, and the three files' paths."""
    pmesh, pbca, pmd = port_case
    problem = magnetite_tpu_torch.compile_problem(
        pmesh, pbca, pmd,
        magnetite_tpu_torch.SolverOptions(keep_operator_host=True, **kwargs),
        device="cpu",
    )
    case = str(tmp_path / "case.npz")
    persist.save_case(case, pmesh, pbca, metadata=pmd)
    persist.save_amg(case + ".amg.npz", problem.amg_setup)
    persist.save_operator(case + ".op.npz", problem)
    return problem, case


def _assert_same_arrays(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_port_round_trips(tmp_path, name):
    from magnetite_tpu_torch.fem.amg import setup_to_arrays

    _, port_case, kwargs, mode = _case(name)
    pmesh, pbca, pmd = port_case
    problem, case = _port_save(tmp_path, port_case, kwargs)
    assert problem.mode == mode and (problem.perm is not None) == CASES[name][1]

    mesh2, bca2, md2, structure = persist.load_case(case)
    np.testing.assert_array_equal(mesh2.coords, pmesh.coords)
    np.testing.assert_array_equal(mesh2.tris, pmesh.tris)
    for f in ("u_known", "u_value", "f_value"):
        np.testing.assert_array_equal(getattr(bca2, f), getattr(pbca, f))
    assert md2 == pmd and structure is None

    # AMG: every float array comes back as its f32 cast, the rest exactly
    saved = setup_to_arrays(problem.amg_setup)
    loaded = setup_to_arrays(persist.load_amg(case + ".amg.npz"))
    _assert_same_arrays(loaded, {
        k: v.astype(np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64 else v
        for k, v in saved.items()
    })

    op, cache = problem.operator_host, persist.load_operator(case + ".op.npz")
    assert cache.sym_half and op.sym_half
    for f in ("mesh_hash", "material", "mode", "offsets", "sym_half"):
        assert getattr(cache, f) == getattr(op, f), f
    for f in ("flat", "cols", "perm"):
        a, b = getattr(cache, f), getattr(op, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)

    # the resume: a hit, the same bands bit for bit, the same answer
    resumed = magnetite_tpu_torch.compile_problem(
        mesh2, bca2, pmd, magnetite_tpu_torch.SolverOptions(**kwargs),
        amg_setup=persist.load_amg(case + ".amg.npz"), operator_cache=cache, device="cpu",
    )
    assert resumed.timings["operator_cache"] == "hit"
    assert resumed.mode == mode
    np.testing.assert_array_equal(resumed.system.bands.numpy(), problem.system.bands.numpy())
    np.testing.assert_array_equal(resumed.perm, problem.perm)
    _bars(resumed.solve(), problem.solve())


@pytest.mark.parametrize("name", ["h0.05_shuffled_renumbered", "h0.05_hybrid"])
def test_full_flat_operator_round_trips(tmp_path, name):
    """A cache holding every band (sym_half False, as the JAX package keeps
    it for a sign-asymmetric offset set) resumes too: its d >= 0 tail is
    what uploads, and the bands come back the same."""
    _, port_case, kwargs, _ = _case(name)
    problem, _ = _port_save(tmp_path, port_case, kwargs)
    op = problem.operator_host
    n = problem.system.bands.shape[-1]
    flat = problem.system.bands.permute(0, 3, 1, 2).reshape(-1, 4).numpy()
    if problem.mode == "hybrid":
        flat = np.concatenate([flat, problem.system.rem[0].reshape(-1, 4).numpy()])
    assert flat.shape[0] == op.flat.shape[0] + (len(op.offsets) // 2) * n
    full = OperatorCache(
        mesh_hash=op.mesh_hash, material=op.material, mode=op.mode,
        offsets=op.offsets, flat=flat, cols=op.cols, perm=op.perm, sym_half=False,
    )
    path = str(tmp_path / "full.op.npz")
    persist.save_operator(path, full)
    cache = persist.load_operator(path)
    assert not cache.sym_half
    np.testing.assert_array_equal(cache.flat, flat)
    pmesh, pbca, pmd = port_case
    resumed = magnetite_tpu_torch.compile_problem(
        pmesh, pbca, pmd, magnetite_tpu_torch.SolverOptions(**kwargs),
        amg_setup=problem.amg_setup, operator_cache=cache, device="cpu",
    )
    assert resumed.timings["operator_cache"] == "hit"
    assert resumed.timings["upload_bytes"] == op.flat.size * 8
    np.testing.assert_array_equal(resumed.system.bands.numpy(), problem.system.bands.numpy())
    if problem.mode == "hybrid":
        np.testing.assert_array_equal(resumed.system.rem[0].numpy(), problem.system.rem[0].numpy())


def _jax_save(tmp_path, jax_case, kwargs):
    mesh, bca, md = jax_case
    problem = magnetite_tpu.compile_problem(
        mesh, bca, md, magnetite_tpu.SolverOptions(keep_operator_host=True, **kwargs)
    )
    case = str(tmp_path / "jax_case.npz")
    jax_persist.save_case(case, mesh, bca, metadata=md)
    jax_persist.save_amg(case + ".amg.npz", problem.amg_setup)
    jax_persist.save_operator(case + ".op.npz", problem)
    return problem, case


@pytest.mark.parametrize("name", list(CASES))
def test_jax_files_resume_in_the_port(tmp_path, capsys, name):
    jax_case, _, kwargs, mode = _case(name)
    jax_problem, case = _jax_save(tmp_path, jax_case, kwargs)
    ref = jax_problem.solve()
    for suffix in ("", ".amg.npz", ".op.npz"):
        _assert_same_arrays(persist._read_npz(case + suffix), jax_persist._read_npz(case + suffix))

    mesh, bca, md, _ = persist.load_case(case)
    amg = persist.load_amg(case + ".amg.npz")
    capsys.readouterr()
    problem = magnetite_tpu_torch.compile_problem(
        mesh, bca, md, magnetite_tpu_torch.SolverOptions(**kwargs), amg_setup=amg,
        operator_cache=persist.load_operator(case + ".op.npz"), device="cpu",
    )
    assert "warning" not in capsys.readouterr().err  # no rebuild, no miss
    assert problem.timings["operator_cache"] == "hit" and problem.mode == mode
    assert problem.amg_setup is amg  # matched: not rebuilt
    np.testing.assert_array_equal(problem.perm, jax_problem.perm)
    _bars(problem.solve(), ref)


@pytest.mark.parametrize("name", list(CASES))
def test_port_files_resume_in_jax(tmp_path, name):
    jax_case, port_case, kwargs, mode = _case(name)
    problem, case = _port_save(tmp_path, port_case, kwargs)
    ref = problem.solve()
    for suffix in ("", ".amg.npz", ".op.npz"):
        _assert_same_arrays(persist._read_npz(case + suffix), jax_persist._read_npz(case + suffix))

    mesh, bca, md, _ = jax_persist.load_case(case)
    amg = jax_persist.load_amg(case + ".amg.npz")
    jax_problem = magnetite_tpu.compile_problem(
        mesh, bca, md, magnetite_tpu.SolverOptions(**kwargs),
        amg_setup=amg, operator_cache=jax_persist.load_operator(case + ".op.npz"),
    )
    assert jax_problem.timings["operator_cache"] == "hit" and jax_problem.mode == mode
    assert jax_problem.amg_setup is amg  # matched: not rebuilt
    _bars(jax_problem.solve(), ref)


def test_bad_file_is_typed_error(tmp_path):
    path = tmp_path / "junk.npz"
    path.write_bytes(b"not an npz")
    for load, what in ((persist.load_case, "case file"), (persist.load_amg, "AMG cache"),
                       (persist.load_operator, "operator cache")):
        with pytest.raises(InputError, match=f"cannot read {what}"):
            load(str(path))


def _rewrite_version(path: str, version: int) -> None:
    data = {k: np.asarray(v) for k, v in persist._read_npz(path).items()}
    data["format_version"] = np.int64(version)
    persist._write_npz(path, data, compressed=False)


def test_version_rules_match_jax(tmp_path):
    """v1 case files and operator caches load; a v1 (or v2) AMG cache and a
    future version of any kind raise, in both packages alike."""
    (mesh, bca, md), port_case, kwargs, _ = _case("h0.05_hybrid")
    _, case = _port_save(tmp_path, port_case, kwargs)
    for suffix in ("", ".op.npz"):
        _rewrite_version(case + suffix, 1)
    m2, b2, _, _ = persist.load_case(case)
    np.testing.assert_array_equal(m2.coords, mesh.coords)
    np.testing.assert_array_equal(b2.u_known, bca.u_known)
    assert persist.load_operator(case + ".op.npz").mode == "hybrid"
    jax_persist.load_operator(case + ".op.npz")
    for version in (1, 2):
        _rewrite_version(case + ".amg.npz", version)
        for pkg in (persist, jax_persist):
            with pytest.raises(pkg.InputError, match=f"format version {version}"):
                pkg.load_amg(case + ".amg.npz")
    for suffix, load in (("", "load_case"), (".op.npz", "load_operator"),
                         (".amg.npz", "load_amg")):
        _rewrite_version(case + suffix, 99)
        for pkg in (persist, jax_persist):
            with pytest.raises(pkg.InputError, match="format version 99"):
                getattr(pkg, load)(case + suffix)


def test_operator_cache_misses_warn(tmp_path, capsys):
    """A renumbered cache under renumber='off', and a cache of another mesh
    or material, are misses with the JAX package's warnings; the compile
    re-assembles and solves the same system."""
    _, port_case, kwargs, _ = _case("h0.05_shuffled_renumbered")
    pmesh, pbca, pmd = port_case
    problem, case = _port_save(tmp_path, port_case, kwargs)
    cache = persist.load_operator(case + ".op.npz")
    opts = magnetite_tpu_torch.SolverOptions
    capsys.readouterr()

    off = magnetite_tpu_torch.compile_problem(
        pmesh, pbca, pmd, opts(renumber="off"), operator_cache=cache, device="cpu")
    assert off.timings["operator_cache"] == "miss" and off.perm is None
    assert "renumber='off' pins the input order; re-assembling" in capsys.readouterr().err

    stiffer = magnetite_tpu_torch.ModelMetadata(2 * pmd.youngs_modulus, pmd.poisson_ratio,
                                                pmd.part_thickness, 0.0, 0.05)
    other_bca = magnetite_tpu_torch.BCArrays(
        u_known=pbca.u_known.copy(), u_value=pbca.u_value, f_value=pbca.f_value)
    other_bca.u_known[np.argmax(~pbca.u_known.any(axis=1))] = True
    for md, bca in ((stiffer, pbca), (pmd, other_bca)):
        miss = magnetite_tpu_torch.compile_problem(
            pmesh, bca, md, opts(), operator_cache=cache, device="cpu")
        assert miss.timings["operator_cache"] == "miss"
        assert "operator cache does not match this problem" in capsys.readouterr().err
    res = magnetite_tpu_torch.compile_problem(
        pmesh, pbca, stiffer, opts(), operator_cache=cache, device="cpu").solve()
    # twice the modulus, half the forces' response to the same pull: the
    # displacements are the same, the forces twice the fresh solve's
    ref = problem.solve()
    assert np.abs(res.u - ref.u).max() <= 1e-6 * np.abs(ref.u).max()
    assert np.abs(res.f - 2 * ref.f).max() <= 1e-5 * np.abs(2 * ref.f).max()


def test_ell_resume_raises_not_ported(tmp_path):
    """An ELL operator cache written by the JAX package, which the port
    once refused with the typed not-ported error, resumes in the port: a
    hit that skips the structure and the assembly, the JAX cache's values
    and cols on the device, and the answer of the JAX package's own ELL
    solve within the golden bars."""
    (mesh, bca, md), port_case, _, _ = _case("h0.05_hybrid")
    jax_problem = magnetite_tpu.compile_problem(
        mesh, bca, md, magnetite_tpu.SolverOptions(operator="ell", keep_operator_host=True))
    path = str(tmp_path / "ell.op.npz")
    jax_persist.save_operator(path, jax_problem)
    cache = persist.load_operator(path)
    assert cache.mode == "ell" and cache.offsets == () and not cache.sym_half
    problem = magnetite_tpu_torch.compile_problem(*port_case, operator_cache=cache, device="cpu")
    assert (problem.mode, problem.timings["operator_cache"]) == ("ell", "hit")
    n, k = cache.cols.shape
    np.testing.assert_array_equal(problem.system.cols.T.numpy(), cache.cols)
    np.testing.assert_array_equal(
        problem.system.data.permute(3, 0, 1, 2).reshape(n * k, 4).numpy(), cache.flat)
    ref = jax_problem.solve()
    res = problem.solve()
    assert abs(res.iterations - ref.iterations) <= 1
    _bars(res, ref)
