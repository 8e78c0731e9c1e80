"""Solve observability in the port against the JAX package: the CG
residual history (SolverOptions.residual_history), progress streaming
(cg_progress_every, CLI --cg-progress) and the CLI's --profile trace.

Bars: the same lengths and iteration numbers as the JAX package's; each
history entry within 1e-8 of the JAX entry, relative, in f64, down to the
recurrence's rounding floor (1e-10 of the first residual: below it the two
frameworks' summation orders alone move the residual by more). The AMG
mixed path's CG runs the f32 V-cycle, whose rounding differs between the
frameworks and carries into every later residual: 1e-3 there. Printed
progress lines carry 7 significant digits: 1e-6.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magnetite_tpu
import magnetite_tpu_torch
from magnetite_tpu.fem.cg import pcg as jax_pcg
from magnetite_tpu_torch.fem.cg import CHECK_EVERY, pcg
from tests.test_torch_refine import _structured
from tests.torch_cases import jax_plate, to_port, write_case
from tests.torch_cases import one_thread  # noqa: F401  (autouse)


def _spd_system(n=30, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    return m @ m.T + n * np.eye(n), rng.standard_normal(n)


def _close(got, ref, rel=1e-8):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if ref.size:
        floor = 1e-10 * np.abs(ref).max()
        assert (np.abs(got - ref) <= rel * np.maximum(np.abs(ref), floor)).all()


def _run_both(history, progress_every):
    a, b = _spd_system()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    seen_j, seen_p = [], []
    ref = jax_pcg(lambda v: ja @ v, jb, rtol=1e-10, history=history,
                  progress_every=progress_every,
                  progress_callback=lambda k, r, bn: seen_j.append((int(k), float(r))))
    jax.effects_barrier()
    res = pcg(lambda v: ta @ v, tb, rtol=1e-10, history=history,
              progress_every=progress_every,
              progress_callback=lambda k, r, bn: seen_p.append((int(k), float(r))))
    return ref, res, seen_j, seen_p


def test_pcg_history_and_progress_match_jax():
    ref, res, seen_j, seen_p = _run_both(64, 5)
    k = int(res.iterations)
    assert k == int(ref.iterations) and k < 64
    _close(res.history.numpy(), np.asarray(ref.history))
    assert res.history[k - 1] == res.residual_norm  # the last active write
    assert [i for i, _ in seen_p] == [i for i, _ in seen_j] == list(range(5, k + 1, 5))
    _close([r for _, r in seen_p], [r for _, r in seen_j])


def test_pcg_history_shorter_than_iterations():
    ref, res, _, _ = _run_both(4, 0)
    assert tuple(res.history.shape) == (4,) and int(res.iterations) > 4
    _close(res.history.numpy(), np.asarray(ref.history))
    full = pcg(lambda v: torch.from_numpy(_spd_system()[0]) @ v,
               torch.from_numpy(_spd_system()[1]), rtol=1e-10, history=64)
    np.testing.assert_array_equal(res.history.numpy(), full.history.numpy()[:4])


def test_frozen_iterations_write_nothing_and_the_loop_is_unchanged():
    """The loop runs CHECK_EVERY-step chunks, so iterations after
    convergence run frozen: they write no history entry, report no
    progress, and history / progress change no matvec count."""
    a, b = _spd_system()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    calls = []

    def counting(v):
        calls.append(1)
        return ta @ v

    plain = pcg(counting, tb, rtol=1e-10)
    n_plain = len(calls)
    calls.clear()
    seen = []
    res = pcg(counting, tb, rtol=1e-10, history=64, progress_every=1,
              progress_callback=lambda k, r, bn: seen.append(int(k)))
    k = int(res.iterations)
    assert n_plain == len(calls) == 1 + CHECK_EVERY * -(-k // CHECK_EVERY) > 1 + k
    assert torch.equal(res.x, plain.x) and int(plain.iterations) == k
    assert (res.history[k:] == 0).all() and (res.history[:k] > 0).all()
    assert seen == list(range(1, k + 1))


_DIA = {"preconditioner": "block_jacobi"}
SOLVES = {
    # name: (case, SolverOptions kwargs, relative bar)
    "dia": ("plate", _DIA, 1e-8),
    "hybrid": ("plate", dict(_DIA, max_diags=20), 1e-8),
    "amg": ("plate0.02", {}, 1e-8),
    "amg_mixed": ("plate0.02", {"dtype": "float32", "refine": "on"}, 1e-3),
    "refined": ("plate", dict(_DIA, dtype="float32", refine="on"), 0.0),
    "stencil": ("grid", {"dtype": "float64"}, 1e-8),
    "stencil_refined": ("grid", {"dtype": "float32", "cg_rtol": 1e-10}, 0.0),
}


def _solve_both(case, kwargs):
    if case == "grid":
        (mesh, bca, md), port = _structured(8, 16)
    else:
        h = 0.02 if case == "plate0.02" else 0.05
        mesh, bca, md = jax_plate(h)
        port = to_port(mesh, bca, h)
    ref = magnetite_tpu.solve_system(mesh, bca, md, magnetite_tpu.SolverOptions(**kwargs))
    problem = magnetite_tpu_torch.compile_problem(
        *port, magnetite_tpu_torch.SolverOptions(**kwargs), device="cpu")
    return ref, problem, problem.solve()


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_residual_history_matches_jax(name):
    case, kwargs, rel = SOLVES[name]
    ref, problem, res = _solve_both(case, dict(kwargs, residual_history=64))
    assert res.residual_history.shape == (min(64, res.iterations),)
    if problem.refine and name != "amg_mixed":
        # classic refinement: `history` zeros; its f32 inner solves part
        # between the frameworks by a few iterations (tests/test_torch_refine.py)
        assert min(res.iterations, ref.iterations) >= 64
        _close(res.residual_history, ref.residual_history, rel)
        assert (res.residual_history == 0).all()
    else:
        assert res.iterations == ref.iterations
        _close(res.residual_history, ref.residual_history, rel)
        assert (res.residual_history > 0).all()
        if res.iterations <= 64:
            assert res.residual_history[-1] == pytest.approx(res.residual_norm, rel=1e-12)


def test_stencil_residual_history_defaults_to_jaxs_empty_array():
    ref, problem, res = _solve_both("grid", {"dtype": "float64"})
    assert problem.mode == "stencil"
    assert isinstance(res.residual_history, np.ndarray)
    assert res.residual_history.shape == ref.residual_history.shape == (0,)
    assert res.residual_history.dtype == ref.residual_history.dtype


_LINE = re.compile(r"info: cg iteration (\d+): residual (\S+) \(relative (\S+)\)")


def test_cli_cg_progress_matches_jax(tmp_path, capfd):
    from magnetite_tpu import cli as jax_cli
    from magnetite_tpu_torch import cli as port_cli

    paths = write_case(str(tmp_path), 0.02)  # multi-level AMG, ~17 iterations
    flags = ["--skip", "--backend", "delaunay", "--cg-progress", "2",
             "--out-dir", str(tmp_path)]
    assert jax_cli.main(paths + flags + ["--precision", "f64"]) == 0
    jax.effects_barrier()
    out_j = capfd.readouterr().out
    assert port_cli.main(paths + flags + ["--device", "cpu"]) == 0
    out_p = capfd.readouterr().out
    lines_j, lines_p = _LINE.findall(out_j), _LINE.findall(out_p)
    iters = int(re.search(r"finished conjugate gradient in (\d+)", out_p).group(1))
    assert len(lines_p) == iters // 2 > 5
    assert [k for k, _, _ in lines_p] == [k for k, _, _ in lines_j]
    for col in (1, 2):
        got = np.array([float(t[col]) for t in lines_p])
        ref = np.array([float(t[col]) for t in lines_j])
        assert (np.abs(got - ref) <= 1e-6 * ref).all()


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    from magnetite_tpu_torch import cli

    paths = write_case(str(tmp_path), 0.05)
    trace_dir = tmp_path / "trace"
    assert cli.main(paths + ["--device", "cpu", "--skip", "--out-dir", str(tmp_path),
                             "--profile", str(trace_dir)]) == 0
    assert f"wrote profiler trace to {trace_dir}" in capsys.readouterr().out
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert (tmp_path / "nodes.csv").exists()
