"""The program's spans (`utils/logging.span`): with no profiler running
they cost one check and record nothing; under `torch.profiler` each one is
a named host event of the trace and a line of the in-memory tally, and the
`timings` keys they write keep their names and meanings.

Small plates from the port's own meshers, no JAX: a Delaunay plate that
coarsens once under AMG (the refined f32 V-cycle in f64 CG) and a
structured plate under multigrid (classic refinement). The AMG V-cycle
is V(1, 1): on the CPU every plain band matvec is dozens of profiled ops,
and V(3, 3) doubles them."""

import contextlib
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from magnetite_tpu_torch.config import ModelMetadata, SolverOptions
from magnetite_tpu_torch.fem import amg as amg_mod
from magnetite_tpu_torch.fem import multigrid as mg_mod
from magnetite_tpu_torch.fem.solve import compile_problem
from magnetite_tpu_torch.utils import logging as spans
from tests.torch_cases import HOLE, OUTER
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

MD = ModelMetadata(youngs_modulus=69e9, poisson_ratio=0.33, part_thickness=0.5,
                   characteristic_length_min=0.0, characteristic_length_max=0.045)
AMG_STAGES = ("amg.level0", "amg.aggregate", "amg.tentative", "amg.rho",
              "amg.smooth_prolongator", "amg.transpose", "amg.rap", "amg.coarse_inverse")


def _delaunay():
    from magnetite_tpu_torch.meshing.delaunay_backend import triangulate
    from magnetite_tpu_torch.meshing.generators import tensile_bcs_for_rect

    mesh = triangulate([np.array(OUTER), np.array(HOLE)], 0.0, 0.045)
    opts = SolverOptions(dtype="float32", cg_rtol=1e-8, refine="on", preconditioner="amg",
                         amg_sweeps=1)
    return mesh, tensile_bcs_for_rect(mesh.coords), opts


def _structured():
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect

    mesh = plate_with_hole_mesh(16, 32)
    return mesh, tensile_bcs_for_rect(mesh.coords), SolverOptions(dtype="float32", cg_rtol=1e-8)


# case -> (mesh maker, the V-cycle's span, its module and factory, the
# compile's and the solve's timings keys)
CASES = {
    "delaunay-amg": (_delaunay, "amg.vcycle", amg_mod, "make_amg_preconditioner",
                     {"structure_s", "assemble_s", "amg_build_s", "upload_s", "amg_upload_s"}),
    "structured-mg": (_structured, "mg.vcycle", mg_mod, "vcycle_preconditioner",
                      {"structure_s", "upload_s", "assemble_s", "mg_build_s"}),
}


def _count_applications(monkeypatch, module, factory) -> list:
    """Wraps the preconditioner factory so each application is counted."""
    calls = []
    real = getattr(module, factory)

    def counting(*args, **kwargs):
        apply = real(*args, **kwargs)

        def counted(r):
            calls.append(1)
            return apply(r)

        return counted

    monkeypatch.setattr(module, factory, counting)
    return calls


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function entered for {name!r}")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    spans.reset_spans()
    assert spans.span("a") is spans.span("b")
    with spans.span("a"):
        pass
    timings = {}
    with spans.span("b", timings, "b_s"):
        pass
    assert timings["b_s"] >= 0.0
    assert spans.span_totals() == {}


def test_spans_from_many_threads_keep_their_own_parents(monkeypatch):
    """Each thread's open spans are its own: a child's time goes to its
    own parent, and the tally loses no update. (torch's profiler is on
    for the thread that started it alone, so each thread here is told it
    is on, with a range that records nothing.)"""
    monkeypatch.setattr(spans, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: contextlib.nullcontext())
    threads, rounds = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    spans.reset_spans()

    def work():
        for _ in range(rounds):
            with spans.span("outer"):
                with spans.span("inner"):
                    pass

    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    totals = spans.span_totals()
    spans.reset_spans()
    outer, inner = totals["outer"], totals["inner"]
    assert outer["count"] == inner["count"] == threads * rounds
    assert inner["self_s"] == pytest.approx(inner["total_s"])
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"])
    assert outer["self_s"] >= 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_spans_under_the_profiler(case, monkeypatch, tmp_path):
    make, vcycle, module, factory, compile_keys = CASES[case]
    mesh, bca, opts = make()
    calls = _count_applications(monkeypatch, module, factory)
    real_rf = torch.profiler.record_function

    def refuse(name):
        raise AssertionError(f"record_function entered for {name!r}")

    # with no profiler running the program never enters a named range
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    spans.reset_spans()
    compile_problem(mesh, bca, MD, opts, device="cpu").solve()
    assert spans.span_totals() == {}
    monkeypatch.setattr(torch.profiler, "record_function", real_rf)

    del calls[:]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        problem = compile_problem(mesh, bca, MD, opts, device="cpu")
        res = problem.solve()
    totals = spans.span_totals()
    spans.reset_spans()

    for name in ("solve", "solve.device", "solve.setup", "cg", "solve.recover",
                 "solve.to_host", "compile_problem", "compile.structure"):
        assert totals[name]["count"] == 1, name
    assert totals[vcycle]["count"] == len(calls) > 0
    assert totals["solve.wait"]["count"] >= 2  # a convergence read and the final sync
    if vcycle == "amg.vcycle":
        assert problem.amg_setup.level_sizes[1:], "the plate has to coarsen"
        for name in AMG_STAGES:
            assert totals[name]["count"] >= 1, name
        children = sum(totals[name]["total_s"] for name in AMG_STAGES)
        assert totals["compile.amg_build"]["total_s"] >= children
    else:
        assert totals["compile.mg_build"]["count"] == 1
    for name, t in totals.items():
        assert 0.0 <= t["self_s"] <= t["total_s"], name

    # the trace the CLI's --profile writes names each span as a user
    # annotation
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert set(totals) <= {e["name"] for e in events if e.get("cat") == "user_annotation"}

    assert compile_keys <= set(problem.timings)
    assert {"solve_s"} | compile_keys <= set(res.timings)
    assert res.timings["solve_s"] >= totals["solve.device"]["total_s"] - 1e-3
