"""The port's four examples (examples/torch_*.py) run on the CPU with JAX
unimportable, each in a child process at a small size, and print their
result lines; the multichip example's own 1e-6 parity assertion against
`solve_system` holds over two CPU shards."""

import os
import re
import subprocess
import sys

import pytest

from tests.torch_cases import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import runpy, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
path = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
leaked = [m for m in sys.modules
          if m == "jax" and sys.modules[m] is not None
          or m == "magnetite_tpu" or m.startswith("magnetite_tpu.")]
print("LEAKED", leaked)
"""

CASES = {
    "torch_plate_benchmark.py": (
        ["16", "32"],
        [r"^prep: \S+s \(operator=stencil, preconditioner=multigrid, refine=True\)$",
         r"^solve: \S+s \(device \S+s\), \d+ inner iterations, relative residual (\S+)$",
         r"^max \|u\| = 1\.0000e-02, max von Mises = \S+$"]),
    "torch_unstructured_plate.py": (
        ["0.05"],
        [r"^prepared in \S+s \(operator=dia, preconditioner=amg, amg levels=",
         r"^warm solve: \S+s \(device \S+s\), \d+ CG iterations, relative residual (\S+)$",
         r"^max \|u\| = 1\.0000e-02, max von Mises = \S+$"]),
    "torch_design_sweep.py": (
        ["8"],
        [r"^8 variants in \S+s -> \d+ solves/s$",
         r"^worst relative residual: \S+$",
         r"^highest-stress variant: pull=\S+, k_scale=\S+, max von Mises=\S+$",
         r"^material sweep: 8 \(E, nu, t\) variants in \S+s -> \d+ solves/s, "
         r"worst rel residual \S+$"]),
    "torch_multichip_pipeline.py": (
        ["0.05", "--shards", "2"],
        [r"^device mesh: 2 x cpu$",
         r"^sharded pipeline: prep \S+ s, solve\+recovery \S+ s, \d+ iterations, "
         r"relative residual (\S+)$"]
        + [rf"^ +{f}: max relative diff \S+  ok$"
           for f in ("u", "f", "sigma", "stress", "von_mises")]),
}


@pytest.mark.parametrize("script", list(CASES))
def test_example_runs_on_the_cpu_without_jax(script, tmp_path):
    args, patterns = CASES[script]
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)  # the example finds the repo itself
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, os.path.join(REPO, "examples", script), *args,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert "LEAKED []" in lines
    for pattern in patterns:
        hit = [m for m in (re.match(pattern, line) for line in lines) if m]
        assert hit, (pattern, proc.stdout)
        if hit[0].groups():  # the plates' relative residual, solved to 1e-8
            assert float(hit[0].group(1)) <= 1e-8, hit[0].group(0)
