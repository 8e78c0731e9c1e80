"""The port runs where JAX does not exist.

The machine with the card has no JAX, so magnetite_tpu_torch must import
and run without it -- directly or through magnetite_tpu, whose
`__init__` imports JAX.
"""

import os
import re
import subprocess
import sys

import numpy as np

from tests.torch_cases import write_case
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import magnetite_tpu_torch
from magnetite_tpu_torch import cli, interop
rc = cli.main(sys.argv[1:])
leaked = [m for m in sys.modules
          if m == "jax" and sys.modules[m] is not None
          or m == "magnetite_tpu" or m.startswith("magnetite_tpu.")]
print("LEAKED", leaked)
sys.exit(rc)
"""


def test_cli_runs_with_jax_unimportable(tmp_path):
    paths = write_case(str(tmp_path), 0.05)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, *paths,
         "--device", "cpu", "--skip", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LEAKED []" in proc.stdout
    nodes = np.loadtxt(tmp_path / "nodes.csv", delimiter=",", skiprows=1)
    assert nodes.shape[1] == 4 and np.isfinite(nodes).all()


_CHILD_STRUCTURED = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import magnetite_tpu_torch as mp
from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect
mesh = plate_with_hole_mesh(16, 32)
bca = tensile_bcs_for_rect(mesh.coords)
md = mp.ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.01)
opts = mp.SolverOptions(dtype="float32", cg_rtol=1e-10)
problem = mp.compile_problem(mesh, bca, md, opts, device="cpu")
res = problem.solve()
leaked = [m for m in sys.modules
          if m == "jax" and sys.modules[m] is not None
          or m == "magnetite_tpu" or m.startswith("magnetite_tpu.")]
print("PATH", problem.mode, problem.preconditioner, problem.refine,
      bool(np.isfinite(res.u).all()), res.residual_rel <= 1e-10)
print("LEAKED", leaked)
"""


def test_structured_path_runs_with_jax_unimportable(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_STRUCTURED],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "PATH stencil multigrid True True True" in proc.stdout
    assert "LEAKED []" in proc.stdout


def test_no_source_file_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from) (jax|magnetite_tpu)\b")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "magnetite_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not sources
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offending = []
    for path in files:
        with open(path) as f:
            offending += [f"{path}:{i}" for i, line in enumerate(f, 1)
                          if pattern.match(line)]
    assert offending == []
