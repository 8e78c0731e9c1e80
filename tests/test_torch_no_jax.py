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


_CHILD_SWEEP = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
from magnetite_tpu_torch.bc import apply_boundary_conditions
from magnetite_tpu_torch.config import (
    BoundaryRegion, BoundaryRule, BoundaryTarget, ModelMetadata,
)
from magnetite_tpu_torch.meshing.delaunay_backend import triangulate
from magnetite_tpu_torch.parallel.sweep import compile_unstructured_sweep
outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
mesh = triangulate([outer], 0.0, 0.08)
rules = (
    BoundaryRule("left", BoundaryRegion(x_max=1e-6), BoundaryTarget(ux=0.0, uy=0.0)),
    BoundaryRule("right", BoundaryRegion(x_min=3.0 - 1e-6), BoundaryTarget(ux=0.01, fy=0.0)),
)
bca = apply_boundary_conditions(mesh.coords, rules)
md = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.08)
sweep = compile_unstructured_sweep(mesh, bca, md, iterations=8, device="cpu")
res = sweep.solve_factors(np.array([1.0, 2.0]), np.ones(2), np.array([1.0, 0.5]))
rel = (res.residual_norm / res.rhs_norm).numpy()
leaked = [m for m in sys.modules
          if m == "jax" and sys.modules[m] is not None
          or m == "magnetite_tpu" or m.startswith("magnetite_tpu.")]
print("SWEEP", tuple(res.u.shape) == (2, mesh.num_nodes, 2),
      bool(np.isfinite(res.u.numpy()).all()), bool(rel.max() <= 1e-6))
print("LEAKED", leaked)
"""


def test_sweep_runs_with_jax_unimportable(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_SWEEP],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "SWEEP True True True" in proc.stdout
    assert "LEAKED []" in proc.stdout


_CHILD_GRID_SWEEPS = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
from magnetite_tpu_torch.config import ModelMetadata
from magnetite_tpu_torch.meshing.generators import rect_mesh, tensile_bcs_for_rect
from magnetite_tpu_torch.parallel.sweep import compile_material_sweep, compile_sweep
mesh = rect_mesh(32, 16, width=2.0)
bca = tensile_bcs_for_rect(mesh.coords)
u = np.tile(bca.u_value[None], (2, 1, 1))
f = np.zeros_like(u)
load = compile_sweep(mesh, bca, ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.05), iterations=20,
                     dtype=np.float64, device="cpu").solve(u, f, np.array([1.0, 2.0]))
mat = compile_material_sweep(mesh, bca, iterations=10, dtype=np.float64, device="cpu").solve(
    u, f, np.array([69e9, 200e9]), np.array([0.33, 0.25]), np.array([0.5, 1.0]))
ok = [bool(np.isfinite(r.u.numpy()).all()) and tuple(r.u.shape) == (2, mesh.num_nodes, 2)
      for r in (load, mat)]
rel = (load.residual_norm / load.rhs_norm).numpy()
leaked = [m for m in sys.modules
          if m == "jax" and sys.modules[m] is not None
          or m == "magnetite_tpu" or m.startswith("magnetite_tpu.")]
print("GRID SWEEPS", ok, bool(rel.max() <= 1e-10))
print("LEAKED", leaked)
"""


def test_grid_sweeps_run_with_jax_unimportable(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_GRID_SWEEPS],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "GRID SWEEPS [True, True] True" in proc.stdout
    assert "LEAKED []" in proc.stdout


_CHILD_LANE_SWEEPS = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
from magnetite_tpu_torch.bc import BCArrays, apply_boundary_conditions
from magnetite_tpu_torch.config import (
    BoundaryRegion, BoundaryRule, BoundaryTarget, ModelMetadata,
)
from magnetite_tpu_torch.fem.dia import build_dia_structure
from magnetite_tpu_torch.meshing.core import Mesh
from magnetite_tpu_torch.meshing.delaunay_backend import triangulate
from magnetite_tpu_torch.parallel.sweep import sweep_solve
outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
mesh = triangulate([outer], 0.0, 0.15)
rules = (
    BoundaryRule("left", BoundaryRegion(x_max=1e-6), BoundaryTarget(ux=0.0, uy=0.0)),
    BoundaryRule("right", BoundaryRegion(x_min=3.0 - 1e-6), BoundaryTarget(ux=0.01, fy=0.0)),
)
bca = apply_boundary_conditions(mesh.coords, rules)
md = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.15)
perm = np.random.default_rng(7).permutation(mesh.num_nodes)
inv = np.empty_like(perm)
inv[perm] = np.arange(perm.size)
smesh = Mesh(coords=mesh.coords[perm], tris=inv[mesh.tris].astype(np.int32))
sbca = BCArrays(u_known=bca.u_known[perm], u_value=bca.u_value[perm], f_value=bca.f_value[perm])
u = np.tile(bca.u_value[None], (2, 1, 1)) * np.array([1.0, 2.0])[:, None, None]
f, k = np.zeros_like(u), np.array([1.0, 0.5])
lanes = sweep_solve(mesh, bca, md, u, f, k, iterations=400, dtype=np.float64, device="cpu")
vmapped = sweep_solve(smesh, sbca, md, u[:, perm], f[:, perm], k, iterations=400,
                      dtype=np.float64, device="cpu")
rel = (lanes.residual_norm / lanes.rhs_norm).numpy()
agree = np.abs(lanes.u.numpy() - vmapped.u.numpy()[:, inv]).max() <= 1e-8 * np.abs(
    lanes.u.numpy()).max()
leaked = [m for m in sys.modules
          if m == "jax" and sys.modules[m] is not None
          or m == "magnetite_tpu" or m.startswith("magnetite_tpu.")]
routes = (build_dia_structure(mesh.tris, mesh.num_nodes) is not None,  # the lanes
          build_dia_structure(smesh.tris, mesh.num_nodes) is None)  # vmap
print("LANE SWEEPS", routes == (True, True), tuple(lanes.u.shape) == (2, mesh.num_nodes, 2),
      bool(np.isfinite(lanes.u.numpy()).all()), bool(rel.max() <= 1e-10), bool(agree))
print("LEAKED", leaked)
"""


def test_lane_sweeps_run_with_jax_unimportable(tmp_path):
    """sweep_solve's auto route on a small plate as meshed (the DIA lanes)
    and with its nodes shuffled (the vmap route), converged, agreeing."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_LANE_SWEEPS],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LANE SWEEPS True True True True True" in proc.stdout
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
