"""magnetite_tpu_torch -- the PyTorch / CUDA port of magnetite_tpu.

2D plane-stress FEA on one NVIDIA GPU: SVG/CSV geometry -> built-in
Delaunay mesh -> banded (DIA / hybrid) stiffness operator -> CG
preconditioned by smoothed-aggregation AMG or block-Jacobi -> stress
recovery -> CSV; structured grids take a 9-point stencil operator with
geometric multigrid; f64, f32 or mixed precision (f64 residuals around f32
inner solves). The host front end (geometry, meshing, boundary
conditions, C++ assembly, AMG setup) is a copy of the JAX package's, kept
byte-identical in output by tests; the device half is PyTorch, with
hand-written CUDA kernels for the band matvec, the double-float band
matvec, the stencil matvec and the level-0 AMG transfers. This package
never imports JAX.
"""

from .utils.hostmem import tune_glibc_malloc as _tune_glibc_malloc

# Large numpy temporaries (meshing, assembly, AMG setup) otherwise pay a
# kernel mmap/fault/munmap round trip per allocation; see utils/hostmem.py.
_tune_glibc_malloc()

from .config import (
    BoundaryRegion,
    BoundaryRule,
    BoundaryTarget,
    ModelMetadata,
    SimulationInput,
    SolverOptions,
    load_simulation_input,
    parse_simulation_input,
)
from .errors import (
    InputError,
    MagnetiteError,
    MesherError,
    PostProcessorError,
    SolverError,
)
from .bc import BCArrays, apply_boundary_conditions
from .meshing.core import Mesh, normalize_orientation, signed_areas
from .fem.solve import CompiledProblem, SolveResult, compile_problem, solve_system

__version__ = "0.1.0"

__all__ = [
    "BCArrays",
    "BoundaryRegion",
    "BoundaryRule",
    "BoundaryTarget",
    "CompiledProblem",
    "InputError",
    "MagnetiteError",
    "Mesh",
    "MesherError",
    "ModelMetadata",
    "PostProcessorError",
    "SimulationInput",
    "SolveResult",
    "SolverError",
    "SolverOptions",
    "apply_boundary_conditions",
    "compile_problem",
    "load_simulation_input",
    "normalize_orientation",
    "parse_simulation_input",
    "signed_areas",
    "solve_system",
]
