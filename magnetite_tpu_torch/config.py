"""Input-JSON schema (bit-compatible with the reference) and solver config.

The public input format users carry over from the reference is a JSON file:

    {
      "metadata": {part_thickness, material_elasticity, poisson_ratio,
                   characteristic_length_min, characteristic_length_max},
      "boundary_conditions": {<name>: {"region": {x_target_min, x_target_max,
                                                  y_target_min, y_target_max},
                                       "targets": {ux, uy, fx, fy}}}
    }

Schema and validation semantics replicate the reference exactly:
  - presence checks               (reference: src/mesher.rs:733-757, 780-799)
  - region min<=max               (reference: src/mesher.rs:871-880)
  - per-axis exactly one of force/displacement known
                                  (reference: src/mesher.rs:881-900)
  - region defaults to all of R^2 (reference: src/mesher.rs:835-840)
  - rule order is preserved: later rules overwrite earlier ones on overlap
                                  (reference: src/mesher.rs:913-927)
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Optional

from .errors import InputError


@dataclass(frozen=True)
class ModelMetadata:
    """Material + meshing parameters (reference: src/datatypes.rs:22-29)."""

    youngs_modulus: float
    poisson_ratio: float
    part_thickness: float
    characteristic_length_min: float
    characteristic_length_max: float


@dataclass(frozen=True)
class BoundaryRegion:
    """Axis-aligned box; nodes strictly inside are targeted.

    Defaults cover all of R^2 (reference: src/mesher.rs:835-840 uses
    f64::MIN/MAX; -inf/+inf is equivalent under the strict comparisons of
    src/mesher.rs:915-918 for finite node coordinates).
    """

    x_min: float = -math.inf
    x_max: float = math.inf
    y_min: float = -math.inf
    y_max: float = math.inf

    def contains(self, x: float, y: float) -> bool:
        return self.x_min < x < self.x_max and self.y_min < y < self.y_max


@dataclass(frozen=True)
class BoundaryTarget:
    """Per-axis prescribed displacement or force; None = unknown
    (reference: src/datatypes.rs:38-44)."""

    ux: Optional[float] = None
    uy: Optional[float] = None
    fx: Optional[float] = None
    fy: Optional[float] = None


@dataclass(frozen=True)
class BoundaryRule:
    name: str
    region: BoundaryRegion
    target: BoundaryTarget


@dataclass(frozen=True)
class SolverOptions:
    """Knobs the reference hard-codes, exposed as real configuration
    (reference constants: src/solver.rs:17-19)."""

    max_cg_iters: int = 10_000_000
    # Reference stops CG at absolute residual norm 1e-4 (src/solver.rs:19);
    # we default to a relative tolerance far tighter for accuracy.
    cg_rtol: float = 1e-10
    cg_atol: float = 0.0
    # "auto" = geometric multigrid on large structured grids, smoothed-
    # aggregation AMG on large unstructured meshes, block-Jacobi otherwise.
    # Explicit: "none" | "jacobi" | "block_jacobi" | "multigrid" | "amg".
    preconditioner: str = "auto"
    # Unstructured meshes below this node count keep block-Jacobi under
    # preconditioner="auto" (the AMG hierarchy build is a host-side setup
    # cost that only pays off once iteration counts grow into the hundreds).
    # The JAX package's value, kept: the CLI's choice and the parity tests
    # rely on it. Measured on an NVIDIA H100 80GB HBM3, 700.00 W
    # (scripts/torch_measure_amg_threshold.py, PERF.md), AMG's warm solve
    # wins at every size of the ladder, from 1,682 nodes up: f32 refined
    # to rtol 1e-8, 0.0502 s / 9 iters amg vs 0.4105 s / 802 iters bj at
    # 1,682 nodes and 0.0408 s vs 1.0584 s at 5,013 (bj did not converge
    # at 8,380, 20,026 and 27,804 nodes); f32 at the f32 rtol floor,
    # 0.0369 s / 8 iters vs 0.2409 s / 369 at 1,682. The card's crossover
    # lies below the ladder, more than 2x under this value (ROADMAP,
    # Queue 3).
    # Exception: TINY meshes (2*nodes <= fem.amg._DENSE_COARSE_MAX_DOF)
    # auto-select "amg" anyway -- the "hierarchy" there is one exact dense
    # inverse (milliseconds to build, ~2 CG iterations).
    amg_auto_min_nodes: int = 5_000
    # Aggregate diameter in median-edge-lengths (~cell_factor^2 nodes per
    # aggregate); 3.0 is the standard SA sweet spot.
    amg_cell_factor: float = 3.0
    # Pre/post smoothing sweeps per AMG V-cycle level. 0 = auto: V(3,3)
    # under mixed-precision refinement -- there the f32 V-cycle
    # preconditions f64 CG whose emulated-f64 band matvec costs ~15x a
    # f32 matvec, so extra cheap f32 sweeps that cut the expensive f64
    # iteration count (19 -> 12 at 23k nodes, measured) are a net win --
    # and V(1,1) everywhere else (same-precision V-cycles pay full price
    # per sweep, where fewer iterations no longer cover the added cost).
    # Policy in fem.solve.compile_problem (the JAX package's in
    # fem.amg.amg_sweep_schedule); honored by the single-device
    # cores AND the sharded pipeline. Fixed-iteration sweep lanes
    # (parallel/sweep.py) auto to V(1,1) -- a static budget cannot
    # harvest an iteration cut -- and take their own amg_sweeps kwarg.
    amg_sweeps: int = 0
    # Scalar-stress sign threshold. The reference flips the sign when
    # sigma_x + sigma_y < 1.0 (src/solver.rs:524-530) -- a quirk we keep as
    # the default for output parity; set to 0.0 for the physical rule.
    stress_sign_threshold: float = 1.0
    # Orientation fix threshold: the reference reverses node order when the
    # signed area is < 1.0 (src/mesher.rs:522-526). The correct rule is < 0.0
    # (our default); set to 1.0 to replicate the reference bit-for-bit.
    ccw_threshold: float = 0.0
    # Sparse operator format: "auto" picks DIA (band/stencil SpMV, the fast
    # TPU path) when the mesh's (col-row) offset set is small, else ELL
    # (gather SpMV). "dia"/"ell" force a format.
    operator: str = "auto"
    max_diags: int = 48
    # Node renumbering for band-friendly sparsity (meshing/reorder.py):
    # "auto" renumbers when the mesh's native ordering would miss the DIA
    # band format; "geometric"/"rcm" force one ordering; "off" disables.
    # Results are always reported in the caller's original node order.
    renumber: str = "auto"
    # Dense direct solve below this many nodes (fast + exact for tiny meshes).
    dense_cutoff: int = 0
    dtype: Optional[str] = None  # None = f64 if x64 enabled else f32
    # Mixed-precision iterative refinement: f64 operator + residual, f32
    # CG/multigrid inner solves. "auto" engages it on the stencil operator
    # when the requested cg_rtol is below what f32 can reach; "on" forces
    # it for any sparse operator format (on AMG paths: f64 CG around the
    # f32 V-cycle); "off" clamps cg_rtol to the working precision instead.
    refine: str = "auto"
    # Double-float CG operator for the refined AMG (unstructured) path:
    # the f64 CG's per-iteration band matvec as compensated f32-pair
    # arithmetic (kernels/df_kernel.py; ~2^-46 of the term scale, ~2e-9
    # attainable relative residual at 1M elements). "auto" keeps native
    # f64 on the card: the pairs stream the same bytes as f64 and measured
    # no faster (fem/solve._decide_df64); "on" forces the df kernel on the
    # card (its plain PyTorch version on the CPU); "off" keeps native f64;
    # "interpret" is accepted for parity with the JAX package and acts as
    # "on": the device, not the option, picks kernel or plain version.
    # Force/stress recovery and the rhs always use the true f64 operator.
    df_matvec: str = "auto"
    # Operator assembly strategy for the irregular formats (dia/hybrid/
    # ell). "host": C++ closed-form assembly + flat upload (up to ~336 MB
    # f64 at 1M elements, host to device).
    # "device": fused scalar-field assembly ON the accelerator from the
    # resident mesh arrays (~6% of the upload bytes; pays an f64
    # segment_sum and disables keep_operator_host / persist.save_operator,
    # which have no host flat to keep). "auto" = host when the native
    # library is available, device otherwise.
    assembly: str = "auto"
    # Iteration cap for each inner f32 solve between refinement residual
    # checks, and cap on refinement passes. Multigrid inner solves converge
    # in a few dozen iterations; the cap exists for block-Jacobi inner
    # solves on irregular meshes, which need a few hundred per pass.
    refine_inner_iters: int = 400
    refine_max_outer: int = 8
    # Abort (typed SolverError) if NaN/Inf appears in the assembled operator
    # or the solution -- the numeric analog of a sanitizer.
    debug_nans: bool = False
    # Record ||r|| for the first N CG iterations (SolveResult.residual_history).
    residual_history: int = 0
    # Stream an iteration/residual log line every N CG iterations during the
    # solve (reference observer analog, src/solver.rs:40-107). 0 = silent.
    cg_progress_every: int = 0
    # Keep the host-side assembled operator on CompiledProblem (needed by
    # persist.save_operator; ~650 MB of f64 at 1M elements). Off by default:
    # a long-lived problem would otherwise pin the full host copy for its
    # lifetime just in case it gets checkpointed. Set True before compiling
    # a problem you intend to pass to persist.save_operator (the CLI does
    # this automatically when --save-case is given).
    keep_operator_host: bool = False


@dataclass(frozen=True)
class SimulationInput:
    metadata: ModelMetadata
    boundary_rules: tuple[BoundaryRule, ...] = field(default_factory=tuple)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise InputError(msg)


def parse_metadata(data: dict) -> ModelMetadata:
    """Validate + extract the metadata block (reference: src/mesher.rs:769-808)."""
    _require("metadata" in data, "Input json missing metadata field")
    md = data["metadata"]
    _require(
        "part_thickness" in md,
        "Input json missing part_thickness field in metadata section",
    )
    _require(
        "material_elasticity" in md,
        "Input json missing material_elasticity field in metadata section",
    )
    _require(
        "poisson_ratio" in md,
        "Input json missing poisson_ratio field in metadata section",
    )
    _require(
        md.get("material_elasticity") is not None,
        "Input json missing material elasticity",
    )
    _require(md.get("poisson_ratio") is not None, "Input json missing poisson ratio")
    _require(
        md.get("characteristic_length_min") is not None,
        "Input json missing minimum characteristic length",
    )
    _require(
        md.get("characteristic_length_max") is not None,
        "Input json missing maximum characteristic length",
    )
    return ModelMetadata(
        youngs_modulus=float(md["material_elasticity"]),
        poisson_ratio=float(md["poisson_ratio"]),
        part_thickness=float(md["part_thickness"]),
        characteristic_length_min=float(md["characteristic_length_min"]),
        characteristic_length_max=float(md["characteristic_length_max"]),
    )


def _opt_float(value) -> Optional[float]:
    return None if value is None else float(value)


def parse_boundary_rules(data: dict) -> tuple[BoundaryRule, ...]:
    """Validate + extract boundary rules, preserving declaration order
    (reference: src/mesher.rs:815-907)."""
    _require(
        "boundary_conditions" in data,
        "Input json missing boundary_conditions field in metadata section",
    )
    rules: list[BoundaryRule] = []
    for name, rule in data["boundary_conditions"].items():
        _require("region" in rule, f"Boundary rule {name} is missing region field")
        _require("targets" in rule, f"Boundary rule {name} is missing target field")

        region_json = rule["region"]
        region = BoundaryRegion(
            x_min=(
                float(region_json["x_target_min"])
                if "x_target_min" in region_json
                else -math.inf
            ),
            x_max=(
                float(region_json["x_target_max"])
                if "x_target_max" in region_json
                else math.inf
            ),
            y_min=(
                float(region_json["y_target_min"])
                if "y_target_min" in region_json
                else -math.inf
            ),
            y_max=(
                float(region_json["y_target_max"])
                if "y_target_max" in region_json
                else math.inf
            ),
        )
        targets_json = rule["targets"]
        target = BoundaryTarget(
            ux=_opt_float(targets_json.get("ux")),
            uy=_opt_float(targets_json.get("uy")),
            fx=_opt_float(targets_json.get("fx")),
            fy=_opt_float(targets_json.get("fy")),
        )

        _require(
            not region.x_min > region.x_max,
            f"Boundary '{name}' has x_target_min greater than x_target_max",
        )
        _require(
            not region.y_min > region.y_max,
            f"Boundary '{name}' has y_target_min greater than y_target_max",
        )
        _require(
            not (target.fx is None and target.ux is None),
            f"Boundary '{name}' is under-constrained in x-axis",
        )
        _require(
            not (target.fy is None and target.uy is None),
            f"Boundary '{name}' is under-constrained in y-axis",
        )
        _require(
            not (target.fx is not None and target.ux is not None),
            f"Boundary '{name}' is over-constrained in x-axis",
        )
        _require(
            not (target.fy is not None and target.uy is not None),
            f"Boundary '{name}' is over-constrained in y-axis",
        )
        rules.append(BoundaryRule(name=name, region=region, target=target))
    return tuple(rules)


def load_simulation_input(path: str) -> SimulationInput:
    """Load + validate an input JSON file (reference: src/mesher.rs:713-760)."""
    try:
        with open(path, "r") as f:
            raw = f.read()
    except OSError:
        raise InputError(f"Unable to open input file {path}")
    try:
        data = json.loads(raw)
    except json.JSONDecodeError as err:
        raise InputError(f"Error in input file json: {err}")
    metadata = parse_metadata(data)
    rules = parse_boundary_rules(data)
    return SimulationInput(metadata=metadata, boundary_rules=rules)


def parse_simulation_input(data: dict) -> SimulationInput:
    """Parse an already-loaded JSON dict (same validation as the file path)."""
    return SimulationInput(
        metadata=parse_metadata(data), boundary_rules=parse_boundary_rules(data)
    )
