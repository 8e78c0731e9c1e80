"""4096-variant design sweep in one batched solve (the PyTorch / CUDA
port's version of examples/design_sweep.py).

Vary the prescribed pull displacement and the Young's-modulus scale across
4096 variants of a tensile plate; all variants solve concurrently as the
lanes of one batch on one CUDA card, preconditioned by ONE shared
multigrid hierarchy (`--device cpu` runs the plain PyTorch versions of
the kernels). Imports nothing of JAX. Run:

    python examples/torch_design_sweep.py [n_variants] [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from magnetite_tpu_torch.config import ModelMetadata
from magnetite_tpu_torch.meshing.generators import rect_mesh, tensile_bcs_for_rect


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_variants", type=int, nargs="?", default=4096)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    b, device = args.n_variants, args.device

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    mesh = rect_mesh(64, 32, width=2.0)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    metadata = ModelMetadata(
        youngs_modulus=69e9, poisson_ratio=0.33, part_thickness=0.5,
        characteristic_length_min=0.0, characteristic_length_max=0.05,
    )

    rng = np.random.default_rng(0)
    pulls = rng.uniform(0.005, 0.02, b).astype(np.float32)
    k_scales = rng.uniform(0.5, 2.0, b)  # Young's modulus scale per variant
    right = np.isclose(mesh.coords[:, 0], 2.0)
    u_values = np.tile(base.u_value[None], (b, 1, 1)).astype(np.float32)
    u_values[:, right, 0] = pulls[:, None]
    f_values = np.zeros((b, mesh.num_nodes, 2), dtype=np.float32)

    # serving pattern: compile once (assembly + multigrid hierarchy stay
    # device-resident), then time warm batches
    from magnetite_tpu_torch.parallel.sweep import compile_sweep

    compiled = compile_sweep(mesh, base, metadata, iterations=20, device=device)
    result = compiled.solve(u_values, f_values, k_scales)  # warm-up
    sync()
    t0 = time.perf_counter()
    result = compiled.solve(u_values, f_values, k_scales)
    sync()
    t = time.perf_counter() - t0
    rel = (result.residual_norm / result.rhs_norm).cpu().numpy()

    print(f"{b} variants in {t:.3f}s -> {b / t:.0f} solves/s")
    print(f"worst relative residual: {rel.max():.2e}")
    vm_max = result.von_mises.amax(dim=1).cpu().numpy()  # [B]
    worst = int(np.argmax(vm_max))
    print(f"highest-stress variant: pull={pulls[worst]:.4f}, "
          f"k_scale={k_scales[worst]:.2f}, "
          f"max von Mises={vm_max[worst]:.3e}")

    # --- TRUE material sweep: per-lane (E, nu, t) ----------------------
    # Three basis stencils span every material (the D matrix is linear in
    # its coefficients) and the multigrid hierarchy coarsens each basis,
    # so every lane is preconditioned by its EXACT coarse operators.
    from magnetite_tpu_torch.parallel.sweep import compile_material_sweep

    compiled = compile_material_sweep(mesh, base, iterations=20, device=device)
    e_moduli = rng.uniform(40e9, 250e9, b).astype(np.float32)
    nus = rng.uniform(0.22, 0.38, b).astype(np.float32)
    thicknesses = rng.uniform(0.2, 1.0, b).astype(np.float32)
    mres = compiled.solve(u_values, f_values, e_moduli, nus, thicknesses)
    sync()  # warm-up
    t0 = time.perf_counter()
    mres = compiled.solve(u_values, f_values, e_moduli, nus, thicknesses)
    sync()
    t = time.perf_counter() - t0
    mrel = (mres.residual_norm / mres.rhs_norm).cpu().numpy()
    print(f"material sweep: {b} (E, nu, t) variants in {t:.3f}s "
          f"-> {b / t:.0f} solves/s, worst rel residual {mrel.max():.2e}")


if __name__ == "__main__":
    main()
