"""The JAX package's per-lane true relative residuals of its structured-grid
sweep benchmarks (bench.py: bench_sweep, bench_material_sweep) on the CPU:
rect_mesh(64, 32, width=2.0) (33x65), 20 CG iterations, f32 and f64, the
benchmarks' batches cut to --lanes lanes. Each answer's residual is
recomputed in f64 with the f64 operator (as chip_smoke.py recomputes the
card's); chip_smoke.py holds the port's full-width sweeps to 10x these (and
to 1e-4).

Usage: JAX_PLATFORMS=cpu python scripts/grid_sweep_bars.py [--lanes 128]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from magnetite_tpu.config import ModelMetadata
    from magnetite_tpu.meshing.generators import rect_mesh, tensile_bcs_for_rect
    from magnetite_tpu.parallel import sweep as js
    from magnetite_tpu.parallel.sweep import compile_material_sweep, compile_sweep

    mesh = rect_mesh(64, 32, width=2.0)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    b = args.lanes
    right = np.isclose(mesh.coords[:, 0], 2.0)
    rng = np.random.default_rng(0)
    u_values = np.tile(base.u_value[None], (b, 1, 1))
    # load sweep: bench_sweep's pulls; material sweep: the base BC values
    f_values = np.zeros_like(u_values)
    pulled = u_values.copy()
    pulled[:, right, 0] = rng.uniform(0.005, 0.02, b)[:, None]
    k_scales = rng.uniform(0.5, 2.0, b)
    mats = (rng.uniform(40e9, 250e9, b), rng.uniform(0.22, 0.38, b), rng.uniform(0.2, 1.0, b))
    out = {"mesh": "rect_mesh(64, 32, width=2.0)", "lanes": b, "iterations": args.iters}
    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.05)
    rows, cols = mesh.grid_shape
    ref_load = compile_sweep(mesh, base, md, iterations=args.iters, dtype=np.float64)
    ref_mat = compile_material_sweep(mesh, base, iterations=args.iters, dtype=np.float64)
    free = np.asarray(ref_load.free_g)[..., None]

    def lanes(x):  # [B, N, 2] -> [2, R, C, B]
        return jnp.asarray(np.asarray(x, np.float64).transpose(2, 1, 0).reshape(2, rows, cols, -1))

    def rel(b_, r_):
        b_, r_ = np.asarray(b_), np.asarray(r_)
        return float((np.sqrt((r_ ** 2).sum(axis=(0, 1, 2)))
                      / np.sqrt((b_ ** 2).sum(axis=(0, 1, 2)))).max())

    raw, reduced = ref_load.setup[0], ref_load.setup[1]
    basis_raw, levels = ref_mat.setup[0], ref_mat.setup[1]
    ks = jnp.asarray(k_scales)
    w = js.material_weights(*(jnp.asarray(m) for m in mats))
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        load = compile_sweep(mesh, base, md, iterations=args.iters, dtype=dtype)
        u = lanes(load.solve(pulled, f_values, k_scales).u)
        uf = lanes(pulled)
        b_ = free * (lanes(f_values) - js._lane_stencil_matvec(raw, uf, False) * ks) + (
            1.0 - free) * uf
        r_ = b_ - (free * js._lane_stencil_matvec(reduced, u, False) * ks + (1.0 - free) * u)
        out[f"load {name}"] = rel(b_, r_)
        mat = compile_material_sweep(mesh, base, iterations=args.iters, dtype=dtype)
        u = lanes(mat.solve(u_values, f_values, *mats).u)
        uf = lanes(u_values)
        kraw = sum(js._lane_stencil_matvec(st, uf, False) * wk for st, wk in zip(basis_raw, w))
        b_ = free * (lanes(f_values) - kraw) + (1.0 - free) * uf
        r_ = b_ - js._lane_material_matvec(levels[0], *w, u, False)
        out[f"material {name}"] = rel(b_, r_)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
