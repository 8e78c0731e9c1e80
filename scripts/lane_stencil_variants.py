"""Launch plans and variants of the lane stencil kernel and the fused coarse
smoother, timed on one CUDA device in interleaved rounds (chip_smoke.py's
timer: L2 flushed before each call, median of --reps calls).

1. lane_stencil_kernel<T, S> (csrc/lane_stencil_matvec.cu) at the bench
   grid (33x65), 17x33, 9x17 and the wrapped 33x64, f32 and f64, S = 1 and
   S = 3, --lanes lanes, random operands: tiles of at most 16 or 8 columns
   by strips of 2, 3, 6 and 11 rows, the committed plan
   (lane_stencil_plan) marked;
2. f64 S = 3: the tensor-core variant (scripts/lane_stencil3_dmma.cu,
   mma.sync m8n8k4) against the committed instance, at the committed plan,
   in the same rounds, each checked against the plain version first;
3. the fused coarse smoother (csrc/lane_coarse_smooth.cu) at the bench
   grid's 9x17 coarsest level with 1 and with 48 sweeps: the first is the
   launch's fixed part (building the lanes' blocks, reading r and dinv,
   writing e).

Usage (on the machine with the card, from the repo root):
    python3 scripts/lane_stencil_variants.py [--lanes 4096] [--rounds 3]
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((33, 65, False), (17, 33, False), (9, 17, False), (33, 64, True))


def build_dmma():
    """scripts/lane_stencil3_dmma.cu as its own library (the build
    directory of the kernels)."""
    from magnetite_tpu_torch.kernels import cuda_lib

    out = os.path.join(cuda_lib.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "liblane_stencil3_dmma.so")
    src = os.path.join(ROOT, "scripts", "lane_stencil3_dmma.cu")
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", src, "-o", so],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    for line in proc.stderr.splitlines():
        if "dmma" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mt_lane_stencil_matvec3_dmma.restype = i32
    lib.mt_lane_stencil_matvec3_dmma.argtypes = [i32, i32, i32, vp, vp, vp, vp, vp, vp, i32, i32,
                                                 i64, i32, i32, vp]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available")
        return 2
    import chip_smoke as cs
    from magnetite_tpu_torch.kernels import cuda_lib
    from magnetite_tpu_torch.kernels import lane_coarse_kernel as lc
    from magnetite_tpu_torch.kernels import lane_stencil_kernel as lk
    from magnetite_tpu_torch.meshing.generators import rect_mesh, tensile_bcs_for_rect
    from magnetite_tpu_torch.parallel.sweep import (
        _lane_material_center_inv, compile_material_sweep, material_weights,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    lib = cuda_lib.load()
    dmma = build_dmma()
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    nb = args.lanes

    def call(fn, name, packed, ws, u, wrap, tile_cols, strip_rows):
        y = torch.empty_like(u)
        rc = fn(cuda_lib.DTYPE_CODES[u.dtype], int(wrap), 1, packed.data_ptr(),
                *(w.data_ptr() for w in ws), u.data_ptr(), y.data_ptr(), u.shape[1], u.shape[2],
                nb, tile_cols, strip_rows, cuda_lib.stream_of(u))
        cuda_lib.check(lib, rc, name)
        return y

    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        es = torch.empty((), dtype=dtype).element_size()
        w3 = tuple(torch.rand(nb, generator=gen, device="cuda", dtype=torch.float64).to(dtype)
                   for _ in range(3))
        for rows, cols, wrap in SHAPES:
            st = tuple(torch.randn(9, 2, 2, rows, cols, generator=gen, device="cuda",
                                   dtype=torch.float64).to(dtype) for _ in range(4))
            u = torch.randn(2, rows, cols, nb, generator=gen, device="cuda",
                            dtype=torch.float64).to(dtype)
            plan = lk.lane_stencil_plan(rows, cols, nb, es, True)
            for sets in (1, 3):
                if sets == 1:
                    packed, ws = lk.pack_lane_stencils(st[0]).data, ()
                    entry = lib.mt_lane_stencil_matvec
                    ref = lk.lane_stencil_matvec_plain(st[0], u, wrap)
                else:
                    packed, ws = lk.pack_lane_stencils(st).data, w3
                    entry = lib.mt_lane_stencil_matvec3
                    ref = lk.lane_material_matvec_plain(st, w3, u, wrap)
                tol = (1e-5 if dtype == torch.float32 else 1e-12) * float(ref.abs().max())
                fns = {}
                for limit in (16, 8):
                    tile_cols = -(-cols // -(-cols // limit))
                    for strip in sorted({2, 3, 6, 11, plan.strip_rows}):
                        if strip > rows:
                            continue
                        mark = " (plan)" if (tile_cols, strip) == plan[1:] else ""
                        fns[f"tiles {tile_cols} strips {strip}{mark}"] = (
                            lambda e=entry, tc=tile_cols, sr=strip:
                            call(e, "lane stencil", packed, ws, u, wrap, tc, sr))
                if sets == 3 and dtype == torch.float64:
                    fns["tensor-core variant (plan)"] = lambda: call(
                        dmma.mt_lane_stencil_matvec3_dmma, "dmma variant", packed, ws, u, wrap,
                        plan.tile_cols, plan.strip_rows)
                for key, fn in fns.items():
                    err = float((fn() - ref).abs().max())
                    if err > tol:
                        raise RuntimeError(f"S={sets} {rows}x{cols} {name} {key}: err {err:.3e}")
                tag = f"S = {sets} {rows}x{cols}{' wrapped' if wrap else ''} B={nb} {name}"
                med = cs.interleaved(tag, fns, args.reps, flush, args.rounds)
                b_ms, b_by = cs.bound(*cs.lane_stencil_bound(rows, cols, nb, sets, es, wrap),
                                      dtype)
                for key, ms in sorted(med.items(), key=lambda kv: kv[1]):
                    cs.say(f"  {tag}: {key}: {ms:.4f} ms ({b_ms / ms:.1%} of bound {b_ms:.4f} ms "
                           f"by {b_by})")
                del ref

        # the coarse smoother's fixed part
        mesh = rect_mesh(64, 32, width=2.0)
        sweep = compile_material_sweep(mesh, tensile_bcs_for_rect(mesh.coords, pull=0.01), 2,
                                       name, device="cuda")
        level, packed = sweep.setup[1][-1], sweep.packed[1][-1]
        wm = material_weights(*(
            (lo + (hi - lo) * torch.rand(nb, generator=gen, device="cuda",
                                         dtype=torch.float64)).to(dtype)
            for lo, hi in ((40e9, 250e9), (0.22, 0.38), (0.2, 1.0))))
        dinv = _lane_material_center_inv(level, *wm)
        r = torch.randn(2, *level.sa.shape[-2:], nb, generator=gen, device="cuda",
                        dtype=torch.float64).to(dtype)
        fns = {f"{k} sweeps": (lambda k=k: lc.lane_coarse_smooth3(packed, dinv, wm, r, False, k,
                                                                   0.7)) for k in (1, 48)}
        cs.interleaved(f"lane_coarse_smooth3 9x17 B={nb} {name}", fns, args.reps, flush,
                       args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
