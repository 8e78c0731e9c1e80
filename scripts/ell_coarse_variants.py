"""Variants of the ELL kernel and geometries of the fused coarse smoother
that the kernels do not ship, timed on one CUDA device against the shipped
kernels in interleaved rounds (chip_smoke.py's timer: L2 flushed before
each call, median of --reps calls), each checked against the plain version
first.

1. ell_matvec_t at the all-gather path's shard (the h = 0.003 plate in 4
   row shards: 92,707 rows, K = 8, against the gathered 370,828 nodes) and,
   with --main, at the 1M plate's ELL mode (500,393 rows), f64 and f32:
   the shipped kernel; one thread a row unrolled 8 times, with an L2
   evict-first policy (unroll 4 and 8), with every slot's cols loaded
   first, in blocks of 128, 256 and 704; split over 2 and 4 threads a row
   in the block that deals the blocks most evenly over the SMs
   (scripts/ell_coarse_variants.cu); with --baseline the parent tree's
   kernel.
2. lane_coarse_smooth3 at the material sweep's 9x17 and wrapped 9x16
   coarsest levels, --lanes lanes, 48 sweeps, f32 and f64: the shipped
   geometry, the other geometries of VAR_COARSE_F32 / VAR_COARSE_F64 the
   level fits, and with --baseline the parent tree's kernel.

Usage (on the machine with the card, from the repo root; the parent tree
unpacked with `git archive <commit> magnetite_tpu_torch/csrc | tar -x -C
_archive/parent`):
    python3 scripts/ell_coarse_variants.py [--main] [--baseline _archive/parent]
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SPLIT_VARIANTS = {5: 2, 6: 4}  # var_ell's split variants: threads a row
ONE_THREAD = {1: "unroll 8", 2: "unroll 8, evict-first", 3: "evict-first",
              4: "cols of all 8 slots first"}


def build():
    """scripts/ell_coarse_variants.cu as its own library (the build
    directory of the kernels), printing ptxas's register lines."""
    from magnetite_tpu_torch.kernels import cuda_lib

    out = os.path.join(cuda_lib.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libell_coarse_variants.so")
    src = os.path.join(ROOT, "scripts", "ell_coarse_variants.cu")
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", src, "-o", so],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    name = None
    for line in proc.stderr.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and ("registers" in line or "spill" in line):
            print(f"  ptxas {name[-60:]}: {line.strip()}")
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.var_ell.restype = i32
    lib.var_ell.argtypes = [i32, i32, vp, vp, vp, vp, i64, i64, i32, i32, vp]
    lib.var_ell_regs.restype = i32
    lib.var_ell_regs.argtypes = [i32, i32]
    lib.var_coarse.restype = i32
    lib.var_coarse.argtypes = [i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, i32, i32, i64,
                               i32, ctypes.c_double, vp]
    return lib


def even_wave_threads(total: int, regs: int, sms: int) -> int:
    """The block size (a multiple of 32, 64 to 768) for `total` threads of
    a kernel holding `regs` registers a thread on `sms` SMs: fewest waves,
    then fewest threads on the busiest SM, then the largest block. An SM
    holds 64 warps, 32 blocks and 65,536 registers, allotted 256 a warp at
    a time."""
    warp_regs = -(-regs * 32 // 256) * 256
    best = None
    for threads in range(64, 769, 32):
        warps = threads // 32
        resident = min(32, 64 // warps, 65536 // (warp_regs * warps))
        if resident < 1:
            continue
        per_sm = -(-(-(-total // threads)) // sms)
        key = (-(-per_sm // resident), per_sm * threads, -threads)
        if best is None or key < best[0]:
            best = (key, threads)
    return best[1]


def ell_rounds(cs, lib, tag, data, cols, u, nbytes, flops, args, flush, parent):
    import torch
    from magnetite_tpu_torch.kernels import cuda_lib
    from magnetite_tpu_torch.kernels.ell_kernel import ell_matvec_t, ell_matvec_t_plain

    k, n = cols.shape
    dtype = u.dtype
    code = cuda_lib.DTYPE_CODES[dtype]
    sms = cuda_lib.sm_count(u.device)

    def var(v, threads):
        y = torch.empty((2, n), dtype=dtype, device=u.device)
        rc = lib.var_ell(v, code, data.data_ptr(), cols.data_ptr(), u.data_ptr(), y.data_ptr(),
                         n, u.shape[1], k, threads, cuda_lib.stream_of(u))
        cuda_lib.check(cuda_lib.load(), rc, f"var_ell {v}")
        return y

    fns = {"shipped (704 threads)": lambda: ell_matvec_t(data, cols, u)}
    for threads in (128, 256, 704):
        fns[f"one thread, {threads} threads"] = lambda t=threads: var(0, t)
    for v, label in ONE_THREAD.items():
        if v != 4 or k == 8:
            fns[label] = lambda v=v: var(v, 256)
    for v, t in SPLIT_VARIANTS.items():
        regs = lib.var_ell_regs(v, code)
        threads = even_wave_threads(n * t, regs, sms)
        fns[f"split {t} ({threads} threads, {regs} registers)"] = (
            lambda v=v, th=threads: var(v, th))
    if parent is not None:
        fns["parent"] = lambda: parent(data, cols, u)
    ref = ell_matvec_t_plain(data, cols, u)
    scale = ell_matvec_t_plain(data.abs(), cols, u.abs()).max()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    shipped = ell_matvec_t(data, cols, u)
    for key, fn in fns.items():
        got = fn()
        cs.compare(f"{tag} {key}", got, ref, scale, tol)
        cs.say(f"  {tag} {key}: bit-identical to the shipped kernel: "
               f"{bool(torch.equal(got, shipped))}")
    med = cs.interleaved(tag, fns, args.reps, flush, args.rounds)
    b_ms, b_by = cs.bound(nbytes, flops, dtype)
    for key, ms in sorted(med.items(), key=lambda kv: kv[1]):
        cs.say(f"  {tag}: {key}: {ms:.4f} ms ({b_ms / ms:.1%} of bound {b_ms:.4f} ms by {b_by})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--main", action="store_true", help="also the 1M plate's ELL mode")
    ap.add_argument("--baseline", default=None, help="a parent tree (chip_smoke.load_baseline)")
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available")
        return 2
    import chip_smoke as cs
    from magnetite_tpu_torch.fem.multigrid import COARSE_SWEEPS
    from magnetite_tpu_torch.kernels import cuda_lib
    from magnetite_tpu_torch.kernels import lane_coarse_kernel as lc
    from magnetite_tpu_torch.kernels.ell_kernel import ell_to_slot_major
    from magnetite_tpu_torch.kernels.mg_smooth_kernel import OMEGA
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect
    from magnetite_tpu_torch.parallel import sharding as psh
    from magnetite_tpu_torch.parallel.pipeline import DeviceMesh
    from magnetite_tpu_torch.parallel.sweep import (
        _lane_material_center_inv, compile_material_sweep, material_weights,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    cuda_lib.load()
    lib = build()
    base = cs.load_baseline(args.baseline)[1] if args.baseline else None
    parent_ell, parent_coarse = cs.baseline_ell_launcher(base), cs.baseline_coarse_launcher(base)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float64).to(dtype)

    # 1. the ELL kernel
    mesh, bca, md = cs.plate_case(0.003)
    p = psh.prepare_sharded_problem(mesh, bca, md, DeviceMesh(("cuda:0",) * 4, "rows"),
                                    dtype=np.float64)
    nl, n_u = p.free.shards[0].shape[1], p.n_pad
    for dtype in (torch.float64, torch.float32):
        d, cols = p.ell_data[0].to(dtype), p.cols[0]
        u = rand(2, n_u, dtype=dtype)
        nbytes, flops = cs.ell_shard_bytes(cols, nl, n_u, d.element_size())
        ell_rounds(cs, lib, f"ell shard N={nl} N_u={n_u} {str(dtype)[6:]}", d, cols, u, nbytes,
                   flops, args, flush, parent_ell)
    del p
    if args.main:
        mesh, bca, md = cs.plate_case(0.00258)
        ell64, cols_nm = cs.ell_operands(mesh, md, torch.float64)
        n, k = cols_nm.shape
        for dtype in (torch.float64, torch.float32):
            d, c = ell_to_slot_major(ell64.to(dtype), cols_nm)
            u = rand(2, n, dtype=dtype)
            es = d.element_size()
            ell_rounds(cs, lib, f"ell main N={n} {str(dtype)[6:]}", d, c, u,
                       n * k * (4 * es + 4) + 4 * n * es, 8 * n * k, args, flush, parent_ell)
            del d, c, u
        del ell64, cols_nm

    # 2. the fused coarse smoother
    nb = args.lanes
    geometries = {4: ((3, 7), (3, 4), (1, 2)), 8: ((2, 3), (2, 2), (1, 2))}  # the .cu's lists
    caps = {(3, 7): 384, (3, 4): 256, (1, 2): 320, (2, 3): 256, (2, 2): 192}
    for dtype in (torch.float32, torch.float64):
        name, es = str(dtype)[6:], torch.empty((), dtype=dtype).element_size()
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        g = torch.Generator(device="cpu").manual_seed(17)
        w3 = material_weights(*(
            (lo + (hi - lo) * torch.rand(nb, generator=g, dtype=torch.float64)).to("cuda", dtype)
            for lo, hi in ((40e9, 250e9), (0.22, 0.38), (0.2, 1.0))))
        for label, mesh in (("9x17", cs.grid_case()[0]), ("9x16", plate_with_hole_mesh(32, 64))):
            sw = compile_material_sweep(mesh, tensile_bcs_for_rect(mesh.coords, pull=0.01), 20,
                                        name, device="cuda")
            level, plevel = sw.setup[1][-1], sw.packed[1][-1]
            level = type(level)(*(x.contiguous() for x in level))
            wrap = bool(mesh.wrap_cols)
            rows, cols = level.sa.shape[-2:]
            dinv = _lane_material_center_inv(level, *w3)
            r = rand(2, rows, cols, nb, dtype=dtype)
            ref = lc.lane_coarse_smooth3_plain(level, dinv, w3, r, wrap, COARSE_SWEEPS, OMEGA)
            plan = lc.lane_coarse_plan(rows, cols, es)

            def var(m, lanes):
                e = torch.empty_like(r)
                rc = lib.var_coarse(cuda_lib.DTYPE_CODES[dtype], m, lanes, int(wrap),
                                    plevel.data.data_ptr(), dinv.data_ptr(),
                                    *(w.data_ptr() for w in w3), r.data_ptr(), e.data_ptr(),
                                    rows, cols, nb, COARSE_SWEEPS, OMEGA, cuda_lib.stream_of(r))
                cuda_lib.check(cuda_lib.load(), rc, f"var_coarse ({m}, {lanes})")
                return e

            fns = {f"shipped ({plan.m}, {plan.lanes})": lambda: lc.lane_coarse_smooth3(
                plevel, dinv, w3, r, wrap, COARSE_SWEEPS, OMEGA)}
            for m, lanes in geometries[es]:
                if (m, lanes) != (plan.m, plan.lanes) and lc._fit(
                        rows, cols, es, m, lanes, caps[m, lanes]) is not None:
                    fns[f"geometry ({m}, {lanes})"] = lambda m=m, lanes=lanes: var(m, lanes)
            if parent_coarse is not None:
                fns["parent"] = lambda: parent_coarse(plevel.data, dinv, w3, r, wrap,
                                                      COARSE_SWEEPS, OMEGA)
            tag = f"coarse {label} B={nb} {name}"
            for key, fn in fns.items():
                cs.compare(f"{tag} {key}", fn(), ref, ref.abs().max(), tol)
            med = cs.interleaved(tag, fns, args.reps, flush, args.rounds)
            b_ms, b_by = cs.bound(*cs.lane_coarse_bound(rows, cols, nb, es, wrap, COARSE_SWEEPS),
                                  dtype)
            for key, ms in sorted(med.items(), key=lambda kv: kv[1]):
                cs.say(f"  {tag}: {key}: {ms:.4f} ms ({b_ms / ms:.1%} of bound {b_ms:.4f} ms "
                       f"by {b_by})")
            del sw, dinv, r, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
