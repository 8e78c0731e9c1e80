"""Geometries of the device assembly's kernel that it does not ship, and
the first design tried (scripts/assembly_variants.cu), timed on one CUDA
device against the shipped kernel in interleaved rounds (chip_smoke.py's
timer: L2 flushed before each call, median of --reps calls), each held
bit for bit to the shipped kernel first, at the 1M Delaunay plate's DIA
and ELL slots (f64 outputs, the shipped count and fill kernels' runs);
then the shipped run building (count, cumsum, fill) against runs built
with per-pair ranks (the count's atomic adds give each pair its place,
the fill needs no atomics), held to the same runs first.

Usage (on the machine with the card, from the repo root):
    python3 scripts/assembly_variants.py [--h 0.00258]
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {0: "first design: blocks of 128 slots, 1,024 staged pairs",
            1: "shipped: warp tiles, 96 staged, 4 warps, 2 in flight",
            2: "96 staged, 2 warps",
            3: "64 staged, 4 warps",
            4: "128 staged, 4 warps",
            5: "96 staged, 8 warps",
            6: "96 staged, 4 warps, 1 in flight",
            7: "96 staged, 4 warps, band-major tiles",
            8: "96 staged, 4 warps, 12 blocks an SM (40 registers)"}


def build():
    """scripts/assembly_variants.cu as its own library (the build directory
    of the kernels), printing ptxas's register lines."""
    from magnetite_tpu_torch.kernels import cuda_lib

    out = os.path.join(cuda_lib.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libassembly_variants.so")
    src = os.path.join(ROOT, "scripts", "assembly_variants.cu")
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", src, "-o", so],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    name = None
    for line in proc.stderr.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and ("registers" in line or "spill" in line):
            print(f"  ptxas {name[-70:]}: {line.strip()}")
    lib = ctypes.CDLL(so)
    vp, i32, i64, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
    lib.var_runs.restype = i32
    lib.var_runs.argtypes = [i32, vp, vp, vp, i64, i64, i64, i64, i64, f64, f64, f64, vp, vp,
                             vp]
    lib.var_count_rank.restype = i32
    lib.var_count_rank.argtypes = [vp, vp, vp, i64, i64, f64, vp, vp, vp, vp]
    lib.var_fill_rank.restype = i32
    lib.var_fill_rank.argtypes = [vp, vp, i64, i64, vp, vp, vp]
    return lib


def rank_runs(lib, coords, tris, ids, n_slots, thick):
    """The runs through per-pair ranks (var_count_rank, cumsum,
    var_fill_rank): (bounds, order, geom) as build_runs gives them."""
    import torch
    from magnetite_tpu_torch.kernels import cuda_lib

    n_elem = tris.shape[0]
    counts = torch.zeros(n_slots + 1, dtype=torch.int32, device=ids.device)
    rank = torch.empty(9 * n_elem, dtype=torch.int32, device=ids.device)
    geom = torch.empty((n_elem, 8), dtype=torch.float64, device=ids.device)
    stream = cuda_lib.stream_of(ids)
    rc = lib.var_count_rank(coords.data_ptr(), tris.data_ptr(), ids.data_ptr(), n_elem,
                            n_slots, thick, geom.data_ptr(), counts.data_ptr(),
                            rank.data_ptr(), stream)
    cuda_lib.check(cuda_lib.load(), rc, "var_count_rank")
    starts = counts.cumsum_(0)
    order = torch.empty(9 * n_elem, dtype=torch.int32, device=ids.device)
    rc = lib.var_fill_rank(ids.data_ptr(), rank.data_ptr(), 9 * n_elem, n_slots,
                           starts.data_ptr(), order.data_ptr(), stream)
    cuda_lib.check(cuda_lib.load(), rc, "var_fill_rank")
    return starts, order, geom


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--h", type=float, default=0.00258, help="the Delaunay plate's mesh size")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device available")
        return 2
    import chip_smoke as cs
    from magnetite_tpu_torch.fem.assembly import build_ell_structure
    from magnetite_tpu_torch.fem.dia import build_dia_structure
    from magnetite_tpu_torch.fem.element import material_constants
    from magnetite_tpu_torch.kernels import cuda_lib
    from magnetite_tpu_torch.kernels.assembly_kernel import assemble_pairs, build_runs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cs.say(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    cuda_lib.load()
    lib = build()
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    mesh, _, md = cs.plate_case(args.h)
    n, e = mesh.num_nodes, mesh.num_elements
    coords = torch.from_numpy(np.asarray(mesh.coords, np.float64)).cuda()
    tris = torch.from_numpy(np.asarray(mesh.tris, np.int64)).cuda()
    mat = (md.youngs_modulus, md.poisson_ratio, md.part_thickness)
    d0, d1, d2 = material_constants(mat[0], mat[1])
    dia = build_dia_structure(mesh.tris, n, max_diags=48)
    ell = build_ell_structure(mesh.tris, n)
    for label, slot_ids, n_bands, is_ell in (
        ("DIA", dia.slot_ids, len(dia.offsets), False),
        ("ELL", ell.slot_ids, ell.cols.shape[1], True),
    ):
        n_slots = n_bands * n
        ids = torch.from_numpy(np.asarray(slot_ids, np.int64)).cuda()
        runs = build_runs(coords, tris, ids, n_slots, mat[2])
        tag = f"assembly kernel {label} S={n_slots} E={e}"

        def var(v):
            bands = torch.empty((n_bands, 2, 2, n), dtype=torch.float64, device="cuda")
            rem = torch.empty((0, 2, 2), dtype=torch.float64, device="cuda")
            rc = lib.var_runs(v, runs.geom.data_ptr(), runs.order.data_ptr(),
                              runs.bounds.data_ptr(), e, n_slots, n_slots, n,
                              n_bands if is_ell else 0, d0, d1, d2, bands.data_ptr(),
                              rem.data_ptr(), cuda_lib.stream_of(bands))
            cuda_lib.check(cuda_lib.load(), rc, f"var_runs {v}")
            return bands

        shipped = assemble_pairs(coords, tris, ids, n, n_bands, *mat, ell=is_ell, runs=runs)[0]
        fns = {"shipped kernel": lambda: assemble_pairs(coords, tris, ids, n, n_bands, *mat,
                                                        ell=is_ell, runs=runs)}
        for v, name in VARIANTS.items():
            got = var(v)
            torch.cuda.synchronize()
            cs.require(torch.equal(got, shipped), f"{tag} {name}: differs from the shipped")
            fns[name] = lambda v=v: var(v)
        cs.say(f"  {tag}: every variant bit for bit the shipped kernel")
        med = cs.interleaved(tag, fns, args.reps, flush, args.rounds)
        nbytes, flops = cs.assembly_bytes_flops(n, e, n_slots)
        b_ms, b_by = cs.bound(nbytes, flops, torch.float64)
        for key, ms in sorted(med.items(), key=lambda kv: kv[1]):
            cs.say(f"  {tag}: {key}: {ms:.4f} ms ({b_ms / ms:.1%} of bound {b_ms:.4f} ms "
                   f"by {b_by})")
        # the runs: the shipped count + cumsum + fill against ranks
        bounds, order, geom = rank_runs(lib, coords, tris, ids, n_slots, mat[2])
        run = torch.repeat_interleave(torch.arange(n_slots, device="cuda"),
                                      (bounds[1:] - bounds[:-1]).to(torch.int64))
        cs.require(torch.equal(bounds, runs.bounds) and torch.equal(geom, runs.geom)
                   and torch.equal(torch.sort(run * (9 * e) + order.to(torch.int64)).values,
                                   torch.sort(run * (9 * e) + runs.order.to(torch.int64)).values),
                   f"{tag}: the rank runs differ from the shipped runs")
        del bounds, order, geom, run
        med = cs.interleaved(f"runs {label}", {
            "shipped count + cumsum + fill": lambda: build_runs(coords, tris, ids, n_slots,
                                                                mat[2]),
            "ranks: count + cumsum + fill": lambda: rank_runs(lib, coords, tris, ids, n_slots,
                                                              mat[2]),
        }, args.reps, flush, args.rounds)
        del runs, shipped
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
