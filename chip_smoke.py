#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (magnetite_tpu_torch) on one GPU.

    python3 chip_smoke.py              # full size: 1M-element plates, ~9 minutes on one H100
    python3 chip_smoke.py --h 0.01 --small-h 0.02 --plate 64 128 --big 128 256 --reps 3 \
        --sweep-h 0.05 --lanes 512 --sweep-small 0.08 32
                                       # a quick rehearsal
    python3 chip_smoke.py --profile    # also trace one 1M structured solve and both sweeps
    python3 chip_smoke.py --only transfers
                                       # phases 0 to 3 alone (no "ok" line)
    python3 chip_smoke.py --only transfers --baseline _archive/parent
                                       # the same, the parent tree's band and prolong
                                       # kernels timed in the same rounds
    python3 chip_smoke.py --only lane-kernels
                                       # phases 0, 1 and 10 alone (no "ok" line)
    python3 chip_smoke.py --only multigrid
                                       # phases 0, 1 and 14 alone (no "ok" line)
    python3 chip_smoke.py --only structured-sweeps
                                       # phases 0, 1 and 15-17 alone (no "ok" line)
    python3 chip_smoke.py --only lane-sweeps
                                       # phases 0, 1 and 18-20 alone (no "ok" line)
    python3 chip_smoke.py --only resume
                                       # phases 0, 1 and 21 alone (no "ok" line)
    python3 chip_smoke.py --only ell
                                       # phases 0, 1, 5, 6 and 22 alone (no "ok" line)
    python3 chip_smoke.py --only assembly --baseline _archive/parent
                                       # phases 0, 1, 5 and 23a-b alone (no "ok" line),
                                       # the parent tree's assembly timed in the same rounds
    python3 chip_smoke.py --only shard
                                       # phases 0, 1, 5, 6 and 23 alone (no "ok" line)
    python3 chip_smoke.py --only grid-shard
                                       # phases 0, 1, 7 and 24 alone (no "ok" line)
    python3 chip_smoke.py --only lane-shard
                                       # phases 0, 1 and 25 alone (no "ok" line)
    python3 chip_smoke.py --only entry
                                       # phases 0, 1 and 26 alone (no "ok" line)
    python3 chip_smoke.py --only examples
                                       # phases 0, 1 and 27 alone (no "ok" line)

Phases (any failure exits non-zero; no phase is wrapped in a catch):
  0. environment: torch / CUDA versions, the card's name and power limit;
     exits non-zero at once when no CUDA device is available;
  1. build: the CUDA kernels (nvcc, sm_90a) and the C++ host library (g++);
  2. the band-matvec kernels against their plain version on the card, at
     the Delaunay plate's level-0 operator (2x2 blocks) and every banded
     coarse AMG level the V-cycle launches (3x3 blocks), in f64 and f32,
     each call repeated bit for bit; the coarse levels timed against their
     cuSPARSE call in interleaved rounds, and the V-cycle's node-major call
     op(x.T).T and its copy beside the bare kernel;
  3. the level-0 AMG transfer kernels (prolong / restrict) against their
     plain gathers, in f64 and f32, plus the adjoint identity; each timed
     against its cuSPARSE call in interleaved rounds;
  4. the double-float band kernel against its plain version and against
     the exact f64 product, timed beside dia_matvec<double>;
  5. the f64 main path through the CLI entry point on the Delaunay plate:
     CSVs written, operator=dia, preconditioner=amg, the true relative
     residual recomputed with the plain operator;
  6. the mixed main path: the CLI with --precision mixed (f64 CG around the
     f32 V(3,3)-cycle), then solve_system with df_matvec="on" reusing the
     AMG hierarchy (the double-float kernel runs the CG's matvec);
  7. the structured main path: the 1M-element plate with a hole through
     compile_problem / solve (stencil operator, geometric multigrid, f32
     storage + f64 refinement to rtol 1e-8), and the same plate in f64;
     each V-cycle level through the two fused smoothing kernels (exact
     launch counts per V-cycle; no coarse-level stencil_matvec), and one
     V-cycle's host enqueue against its device time;
  8. the stencil kernel against its plain version at every multigrid level
     of the 1M plate (level 0: the reduced operator; each with its
     launches over phase 7), the 4M plate's grid, and a non-wrapped grid
     whose cols are not a multiple of 32, in f64 and f32;
  9. card against CPU (plain versions): the Delaunay plate at --small-h in
     f64 and mixed precision, the structured 64x128 plate in f64 and f32
     refined;
 10. the design-sweep plate (--sweep-h, the JAX package's sweep benchmark
     mesh) compiled for both AMG-lane sweeps; the lane kernels (K7 and the
     material K8) against their plain versions at its level-0 bands and
     basis band sets, --lanes lanes, f32 and f64, then 1000 lanes and
     offsets reaching past N; each kernel's route (ring or direct), ring
     geometry and ptxas line, and both routes timed in turn at the plate;
 11. the load sweep at full width (25 iterations, f32 CG; bench.py's batch):
     first and warm solve_s, solves/s, K7's launch count (every launch on
     the ring route), dense solve()
     against solve_factors(), every lane's true residual in f64, lanes 0, 1
     and the last against single f64 solves; then the same with f64 CG
     (refined, the sweeps' default for f32: the f64 instance of K7 runs the
     CG operator, and its launches are counted apart);
 12. the material sweep at full width (30 iterations; per-lane E, nu, t):
     the same checks with K8 (every launch on the ring route), f32 CG and
     then f64 CG (refined);
 13. both sweeps on the card against the CPU at --sweep-small;
 14. (run after phase 8) the fused V-cycle kernels mg_presmooth /
     mg_postsmooth against their plain versions at every smoothing level
     of the 1M plate (phase 7's f64 hierarchy and its f32 copy), and over
     the hierarchy of the non-wrapped --rect grid (cols not a multiple of
     the tile; its coarsest level smooths, 48 sweeps, no dense inverse),
     in f64 and f32, each timed against the unfused sequence it replaced
     (stencil_matvec kernel + torch ops; with --baseline also the older
     tree's fused kernels) in interleaved rounds; then that hierarchy's
     whole V-cycle on the card against the CPU's.
 15. the structured-grid load sweep (compile_sweep) on the JAX package's
     sweep benchmark grid (rect_mesh(64, 32, width=2.0), 33x65 nodes), --lanes
     lanes (pulls U(0.005, 0.02), k U(0.5, 2)), 20 iterations, f32 and f64:
     first and warm solve_s (median and spread of fresh batches made on the
     card), solves/s, the lane stencil kernel's launches per level shape
     against the count derived from the hierarchy, every lane's true
     residual in f64 against 10x the JAX package's (GRID_BARS), lanes 0, 1
     and the last against single f64 solves; then the sweep on the card
     against the CPU on the 17x33 rectangle and the wrapped 17x32 plate;
 16. the same for the structured material sweep (compile_material_sweep,
     per-lane E, nu, t; S = 3 instance of the kernel, and the coarsest
     level's 48 sweeps as one fused coarse-smoother launch per V-cycle:
     exactly iterations + 1 per solve, no S = 3 launch at 9x17);
 17. (run after 15-16) the lane stencil kernel, S = 1 and S = 3 on packed
     stencils, against its plain versions at the bench grid, its 17x33 and
     9x17 levels and the wrapped 33x64 plate, f32 and f64, each timed beside
     its bound and plain version, S = 1 against cuSPARSE SpMM, and with
     --baseline both instances against the parent tree's kernel, in
     interleaved rounds; then the fused coarse smoother at the material
     sweep's 9x17 and wrapped 9x16 coarsest levels against its plain
     version, through the geometry the level takes (rows a thread x lanes
     a block), timed with the unfused sequence it replaced (47 S = 3 launches and the torch passes) and
     with --baseline the parent tree's fused kernel in interleaved rounds.
 18. the DIA block-Jacobi lanes: sweep_solve(impl="auto") on the sweep plate
     (--sweep-h) as meshed, --lanes lanes (pulls U(0.005, 0.02), k U(0.5,
     2)), 200 iterations, f32 and f64: first and warm solve_s, solves/s
     (with --profile a torch.profiler trace of one warm solve),
     exactly 203 K7 launches per solve, all on the ring, and no other
     kernel; every lane's true residual in f64 against 10x the JAX
     package's (LANE_BARS), lanes 0, 1 and the last against single f64
     solves;
 19. the vmap route: the same on the plate with its nodes shuffled (numpy
     seed 7), exactly 203 lane ELL kernel launches and no other kernel, the
     same checks, and the lanes against phase 18's mapped back to the
     shuffled order; then both routes on the card against the CPU at h =
     0.08, plain and shuffled;
 20. (run before 18-19) the lane ELL kernel against its plain version at
     the sweep plate shuffled and as meshed, f32 and f64, B = --lanes,
     1,000 and 1, each call repeated bit for bit; timed beside its bound,
     plain version and cuSPARSE SpMM in interleaved rounds.
 21. (run after 6) persistence and observability on the --h Delaunay plate:
     a fresh f64 CLI run with --save-case (the three files' sizes, the save
     stages, the operator cache holding the symmetric half), then --load-case
     runs with no geometry in f64 and --precision mixed: each an operator-cache
     hit with the AMG hierarchy loaded and no warning, CSVs within the golden
     bars of the fresh run's, the true residual <= 1e-9, every prep stage
     printed beside the fresh run's; the fresh run in child processes with
     and without the glibc malloc tuning (MAGNETITE_NO_MALLOC_TUNE=1),
     interleaved; residual_history=64 and cg_progress_every=8 on the plate
     and the structured --plate in f64 (history length and last entry,
     progress lines, the same band / stencil launches as without them, warm
     solve_s with and without); --profile on a --small-h CLI run, whose trace
     must name dia_matvec.
 22. (run after 6) the ELL and dense modes: the ELL kernel against its plain
     version at the Delaunay plate's level-0 operator (slot-major [K, 2, 2,
     N]), f64 and f32, each call repeated bit for bit, timed against the
     plain version and a cuSPARSE CSR SpMV in interleaved rounds, then in
     rounds with the launch floor (a kernel that reads one value and
     writes one; with --baseline also the parent tree's kernel, held bit
     for bit to it); the
     --operator ell CLI on the plate in f64 and --precision mixed, from a
     case holding the mesh and phase 5's AMG hierarchy (f64 values): AMG by
     auto, iterations within +-1 and u / stress on the golden bars of
     phases 5-6's DIA runs, the true residual <= 1e-9 with the plain ELL
     operator, exactly the launches of the ELL kernel, the transfers and
     the m = 3 band kernel per coarse shape that the iterations and the
     hierarchy imply, and no other kernel; the f64 run saves the ELL
     operator cache and a --load-case run resumes from it (a hit, the same
     iterations, u within 1e-12); prep and warm solve_s beside DIA's; then
     dense_cutoff on the h = 0.03 plate (3,774 nodes) in f64 and f32
     against the f64 DIA + AMG answer and against the CPU, with the
     assembly and the LU (torch.linalg.solve) timed apart.
 23. (run after 6) device assembly and the node-sharded pipeline on the
     Delaunay plate: (23a) the device assembly's three kernels (count,
     fill, assembly) at the plate's DIA slots and its ELL slots, f64: the
     output in the operator's layout bit for bit the sequential
     pair-major sum, two calls bit for bit, within 1e-12 of the plain
     version (pair_block_fields + four index_add_ + the layout), f32 the
     f64 sums rounded once, the count and fill kernels against their plain
     versions, each timed beside its plain version and its library call
     (bincount, a stable sort) at both slot sets; each stage timed, and in
     interleaved rounds the assembly
     kernel, the whole function and the plain version (with --baseline
     also the parent tree's kernel and its whole function, stage by stage,
     and the output held bit for bit to it); (23b) compile_problem
     (assembly="device") in f64 against phase 5 (one launch of each
     assembly kernel, iterations +-1, u and
     stress on the golden bars, the true residual <= 1e-9) with its
     assemble_device_s beside phase 5's assemble_s; compile_sharded_problem
     over DeviceMesh((cuda:0,) * S), S = 1, 2, 4, in f64 and --precision
     mixed: the same checks against phases 5-6, the halo width and the
     shard size, exactly the band kernel's launches the iterations imply
     (m = 2 only at the halo-extended shard shape, S per matvec; the
     replicated m = 3 levels once per V-cycle, as on one device), warm
     solve_s beside S = 1; then the CLI with --shard over every visible
     GPU against phase 5's CSVs.
 24. (run after 7) the structured multi-GPU path on phase 7's plate:
     compile_sharded_problem over DeviceMesh((cuda:0,) * S), S = 1, 2, 4
     (grid rows) and DeviceMesh2D((cuda:0,) * 4, (2, 2)) (tiles), f64 CG and
     f32 refined to rtol 1e-8 (their distance to phase 7's answers
     printed), then each at rtol 1e-10 with u, stress and von Mises on the
     golden bars of the single-device f64 answer at rtol 1e-10; the true
     relative residual in f64; the iterations beside phase 7's, f64
     identical across the layouts, the refined inner counts within one
     across S (1-D and 2-D refine by the JAX package's two schemes);
     exactly the stencil_matvec launches per halo-extended shape and the
     fused smoothing launches per coarse shape the iterations imply; warm
     solve_s; the stencil kernel at every halo-extended block shape of
     those runs (shard 0's padded stencil, a field after the halo
     exchange) against its plain version in each dtype the run launched;
     then the CLI with --shard-layout 1x1 --load-case on a case saved from
     the plate, against the rtol 1e-10 answer, and the kernel at that
     layout's block (one wrapped 2-D tile) in f64 and f32.
 25. lane sharding: each lane kernel of phases 11, 12, 15 and 16's sweeps
     at the chunks' lane counts (--lanes / 2 and / 4) against its plain
     version, and bit for bit against the same lanes of a full-width
     call; the sweeps' torch operations whose rounding depends on the lane
     count, printed; then the sweeps (f32) at --lanes lanes over 2 and 4
     shards of cuda:0: each kernel launched exactly S times the unsharded
     run's, each chunk bit-identical to the unsharded sweep on its lanes
     alone, per-lane u against the unsharded run at full width within
     LANE_SHARD_BARS and every lane's true residual (f64, plain operator)
     within the phase's bar, first and warm solve_s; sharded_pcg_solve
     (the all-gather block-ELL path) over 4 shards on the --ell-shard-h
     plate to rtol 1e-8 with exact ELL launches (derived from the
     iterations observed) and the true residual, and the ELL kernel at the
     shard's shape (N_u > N) against its plain version and cuSPARSE, each
     launch plan and the launch floor in rounds as in phase 22;
     sharded_batch_pcg_solve of ELL_BATCH_LANES lanes
     over a 2 x 2 (batch x rows) mesh with exact lane ELL launches, lanes
     against one-lane solves, and the lane ELL kernel at the chunk's shape
     against its plain version and cuSPARSE SpMM; dryrun_multichip(4) on
     cuda:0; with more than one GPU the sweeps and dryrun_multichip over
     the distinct cards.
 26. entry(): the 48x96 plate of dryrun.entry (f32 to rtol 1e-6, stencil
     operator, multigrid, refined) compiled on the card; fn(*args) called
     three times as one main path (stencil_matvec and the fused smoothing
     pair must launch), the three calls bit for bit alike, the answer
     against entry(device="cpu") (iterations +-2; u, f and von Mises on
     ENTRY_BARS), the warm fn(*args) the median of CUDA events.
 27. the four port examples (examples/torch_*.py) at their default sizes,
     each a child process on the card: exit 0, their result lines printed
     and required, the plates' residuals <= 1e-8, the multichip example's
     parity lines "ok" (its own 1e-6 assertion).
Every kernel is timed with CUDA events (median of --reps launches, L2
flushed before each) beside its plain version, its bound (the larger of
bytes moved once over 3.35 TB/s and operations over the peak rate of their
type) and one PyTorch call computing the same function (a cuSPARSE CSR
SpMV of the same operator); where the two are close (the transfers, the
coarse band levels) they are timed in ROUNDS interleaved rounds, every
reading printed and the medians kept; with --baseline DIR an older
tree's band and prolong kernels join those rounds. Each main path runs
with every launch counter set to 0 just before it and read just after
(dia_matvec, stencil_matvec and the smoothing kernels also per shape). The last lines are the
card's nvidia-smi line, a JSON line of per-kernel results (the band
matvec's 2x2 and 3x3 kernels as two rows, the lane stencil kernel's two
instances as two rows, the fused coarse smoother, the lane ELL kernel, the
ELL kernel, both ELL kernels again at the all-gather path's shapes, the
device assembly's count, fill and assembly kernels), and
{"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

OUTER = [[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]]
HOLE = [[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]]
E_MOD, NU, THICK = 69e9, 0.33, 0.5
# NVIDIA H100 SXM data sheet: HBM3 bandwidth; FP32 and FP64 rates outside
# the tensor cores
PEAK_GBS = 3350.0
PEAK_TFLOPS = {"float32": 67.0, "float64": 34.0}
DEV = "cuda"
PTXAS = ""  # nvcc's ptxas report of phase 1's build
KERNELS = {
    # name: (source, replaced TPU kernel)
    # level 0 (2x2 blocks) and the coarse AMG levels (3x3 blocks): two
    # kernels of one source, counted apart
    "dia_matvec": ("magnetite_tpu_torch/csrc/dia_matvec.cu",
                   "magnetite_tpu/pallas/dia_kernel.py:146"),
    "dia_matvec m=3": ("magnetite_tpu_torch/csrc/dia_matvec.cu",
                       "magnetite_tpu/pallas/dia_kernel.py:146"),
    "prolong0": ("magnetite_tpu_torch/csrc/transfer.cu",
                 "magnetite_tpu/pallas/transfer_kernel.py:182"),
    "restrict0": ("magnetite_tpu_torch/csrc/transfer.cu",
                  "magnetite_tpu/pallas/transfer_kernel.py:214"),
    # also replaces the row-blocked variant, stencil_kernel.py:191
    "stencil_matvec": ("magnetite_tpu_torch/csrc/stencil_matvec.cu",
                       "magnetite_tpu/pallas/stencil_kernel.py:91"),
    # the V-cycle's use of the stencil kernel: both smoothing phases of a
    # level with the residual and the transfers, one kernel each
    "mg_presmooth": ("magnetite_tpu_torch/csrc/mg_smooth.cu",
                     "magnetite_tpu/pallas/stencil_kernel.py:91"),
    "mg_postsmooth": ("magnetite_tpu_torch/csrc/mg_smooth.cu",
                      "magnetite_tpu/pallas/stencil_kernel.py:91"),
    "df_dia_matvec": ("magnetite_tpu_torch/csrc/df_dia_matvec.cu",
                      "magnetite_tpu/pallas/dia_kernel.py:330"),
    "lane_dia_matvec": ("magnetite_tpu_torch/csrc/lane_dia_matvec.cu",
                        "magnetite_tpu/pallas/lane_dia_kernel.py:135"),
    "lane_dia_matvec3": ("magnetite_tpu_torch/csrc/lane_dia_matvec.cu",
                         "magnetite_tpu/pallas/lane_dia_kernel.py:161"),
    # the structured sweeps' lane stencil matvec: no pallas_call stands
    # behind it, the JAX package leaves it to XLA, which fuses it
    "lane_stencil_matvec": ("magnetite_tpu_torch/csrc/lane_stencil_matvec.cu",
                            "no pallas_call: XLA-fused in JAX, "
                            "magnetite_tpu/parallel/sweep.py:340"),
    "lane_stencil_matvec3": ("magnetite_tpu_torch/csrc/lane_stencil_matvec.cu",
                             "no pallas_call: XLA-fused in JAX, "
                             "magnetite_tpu/parallel/sweep.py:993"),
    # the material sweep's coarsest-level solve (48 sweeps) in one launch
    "lane_coarse_smooth3": ("magnetite_tpu_torch/csrc/lane_coarse_smooth.cu",
                            "no pallas_call: XLA-fused in JAX, "
                            "magnetite_tpu/parallel/sweep.py:1055"),
    # the vmap sweep route's block-ELL matvec: no pallas_call stands behind
    # it, the JAX package vmaps ell_matvec over the lanes in XLA
    "lane_ell_matvec": ("magnetite_tpu_torch/csrc/lane_ell_matvec.cu",
                        "no pallas_call: XLA-fused in JAX, magnetite_tpu/fem/operator.py:27 "
                        "under jax.vmap, magnetite_tpu/parallel/sweep.py:692"),
    # the ELL solve mode's level-0 operator: no pallas_call stands behind
    # it, the JAX package's ell_matvec (a gather and an einsum) is XLA's
    "ell_matvec_t": ("magnetite_tpu_torch/csrc/ell_matvec.cu",
                     "no pallas_call: XLA-fused in JAX, magnetite_tpu/fem/operator.py:27 "
                     "(ell_matvec), run by magnetite_tpu/fem/solve.py:541 (_solve_ell)"),
    # the all-gather sharded path's calls of the two ELL kernels (a shard's
    # rows against the gathered field, N_u > N): rows of their own, at
    # these shapes, counted over phase 25b's solves
    "ell_matvec_t gathered": ("magnetite_tpu_torch/csrc/ell_matvec.cu",
                              "no pallas_call: XLA-fused in JAX, "
                              "magnetite_tpu/parallel/sharding.py:163 (_local_pcg's matvec)"),
    "lane_ell_matvec gathered": ("magnetite_tpu_torch/csrc/lane_ell_matvec.cu",
                                 "no pallas_call: XLA-fused in JAX, "
                                 "magnetite_tpu/parallel/sharding.py:213 "
                                 "(sharded_batch_pcg_solve's matvec under jax.vmap)"),
    # device assembly: no pallas_call stands behind it, the JAX package's
    # four segment_sums over closed-form pair fields are XLA's; the
    # assembly kernel sums the slots' runs that the count and fill kernels
    # build (one launch of each a device-assembled compile)
    "assemble_pairs": ("magnetite_tpu_torch/csrc/assemble_pairs.cu",
                       "no pallas_call: XLA segment_sums in JAX, magnetite_tpu/fem/dia.py:237 "
                       "(assemble_dia_fused), :254, magnetite_tpu/fem/solve.py:919"),
    "assemble_count": ("magnetite_tpu_torch/csrc/assemble_pairs.cu",
                       "no pallas_call: XLA segment_sums in JAX, magnetite_tpu/fem/dia.py:237 "
                       "(assemble_dia_fused), :254, magnetite_tpu/fem/solve.py:919"),
    "assemble_fill": ("magnetite_tpu_torch/csrc/assemble_pairs.cu",
                      "no pallas_call: XLA segment_sums in JAX, magnetite_tpu/fem/dia.py:237 "
                      "(assemble_dia_fused), :254, magnetite_tpu/fem/solve.py:919"),
}
# the JAX package's sweep benchmarks (bench.py: bench_unstructured_sweep and
# bench_unstructured_material_sweep): mesh size, lanes, CG iterations
SWEEP_H, SWEEP_LANES, LOAD_ITERS, MATERIAL_ITERS = 0.03, 4096, 25, 30
# per-lane bars of the full-width sweeps: the true relative residual (f64,
# plain operator) and max|u - u_single| / max|u| against single f64 solves.
# f32 CG: the CPU tests' residual floor; a fixed budget stops short of the
# converged answer (measured at h = 0.03 on the CPU: residual 2-3e-6, u
# 1e-4 (load) and 4-6e-4 (material)), so u is held to 2e-3. f64 CG (load):
# u carries the f32 rounding of the base boundary values (2.2e-8). f64 CG
# (material): 30 iterations stop short as f32 CG does (measured on the CPU:
# residual 1.4-1.7e-6, u 4.2-4.5e-4; 60 iterations reach 1e-12 and 2.2e-8),
# so only its residual bar is tighter than f32 CG's.
# interleaved kernel / library rounds of the kernels that run near their
# cuSPARSE call (the transfers, the coarse band level): single readings
# swing 2-3x between calls
ROUNDS = 5
# clock cycles the device spins before each timed call (~0.1 ms)
SPIN_CYCLES = 200_000
SWEEP_BARS = {"f32": {"residual": 1e-4, "u": 2e-3}, "refined": {"residual": 1e-10, "u": 1e-6},
              "material refined": {"residual": 1e-5, "u": 2e-3}}
# phase 25's per-lane bars of a lane-sharded f32 sweep against the same
# sweep unsharded at all --lanes lanes: max|u - u_unsharded| / max|u|. Each
# chunk is the unsharded sweep on its lanes alone, bit for bit (checked);
# the gap to the full-width run is f32 rounding in the torch operations
# whose summation order follows the lane count (lane_b_dependence on the
# H100: the per-lane dots' torch.sum, ~2e-7 of the sum, and the AMG load
# sweep's dense coarsest cuBLAS GEMM, 1.5e-6; the lane kernels and the
# AMG einsums are bit-identical per lane), which 20-30 fixed f32 CG
# iterations carry into u. ~4x the largest reading of S = 2 and 4 on the
# H100 (load 1.572e-4, material 3.690e-6, structured load 3.300e-5,
# structured material 1.197e-5), and 3-13x under the bars that hold the
# same sweeps against f64 single solves.
LANE_SHARD_BARS = {"load": 6e-4, "material": 1.5e-5, "grid load": 1.3e-4,
                   "grid material": 5e-5}
# phase 25b's batch solve: lanes and fixed iterations (the JAX package's
# default budget) over the all-gather ELL plate
ELL_BATCH_LANES, ELL_BATCH_ITERS = 64, 200
# the JAX package's structured-grid sweep benchmarks (bench.py: bench_sweep
# and bench_material_sweep): rect_mesh(64, 32, width=2.0), 33x65 nodes, 20 CG
# iterations; warm batches timed per dtype
GRID_CELLS, GRID_ITERS, GRID_WARM = (64, 32), 20, 4
# their per-lane bars. The true relative residual (f64, plain operator):
# 10 x the JAX package's on the CPU at the same mesh and iterations with 128
# lanes ("jax", scripts/grid_sweep_bars.py: each answer's residual
# recomputed in f64), and never above 1e-4. max|u - u_single| / max|u| of
# lanes against single f64 solves (rtol 1e-10): 20 iterations of f32 CG
# stop at a residual ~1.5e-6, which leaves u ~3-4e-5 off the converged
# answer on the CPU at 16 lanes, so 1e-4; f64 CG reaches the single solve's
# own tolerance (~1e-10 of max|u|), so 1e-8.
GRID_BARS = {
    "load float32": {"jax": 1.3269274684674583e-06, "u": 1e-4},
    "load float64": {"jax": 3.567940353591736e-15, "u": 1e-8},
    "material float32": {"jax": 1.5882044500208306e-06, "u": 1e-4},
    "material float64": {"jax": 2.407376801032443e-13, "u": 1e-8},
}
for _bar in GRID_BARS.values():
    _bar["residual"] = min(1e-4, 10 * _bar["jax"])
# the block-Jacobi sweep routes of sweep_solve (phases 18-19): the JAX
# package's default budget, the vmap route's plate shuffled by this numpy
# seed, warm batches timed per route and dtype
LANE_SWEEP_ITERS, SHUFFLE_SEED, LANE_SWEEP_WARM = 200, 7, 2
# the plate of both routes' card-against-CPU check (552 nodes)
LANE_SMALL_H = 0.08
# their per-lane bars: 10 x the JAX package's own on the CPU at the same
# mesh and budget with 128 lanes (scripts/lane_sweep_bars.py). "residual":
# the true relative residual (f64, plain operator); "single": lanes 0, 1 and
# the last against converged single f64 solves; "routes": the vmap route's
# answer mapped back to the meshed order against the lanes' (the same
# arithmetic in another order). 200 block-Jacobi iterations stop far short
# of convergence (residual ~2e-4), where CG amplifies the rounding of two
# summation orders to ~1e-5 of max|u| even in f64 (measured on the CPU),
# so no fixed bar holds any of the three.
LANE_JAX = {  # scripts/lane_sweep_bars.py on the CPU: h = 0.03, 128 lanes, 200 iterations
    "lanes float32": {"residual": 2.329814512733967e-04, "single": 2.5415012227689e-03},
    "lanes float64": {"residual": 2.2493522727552685e-04, "single": 2.4969854046425597e-03},
    "vmap float32": {"residual": 2.3721188976882495e-04, "single": 2.536318662832819e-03},
    "vmap float64": {"residual": 2.242885642706875e-04, "single": 2.49715057985395e-03},
    "routes float32": 4.087746559713298e-05,
    "routes float64": 2.6894446216458525e-05,
}
LANE_BARS = {k: {m: 10 * x for m, x in v.items()} if isinstance(v, dict) else 10 * v
             for k, v in LANE_JAX.items()}


def say(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def counters():
    """The seventeen kernel wrappers, each carrying its `.launches` count."""
    from magnetite_tpu_torch.kernels.assembly_kernel import (
        assemble_count, assemble_fill, assemble_pairs,
    )
    from magnetite_tpu_torch.kernels.df_kernel import df_dia_matvec
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec
    from magnetite_tpu_torch.kernels.ell_kernel import ell_matvec_t
    from magnetite_tpu_torch.kernels.lane_coarse_kernel import lane_coarse_smooth3
    from magnetite_tpu_torch.kernels.lane_dia_kernel import lane_dia_matvec, lane_dia_matvec3
    from magnetite_tpu_torch.kernels.lane_ell_kernel import lane_ell_matvec
    from magnetite_tpu_torch.kernels.lane_stencil_kernel import (
        lane_stencil_matvec, lane_stencil_matvec3,
    )
    from magnetite_tpu_torch.kernels.mg_smooth_kernel import mg_postsmooth, mg_presmooth
    from magnetite_tpu_torch.kernels.stencil_kernel import stencil_matvec
    from magnetite_tpu_torch.kernels.transfer_kernel import prolong0, restrict0

    return (dia_matvec, prolong0, restrict0, stencil_matvec, mg_presmooth, mg_postsmooth,
            df_dia_matvec, lane_dia_matvec, lane_dia_matvec3, lane_stencil_matvec,
            lane_stencil_matvec3, lane_coarse_smooth3, lane_ell_matvec, ell_matvec_t,
            assemble_pairs, assemble_count, assemble_fill)


def shape_label(kernel: str, key) -> str:
    """A `.shape_launches` key as text: (m, N, dtype) of dia_matvec,
    (rows, cols, dtype) of the stencil and smoothing kernels."""
    a, b, dtype = key
    name = str(dtype).replace("torch.", "")
    return f"m={a} N={b} {name}" if kernel == "dia_matvec" else f"{a}x{b} {name}"


@contextlib.contextmanager
def main_path(name: str, totals: dict, expect: tuple):
    """Counts set to 0 just before the path, read just after; every kernel
    in `expect` must have launched. Yields a dict that holds the counts of
    the run once the block has ended, under "<name> f64" the f64 launches
    of the lane kernels (which count them apart), under "<name> ring"
    their ring-route launches, under "lane_coarse_smooth3 per_sweep" the
    coarse solves that took the per-sweep route, and under "dia_matvec
    m=2" / "m=3" the band kernel's launches per block size. `totals["per
    shape"]` sums the launches per shape ("<name> <shape>") over the main
    paths."""
    ks = counters()
    split = [(k, attr) for k in ks for attr in ("f64_launches", "ring_launches", "per_sweep")
             if hasattr(k, attr)]
    shaped = [k for k in ks if hasattr(k, "shape_launches")]
    for k in ks:
        k.launches = 0
    for k, attr in split:
        setattr(k, attr, 0)
    for k in shaped:
        k.shape_launches.clear()
    got: dict = {}
    yield got
    got.update({k.__name__: k.launches for k in ks})
    parts = {f"{k.__name__} {attr.removesuffix('_launches')}": getattr(k, attr)
             for k, attr in split}
    dia = next(k for k in ks if k.__name__ == "dia_matvec")
    for m in (2, 3):
        parts[f"dia_matvec m={m}"] = sum(
            c for key, c in dia.shape_launches.items() if key[0] == m)
    say(f"  kernel launches in {name}: {got}; of those: {parts}")
    for k in shaped:
        if k.shape_launches:
            say(f"  {k.__name__} launches per shape: " + "; ".join(
                f"{shape_label(k.__name__, key)}: {c}" for key, c in sorted(
                    k.shape_launches.items(), key=lambda kv: (str(kv[0][2]), -kv[0][1]))))
        shapes = totals.setdefault("per shape", {})
        for key, c in k.shape_launches.items():
            label = f"{k.__name__} {shape_label(k.__name__, key)}"
            shapes[label] = shapes.get(label, 0) + c
    got.update(parts)
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v
    missing = [k for k in expect if got[k] == 0]
    require(not missing, f"{name}: kernels of the path never launched: {missing}")


def plate_case(h: float):
    """The Delaunay plate with a rectangular hole: mesh, BC arrays, metadata."""
    import numpy as np
    from magnetite_tpu_torch.bc import apply_boundary_conditions
    from magnetite_tpu_torch.config import (
        BoundaryRegion, BoundaryRule, BoundaryTarget, ModelMetadata,
    )
    from magnetite_tpu_torch.meshing.runner import mesh_loops

    # the CLI's meshing stage (Delaunay + orientation fix) on the same loops
    mesh = mesh_loops([np.array(OUTER), np.array(HOLE)], 0.0, h,
                      backend="delaunay", log=lambda msg: None)
    rules = (
        BoundaryRule("left", BoundaryRegion(x_max=1e-6), BoundaryTarget(ux=0.0, uy=0.0)),
        BoundaryRule(
            "right", BoundaryRegion(x_min=3.0 - 1e-6), BoundaryTarget(ux=0.01, fy=0.0)
        ),
    )
    bca = apply_boundary_conditions(mesh.coords, rules)
    return mesh, bca, ModelMetadata(E_MOD, NU, THICK, 0.0, h)


def structured_case(nr: int, nt: int):
    """The structured plate with a circular hole of the JAX package's
    benchmark: left edge fixed, right edge ux = 0.01."""
    from magnetite_tpu_torch.config import ModelMetadata
    from magnetite_tpu_torch.meshing.generators import (
        plate_with_hole_mesh, tensile_bcs_for_rect,
    )

    mesh = plate_with_hole_mesh(nr, nt)
    return mesh, tensile_bcs_for_rect(mesh.coords), ModelMetadata(E_MOD, NU, THICK, 0.0, 0.01)


def write_case_files(dirname: str, h: float) -> list:
    """input.json + outer.csv + hole.csv for the plate, as a user writes them."""
    case = {
        "metadata": {
            "part_thickness": THICK, "material_elasticity": E_MOD,
            "poisson_ratio": NU, "characteristic_length_min": 0.0,
            "characteristic_length_max": h,
        },
        "boundary_conditions": {
            "left": {"region": {"x_target_max": 1e-6},
                     "targets": {"ux": 0.0, "uy": 0.0}},
            "right": {"region": {"x_target_min": 3.0 - 1e-6},
                      "targets": {"ux": 0.01, "fy": 0.0}},
        },
    }
    paths = [os.path.join(dirname, n) for n in ("input.json", "outer.csv", "hole.csv")]
    with open(paths[0], "w") as f:
        json.dump(case, f)
    for path, loop in ((paths[1], OUTER), (paths[2], HOLE)):
        with open(path, "w") as f:
            f.write("x,y\n" + "".join(f"{x!r},{y!r}\n" for x, y in loop))
    return paths


def event_ms(fn, reps: int, flush, setup=None) -> float:
    """Median of `reps` CUDA-event timings of one call each, L2 flushed
    before every call (the solver finds these operands cold). The device
    spins after the flush while the host enqueues the call, so the events
    time the device's work and not the host's pace (a transfer kernel takes
    less device time than its wrapper takes to launch it). `setup`, where
    given, runs before each call's flush, outside the timed span (it
    restores an operand the call updates in place)."""
    import torch

    for _ in range(3):
        if setup is not None:
            setup()
        fn()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / (PEAK_GBS * 1e9) * 1e3
    t_ops = flops / (PEAK_TFLOPS[str(dtype).replace("torch.", "")] * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, ref, scale, tol):
    err = float((got - ref).abs().max())
    lim = tol * float(scale)
    say(f"  {name}: max|diff| {err:.3e} <= {lim:.3e} ({tol:g} x scale {float(scale):.3e})")
    require(err <= lim, f"{name} disagrees with its reference")
    return err


def csr(rows, cols, vals, shape):
    """A CSR matrix from COO pieces (the library yardstick's operand)."""
    import torch

    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    coo = torch.sparse_coo_tensor(idx, torch.cat(vals), shape)
    return coo.coalesce().to_sparse_csr()


def csr_of_bands(bands, offsets):
    """K of bands [D, m, m, N] on the flattened [m, N] layout."""
    import torch

    d, m, _, n = bands.shape
    node = torch.arange(n, device=bands.device)
    rows, cols, vals = [], [], []
    for k, off in enumerate(offsets):
        ok = (node + off >= 0) & (node + off < n)
        src = node[ok]
        for i in range(m):
            for j in range(m):
                rows.append(i * n + src)
                cols.append(j * n + src + off)
                vals.append(bands[k, i, j][ok])
    return csr(rows, cols, vals, (m * n, m * n))


def csr_of_stencil(st, wrap):
    """K of a stencil [9, 2, 2, R, C] on the flattened [2, R, C] layout."""
    import torch

    _, _, _, rr, cc = st.shape
    r = torch.arange(rr, device=st.device)[:, None].expand(rr, cc)
    c = torch.arange(cc, device=st.device)[None, :].expand(rr, cc)
    rows, cols, vals = [], [], []
    for s in range(9):
        dr, dt = s // 3 - 1, s % 3 - 1
        r2, c2 = r + dr, c + dt
        ok = (r2 >= 0) & (r2 < rr)
        if wrap:
            c2 = c2 % cc
        else:
            ok = ok & (c2 >= 0) & (c2 < cc)
        src, dst = (r * cc + c)[ok], (r2 * cc + c2)[ok]
        for i in range(2):
            for j in range(2):
                rows.append(i * rr * cc + src)
                cols.append(j * rr * cc + dst)
                vals.append(st[s, i, j][ok])
    return csr(rows, cols, vals, (2 * rr * cc, 2 * rr * cc))


def interleaved(tag, fns: dict, reps, flush, rounds) -> dict:
    """`rounds` rounds, each timing every call of `fns` in turn (kernel,
    library, kernel, library, ...); prints every reading, the medians and
    the spread, and returns the medians."""
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            times[k].append(event_ms(fn, reps, flush))
    med = {k: statistics.median(v) for k, v in times.items()}
    for k, v in times.items():
        say(f"    {tag} {k} in {rounds} rounds: " + " / ".join(f"{t:.4f}" for t in v)
            + f" ms; median {med[k]:.4f}, spread {min(v):.4f}-{max(v):.4f}")
    return med


def time_kernel(tag, fn, plain, library, reps, flush, nbytes, flops, dtype, rounds=1,
                parent=None):
    """Kernel, plain and library times beside the bound; returns the row.
    With rounds > 1, or beside `parent` (the same call through an older
    tree's kernel, --baseline), kernel, parent and library are the medians
    of interleaved rounds, and a line says which is faster."""
    parent_ms = None
    if rounds > 1 or parent is not None:
        fns = {"kernel": fn, "parent": parent, "library": library}
        med = interleaved(tag, {k: f for k, f in fns.items() if f is not None}, reps, flush,
                          max(rounds, ROUNDS))
        ms, parent_ms, library_ms = med["kernel"], med.get("parent"), med.get("library")
        for k in ("parent", "library"):
            if k in med:
                say(f"    {tag}: kernel median {'below' if ms < med[k] else 'NOT below'} "
                    f"the {k}'s ({ms / med[k]:.3f}x)")
    else:
        ms = event_ms(fn, reps, flush)
        library_ms = event_ms(library, reps, flush) if library is not None else None
    plain_ms = event_ms(plain, reps, flush)
    b_ms, b_by = bound(nbytes, flops, dtype)
    lib = f"{library_ms:.4f}" if library_ms is not None else "none"
    par = (f", parent {parent_ms:.4f} ms ({b_ms / parent_ms:.1%} of bound)"
           if parent_ms is not None else "")
    say(f"  {tag}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s, "
        f"{b_ms / ms:.1%} of bound {b_ms:.4f} ms by {b_by}){par}, plain {plain_ms:.4f} ms, "
        f"library {lib} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


# the sources of --baseline's kernels (mg_smooth.cu, lane_stencil_matvec.cu,
# ell_matvec.cu, lane_coarse_smooth.cu and assemble_pairs.cu where the tree
# has them), and the only entries called there
BASELINE_SOURCES = ("dia_matvec.cu", "transfer.cu", "mg_smooth.cu", "lane_stencil_matvec.cu",
                    "ell_matvec.cu", "lane_coarse_smooth.cu", "assemble_pairs.cu")


def load_baseline(tree: str):
    """An older checkout's dia_matvec, prolong0, fused smoothing and lane
    stencil kernels (`tree`, e.g. the parent commit unpacked by git
    archive), built apart from this tree's library with their C signatures
    bound here (the lane stencil kernel's are PR 9's, on stencils in the
    JAX layout): (seconds, ctypes library)."""
    import ctypes
    import shutil
    from magnetite_tpu_torch.kernels import cuda_lib

    csrc = os.path.join(tree, "magnetite_tpu_torch", "csrc")
    out = os.path.join(cuda_lib.BUILD_DIR, "baseline")
    os.makedirs(out, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    t0 = time.perf_counter()
    objs, procs = [], []
    sources = [src for src in BASELINE_SOURCES if os.path.exists(os.path.join(csrc, src))]
    for src in sources:
        objs.append(os.path.join(out, f"{src}.o"))
        procs.append(subprocess.Popen(
            [nvcc, *cuda_lib.NVCC_FLAGS, "-c", os.path.join(csrc, src), "-o", objs[-1]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for src, proc in zip(sources, procs):
        _, err = proc.communicate(timeout=600)
        require(proc.returncode == 0, f"baseline {src} did not build:\n{err[-4000:]}")
        for line in err.splitlines():
            if "registers" in line:
                say(f"    baseline {src}: {line.strip()}")
    so = os.path.join(out, "libbaseline_kernels.so")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", *objs, "-o", so],
        capture_output=True, text=True, timeout=600)
    require(link.returncode == 0, f"baseline link failed:\n{link.stderr[-4000:]}")
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mt_dia_matvec.restype = i32
    lib.mt_dia_matvec.argtypes = [i32, i32, vp, vp, i32, vp, vp, i64, vp]
    lib.mt_prolong0.restype = i32
    lib.mt_prolong0.argtypes = [i32, vp, vp, vp, vp, i64, vp]
    if "mg_smooth.cu" in sources:
        lib.mt_mg_presmooth.restype = i32
        lib.mt_mg_presmooth.argtypes = [i32, i32, vp, vp, vp, vp, vp, i32, i32, vp]
        lib.mt_mg_postsmooth.restype = i32
        lib.mt_mg_postsmooth.argtypes = [i32, i32, vp, vp, vp, vp, vp, vp, i32, i32, vp]
    lib.has_mg_smooth = "mg_smooth.cu" in sources
    if "lane_stencil_matvec.cu" in sources:
        lib.mt_lane_stencil_matvec.restype = i32
        lib.mt_lane_stencil_matvec.argtypes = [i32, i32, i32, vp, vp, vp, i32, i32, i64, i32, vp]
        lib.mt_lane_stencil_matvec3.restype = i32
        lib.mt_lane_stencil_matvec3.argtypes = [
            i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i64, i32, vp]
    lib.has_lane_stencil = "lane_stencil_matvec.cu" in sources
    # the parent tree's ELL kernel and coarse smoother, by their C
    # signatures there
    if "ell_matvec.cu" in sources:
        lib.mt_ell_matvec.restype = i32
        lib.mt_ell_matvec.argtypes = [i32, vp, vp, vp, vp, i64, i64, i32, vp]
    lib.has_ell = "ell_matvec.cu" in sources
    if "lane_coarse_smooth.cu" in sources:
        lib.mt_lane_coarse_smooth3.restype = i32
        lib.mt_lane_coarse_smooth3.argtypes = [
            i32, i32, vp, vp, vp, vp, vp, vp, vp, i32, i32, i64, i32, ctypes.c_double, vp]
    lib.has_lane_coarse = "lane_coarse_smooth.cu" in sources
    # PR 14's assembly kernel, one thread a slot over int64 runs; later
    # trees name their entries otherwise
    lib.has_assemble = "assemble_pairs.cu" in sources and hasattr(lib, "mt_assemble_pairs")
    if lib.has_assemble:
        lib.mt_assemble_pairs.restype = i32
        lib.mt_assemble_pairs.argtypes = [vp, vp, vp, vp, i64, i64, ctypes.c_double,
                                          ctypes.c_double, ctypes.c_double, ctypes.c_double,
                                          vp, vp]
    lib.mt_error_string.restype = ctypes.c_char_p
    lib.mt_error_string.argtypes = [i32]
    return time.perf_counter() - t0, lib


def baseline_launchers(base):
    """Calls of an older tree's band and prolong kernels (`base`, the
    library of --baseline) on the same operands as the wrappers', or
    (None, None) without one."""
    if base is None:
        return None, None
    import torch
    from magnetite_tpu_torch.kernels import cuda_lib

    def dia(bands, u, offsets_dev):
        d, m, _, n = bands.shape
        y = torch.empty_like(u)
        rc = base.mt_dia_matvec(cuda_lib.DTYPE_CODES[u.dtype], m, bands.data_ptr(),
                                offsets_dev.data_ptr(), d, u.data_ptr(), y.data_ptr(), n,
                                cuda_lib.stream_of(u))
        cuda_lib.check(base, rc, "baseline dia_matvec")
        return y

    def prolong(ec, agg, p0):
        n0 = agg.shape[0]
        u0 = torch.empty((2, n0), dtype=ec.dtype, device=ec.device)
        rc = base.mt_prolong0(cuda_lib.DTYPE_CODES[ec.dtype], ec.data_ptr(), agg.data_ptr(),
                              p0.data_ptr(), u0.data_ptr(), n0, cuda_lib.stream_of(ec))
        cuda_lib.check(base, rc, "baseline prolong0")
        return u0

    return dia, prolong


def baseline_ell_launcher(base):
    """A call of an older tree's ELL kernel on the wrapper's operands, or
    None where --baseline is absent or its tree has none."""
    if base is None or not base.has_ell:
        return None
    import torch
    from magnetite_tpu_torch.kernels import cuda_lib

    def ell(data, cols, u):
        k, n = cols.shape
        y = torch.empty((2, n), dtype=u.dtype, device=u.device)
        rc = base.mt_ell_matvec(cuda_lib.DTYPE_CODES[u.dtype], data.data_ptr(), cols.data_ptr(),
                                u.data_ptr(), y.data_ptr(), n, u.shape[1], k,
                                cuda_lib.stream_of(u))
        cuda_lib.check(base, rc, "baseline ell_matvec")
        return y

    return ell


def baseline_coarse_launcher(base):
    """A call of an older tree's fused coarse smoother (the same C
    signature) on the wrapper's operands, or None where --baseline is
    absent or its tree has none."""
    if base is None or not base.has_lane_coarse:
        return None
    import torch
    from magnetite_tpu_torch.kernels import cuda_lib

    def coarse(packed, dinv, w3, r, wrap, sweeps, omega):
        rows, cols, nb = r.shape[1], r.shape[2], r.shape[3]
        e = torch.empty_like(r)
        rc = base.mt_lane_coarse_smooth3(
            cuda_lib.DTYPE_CODES[r.dtype], int(wrap), packed.data_ptr(), dinv.data_ptr(),
            *(w.data_ptr() for w in w3), r.data_ptr(), e.data_ptr(), rows, cols, nb, sweeps,
            omega, cuda_lib.stream_of(r))
        cuda_lib.check(base, rc, "baseline lane_coarse_smooth3")
        return e

    return coarse


def baseline_mg_launchers(base):
    """Calls of an older tree's mg_presmooth / mg_postsmooth kernels on the
    same operands as the wrappers', or (None, None) where --baseline is
    absent or its tree has none."""
    if base is None or not base.has_mg_smooth:
        return None, None
    import torch
    from magnetite_tpu_torch.kernels import cuda_lib
    from magnetite_tpu_torch.kernels.mg_smooth_kernel import coarse_shape

    def pre(st, dinv, r, wrap):
        rows, cols = r.shape[-2:]
        e = torch.empty_like(r)
        rc = torch.empty((2, *coarse_shape(rows, cols, wrap)), dtype=r.dtype, device=r.device)
        code = base.mt_mg_presmooth(cuda_lib.DTYPE_CODES[r.dtype], int(wrap), st.data_ptr(),
                                    dinv.data_ptr(), r.data_ptr(), e.data_ptr(), rc.data_ptr(),
                                    rows, cols, cuda_lib.stream_of(r))
        cuda_lib.check(base, code, "baseline mg_presmooth")
        return e, rc

    def post(st, dinv, r, e, ec, wrap):
        rows, cols = r.shape[-2:]
        out = torch.empty_like(r)
        code = base.mt_mg_postsmooth(
            cuda_lib.DTYPE_CODES[r.dtype], int(wrap), st.data_ptr(), dinv.data_ptr(),
            r.data_ptr(), None if e is None else e.data_ptr(),
            None if ec is None else ec.data_ptr(), out.data_ptr(), rows, cols,
            cuda_lib.stream_of(r))
        cuda_lib.check(base, code, "baseline mg_postsmooth")
        return out

    return pre, post


def phase_band_and_transfer(problem, reps, flush, rand, base=None):
    """Phases 2 and 3: the band and transfer kernels against their plain
    versions on the card (and against an older tree's, `base`)."""
    import torch
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec, dia_matvec_blocks
    from magnetite_tpu_torch.kernels.transfer_kernel import (
        prolong0, prolong0_plain, restrict0, restrict0_plain,
    )

    base_dia, base_prolong = baseline_launchers(base)
    results = {}
    # the banded levels the V-cycle runs its matvec on: all but the
    # coarsest, and the coarsest only where it has no dense inverse
    # (amg.make_coarse_cycle)
    amg = problem.system.amg
    last = len(amg.coarse_bands) - 1
    coarse = [(l, cb) for l, cb in enumerate(amg.coarse_bands)
              if cb is not None and (l < last or amg.ci is None)]
    require(bool(coarse), "the V-cycle runs no banded coarse level")
    say("phase 2: band matvec kernel against dia_matvec_blocks on the card, level 0 and "
        f"every banded coarse level the V-cycle launches ({len(coarse)})")
    for label, bands64, offsets in (
        ("level-0 m=2", problem.system.bands, problem.system.offsets),
        *((f"coarse level {l + 1} m=3", cb.bands, cb.offsets) for l, cb in coarse),
    ):
        d, m, _, n = bands64.shape
        offsets_dev = torch.tensor(offsets, dtype=torch.int32, device=DEV)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            bands = bands64.to(dtype).contiguous()
            u = rand(m, n, dtype=dtype)
            scale = dia_matvec_blocks(bands.abs(), offsets, u.abs()).max()
            ref = dia_matvec_blocks(bands, offsets, u)
            tag = f"dia_matvec {label} D={d} N={n} {str(dtype)[6:]}"
            y = dia_matvec(bands, offsets, u, offsets_dev)
            err = compare(tag, y, ref, scale, tol)
            require(torch.equal(y, dia_matvec(bands, offsets, u, offsets_dev)),
                    f"{tag}: a second call differs")
            parent = None
            if base_dia is not None:
                compare(f"parent {tag}", base_dia(bands, u, offsets_dev), ref, scale, tol)
                parent = lambda: base_dia(bands, u, offsets_dev)  # noqa: E731
            a = csr_of_bands(bands, offsets)
            x = u.reshape(-1)
            compare(f"library CSR SpMV {tag}", torch.mv(a, x).reshape(m, n), ref, scale, tol)
            nbytes = (d * m * m * n + 2 * m * n) * bands.element_size() + 4 * d
            row = time_kernel(
                tag, lambda: dia_matvec(bands, offsets, u, offsets_dev),
                lambda: dia_matvec_blocks(bands, offsets, u), lambda: torch.mv(a, x),
                reps, flush, nbytes, 2 * d * m * m * n, dtype,
                rounds=1 if m == 2 else ROUNDS, parent=parent,
            )
            del a
            if m == 3:
                # the V-cycle's call: a node-major [n, 3] field through
                # op(x.T).T, whose wrapper copies x.T to [3, n] first
                xn = u.T.contiguous()
                call = event_ms(lambda: dia_matvec(bands, offsets, xn.T, offsets_dev).T,
                                reps, flush)
                copy = event_ms(lambda: xn.T.contiguous(), reps, flush)
                say(f"    {tag}: the V-cycle's call op(x.T).T {call:.4f} ms, the copy alone "
                    f"{copy:.4f} ms; the kernel's gap to its bound "
                    f"{row['ms'] - row['bound_ms']:.4f} ms")
            if dtype == torch.float64 and (m == 2 or "dia_matvec m=3" not in results):
                results["dia_matvec" if m == 2 else "dia_matvec m=3"] = dict(
                    max_abs_err=err, **row)

    say("phase 3: level-0 transfer kernels against the plain gathers on the card")
    agg, p0_64, ptc, ptv_64, _ = problem.system.amg.fast0
    n0, n1, w0 = agg.shape[0], ptc.shape[0], ptc.shape[1]
    node = torch.arange(n0, device=DEV)
    agg64 = agg.long()
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        p0, ptv = p0_64.to(dtype).contiguous(), ptv_64.to(dtype).contiguous()
        ec, tmp = rand(n1, 3, dtype=dtype), rand(2, n0, dtype=dtype)
        es, name = p0.element_size(), str(dtype)[6:]
        # P0 as a CSR on the flattened layouts: uf [2, n0] <- ec [n1, 3]
        prow = [c * n0 + node for c in range(2) for k in range(3)]
        pcol = [agg64 * 3 + k for c in range(2) for k in range(3)]
        pval = [p0[:, c, k] for c in range(2) for k in range(3)]
        p_csr = csr(prow, pcol, pval, (2 * n0, 3 * n1))
        pt_csr = csr(pcol, prow, pval, (3 * n1, 2 * n0))
        scale_p = prolong0_plain(ec.abs(), agg, p0.abs()).max()
        uf = prolong0(ec, agg, p0)
        ref_p = prolong0_plain(ec, agg, p0)
        err_p = compare(f"prolong0 n0={n0} n1={n1} {name}", uf, ref_p, scale_p, tol)
        compare(f"library CSR prolong {name}", torch.mv(p_csr, ec.reshape(-1)).reshape(2, n0),
                ref_p, scale_p, tol)
        parent = None
        if base_prolong is not None:
            compare(f"parent prolong0 {name}", base_prolong(ec, agg, p0), ref_p, scale_p, tol)
            parent = lambda: base_prolong(ec, agg, p0)  # noqa: E731
        scale_r = restrict0_plain(tmp.abs(), ptc, ptv.abs()).max()
        rc = restrict0(tmp, ptc, ptv)
        ref_r = restrict0_plain(tmp, ptc, ptv)
        err_r = compare(f"restrict0 w0={w0} {name}", rc, ref_r, scale_r, tol)
        compare(f"library CSR restrict {name}", torch.mv(pt_csr, tmp.reshape(-1)).reshape(n1, 3),
                ref_r, scale_r, tol)
        lhs, rhs = float((uf * tmp).sum()), float((ec * rc).sum())
        mag = float((prolong0(ec.abs(), agg, p0.abs()) * tmp.abs()).sum())
        say(f"  adjoint {name}: |<P0 x, y> - <x, P0^T y>| = {abs(lhs - rhs):.3e} "
            f"<= {tol:g} x {mag:.3e}")
        require(abs(lhs - rhs) <= tol * mag, "prolong0 / restrict0 are not adjoint")
        for kname, fn, plain, lib, nbytes, err, par in (
            ("prolong0", lambda: prolong0(ec, agg, p0), lambda: prolong0_plain(ec, agg, p0),
             lambda: torch.mv(p_csr, ec.reshape(-1)), (8 * n0 + 3 * n1) * es + 4 * n0, err_p,
             parent),
            ("restrict0", lambda: restrict0(tmp, ptc, ptv),
             lambda: restrict0_plain(tmp, ptc, ptv), lambda: torch.mv(pt_csr, tmp.reshape(-1)),
             (6 * n1 * w0 + 2 * n0 + 3 * n1) * es + 4 * n1 * w0, err_r, None),
        ):
            row = time_kernel(f"{kname} {name}", fn, plain, lib, reps, flush,
                              nbytes, 12 * n0, dtype, rounds=ROUNDS, parent=par)
            if dtype == torch.float64:
                results[kname] = dict(max_abs_err=err, **row)
        del p_csr, pt_csr
    return results


def phase_df(problem, reps, flush, rand):
    """Phase 4: the double-float kernel on the Delaunay plate's level-0 bands."""
    import torch
    from magnetite_tpu_torch.kernels.df_kernel import (
        df_dia_matvec, df_dia_matvec_plain, split_bands,
    )
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec, dia_matvec_blocks

    say("phase 4: double-float band kernel against its plain version and exact f64")
    bands, offsets = problem.system.bands, problem.system.offsets
    d, _, _, n = bands.shape
    offsets_dev = torch.tensor(offsets, dtype=torch.int32, device=DEV)
    hl = split_bands(bands)
    u = rand(2, n, dtype=torch.float64)
    scale = dia_matvec_blocks(bands.abs(), offsets, u.abs()).max()
    got = df_dia_matvec(hl, offsets, u, offsets_dev)
    # the kernel repeats its plain version's f32 operations one for one
    # (no FMA contraction): a broken Veltkamp split or two-sum would show
    # as ~1e-8 of the scale
    compare("df_dia_matvec vs its plain version", got,
            df_dia_matvec_plain(hl, offsets, u), scale, 1e-14)
    # the pairs' accuracy: ~2^-46 per term, 2-4e-14 of the scale on these
    # fields; tests/test_pallas_kernel.py holds the TPU kernel to 1e-13
    exact = dia_matvec_blocks(bands, offsets, u)
    err = compare("df_dia_matvec vs exact f64", got, exact, scale, 1e-13)
    f32 = dia_matvec_blocks(bands.float(), offsets, u.float()).double()
    say(f"  (plain f32 for contrast: max|diff| {float((f32 - exact).abs().max()):.3e})")
    a = csr_of_bands(bands, offsets)
    x = u.reshape(-1)
    tag = f"df_dia_matvec D={d} N={n}"
    # f64 and df in turns: f64, df, df, f64
    f64_a = event_ms(lambda: dia_matvec(bands, offsets, u, offsets_dev), reps, flush)
    row = time_kernel(
        tag, lambda: df_dia_matvec(hl, offsets, u, offsets_dev),
        lambda: df_dia_matvec_plain(hl, offsets, u), lambda: torch.mv(a, x),
        reps, flush, (d * 8 * n) * 4 + 2 * 2 * n * 8 + 4 * d, 150 * d * n, torch.float32,
    )
    df_b = event_ms(lambda: df_dia_matvec(hl, offsets, u, offsets_dev), reps, flush)
    f64_b = event_ms(lambda: dia_matvec(bands, offsets, u, offsets_dev), reps, flush)
    say(f"  df vs f64 in turns: dia_matvec<double> {f64_a:.4f} / {f64_b:.4f} ms, "
        f"df_dia_matvec {row['ms']:.4f} / {df_b:.4f} ms "
        f"(df / f64 = {(row['ms'] + df_b) / (f64_a + f64_b):.3f})")
    del a, hl
    return {"df_dia_matvec": dict(max_abs_err=err, **row)}


def run_cli(argv) -> tuple:
    """magnetite_tpu_torch.cli.main(argv), echoing and returning its stdout
    and its stderr (where the warnings go)."""
    from magnetite_tpu_torch import cli

    class Tee(io.StringIO):
        def __init__(self, stream):
            super().__init__()
            self.stream = stream

        def write(self, s):
            self.stream.write(s)
            return super().write(s)

    out, err = Tee(sys.__stdout__), Tee(sys.__stderr__)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    sys.stdout.flush()
    require(rc == 0, f"cli.main returned {rc}")
    return out.getvalue(), err.getvalue()


def true_residual(problem, u, k_op):
    """||b - K u|| / ||b|| of the reduced system in f64 for the unreduced
    operator `k_op` on [2, N] fields; u [N, 2] in the problem's node
    order."""
    import torch

    u_t = torch.from_numpy(u.T.copy()).to(DEV, torch.float64)
    free_t = (~problem.u_known).double().T
    fixed_t = 1.0 - free_t
    uf_t, f_t = problem.u_value.double().T, problem.f_value.double().T
    b = free_t * (f_t - k_op(uf_t)) + fixed_t * uf_t
    res = b - (free_t * k_op(free_t * u_t) + fixed_t * u_t)
    return float(res.norm() / b.norm())


def true_residual_banded(problem, u):
    """The true relative residual with the plain band operator; u [N, 2] in
    the problem's (renumbered) node order."""
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec_blocks

    bands, offsets = problem.system.bands.double(), problem.system.offsets
    return true_residual(problem, u, lambda v: dia_matvec_blocks(bands, offsets, v))


def cli_summary(out: str) -> tuple:
    """(operator, preconditioner, refine, iterations) of a CLI run's log."""
    op, pre = re.search(r"info: operator=(\w+) preconditioner=(\w+)", out).groups()
    refine = re.search(r"refine=(\w+)", out).group(1)
    iters = int(re.search(r"finished conjugate gradient in (\d+) iterations", out).group(1))
    return op, pre, refine, iters


def cli_path(name, problem, mesh, h, workdir, extra, tol, totals):
    """The Delaunay plate through the CLI; checks the CSVs and the true
    residual against `tol`. Returns the CSVs' rows (nodes, elements), the
    iterations and the stage times."""
    import numpy as np

    case_dir = os.path.join(workdir, name)
    os.makedirs(case_dir)
    argv = write_case_files(case_dir, h) + [
        "--device", DEV, "--backend", "delaunay", "--skip", "--out-dir", case_dir,
    ] + extra
    t0 = time.perf_counter()
    with main_path(name, totals, ("dia_matvec m=2", "dia_matvec m=3", "prolong0", "restrict0")):
        out, _ = run_cli(argv)
    wall = time.perf_counter() - t0
    op, pre, refine, iters = cli_summary(out)
    timings = json.loads(re.search(r"info: timings (\{.*\})", out).group(1))
    mesh_s = float(re.search(r"stage 'mesh' took ([\d.]+)s", out).group(1))
    say(f"  cli wall {wall:.2f} s; operator={op} preconditioner={pre} refine={refine} "
        f"iterations={iters}")
    say("  stage timings (s): " + json.dumps({"mesh": mesh_s, **timings}))
    require(op == "dia" and pre == "amg", f"expected dia/amg, got {op}/{pre}")
    require(refine == str("--precision" in extra), f"refine={refine}")

    with open(os.path.join(case_dir, "nodes.csv")) as f:
        require(f.readline().strip() == "x,y,ux,uy", "nodes.csv header")
    with open(os.path.join(case_dir, "elements.csv")) as f:
        require(f.readline().strip() == "n0,n1,n2,stress", "elements.csv header")
    nodes = np.loadtxt(os.path.join(case_dir, "nodes.csv"), delimiter=",", skiprows=1)
    elems = np.loadtxt(os.path.join(case_dir, "elements.csv"), delimiter=",", skiprows=1)
    require(nodes.shape == (mesh.num_nodes, 4), f"nodes.csv rows {nodes.shape}")
    require(elems.shape == (mesh.num_elements, 4), f"elements.csv rows {elems.shape}")
    require(np.array_equal(nodes[:, :2], mesh.coords), "nodes.csv coordinates")
    require(np.array_equal(elems[:, :3].astype(np.int32), mesh.tris), "elements.csv tris")
    require(np.isfinite(nodes).all() and np.isfinite(elems).all(), "non-finite output")
    u = nodes[:, 2:] if problem.perm is None else nodes[problem.perm, 2:]
    rel = true_residual_banded(problem, u)
    say(f"  true relative residual ||b - K u|| / ||b|| = {rel:.3e} (<= {tol:g})")
    require(rel <= tol, "true residual too large")
    return nodes, elems, iters, cli_stages(out)


def phase_mixed_df(problem, mesh, bca, md, totals):
    """Phase 6b: refined AMG with the double-float CG matvec, reusing the
    hierarchy built for the f64 problem."""
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import compile_problem

    opts = SolverOptions(dtype="float32", refine="on", cg_rtol=1e-8, df_matvec="on")
    with main_path("the df_matvec='on' solve", totals, ("df_dia_matvec", "prolong0")):
        t0 = time.perf_counter()
        prob = compile_problem(mesh, bca, md, opts, amg_setup=problem.amg_setup, device=DEV)
        prep = time.perf_counter() - t0
        res = prob.solve()
    require(prob.system.df64 == "kernel" and prob.refine, f"df64={prob.system.df64!r} refine={prob.refine}")
    u = res.u if prob.perm is None else res.u[prob.perm]
    rel = true_residual_banded(problem, u)
    say(f"  df run: prep {prep:.2f} s, solve_s {res.timings['solve_s']:.4f}, "
        f"{res.iterations} iterations, reported residual_rel {res.residual_rel:.3e}, "
        f"true relative residual {rel:.3e} (<= 2e-08)")
    require(rel <= 2e-8, "df run: true residual too large")
    warm = [prob.solve().timings["solve_s"] for _ in range(2)]
    say(f"  df run warm solve_s: {warm}")


# ---------------- persistence and observability (phase 21) -----------------


# the host prep stages of a CLI run: meshing or the loads, then the compile's
PREP_STAGES = ("mesh", "load-case", "load-amg", "load-operator", "structure_s",
               "assemble_s", "amg_build_s", "upload_s", "amg_upload_s")


def cli_stages(out: str) -> dict:
    """Stage times of a CLI run: its `stage '...' took` lines and the
    compile's `info: timings` keys; "prep" sums PREP_STAGES."""
    stages = {name: float(s) for name, s in re.findall(r"stage '([\w-]+)' took ([\d.]+)s", out)}
    stages.update(json.loads(re.search(r"info: timings (\{.*\})", out).group(1)))
    stages["prep"] = sum(stages.get(k, 0.0) for k in PREP_STAGES)
    return stages


def read_csvs(out_dir):
    import numpy as np

    nodes = np.loadtxt(os.path.join(out_dir, "nodes.csv"), delimiter=",", skiprows=1)
    elems = np.loadtxt(os.path.join(out_dir, "elements.csv"), delimiter=",", skiprows=1)
    return nodes, elems


def resume_cli(name, problem, argv, fresh, totals):
    """A --load-case CLI run (no geometry): an operator-cache hit with the
    AMG hierarchy loaded and no rebuild or miss warning, CSVs within the
    golden bars of the `fresh` run's, the true residual <= 1e-9 with the
    plain operator. Returns its stage times."""
    expect = ("dia_matvec m=2", "dia_matvec m=3", "prolong0", "restrict0")
    with main_path(name, totals, expect):
        out, err = run_cli(argv)
    require("info: operator cache hit" in out, f"{name}: no operator cache hit")
    require("info: loaded AMG hierarchy cache" in out, f"{name}: AMG cache not loaded")
    require("warning" not in err, f"{name}: warned: {err.strip()[:300]}")
    nodes, elems = read_csvs(argv[argv.index("--out-dir") + 1])
    (nodes_f, elems_f), iters_f = fresh
    golden_against(f"{name} against the fresh run", nodes, elems, nodes_f, elems_f)
    u = nodes[:, 2:] if problem.perm is None else nodes[problem.perm, 2:]
    rel = true_residual_banded(problem, u)
    iters = int(re.search(r"finished conjugate gradient in (\d+) iterations", out).group(1))
    say(f"  {name}: {iters} iterations (fresh {iters_f}); true relative residual "
        f"{rel:.3e} (<= 1e-09)")
    require(rel <= 1e-9, f"{name}: true residual too large")
    return cli_stages(out)


def print_prep(label, runs: dict):
    """Each prep stage of several CLI runs side by side (seconds)."""
    say(f"  {label} (s): " + "; ".join(
        f"{k}: " + " / ".join(f"{r[k]:.4f}" if k in r else "-" for r in runs.values())
        for k in PREP_STAGES + ("prep", "solve_s")) + f"  [{' / '.join(runs)}]")


def child_cli_stages(argv, env_extra) -> dict:
    """The CLI in a fresh process (its own heap and CUDA context): its stage
    times."""
    env = dict(os.environ, **env_extra)
    proc = subprocess.run([sys.executable, "-m", "magnetite_tpu_torch.cli", *argv],
                          capture_output=True, text=True, timeout=600, env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    require(proc.returncode == 0, f"child CLI failed: {proc.stderr[-2000:]}")
    return cli_stages(proc.stdout)


def observed_solve(name, problem, kernel, totals):
    """Phase 21d on one compiled problem with residual_history=64 and
    cg_progress_every=8: the history's length and last entry, the progress
    lines, the same `kernel` launches as the problem without them, and warm
    solve_s with and without, interleaved."""
    import dataclasses

    plain = dataclasses.replace(problem, history=0, progress_every=0)
    # the part's first solve: eager (a later one replays CUDA graphs, which
    # the wrappers' counters do not count)
    with main_path(f"the {name} solve without them", totals, (kernel,)) as got_plain:
        ref = plain.solve()
    with main_path(f"the {name} solve with history and progress", totals, (kernel,)) as got:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = problem.solve()
    k, hist = res.iterations, res.residual_history
    lines = re.findall(r"info: cg iteration (\d+): residual", buf.getvalue())
    say(f"  {name}: {k} iterations (without: {ref.iterations}); history {len(hist)} entries, "
        f"last {hist[-1]:.6e} vs residual_norm {res.residual_norm:.6e}; progress lines at "
        f"{lines}")
    require(len(hist) == min(k, 64), f"{name}: history length {len(hist)}")
    if k <= 64:
        require(abs(hist[-1] - res.residual_norm) <= 1e-12 * res.residual_norm,
                f"{name}: last history entry is not the residual norm")
    require([int(i) for i in lines] == list(range(8, k + 1, 8)), f"{name}: progress lines")
    require(got[kernel] == got_plain[kernel] and k == ref.iterations,
            f"{name}: {kernel} launches {got[kernel]} with history, {got_plain[kernel]} "
            "without")
    warm = {"with": [], "without": []}
    for _ in range(3):
        with contextlib.redirect_stdout(io.StringIO()):
            warm["with"].append(problem.solve().timings["solve_s"])
        warm["without"].append(plain.solve().timings["solve_s"])
    say(f"  {name}: {kernel} launches {got[kernel]} with and without; warm solve_s with "
        f"history + progress {warm['with']}, without {warm['without']}")


def phase_resume(problem, mesh, bca, md, args, totals):
    """Phase 21: the Delaunay plate saved by one CLI run and resumed by
    others (f64 and mixed), the malloc tuning's prep A/B in fresh processes,
    residual history and progress on the plate and the structured plate,
    and --profile on a small CLI run."""
    from magnetite_tpu_torch import persist
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import compile_problem

    h = args.h
    with tempfile.TemporaryDirectory() as workdir:
        say(f"phase 21: --save-case / --load-case on the Delaunay plate at h={h}")
        paths = write_case_files(workdir, h)
        case = os.path.join(workdir, "case.npz")
        flags = ["--device", DEV, "--skip"]
        dirs = {k: os.path.join(workdir, k) for k in ("fresh", "resumed", "mixed", "child")}
        for d in dirs.values():
            os.makedirs(d)
        expect = ("dia_matvec m=2", "dia_matvec m=3", "prolong0", "restrict0")
        with main_path("the --save-case CLI run", totals, expect):
            out, _ = run_cli(paths + flags + [
                "--backend", "delaunay", "--save-case", case, "--out-dir", dirs["fresh"]])
        fresh_stages = cli_stages(out)
        fresh = (read_csvs(dirs["fresh"]),
                 int(re.search(r"finished conjugate gradient in (\d+)", out).group(1)))
        u = fresh[0][0][:, 2:]
        rel = true_residual_banded(problem, u if problem.perm is None else u[problem.perm])
        say(f"  fresh run: true relative residual {rel:.3e} (<= 1e-09)")
        require(rel <= 1e-9, "--save-case run: true residual too large")
        sizes = {s or ".npz": os.path.getsize(case + s) for s in ("", ".amg.npz", ".op.npz")}
        say("  files (bytes): " + json.dumps(sizes) + "; save stages (s): " + json.dumps(
            {k: fresh_stages[k] for k in ("save-case", "save-amg", "save-operator")}))
        op = persist.load_operator(case + ".op.npz")
        n_neg = sum(1 for o in op.offsets if o < 0)
        n = problem.system.bands.shape[-1]
        say(f"  operator cache: mode {op.mode}, {len(op.offsets)} offsets, sym_half "
            f"{op.sym_half}, flat {op.flat.shape} ({len(op.offsets) - n_neg} x {n} rows)")
        require(op.sym_half and op.flat.shape == ((len(op.offsets) - n_neg) * n, 4),
                "the operator cache does not hold the symmetric half")

        resumed = resume_cli("the --load-case CLI run", problem, [
            paths[0], "--load-case", case, "--out-dir", dirs["resumed"]] + flags,
            fresh, totals)
        mixed = resume_cli("the --load-case --precision mixed CLI run", problem, [
            paths[0], "--load-case", case, "--precision", "mixed",
            "--out-dir", dirs["mixed"]] + flags, fresh, totals)
        print_prep("prep stages, fresh / resumed / resumed mixed",
                   {"fresh": fresh_stages, "resumed": resumed, "mixed": mixed})
        require(resumed["assemble_s"] < 0.1 * fresh_stages["assemble_s"]
                and resumed["amg_build_s"] < 0.1 * fresh_stages["amg_build_s"]
                and "mesh" not in resumed, "the resumed run did not skip its prep stages")

        say("  malloc tuning: the same fresh CLI run in child processes, tuned and with "
            "MAGNETITE_NO_MALLOC_TUNE=1, twice each, interleaved")
        child = {}
        for rnd in range(2):
            for tag, env in (("tuned", {}), ("untuned", {"MAGNETITE_NO_MALLOC_TUNE": "1"})):
                child[f"{tag} {rnd + 1}"] = child_cli_stages(
                    paths + flags + ["--backend", "delaunay", "--out-dir", dirs["child"]], env)
        print_prep("prep stages of the children", child)

    say("  residual history (64) and progress (every 8) through compile_problem / solve")
    opts = SolverOptions(residual_history=64, cg_progress_every=8)
    observed_solve("Delaunay plate f64", compile_problem(
        mesh, bca, md, opts, amg_setup=problem.amg_setup, device=DEV), "dia_matvec", totals)
    smesh, sbca, smd = structured_case(*args.plate)
    observed_solve("structured plate f64", compile_problem(
        smesh, sbca, smd, SolverOptions(dtype="float64", cg_rtol=1e-8, residual_history=64,
                                        cg_progress_every=8), device=DEV),
        "stencil_matvec", totals)
    del smesh, sbca

    with tempfile.TemporaryDirectory() as workdir:
        say(f"  --profile on the CLI at h={args.small_h}")
        paths = write_case_files(workdir, args.small_h)
        trace_dir = os.path.join(workdir, "trace")
        with main_path("the --profile CLI run", totals, ("dia_matvec m=2",)):
            run_cli(paths + ["--device", DEV, "--skip", "--backend", "delaunay",
                                    "--out-dir", workdir, "--profile", trace_dir])
        path = os.path.join(trace_dir, "trace.json")
        require(os.path.exists(path), "no trace written")
        with open(path) as f:
            text = f.read()
        n_kernel = text.count("dia_matvec")
        say(f"  trace {path}: {len(text)} bytes, 'dia_matvec' named {n_kernel} times")
        require(n_kernel > 0, "the trace does not name dia_matvec")


def true_residual_stencil(problem, res):
    """||b - K u|| / ||b|| of the reduced grid system, f64, plain stencil."""
    import torch
    from magnetite_tpu_torch.fem.stencil import stencil_matvec_plain

    rows, cols, wrap, _ = problem.system.grid
    raw, red = problem.system.stencil.double(), problem.system.reduced.double()

    def grid(a):
        return torch.from_numpy(a.T.copy()).to(DEV, torch.float64).reshape(2, rows, cols)

    free = (~problem.u_known).double().T.reshape(2, rows, cols)
    fixed = 1.0 - free
    uf = problem.u_value.double().T.reshape(2, rows, cols)
    f = problem.f_value.double().T.reshape(2, rows, cols)
    b = free * (f - stencil_matvec_plain(raw, fixed * uf, wrap)) + fixed * uf
    r = b - stencil_matvec_plain(red, grid(res.u), wrap)
    return float(r.norm() / b.norm())


def vcycles(inner_per_pass, maxiter):
    """V-cycles one classic-refinement solve launched: each inner PCG
    applies the preconditioner once up front and once per loop step, and
    its loop runs in chunks of cg.CHECK_EVERY steps."""
    from magnetite_tpu_torch.fem.cg import CHECK_EVERY

    return sum(
        1 + min(maxiter, CHECK_EVERY * max(1, math.ceil(k / CHECK_EVERY)))
        for k in inner_per_pass
    )


def check_vcycle_launches(key, problem, got, vcycles_run):
    """Each smoothing level of each V-cycle is one mg_presmooth and one
    mg_postsmooth launch (a coarsest level without a dense inverse adds
    COARSE_SWEEPS / SWEEPS post-smoothing launches), and no coarse level
    calls stencil_matvec."""
    from magnetite_tpu_torch.fem.multigrid import COARSE_SWEEPS, SWEEPS
    from magnetite_tpu_torch.kernels.stencil_kernel import stencil_matvec

    levels = problem.system.mg_levels
    pre = len(levels) - 1
    post = pre + (0 if levels[-1].dense_inv is not None else COARSE_SWEEPS // SWEEPS)
    say(f"  {key}: {vcycles_run} V-cycles; mg_presmooth {got['mg_presmooth']} launches "
        f"(expected {pre} x {vcycles_run}), mg_postsmooth {got['mg_postsmooth']} "
        f"(expected {post} x {vcycles_run})")
    require(got["mg_presmooth"] == pre * vcycles_run
            and got["mg_postsmooth"] == post * vcycles_run,
            f"structured {key}: fused smoothing launches per V-cycle")
    coarse = {(lv.rows, lv.cols) for lv in levels[1:]}
    stray = [k for k in stencil_matvec.shape_launches if k[:2] in coarse]
    require(not stray, f"structured {key}: stencil_matvec launched at coarse levels {stray}")


def phase_structured(nr, nt, totals, profile, refs=None):
    """Phase 7: the structured plate, f32 storage + refinement, and f64.
    Returns the f64 solve's multigrid levels, finest (the reduced operator)
    first; `refs`, when given, receives each solve's answer (u, stress, von
    Mises, iterations, passes) for phase 24."""
    import torch
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import compile_problem

    mesh, bca, md = structured_case(nr, nt)
    say(f"phase 7: structured plate {nr}x{nt}: {mesh.num_nodes} nodes, "
        f"{mesh.num_elements} elements, grid {mesh.grid_shape}")
    keep = None
    for key, opts, refine in (
        ("f32 refined", SolverOptions(dtype="float32", cg_rtol=1e-8), True),
        ("f64", SolverOptions(dtype="float64", cg_rtol=1e-8), False),
    ):
        expect = ("stencil_matvec", "mg_presmooth", "mg_postsmooth")
        with main_path(f"the structured {key} solve", totals, expect) as got:
            t0 = time.perf_counter()
            problem = compile_problem(mesh, bca, md, opts, device=DEV)
            prep = time.perf_counter() - t0
            res = problem.solve()
        require(
            (problem.mode, problem.preconditioner, problem.refine)
            == ("stencil", "multigrid", refine),
            f"{key}: {problem.mode}/{problem.preconditioner}/refine={problem.refine}",
        )
        t = res.timings
        rel = true_residual_stencil(problem, res)
        warm = [problem.solve().timings["solve_s"] for _ in range(3)]
        say(f"  {key}: prep {prep:.3f} s (upload {t['upload_s']:.4f}, assemble "
            f"{t['assemble_s']:.4f}, multigrid build {t['mg_build_s']:.4f}; levels "
            f"{t['mg_levels']}), first solve_s {t['solve_s']:.4f}, warm {warm}")
        extra = ""
        if refine:
            inner = t["refine_inner"]
            run = vcycles(inner, problem.refine_inner_iters)
            extra = (f", outer passes {t['refine_outer']}, inner iterations per pass "
                     f"{inner}")
        else:
            run = vcycles([res.iterations], problem.maxiter)
        if refs is not None:
            passes = (f" ({t['refine_outer']} passes, inner {list(map(int, t['refine_inner']))})"
                      if refine else "")
            refs[key] = dict(u=res.u, stress=res.stress, vm=res.von_mises,
                             iterations=res.iterations, passes=passes)
        say(f"  {key}: {res.iterations} iterations{extra}; reported residual_rel "
            f"{res.residual_rel:.3e}; true relative residual {rel:.3e} (<= 1e-08)")
        require(rel <= 1e-8, f"structured {key}: true residual too large")
        check_vcycle_launches(key, problem, got, run)
        if refine:
            if profile:
                profile_call("solve", problem.solve)
            vcycle_times(problem)
        if not refine:
            keep = problem.system.mg_levels
        del problem
        torch.cuda.empty_cache()
    return keep


def profile_call(label, fn):
    """One warm call under torch.profiler (ending in a device sync): kernel
    time by name and the device's idle share of the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels and copies): the aten rows would
    # count the same kernels a second time
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    say(f"  profiled {label}: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms in "
        f"{len(dev)} device events, idle {1 - busy / (wall * 1e3):.1%}")
    by_name: dict = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        say(f"    {ms:9.3f} ms  {n:6d}x  {name[:90]}")


def vcycle_times(problem):
    """One V-cycle of the f32 hierarchy: host enqueue time against device
    time (median of 10)."""
    import torch
    from magnetite_tpu_torch.fem.multigrid import vcycle_preconditioner

    apply = vcycle_preconditioner(problem.system.mg_levels, problem.system.grid.wrap)
    r = torch.randn(2, problem.system.grid.rows, problem.system.grid.cols, device=DEV)
    for _ in range(3):
        apply(r)
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # the device spins while the host enqueues the whole cycle, so the
        # events time the device's work and not the host's pace
        torch.cuda._sleep(200_000_000)
        start.record()
        t0 = time.perf_counter()
        apply(r)
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end))
    say(f"  one V-cycle ({len(problem.system.mg_levels)} levels, f32): host enqueue "
        f"{statistics.median(host):.3f} ms, device {statistics.median(device):.3f} ms "
        "(median of 10)")


def phase_stencil_kernel(levels_1m, big, rect_cells, reps, flush, rand, totals):
    """Phase 8: the stencil kernel against its plain version at every
    multigrid level of the 1M plate (with each shape's launches over the
    structured main path), the 4M plate's grid and a non-wrapped grid."""
    import torch
    from magnetite_tpu_torch.fem.stencil import assemble_stencil_structured
    from magnetite_tpu_torch.kernels.stencil_kernel import (
        stencil_matvec, stencil_matvec_plain,
    )
    from magnetite_tpu_torch.meshing.generators import rect_mesh

    say("phase 8: stencil kernel against stencil_matvec_plain on the card")
    mesh4m, _, _ = structured_case(*big)
    rect = rect_mesh(*rect_cells, width=3.0, height=1.0)
    require(rect.grid_shape[1] % 32 != 0, "the non-wrapped grid must exercise edge masking")

    def assembled(mesh):
        rows, cols = mesh.grid_shape
        coords = torch.from_numpy(mesh.coords).to(DEV)
        return assemble_stencil_structured(
            coords, E_MOD, NU, THICK, rows, cols, mesh.wrap_cols
        )

    results = {}
    for label, st64, wrap in (
        *((f"1M plate multigrid level {k}", lv.stencil, True) for k, lv in enumerate(levels_1m)),
        (f"{big[0]}x{big[1]} plate", assembled(mesh4m), True),
        ("rect, no wrap", assembled(rect), False),
    ):
        _, _, _, rr, cc = st64.shape
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            st = st64.to(dtype).contiguous()
            u = rand(2, rr, cc, dtype=dtype)
            scale = stencil_matvec_plain(st.abs(), u.abs(), wrap).max()
            ref = stencil_matvec_plain(st, u, wrap)
            tag = f"stencil_matvec {label} {rr}x{cc} wrap={wrap} {str(dtype)[6:]}"
            err = compare(tag, stencil_matvec(st, u, wrap), ref, scale, tol)
            a = csr_of_stencil(st, wrap)
            x = u.reshape(-1)
            compare(f"library CSR SpMV {tag}", torch.mv(a, x).reshape(2, rr, cc),
                    ref, scale, tol)
            row = time_kernel(
                tag, lambda: stencil_matvec(st, u, wrap),
                lambda: stencil_matvec_plain(st, u, wrap), lambda: torch.mv(a, x),
                reps, flush, (36 + 4) * rr * cc * st.element_size(), 72 * rr * cc, dtype,
            )
            if label.startswith("1M"):
                shape = f"stencil_matvec {rr}x{cc} {str(dtype)[6:]}"
                say(f"    {tag}: {totals['per shape'].get(shape, 0)} launches over the "
                    "structured main path")
            del a
            # the main path's hot call: the f32 inner solves at the 1M grid
            if label == "1M plate multigrid level 0" and dtype == torch.float32:
                results["stencil_matvec"] = dict(max_abs_err=err, **row)
        del st64
        torch.cuda.empty_cache()
    return results


def unfused_presmooth(st, dinv, r, wrap):
    """The V-cycle's pre-smoothing as it ran before the fused kernels: the
    stencil_matvec kernel and torch ops."""
    import torch
    from magnetite_tpu_torch.fem.blocks import apply_blocks
    from magnetite_tpu_torch.kernels.mg_smooth_kernel import OMEGA, SWEEPS, restrict
    from magnetite_tpu_torch.kernels.stencil_kernel import stencil_matvec

    e = torch.zeros_like(r)
    for _ in range(SWEEPS):
        e = e + OMEGA * apply_blocks(dinv, r - stencil_matvec(st, e, wrap))
    return e, restrict(r - stencil_matvec(st, e, wrap), wrap)


def unfused_postsmooth(st, dinv, r, e, ec, wrap):
    """The V-cycle's post-smoothing as it ran before the fused kernels."""
    import torch
    from magnetite_tpu_torch.fem.blocks import apply_blocks
    from magnetite_tpu_torch.kernels.mg_smooth_kernel import OMEGA, SWEEPS, prolong
    from magnetite_tpu_torch.kernels.stencil_kernel import stencil_matvec

    e = torch.zeros_like(r) if e is None else e
    if ec is not None:
        e = e + prolong(ec, wrap)
    for _ in range(SWEEPS):
        e = e + OMEGA * apply_blocks(dinv, r - stencil_matvec(st, e, wrap))
    return e


def rect_problem(rect_cells, dtype):
    """The non-wrapped --rect grid (tensile BCs) compiled for the structured
    path; its multigrid hierarchy ends on a level that smooths."""
    from magnetite_tpu_torch.config import ModelMetadata, SolverOptions
    from magnetite_tpu_torch.fem.solve import compile_problem
    from magnetite_tpu_torch.meshing.generators import rect_mesh, tensile_bcs_for_rect

    rect = rect_mesh(*rect_cells, width=3.0, height=1.0)
    md = ModelMetadata(E_MOD, NU, THICK, 0.0, 0.01)
    return compile_problem(rect, tensile_bcs_for_rect(rect.coords), md,
                           SolverOptions(dtype=dtype, cg_rtol=1e-8), device=DEV)


def phase_mg_smooth(levels_1m, rect_cells, reps, flush, rand, totals, base=None):
    """Phase 14: the fused V-cycle kernels against their plain versions at
    every smoothing level of the 1M plate and of the --rect hierarchy, f64
    and f32, timed against the unfused sequence (and with --baseline the
    older tree's kernels) in interleaved rounds; then the --rect
    hierarchy's V-cycle on the card against the CPU's."""
    import torch
    from magnetite_tpu_torch.fem.multigrid import (
        COARSE_SWEEPS, SWEEPS, MGLevel, _center_inverse, vcycle_preconditioner,
    )
    from magnetite_tpu_torch.kernels import mg_smooth_kernel as mgk

    def parts(x):  # a kernel's outputs as a tuple
        return x if isinstance(x, tuple) else (x,)

    say("phase 14: fused V-cycle kernels against their plain versions on the card")
    rect = rect_problem(rect_cells, "float64")
    require(rect.mode == "stencil" and rect.preconditioner == "multigrid",
            f"--rect grid: {rect.mode}/{rect.preconditioner}")
    rlev = rect.system.mg_levels
    rr, rcols = rlev[0].rows, rlev[0].cols
    require(rcols % 32 != 0 and rlev[-1].dense_inv is None,
            f"--rect grid {rr}x{rcols}: needs cols not a multiple of the tile and a "
            "coarsest level without a dense inverse")
    say(f"  --rect hierarchy: {[(lv.rows, lv.cols) for lv in rlev]}, coarsest smooths")
    # (label, level, wrap); a level with a dense inverse never smooths
    cases = [(f"1M plate level {k}", lv, True) for k, lv in enumerate(levels_1m)
             if lv.dense_inv is None]
    cases += [(f"rect level {k}", lv, False) for k, lv in enumerate(rlev)]
    results = {}
    parent_pre, parent_post = baseline_mg_launchers(base)
    for label, lv, wrap in cases:
        rows, cols = lv.rows, lv.cols
        coarsest = lv is rlev[-1]
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            st = lv.stencil.to(dtype).contiguous()
            dinv = _center_inverse(st)
            es, n = st.element_size(), rows * cols
            r = rand(2, rows, cols, dtype=dtype)
            e = rand(2, rows, cols, dtype=dtype)
            neg, ad = -st.abs(), dinv.abs()  # every term adds: the rounding scale
            name = str(dtype)[6:]
            rows_out = {}
            if not coarsest:
                ec = rand(2, *mgk.coarse_shape(rows, cols, wrap), dtype=dtype)
                calls = {
                    "mg_presmooth": (
                        lambda: mgk.mg_presmooth(st, dinv, r, wrap),
                        parent_pre and (lambda: parent_pre(st, dinv, r, wrap)),
                        lambda: mgk.mg_presmooth_plain(st, dinv, r, wrap),
                        lambda: unfused_presmooth(st, dinv, r, wrap),
                        mgk.mg_presmooth_plain(neg, ad, r.abs(), wrap),
                        44.5 * n * es, 170 * n),
                    "mg_postsmooth": (
                        lambda: mgk.mg_postsmooth(st, dinv, r, e, ec, wrap),
                        parent_post and (lambda: parent_post(st, dinv, r, e, ec, wrap)),
                        lambda: mgk.mg_postsmooth_plain(st, dinv, r, e, ec, wrap),
                        lambda: unfused_postsmooth(st, dinv, r, e, ec, wrap),
                        mgk.mg_postsmooth_plain(neg, ad, r.abs(), e.abs(), ec.abs(), wrap),
                        46.5 * n * es, 175 * n),
                }
            else:  # the coarsest solve's calls: from e = 0, then from e
                calls = {
                    "mg_postsmooth from 0": (
                        lambda: mgk.mg_postsmooth(st, dinv, r, None, None, wrap),
                        parent_post and (lambda: parent_post(st, dinv, r, None, None, wrap)),
                        lambda: mgk.mg_postsmooth_plain(st, dinv, r, None, None, wrap),
                        lambda: unfused_postsmooth(st, dinv, r, None, None, wrap),
                        mgk.mg_postsmooth_plain(neg, ad, r.abs(), None, None, wrap),
                        44 * n * es, 92 * n),
                    "mg_postsmooth": (
                        lambda: mgk.mg_postsmooth(st, dinv, r, e, None, wrap),
                        parent_post and (lambda: parent_post(st, dinv, r, e, None, wrap)),
                        lambda: mgk.mg_postsmooth_plain(st, dinv, r, e, None, wrap),
                        lambda: unfused_postsmooth(st, dinv, r, e, None, wrap),
                        mgk.mg_postsmooth_plain(neg, ad, r.abs(), e.abs(), None, wrap),
                        46 * n * es, 168 * n),
                }
            for kname, (fused, parent, plain, unfused, scale, nbytes, flops) in calls.items():
                tag = f"{kname} {label} {rows}x{cols} wrap={wrap} {name}"
                got, ref, scale = parts(fused()), parts(plain()), parts(scale)
                err = max(compare(f"{tag} {part}", g, p, sc.max(), tol)
                          for part, g, p, sc in zip(("e", "rc"), got, ref, scale))
                require(all(torch.equal(a, b) for a, b in zip(parts(fused()), got)),
                        f"{tag}: a second launch differs")
                fns = {"kernel": fused, "unfused": unfused}
                if parent is not None:
                    fns["parent"] = parent
                med = interleaved(tag, fns, reps, flush, ROUNDS)
                plain_ms = event_ms(plain, reps, flush)
                b_ms, b_by = bound(nbytes, flops, dtype)
                ms = med["kernel"]
                per_shape = totals.get("per shape")
                launches = ("phase 7 not run" if per_shape is None
                            else per_shape.get(f"{kname.split()[0]} {rows}x{cols} {name}", 0))
                par = (f", parent {med['parent']:.4f} ms ({med['parent'] / ms:.2f}x)"
                       if "parent" in med else "")
                say(f"  {tag}: kernel {ms:.4f} ms ({b_ms / ms:.1%} of bound {b_ms:.4f} ms by "
                    f"{b_by}){par}, unfused {med['unfused']:.4f} ms ({med['unfused'] / ms:.2f}x "
                    f"the kernel's), plain {plain_ms:.4f} ms; launches over phase 7: {launches}")
                rows_out[kname] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                       bound_by=b_by, library_ms=None)
            # the main path's hot calls: the f32 inner solves at the 1M grid
            if label == "1M plate level 0" and dtype == torch.float32:
                results.update(rows_out)
            del st, dinv, r, e
        torch.cuda.empty_cache()

    # the whole V-cycle over the coarsest-smoothing hierarchy, card against
    # CPU (plain versions on the same levels)
    r = rand(2, rr, rcols, dtype=torch.float64)
    before = {k.__name__: k.launches for k in (mgk.mg_presmooth, mgk.mg_postsmooth)}
    card = vcycle_preconditioner(rlev, False)(r)
    torch.cuda.synchronize()
    pre = mgk.mg_presmooth.launches - before["mg_presmooth"]
    post = mgk.mg_postsmooth.launches - before["mg_postsmooth"]
    require(pre == len(rlev) - 1 and post == len(rlev) - 1 + COARSE_SWEEPS // SWEEPS,
            f"--rect V-cycle launched {pre} / {post} fused kernels")
    cpu_levels = [MGLevel(stencil=lv.stencil.cpu(), diag_inv=lv.diag_inv.cpu(), rows=lv.rows,
                          cols=lv.cols) for lv in rlev]
    ref = vcycle_preconditioner(cpu_levels, False)(r.cpu())
    # FMA-contracted sums against the plain version's, through 3 levels and
    # the coarsest level's 48 sweeps
    compare(f"--rect V-cycle ({pre} + {post} fused launches) card vs CPU", card.cpu(), ref,
            ref.abs().max(), 1e-10)
    del rect, rlev
    torch.cuda.empty_cache()
    return results


def phase_card_vs_cpu(small_h, small_plate):
    """Phase 9: the port on the card (kernels) against the port on the CPU
    (plain versions), and mixed precision against f64."""
    import numpy as np
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import solve_system

    def agree(label, a_run, b_run, u_tol, tol, iters=True):
        if iters:
            require(abs(a_run.iterations - b_run.iterations) <= 1,
                    f"{label}: iteration counts differ by > 1")
        for name, t in (("u", u_tol), ("f", tol), ("stress", tol), ("von_mises", tol)):
            a, b = getattr(a_run, name), getattr(b_run, name)
            rel = np.abs(a - b).max() / np.abs(b).max()
            say(f"  {label} {name}: {rel:.3e} of max (<= {t:g})")
            require(np.isfinite(a).all() and rel <= t, f"{label}: {name} differs")

    def run(key, case, device, **kw):
        t0 = time.perf_counter()
        r = solve_system(*case, SolverOptions(**kw), device=device)
        extra = f", refine passes {r.timings['refine_outer']}" if "refine_outer" in r.timings else ""
        say(f"  {key}: {r.iterations} iterations{extra}, residual_rel {r.residual_rel:.3e}, "
            f"solve_s {r.timings['solve_s']:.4f}, total {time.perf_counter() - t0:.2f} s")
        return r

    say(f"phase 9: card against CPU, Delaunay plate h={small_h}")
    case = plate_case(small_h)
    say(f"  {case[0].num_nodes} nodes, {case[0].num_elements} elements")
    g = run("cuda f64", case, DEV, dtype="float64")
    c = run("cpu f64", case, "cpu", dtype="float64")
    m = run("cuda mixed", case, DEV, dtype="float32", refine="on")
    agree("cuda f64 vs cpu f64", g, c, 1e-8, 1e-7)
    # f64 CG around the f32 V-cycle reaches rtol 1e-10: the golden bars
    agree("cuda mixed vs cuda f64", m, g, 1e-6, 1e-5, iters=False)

    say(f"phase 9: card against CPU, structured plate {small_plate[0]}x{small_plate[1]}")
    case = structured_case(*small_plate)
    g = run("cuda f64", case, DEV, dtype="float64")
    c = run("cpu f64", case, "cpu", dtype="float64")
    gr = run("cuda f32 refined", case, DEV, dtype="float32")
    cr = run("cpu f32 refined", case, "cpu", dtype="float32")
    agree("cuda f64 vs cpu f64", g, c, 1e-8, 1e-7)
    agree("cuda f32 refined vs cpu f32 refined", gr, cr, 1e-6, 1e-5, iters=False)
    agree("cuda f32 refined vs cuda f64", gr, g, 1e-6, 1e-5, iters=False)


def lane_bound(offsets, n, nb, nbases, es):
    """(bytes moved once, operations) of one lane matvec with `es`-byte
    values: u and y once, the band sets (and K8's three weight vectors)
    once; 4 FMAs per basis for each (offset, node) term inside [0, N) and
    lane, plus K8's per-lane combination."""
    inside = sum(max(0, n - abs(int(o))) for o in offsets)
    nbytes = (4 * n * nb + nbases * 4 * len(offsets) * n + (3 * nb if nbases == 3 else 0)) * es
    flops = 8 * nbases * inside * nb + (10 * n * nb if nbases == 3 else 0)
    return nbytes + 4 * len(offsets), flops


def compile_sweeps(h):
    """Phase 10's set-up: the plate at h compiled for the load sweep (f32 CG
    and f64 CG over the f32 V-cycle, one hierarchy) and the material sweep
    (f32; f64 basis bands for the residual checks)."""
    from magnetite_tpu_torch.parallel.sweep import (
        compile_unstructured_material_sweep, compile_unstructured_sweep,
    )

    mesh, bca, md = plate_case(h)
    out = {"case": (mesh, bca, md)}
    t0 = time.perf_counter()
    out["load"] = compile_unstructured_sweep(
        mesh, bca, md, iterations=LOAD_ITERS, refined=False, device=DEV)
    sync()
    out["load_compile_s"] = time.perf_counter() - t0
    out["load64"] = compile_unstructured_sweep(
        mesh, bca, md, iterations=LOAD_ITERS, refined=True, device=DEV,
        amg_setup=out["load"].amg_setup)
    t0 = time.perf_counter()
    out["material"] = compile_unstructured_material_sweep(
        mesh, bca, iterations=MATERIAL_ITERS, refined=False, device=DEV)
    sync()
    out["material_compile_s"] = time.perf_counter() - t0
    out["material64"] = compile_unstructured_material_sweep(
        mesh, bca, iterations=MATERIAL_ITERS, refined=True, device=DEV,
        material_setup=out["material"].material_setup)
    ld = out["load"]
    say(f"  plate h={h}: {mesh.num_nodes} nodes, {mesh.num_elements} elements, "
        f"{len(ld.offsets)} offsets (reach {min(ld.offsets)}..{max(ld.offsets)}), "
        f"renumbered={ld.perm is not None}, AMG levels {ld.amg_setup.level_sizes}, "
        f"material levels {out['material'].material_setup.level_sizes}; compile "
        f"{out['load_compile_s']:.2f} s (load), {out['material_compile_s']:.2f} s (material)")
    return out


def sync():
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()


LANE_OFFSETS = (-1300, -512, -200, -199, -37, -1, 0, 1, 37, 199, 200, 512, 1300)


def random_lane_bands(n, offsets, dtype):
    """Random bands [D, 2, 2, n] on the card, zero wherever n + offset
    leaves [0, n) (the invariant every assembled operator holds)."""
    import torch

    bands = torch.randn(len(offsets), 2, 2, n, device=DEV, dtype=torch.float64).to(dtype)
    node = torch.arange(n, device=DEV)
    for k, off in enumerate(offsets):
        bands[k][:, :, (node + off < 0) | (node + off >= n)] = 0.0
    return bands


def ptxas_of(kernel: str) -> list:
    """nvcc's ptxas lines (registers, spills) for the entries whose mangled
    name holds `kernel` (phase 1's build report)."""
    out, keep = [], False
    for line in PTXAS.splitlines():
        if "Compiling entry" in line:
            keep = kernel in line
            if keep:
                out.append(line.split("'")[1] if "'" in line else line.strip())
        elif keep and ("registers" in line or "spill" in line):
            out.append("  " + line.strip().replace("ptxas info    : ", ""))
    return out


def took_route(wrapper, fn, route):
    """Run fn (one call of the lane wrapper `wrapper`, K7's or K8's) and
    require that it took `route`."""
    before = wrapper.ring_launches
    y = fn()
    took = "ring" if wrapper.ring_launches > before else "direct"
    require(took == route, f"{wrapper.__name__} took the {took} route, expected {route}")
    return y


def routes_timed(launch, ring_plan, reps, flush, ref, scale, tol):
    """A lane kernel's two routes on the same operands (`launch(plan)` runs
    it through `plan`'s kernel), each checked against the plain version's
    `ref` and timed in turn (direct, ring, direct, ring), so that the route
    rule's choice is measured within one run."""
    from magnetite_tpu_torch.kernels.lane_dia_kernel import LanePlan

    plans = {"direct": LanePlan("direct", ring_plan.min_off, ring_plan.max_off),
             "ring": ring_plan}
    for route, plan in plans.items():
        err = float((launch(plan) - ref).abs().max())
        require(err <= tol * float(scale), f"{route} route disagrees: {err:.3e}")
    times = {route: [] for route in plans}
    for _ in range(2):
        for route, plan in plans.items():
            times[route].append(event_ms(lambda: launch(plan), reps, flush))
    say("    " + "; ".join(f"{route} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                          for route, ts in times.items()))
    return times


def describe_plan(name, plan, sets, es):
    """One line of a ring plan's geometry."""
    from magnetite_tpu_torch.kernels.lane_dia_kernel import RING_GEOMETRY

    k = RING_GEOMETRY[sets, es][0]
    say(f"  {name} route {plan.route}: {plan.lanes} lanes x {plan.rows} rows per step, "
        f"{k} per thread ({plan.lanes // (16 // es) * plan.rows // k} threads), "
        f"{plan.strips} strips of {plan.strip_rows} rows, {plan.smem_bytes} B shared memory")


def phase_lane_kernels(sweeps, reps, flush, rand):
    """Phase 10: the lane kernels (K7, K8) against their plain versions at
    the sweep plate's level-0 bands / basis band sets, full lane count, f32
    and f64; then odd shapes (B = 1000; offsets past N). Both must take the
    ring route at the plate's offsets and the direct route past N."""
    import torch
    from magnetite_tpu_torch.kernels import cuda_lib
    from magnetite_tpu_torch.kernels.lane_dia_kernel import (
        launch_lane_dia, launch_lane_dia3, lane_dia_matvec, lane_dia_matvec3,
        lane_dia_matvec3_plain, lane_dia_matvec_plain, lane_window_plan,
    )
    from magnetite_tpu_torch.parallel.sweep import material_weights

    say("phase 10: lane band kernels against their plain versions on the card")
    load, mat = sweeps["load64"], sweeps["material64"]
    offsets, n, nb = load.offsets, load.n_nodes, SWEEP_LANES
    od = torch.tensor(offsets, dtype=torch.int32, device=DEV)
    results = {}
    for line in ptxas_of("lane_dia_ring_kernel"):
        say(f"  ptxas: {line}")

    def weights(count, dtype):
        gen = torch.Generator(device="cpu").manual_seed(count)
        e = 40e9 + 210e9 * torch.rand(count, generator=gen, dtype=torch.float64)
        nu = 0.22 + 0.16 * torch.rand(count, generator=gen, dtype=torch.float64)
        t = 0.2 + 0.8 * torch.rand(count, generator=gen, dtype=torch.float64)
        return tuple(w.to(DEV, dtype) for w in material_weights(e, nu, t))

    for dtype, tol7, tol8 in ((torch.float32, 1e-6, 1e-5), (torch.float64, 1e-13, 1e-13)):
        name, es = str(dtype)[6:], torch.empty((), dtype=dtype).element_size()
        sms = cuda_lib.sm_count(torch.device(DEV)) if DEV == "cuda" else 132
        bands = load.bands.to(dtype).contiguous()
        u = rand(2, n, nb, dtype=dtype)
        ref = lane_dia_matvec_plain(bands, offsets, u)
        scale = lane_dia_matvec_plain(bands.abs(), offsets, u.abs()).max()
        tag = f"lane_dia_matvec D={len(offsets)} N={n} B={nb} {name}"
        plan = lane_window_plan(offsets, n, nb, dtype, sms=sms)
        require(plan.route == "ring", f"K7 {name} at the sweep plate left the ring route")
        err = compare(tag, took_route(lane_dia_matvec,
                                      lambda: lane_dia_matvec(bands, offsets, u, od), "ring"),
                      ref, scale, tol7)
        describe_plan(f"K7 {name}", plan, 1, es)
        a = csr_of_bands(bands, offsets)
        x = u.reshape(2 * n, nb)
        compare(f"library CSR SpMM {tag}", torch.sparse.mm(a, x).reshape(2, n, nb), ref, scale,
                1e-5 if dtype == torch.float32 else 1e-12)
        row = time_kernel(
            tag, lambda: lane_dia_matvec(bands, offsets, u, od),
            lambda: lane_dia_matvec_plain(bands, offsets, u), lambda: torch.sparse.mm(a, x),
            reps, flush, *lane_bound(offsets, n, nb, 1, es), dtype,
        )
        results[f"lane_dia_matvec {name}"] = dict(max_abs_err=err, **row)
        del a, x
        say(f"  K7 {name} at the sweep plate, each route in turn:")
        routes_timed(lambda p: launch_lane_dia(bands, u, od, p), plan, reps, flush, ref, scale,
                     tol7)
        del ref

        bands3 = tuple(b.to(dtype).contiguous() for b in mat.bands3)
        w3 = weights(nb, dtype)
        ref = lane_dia_matvec3_plain(bands3, w3, offsets, u)
        scale = lane_dia_matvec3_plain(tuple(b.abs() for b in bands3), w3, offsets, u.abs()).max()
        tag = f"lane_dia_matvec3 D={len(offsets)} N={n} B={nb} {name}"
        plan3 = lane_window_plan(offsets, n, nb, dtype, sms=sms, sets=3)
        require(plan3.route == "ring", f"K8 {name} at the sweep plate left the ring route")
        err = compare(tag, took_route(lane_dia_matvec3,
                                      lambda: lane_dia_matvec3(bands3, w3, offsets, u, od),
                                      "ring"), ref, scale, tol8)
        describe_plan(f"K8 {name}", plan3, 3, es)
        row = time_kernel(
            tag, lambda: lane_dia_matvec3(bands3, w3, offsets, u, od),
            lambda: lane_dia_matvec3_plain(bands3, w3, offsets, u), None,
            reps, flush, *lane_bound(offsets, n, nb, 3, es), dtype,
        )
        say("  (lane_dia_matvec3: no single PyTorch call computes a per-lane "
            "weighted sum of three operators: library none)")
        results[f"lane_dia_matvec3 {name}"] = dict(max_abs_err=err, **row)
        say(f"  K8 {name} at the sweep plate, each route in turn:")
        routes_timed(lambda p: launch_lane_dia3(bands3, w3, u, od, p), plan3, reps, flush, ref,
                     scale, tol8)
        del ref, u

        # odd shapes: 1000 lanes on the plate's bands; a short random-band
        # operator whose offsets reach past N on both sides
        short = tuple(random_lane_bands(997, LANE_OFFSETS, dtype) for _ in range(3))
        for label, b7, b3, offs, route in (
            ("plate bands, B=1000", bands, bands3, offsets, "ring"),
            ("offsets to +-1300 > N=997, B=1000", short[0], short, LANE_OFFSETS, "direct"),
        ):
            u = rand(2, b7.shape[-1], 1000, dtype=dtype)
            w3 = weights(1000, dtype)
            compare(f"lane_dia_matvec {label} {name} ({route})",
                    took_route(lane_dia_matvec, lambda: lane_dia_matvec(b7, offs, u), route),
                    lane_dia_matvec_plain(b7, offs, u),
                    lane_dia_matvec_plain(b7.abs(), offs, u.abs()).max(), tol7)
            compare(f"lane_dia_matvec3 {label} {name} ({route})",
                    took_route(lane_dia_matvec3, lambda: lane_dia_matvec3(b3, w3, offs, u), route),
                    lane_dia_matvec3_plain(b3, w3, offs, u),
                    lane_dia_matvec3_plain(tuple(b.abs() for b in b3), w3, offs, u.abs()).max(),
                    tol8)
        if DEV == "cuda":
            torch.cuda.empty_cache()
    return results


def lane_residuals(sweep, bands64, res, u_fixed, f_applied, operator_of):
    """Per-lane true relative residual ||b - A u|| / ||b|| in f64 with the
    plain lane operator: u_fixed / f_applied [B, N, 2] (the values the
    sweep solved for, caller's node order), operator_of(bands, v) the
    per-lane UNREDUCED K_b v."""
    import torch

    def lanes(x):  # [B, N, 2] caller's order -> [2, N, B] renumbered, f64
        x = x.to(DEV, torch.float64)
        if sweep.perm_dev is not None:
            x = x[:, sweep.perm_dev]
        return x.permute(2, 1, 0).contiguous()

    free = sweep.free.double()[:, :, None]
    uf, fa, u = lanes(u_fixed), lanes(f_applied), lanes(res.u)
    b = free * (fa - operator_of(bands64, uf)) + (1.0 - free) * uf
    r = b - (free * operator_of(bands64, free * u) + (1.0 - free) * u)
    return (r.square().sum(dim=(0, 1)).sqrt() / b.square().sum(dim=(0, 1)).sqrt()).cpu()


def single_solves(case, sweep_u, lanes, lane_case, tol, label, cache=None):
    """Lanes of a sweep against single solves through compile_problem (f64,
    rtol 1e-10) of the lane's own material and boundary values (kept in
    `cache` when given, keyed by those values)."""
    import numpy as np
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import compile_problem

    mesh = case[0]
    worst = 0.0
    cache = {} if cache is None else cache
    for b in lanes:
        bca_b, md_b = lane_case(b)
        key = (repr(md_b), bca_b.u_value.tobytes(), bca_b.f_value.tobytes())
        if key not in cache:
            cache[key] = compile_problem(
                mesh, bca_b, md_b, SolverOptions(dtype="float64", cg_rtol=1e-10), device=DEV,
            ).solve()
        one = cache[key]
        got = sweep_u[b].cpu().numpy()
        err = float(np.abs(got - one.u).max() / np.abs(one.u).max())
        say(f"  {label} lane {b}: max|u - u_single| = {err:.3e} of max|u| (<= {tol:g}; "
            f"single solve {one.iterations} iterations)")
        require(np.isfinite(got).all() and err <= tol, f"{label} lane {b} off its single solve")
        worst = max(worst, err)
    return worst


def run_sweep(name, sweep, args, expect, totals, warm_args, profile=False):
    """First solve under the launch counters, then warm batches (and one
    more under torch.profiler with `profile`)."""
    import torch

    with main_path(name, totals, (expect,)) as got:
        t0 = time.perf_counter()
        res = sweep.solve_factors(*args)
        sync()
        first = time.perf_counter() - t0
    warm = []
    for a in warm_args:
        t0 = time.perf_counter()
        sweep.solve_factors(*a)
        sync()
        warm.append(time.perf_counter() - t0)
    rel = (res.residual_norm / res.rhs_norm).cpu()
    say(f"  {name}: first solve_s {first:.4f}, warm solve_s {[round(w, 4) for w in warm]}, "
        f"min {min(warm) if warm else first:.4f} -> "
        f"{SWEEP_LANES / (min(warm) if warm else first):.0f} solves/s; reported "
        f"relative residual max {float(rel.max()):.3e}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30 if DEV == 'cuda' else 0:.2f} GiB")
    require(bool(torch.isfinite(res.u).all()), f"{name}: non-finite displacements")
    if profile:
        profile_call(f"{name} (one warm solve_factors)", lambda: sweep.solve_factors(*args))
    return res, got


def expected_launches(iterations, per_iteration, outside):
    return iterations * per_iteration + outside


def phase_load_sweep(sweeps, totals, bars, profile):
    """Phase 11: the load sweep at full width (bench.py's batch)."""
    import numpy as np
    import torch
    from magnetite_tpu_torch.bc import BCArrays
    from magnetite_tpu_torch.config import ModelMetadata
    from magnetite_tpu_torch.kernels.lane_dia_kernel import lane_dia_matvec_plain

    say(f"phase 11: load sweep, {SWEEP_LANES} lanes, {LOAD_ITERS} iterations, f32 CG")
    case, sweep, sweep64 = sweeps["case"], sweeps["load"], sweeps["load64"]
    mesh, bca, md = case
    nb = SWEEP_LANES

    def batch(seed):
        rng = np.random.default_rng(seed)
        return (rng.uniform(0.5, 2.0, nb).astype(np.float32), np.ones(nb, np.float32),
                rng.uniform(0.5, 2.0, nb))

    args = batch(0)
    res, got = run_sweep("the load sweep", sweep, args, "lane_dia_matvec", totals,
                         [batch(s) for s in (1, 2, 3, 4)], profile)
    # per iteration: the CG operator and, in the V(1,1)-cycle, the
    # pre-residual, restrict's and prolong's masked operator and the post
    # sweep; outside: rhs, r0, z0's V-cycle (4) and the true final residual
    want = expected_launches(LOAD_ITERS, 5, 7)
    require(got["lane_dia_matvec"] == want and got["lane_dia_matvec f64"] == 0
            and got["lane_dia_matvec ring"] == want and got["lane_dia_matvec3"] == 0,
            f"load sweep launches {got}, expected {want} of lane_dia_matvec, all f32 and "
            "all on the ring route")
    say(f"  lane_dia_matvec launches {got['lane_dia_matvec']} = {LOAD_ITERS} x 5 + 7, "
        f"ring route {got['lane_dia_matvec ring']}")

    u_values = torch.as_tensor(bca.u_value.astype(np.float32)[None] * args[0][:, None, None])
    f_values = torch.as_tensor(bca.f_value.astype(np.float32)[None] * args[1][:, None, None])
    dense = sweep.solve(u_values, f_values, args[2])
    su = float(res.u.abs().max())
    d_err = float((dense.u - res.u).abs().max())
    say(f"  dense solve() vs solve_factors(): max|diff| {d_err:.3e} (<= 1e-6 x {su:.3e})")
    require(d_err <= 1e-6 * su, "dense solve() differs from solve_factors()")
    del dense

    ks = torch.as_tensor(args[2], dtype=torch.float64, device=DEV)

    def k_op(bands, v):
        return lane_dia_matvec_plain(bands, sweep.offsets, v) * ks

    def lane_case(b):
        return (BCArrays(u_known=bca.u_known, u_value=bca.u_value * float(args[0][b]),
                         f_value=bca.f_value * float(args[1][b])),
                ModelMetadata(md.youngs_modulus * float(args[2][b]), md.poisson_ratio,
                              md.part_thickness, 0.0, md.characteristic_length_max))

    for label, s, r, bar in (("f32 CG", sweep, res, bars["f32"]),
                             ("f64 CG (refined)", sweep64, None, bars["refined"])):
        if r is None:
            r, got = run_sweep("the refined load sweep", s, args, "lane_dia_matvec", totals,
                               [batch(seed) for seed in (1, 2, 3)])
            # f64: the CG operator each iteration, rhs, r0 and the final
            # residual; the V-cycle's stay f32
            require(got["lane_dia_matvec"] == want
                    and got["lane_dia_matvec f64"] == LOAD_ITERS + 3
                    and got["lane_dia_matvec ring"] == want,
                    f"refined launches {got}, expected {want}, {LOAD_ITERS + 3} of them f64, "
                    "all on the ring route")
            say(f"  lane_dia_matvec launches {want}, f64 {got['lane_dia_matvec f64']} = "
                f"{LOAD_ITERS} + 3, ring route {got['lane_dia_matvec ring']}")
        rel = lane_residuals(s, sweep64.bands, r, u_values, f_values, k_op)
        say(f"  {label}: per-lane true relative residual (f64, plain operator) max "
            f"{float(rel.max()):.3e}, median {float(rel.median()):.3e} (<= {bar['residual']:g})")
        require(bool(torch.isfinite(rel).all()) and float(rel.max()) <= bar["residual"],
                f"load sweep {label}: residual above its bar")
        single_solves(case, r.u, (0, 1, nb - 1), lane_case, bar["u"], f"load {label}")
        sweeps[f"load_result {label}"] = float(rel.max())
    del res


def phase_material_sweep(sweeps, totals, bars, profile):
    """Phase 12: the material sweep at full width (bench.py's batch)."""
    import numpy as np
    import torch
    from magnetite_tpu_torch.bc import BCArrays
    from magnetite_tpu_torch.config import ModelMetadata
    from magnetite_tpu_torch.kernels.lane_dia_kernel import lane_dia_matvec3_plain
    from magnetite_tpu_torch.parallel.sweep import material_weights

    say(f"phase 12: material sweep, {SWEEP_LANES} lanes, {MATERIAL_ITERS} iterations, "
        "f32 CG and f64 CG")
    case, sweep, sweep64 = sweeps["case"], sweeps["material"], sweeps["material64"]
    mesh, bca, md = case
    nb = SWEEP_LANES

    def batch(seed):
        rng = np.random.default_rng(seed)
        ones = np.ones(nb, dtype=np.float32)
        return (ones, ones, rng.uniform(40e9, 250e9, nb).astype(np.float32),
                rng.uniform(0.22, 0.38, nb).astype(np.float32),
                rng.uniform(0.2, 1.0, nb).astype(np.float32))

    args = batch(0)
    res, got = run_sweep("the material sweep", sweep, args, "lane_dia_matvec3", totals,
                         [batch(s) for s in (1, 2, 3)], profile)
    # per iteration: the CG operator and the V(1,1)-cycle's pre-residual and
    # post sweep (its level-0 transfers are ELL gathers); outside: rhs, r0,
    # z0's two and the true final residual
    want = expected_launches(MATERIAL_ITERS, 3, 5)
    require(got["lane_dia_matvec3"] == want and got["lane_dia_matvec3 f64"] == 0
            and got["lane_dia_matvec3 ring"] == want and got["lane_dia_matvec"] == 0,
            f"material sweep launches {got}, expected {want} of lane_dia_matvec3, all f32 "
            "and all on the ring route")
    say(f"  lane_dia_matvec3 launches {got['lane_dia_matvec3']} = {MATERIAL_ITERS} x 3 + 5, "
        f"ring route {got['lane_dia_matvec3 ring']}")

    u_values = torch.as_tensor(bca.u_value.astype(np.float32)[None] * args[0][:, None, None])
    f_values = torch.as_tensor(bca.f_value.astype(np.float32)[None] * args[1][:, None, None])
    dense = sweep.solve(u_values, f_values, *args[2:])
    su = float(res.u.abs().max())
    d_err = float((dense.u - res.u).abs().max())
    say(f"  dense solve() vs solve_factors(): max|diff| {d_err:.3e} (<= 1e-6 x {su:.3e})")
    require(d_err <= 1e-6 * su, "dense solve() differs from solve_factors()")
    del dense

    w3 = material_weights(*(torch.as_tensor(a, dtype=torch.float64, device=DEV)
                            for a in args[2:]))

    def k_op(bands3, v):
        return lane_dia_matvec3_plain(bands3, w3, sweep.offsets, v)

    def lane_case(b):
        return (BCArrays(u_known=bca.u_known, u_value=bca.u_value * float(args[0][b]),
                         f_value=bca.f_value * float(args[1][b])),
                ModelMetadata(float(args[2][b]), float(args[3][b]), float(args[4][b]), 0.0,
                              md.characteristic_length_max))

    for label, s, r, bar in (("f32 CG", sweep, res, bars["f32"]),
                             ("f64 CG (refined)", sweep64, None, bars["material refined"])):
        if r is None:
            r, got = run_sweep("the refined material sweep", s, args, "lane_dia_matvec3",
                               totals, [batch(seed) for seed in (1, 2)])
            # f64: the CG operator each iteration, rhs, r0 and the final
            # residual; the V-cycle's two stay f32
            require(got["lane_dia_matvec3"] == want and got["lane_dia_matvec"] == 0
                    and got["lane_dia_matvec3 f64"] == MATERIAL_ITERS + 3
                    and got["lane_dia_matvec3 ring"] == want,
                    f"refined launches {got}, expected {want}, {MATERIAL_ITERS + 3} of them f64, "
                    "all on the ring route")
            say(f"  lane_dia_matvec3 launches {want}, f64 {got['lane_dia_matvec3 f64']} = "
                f"{MATERIAL_ITERS} + 3, ring route {got['lane_dia_matvec3 ring']}")
        rel = lane_residuals(s, sweep64.bands3, r, u_values, f_values, k_op)
        say(f"  {label}: per-lane true relative residual (f64, plain operator) max "
            f"{float(rel.max()):.3e}, median {float(rel.median()):.3e} (<= {bar['residual']:g})")
        require(bool(torch.isfinite(rel).all()) and float(rel.max()) <= bar["residual"],
                f"material sweep {label}: residual above its bar")
        single_solves(case, r.u, (0, 1, nb - 1), lane_case, bar["u"], f"material {label}")
        sweeps[f"material_result {label}"] = float(rel.max())
    del res


def phase_sweeps_card_vs_cpu(h, lanes):
    """Phase 13: both sweeps on the card (kernels) against the CPU (plain
    versions), f64 CG over the f32 V-cycle (the f32-CG answers of two
    summation orders part at the f32 floor, ~1e-4 of max|u|)."""
    import numpy as np
    from magnetite_tpu_torch.parallel.sweep import (
        compile_unstructured_material_sweep, compile_unstructured_sweep,
    )

    say(f"phase 13: sweeps on the card against the CPU, h={h}, {lanes} lanes")
    mesh, bca, md = plate_case(h)
    rng = np.random.default_rng(13)
    load_args = (rng.uniform(0.5, 2.0, lanes), np.ones(lanes), rng.uniform(0.5, 2.0, lanes))
    mat_args = (np.ones(lanes), np.ones(lanes), rng.uniform(40e9, 250e9, lanes),
                rng.uniform(0.22, 0.38, lanes), rng.uniform(0.2, 1.0, lanes))
    for label, make, args in (
        ("load", lambda dev: compile_unstructured_sweep(
            mesh, bca, md, iterations=LOAD_ITERS, device=dev), load_args),
        ("material", lambda dev: compile_unstructured_material_sweep(
            mesh, bca, iterations=MATERIAL_ITERS, device=dev), mat_args),
    ):
        card = make(DEV).solve_factors(*args)
        cpu = make("cpu").solve_factors(*args)
        a, b = card.u.cpu().numpy(), cpu.u.numpy()
        rel = float(np.abs(a - b).max() / np.abs(b).max())
        say(f"  {label}: {mesh.num_nodes} nodes, card vs CPU max|du| {rel:.3e} of max|u| "
            "(<= 1e-05)")
        require(np.isfinite(a).all() and rel <= 1e-5, f"{label} sweep: card differs from CPU")



# ------------------- structured-grid sweeps (phases 15-17) ------------------


def grid_case(cells=None):
    """bench.py's sweep grid: rect_mesh(64, 32, width=2.0) (33x65 nodes),
    left edge fixed, right edge ux = 0.01, bench_sweep's metadata."""
    from magnetite_tpu_torch.config import ModelMetadata
    from magnetite_tpu_torch.meshing.generators import rect_mesh, tensile_bcs_for_rect

    mesh = rect_mesh(*(cells or GRID_CELLS), width=2.0)
    return mesh, tensile_bcs_for_rect(mesh.coords, pull=0.01), ModelMetadata(
        E_MOD, NU, THICK, 0.0, 0.05)


def compile_grid_sweeps():
    """Phases 15-17's set-up: the bench grid compiled for both structured
    sweeps in f32 (the JAX package's default) and f64."""
    from magnetite_tpu_torch.parallel.sweep import compile_material_sweep, compile_sweep

    mesh, bca, md = grid_case()
    out = {"case": (mesh, bca, md)}
    for dtype in ("float32", "float64"):
        t0 = time.perf_counter()
        out[f"load {dtype}"] = compile_sweep(mesh, bca, md, iterations=GRID_ITERS, dtype=dtype,
                                             device=DEV)
        sync()
        t1 = time.perf_counter()
        out[f"material {dtype}"] = compile_material_sweep(mesh, bca, iterations=GRID_ITERS,
                                                          dtype=dtype, device=DEV)
        sync()
        say(f"  {dtype}: compiled in {t1 - t0:.3f} s (load), {time.perf_counter() - t1:.3f} s "
            "(material)")
    load = out["load float64"]
    say(f"  bench grid {mesh.grid_shape}: {mesh.num_nodes} nodes, {mesh.num_elements} elements; "
        f"load hierarchy {[tuple(lv.stencil.shape[-2:]) for lv in load.setup[2]]} (coarsest "
        f"dense: {load.setup[2][-1].dense_inv is not None}), material hierarchy "
        f"{[tuple(lv.sa.shape[-2:]) for lv in out['material float64'].setup[1]]}")
    return out


def grid_launches(shapes, dense, iterations, material, es):
    """{(instance, (rows, cols)): launches} of one structured sweep solve,
    derived from its hierarchy (`shapes` finest first; `dense`: the
    coarsest level is a dense inverse; `es`: bytes per value). A V-cycle
    launches 4 matvecs per smoothing level (2 + 2 sweeps, the first from
    zero without one, and the residual); a coarsest level that smooths
    takes one fused coarse-smoother launch ("coarse") on the material
    sweep where lane_coarse_route says it fits, else COARSE_SWEEPS - 1
    matvecs; the CG operator runs iterations + 2 times (r0, each
    iteration, the true residual) at level 0, and the rhs takes 1 (load:
    the raw stencil) or 3 (material: the raw bases) S = 1 launches there."""
    from magnetite_tpu_torch.fem.multigrid import COARSE_SWEEPS
    from magnetite_tpu_torch.kernels.lane_coarse_kernel import lane_coarse_route

    op = "S3" if material else "S1"
    out: dict = {}

    def add(key, n):
        if n:
            out[key] = out.get(key, 0) + n

    add((op, shapes[0]), iterations + 2)
    add(("S1", shapes[0]), 3 if material else 1)
    for lv, shape in enumerate(shapes):
        if lv < len(shapes) - 1:
            add((op, shape), 4 * (iterations + 1))
        elif material and lane_coarse_route(*shape, es) == "fused":
            add(("coarse", shape), iterations + 1)
        elif not dense:
            add((op, shape), (COARSE_SWEEPS - 1) * (iterations + 1))
    return out


def check_grid_launches(label, sweep, material):
    """The lane kernels' launches per shape in the run just counted (the
    wrappers' .shape_launches) against grid_launches."""
    from magnetite_tpu_torch.kernels.lane_coarse_kernel import lane_coarse_smooth3
    from magnetite_tpu_torch.kernels.lane_stencil_kernel import (
        lane_stencil_matvec, lane_stencil_matvec3,
    )

    if material:
        shapes, dense = [tuple(lv.sa.shape[-2:]) for lv in sweep.setup[1]], False
    else:
        shapes = [tuple(lv.stencil.shape[-2:]) for lv in sweep.setup[2]]
        dense = sweep.setup[2][-1].dense_inv is not None
    es = sweep.dtype.itemsize
    want = grid_launches(shapes, dense, sweep.iterations, material, es)
    seen = {}
    for tag, k in (("S1", lane_stencil_matvec), ("S3", lane_stencil_matvec3),
                   ("coarse", lane_coarse_smooth3)):
        for (r, c, _), n in k.shape_launches.items():
            seen[tag, (r, c)] = seen.get((tag, (r, c)), 0) + n
    say(f"  {label}: lane kernel launches per shape {sorted(seen.items())}, derived from the "
        f"hierarchy {sorted(want.items())}; per-sweep coarse solves "
        f"{lane_coarse_smooth3.per_sweep}")
    require(seen == want, f"{label}: lane kernel launches {seen}, expected {want}")


def grid_batch(case, nb, seed, dtype, material):
    """bench_sweep's / bench_material_sweep's batch on the card: the base BC
    values (load: pulls U(0.005, 0.02) on the right edge per lane), no
    forces, and k U(0.5, 2) (load) or E U(40e9, 250e9), nu U(0.22, 0.38),
    t U(0.2, 1.0) (material)."""
    import numpy as np
    import torch

    mesh, bca, _ = case
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(bca.u_value, dtype=dtype, device=DEV).expand(nb, -1, -1).clone()
    f = torch.zeros_like(u)
    if material:
        return (u, f, *(torch.as_tensor(rng.uniform(lo, hi, nb), dtype=dtype, device=DEV)
                        for lo, hi in ((40e9, 250e9), (0.22, 0.38), (0.2, 1.0))))
    right = torch.as_tensor(np.isclose(mesh.coords[:, 0], mesh.coords[:, 0].max()), device=DEV)
    u[:, right, 0] = torch.as_tensor(rng.uniform(0.005, 0.02, nb), dtype=dtype,
                                     device=DEV)[:, None]
    return u, f, torch.as_tensor(rng.uniform(0.5, 2.0, nb), dtype=dtype, device=DEV)


def run_grid_sweep(name, sweep, case, material, expect, totals, profile=False):
    """First solve under the launch counters, then GRID_WARM fresh batches
    (made on the card before each timed call): warm solve_s median and
    spread, up to the device sync."""
    import torch

    dtype = sweep.dtype
    args = grid_batch(case, SWEEP_LANES, 0, dtype, material)
    sync()
    with main_path(name, totals, expect):
        t0 = time.perf_counter()
        res = sweep.solve(*args)
        sync()
        first = time.perf_counter() - t0
    check_grid_launches(name, sweep, material)
    warm = []
    for seed in range(1, GRID_WARM + 1):
        batch = grid_batch(case, SWEEP_LANES, seed, dtype, material)
        sync()
        t0 = time.perf_counter()
        sweep.solve(*batch)
        sync()
        warm.append(time.perf_counter() - t0)
    med = statistics.median(warm)
    say(f"  {name}: first solve_s {first:.4f}; warm solve_s median {med:.4f} over {len(warm)} "
        f"fresh batches ({' / '.join(f'{w:.4f}' for w in warm)}), spread {min(warm):.4f}-"
        f"{max(warm):.4f} -> {SWEEP_LANES / med:.0f} solves/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30 if DEV == 'cuda' else 0:.2f} GiB")
    require(bool(torch.isfinite(res.u).all()), f"{name}: non-finite displacements")
    if profile:
        profile_call(f"{name} (one warm solve)", lambda: sweep.solve(*args))
    return res, args


def grid_residuals(grid, material, args, u):
    """Per-lane true relative residual ||b - A u|| / ||b|| in f64 with the
    plain lane operator of the f64 setup, for the batch `args` and the
    answer u [B, N, 2]."""
    import torch
    from magnetite_tpu_torch.kernels.lane_stencil_kernel import (
        lane_material_matvec_plain, lane_stencil_matvec_plain,
    )
    from magnetite_tpu_torch.parallel.sweep import material_weights

    ref = grid[f"{'material' if material else 'load'} float64"]
    rows, cols = ref.rows, ref.cols
    free = ref.free_g.double()[..., None]

    def lanes(x):  # [B, N, 2] -> [2, R, C, B], f64
        return x.to(DEV, torch.float64).permute(2, 1, 0).reshape(2, rows, cols, -1)

    uf, fa, uu = lanes(args[0]), lanes(args[1]), lanes(u)
    if material:
        basis_raw, levels, _ = ref.setup
        w3 = material_weights(*(a.to(DEV, torch.float64) for a in args[2:]))
        kraw = sum(lane_stencil_matvec_plain(st, uf, False) * w for st, w in zip(basis_raw, w3))
        b = free * (fa - kraw) + (1.0 - free) * uf
        r = b - lane_material_matvec_plain(levels[0], w3, uu, False)
    else:
        raw, reduced = ref.setup[0], ref.setup[1]
        ks = args[2].to(DEV, torch.float64)
        b = free * (fa - lane_stencil_matvec_plain(raw, uf, False) * ks) + (1.0 - free) * uf
        r = b - (free * lane_stencil_matvec_plain(reduced, uu, False) * ks + (1.0 - free) * uu)
    return (r.square().sum(dim=(0, 1, 2)).sqrt() / b.square().sum(dim=(0, 1, 2)).sqrt()).cpu()


def grid_single_solves(case, args, u, material, bar, label, cache=None):
    """Lanes 0, 1 and the last against single solves through compile_problem
    (f64, rtol 1e-10) of the lane's own boundary values and material."""
    import numpy as np
    from magnetite_tpu_torch.bc import BCArrays
    from magnetite_tpu_torch.config import ModelMetadata

    mesh, bca, md = case
    nb = u.shape[0]

    def lane_case(b):
        u_b = args[0][b].double().cpu().numpy()
        bca_b = BCArrays(u_known=bca.u_known, u_value=u_b, f_value=np.zeros_like(u_b))
        if material:
            e, nu, t = (float(a[b]) for a in args[2:])
            return bca_b, ModelMetadata(e, nu, t, 0.0, md.characteristic_length_max)
        return bca_b, ModelMetadata(md.youngs_modulus * float(args[2][b]), md.poisson_ratio,
                                    md.part_thickness, 0.0, md.characteristic_length_max)

    return single_solves(case, u, (0, 1, nb - 1), lane_case, bar, label, cache)


def phase_grid_sweep(grid, totals, material, profile):
    """Phase 15 (load) / 16 (material): the structured-grid sweep at full
    width, f32 then f64: warm solve_s and solves/s, the lane kernel's
    launches per shape against the hierarchy, every lane's true residual in
    f64, lanes against single f64 solves; then the sweep on the card
    against the CPU at small size."""
    import torch

    kind = "material" if material else "load"
    expect = (("lane_stencil_matvec3", "lane_coarse_smooth3") if material
              else ("lane_stencil_matvec",))
    say(f"phase {16 if material else 15}: structured {kind} sweep on the bench grid, "
        f"{SWEEP_LANES} lanes, {GRID_ITERS} iterations, f32 and f64")
    for dtype in ("float32", "float64"):
        name = f"the structured {kind} sweep {dtype}"
        res, args = run_grid_sweep(name, grid[f"{kind} {dtype}"], grid["case"], material, expect,
                                   totals, profile and dtype == "float32")
        rel = grid_residuals(grid, material, args, res.u)
        bar = GRID_BARS[f"{kind} {dtype}"]
        say(f"  {name}: per-lane true relative residual (f64, plain operator) max "
            f"{float(rel.max()):.3e}, median {float(rel.median()):.3e} (<= {bar['residual']:g}: "
            f"10 x the JAX package's {bar['jax']:.3e} on the CPU, at most 1e-4)")
        require(bool(torch.isfinite(rel).all()) and float(rel.max()) <= bar["residual"],
                f"{name}: residual above its bar")
        grid_single_solves(grid["case"], args, res.u, material, bar["u"], name)
        del res
    grid_card_vs_cpu(material)


def grid_card_vs_cpu(material):
    """The sweep on the card (kernel) against the CPU (plain versions) on the
    17x33 rectangle and the wrapped 17x32 plate, 32 lanes, f64."""
    import numpy as np
    import torch
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect
    from magnetite_tpu_torch.parallel.sweep import compile_material_sweep, compile_sweep

    kind = "material" if material else "load"
    for label, mesh in (("17x33 rectangle", grid_case((32, 16))[0]),
                        ("17x32 wrapped plate", plate_with_hole_mesh(16, 32))):
        bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
        md = grid_case()[2]
        case = (mesh, bca, md)
        out = {}
        for dev in (DEV, "cpu"):
            args = tuple(a.to(dev) for a in grid_batch(case, 32, 17, torch.float64, material))
            if material:
                sweep = compile_material_sweep(mesh, bca, GRID_ITERS, "float64", device=dev)
            else:
                sweep = compile_sweep(mesh, bca, md, GRID_ITERS, "float64", device=dev)
            out[dev] = sweep.solve(*args).u.cpu().numpy()
        a, b = out[DEV], out["cpu"]
        rel = float(np.abs(a - b).max() / np.abs(b).max())
        say(f"  {kind} sweep card vs CPU, {label}, 32 lanes, f64: max|du| {rel:.3e} of max|u| "
            "(<= 1e-09)")
        require(np.isfinite(a).all() and rel <= 1e-9, f"{kind} sweep on the {label}: card "
                "differs from CPU")


def lane_inside(rows, cols, wrap):
    """Stencil terms (node, offset) whose neighbour lies inside the grid."""
    return sum((rows - abs(dr)) * (cols if wrap else cols - abs(dt))
               for dr in (-1, 0, 1) for dt in (-1, 0, 1))


def lane_stencil_bound(rows, cols, nb, sets, es, wrap):
    """(bytes moved once, operations) of one lane stencil matvec: u read
    and y written once, the stencils (1, or 3 bases + Sfix) and S = 3's
    weights once; 8 flops per stencil term inside the grid and lane, plus
    S = 3's 24 to build the lane's 2x2 block."""
    nst = 4 if sets == 3 else 1
    nbytes = (4 * rows * cols * nb + 36 * nst * rows * cols + (3 * nb if sets == 3 else 0)) * es
    return nbytes, (8 if sets == 1 else 32) * lane_inside(rows, cols, wrap) * nb


def lane_coarse_bound(rows, cols, nb, es, wrap, sweeps):
    """(bytes moved once, operations) of one fused coarse solve: r, dinv,
    the weights and the four stencils read once, e written once; 24 flops
    per inside stencil term and lane to build the lane's blocks, the first
    sweep's 2x2 apply (8 per node and lane), then per sweep 8 flops per
    inside term and 12 per node (residual, 2x2 apply, omega, update)."""
    n, inside = rows * cols, lane_inside(rows, cols, wrap)
    nbytes = (8 * n * nb + 3 * nb + 144 * n) * es
    return nbytes, nb * (24 * inside + 8 * n + (sweeps - 1) * (8 * inside + 12 * n))


def parent_lane_plan(rows, cols, nb, es, aligned, sms):
    """The parent tree's lane_stencil_plan (PR 9's register-window kernel):
    (lanes per thread, rows per strip)."""
    vec = 16 // es if aligned and nb % (16 // es) == 0 else 1
    per_strip = -(-nb // vec) * cols
    strips = min(rows, max(1, -(-(sms * 2048) // per_strip)))
    return vec, -(-rows // strips)


def baseline_lane_launchers(base):
    """Calls of an older tree's lane stencil kernel, S = 1 and S = 3 (the
    library of --baseline: PR 9's C signatures, stencils in the JAX layout,
    contiguous), or (None, None) where --baseline is absent or its tree has
    none."""
    if base is None or not base.has_lane_stencil:
        return None, None
    import torch
    from magnetite_tpu_torch.kernels import cuda_lib

    def plan(u, y, ws):
        aligned = all(t.data_ptr() % 16 == 0 for t in (u, y, *ws))
        return parent_lane_plan(u.shape[1], u.shape[2], u.shape[3], u.element_size(), aligned,
                                cuda_lib.sm_count(u.device))

    def s1(st, u, wrap):
        y = torch.empty_like(u)
        vec, strip = plan(u, y, ())
        rc = base.mt_lane_stencil_matvec(cuda_lib.DTYPE_CODES[u.dtype], int(wrap), vec,
                                         st.data_ptr(), u.data_ptr(), y.data_ptr(), u.shape[1],
                                         u.shape[2], u.shape[3], strip, cuda_lib.stream_of(u))
        cuda_lib.check(base, rc, "baseline lane_stencil_matvec")
        return y

    def s3(st4, w3, u, wrap):
        y = torch.empty_like(u)
        vec, strip = plan(u, y, w3)
        rc = base.mt_lane_stencil_matvec3(
            cuda_lib.DTYPE_CODES[u.dtype], int(wrap), vec, *(s.data_ptr() for s in st4),
            *(w.data_ptr() for w in w3), u.data_ptr(), y.data_ptr(), u.shape[1], u.shape[2],
            u.shape[3], strip, cuda_lib.stream_of(u))
        cuda_lib.check(base, rc, "baseline lane_stencil_matvec3")
        return y

    return s1, s3


def phase_lane_stencil_kernel(grid, reps, flush, rand, totals, base=None):
    """Phase 17 (run after 15-16): both lane stencil kernel instances on
    packed stencils against their plain versions at the bench grid and its
    17x33 / 9x17 levels (the sweeps' own stencils) and on the wrapped 33x64
    plate, f32 and f64, each timed beside its bound and plain version, in
    interleaved rounds with cuSPARSE SpMM of the same stencil (S = 1) and
    with --baseline the parent tree's kernel; then the fused coarse
    smoother at the material sweep's coarsest levels (the bench grid's
    9x17, the wrapped plate's 9x16) against its plain version, timed
    against the unfused sequence it replaced (the per-sweep route: 47 S = 3
    launches and the torch passes; with --baseline also through the parent
    tree's S = 3 kernel) in interleaved rounds."""
    import torch
    from magnetite_tpu_torch.fem.multigrid import COARSE_SWEEPS
    from magnetite_tpu_torch.kernels import lane_coarse_kernel as lc
    from magnetite_tpu_torch.kernels.lane_stencil_kernel import (
        lane_material_matvec_plain, lane_stencil_matvec, lane_stencil_matvec3,
        lane_stencil_matvec_plain,
    )
    from magnetite_tpu_torch.kernels.mg_smooth_kernel import OMEGA
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect
    from magnetite_tpu_torch.parallel.sweep import (
        _lane_material_center_inv, compile_material_sweep, compile_sweep, material_weights,
    )

    say("phase 17: the lane stencil kernel (S = 1, S = 3) and the fused coarse smoother "
        "against their plain versions")
    for kernel in ("lane_stencil_kernel", "lane_coarse_smooth3_kernel"):
        for line in ptxas_of(kernel):
            say(f"  ptxas: {line}")
    parent1, parent3 = baseline_lane_launchers(base)
    parent_coarse = baseline_coarse_launcher(base)
    plate = plate_with_hole_mesh(32, 64)
    pbca = tensile_bcs_for_rect(plate.coords, pull=0.01)
    nb = SWEEP_LANES
    per_shape = totals.get("per shape", {})
    results = {}

    def launches(kname, rows, cols, name):  # over the main paths run before this phase
        return per_shape.get(f"{kname} {rows}x{cols} {name}", 0)

    for dtype in (torch.float32, torch.float64):
        name, es = str(dtype)[6:], torch.empty((), dtype=dtype).element_size()
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        load, mat = grid[f"load {name}"], grid[f"material {name}"]
        pload = compile_sweep(plate, pbca, grid["case"][2], GRID_ITERS, name, device=DEV)
        pmat = compile_material_sweep(plate, pbca, GRID_ITERS, name, device=DEV)
        # (label, S = 1 stencil and its packed copy, S = 3 level and its packed copy, wrap)
        shapes = [("bench 33x65", load.setup[1], load.packed[1], mat.setup[1][0],
                   mat.packed[1][0], False)]
        shapes += [(f"level {lv} {'x'.join(map(str, load.setup[2][lv].stencil.shape[-2:]))}",
                    load.setup[2][lv].stencil, load.packed[2][lv].stencil, mat.setup[1][lv],
                    mat.packed[1][lv], False) for lv in (1, 2)]
        shapes += [("wrapped plate 33x64", pload.setup[1], pload.packed[1], pmat.setup[1][0],
                    pmat.packed[1][0], True)]
        gen = torch.Generator(device="cpu").manual_seed(17)
        w3 = material_weights(*(
            (lo + (hi - lo) * torch.rand(nb, generator=gen, dtype=torch.float64)).to(DEV, dtype)
            for lo, hi in ((40e9, 250e9), (0.22, 0.38), (0.2, 1.0))))
        for label, st, pst, level, plevel, wrap in shapes:
            rows, cols = st.shape[-2:]
            st, level = st.contiguous(), tuple(s.contiguous() for s in level)
            u = rand(2, rows, cols, nb, dtype=dtype)
            tag = f"lane_stencil_matvec {label} B={nb} {name}"
            ref = lane_stencil_matvec_plain(st, u, wrap)
            scale = lane_stencil_matvec_plain(st.abs(), u.abs(), wrap).max()
            got = lane_stencil_matvec(pst, u, wrap)
            err = compare(tag, got, ref, scale, tol)
            require(torch.equal(lane_stencil_matvec(pst, u, wrap), got),
                    f"{tag}: a second launch differs")
            if parent1 is not None:
                compare(f"parent {tag}", parent1(st, u, wrap), ref, scale, tol)
            a = csr_of_stencil(st, wrap)
            x = u.reshape(2 * rows * cols, nb)
            compare(f"library CSR SpMM {tag}", torch.sparse.mm(a, x).reshape(u.shape), ref, scale,
                    tol)
            row = time_kernel(tag, lambda: lane_stencil_matvec(pst, u, wrap),
                              lambda: lane_stencil_matvec_plain(st, u, wrap),
                              lambda: torch.sparse.mm(a, x), reps, flush,
                              *lane_stencil_bound(rows, cols, nb, 1, es, wrap), dtype,
                              rounds=ROUNDS,
                              parent=parent1 and (lambda: parent1(st, u, wrap)))
            say(f"    launches over the main paths: "
                f"{launches('lane_stencil_matvec', rows, cols, name)}")
            results[f"lane_stencil_matvec {label} {name}"] = dict(max_abs_err=err, **row)
            del a, x, ref
            tag = f"lane_stencil_matvec3 {label} B={nb} {name}"
            ref = lane_material_matvec_plain(level, w3, u, wrap)
            scale = lane_material_matvec_plain(tuple(s.abs() for s in level), w3, u.abs(),
                                               wrap).max()
            got = lane_stencil_matvec3(plevel, w3, u, wrap)
            err = compare(tag, got, ref, scale, tol)
            require(torch.equal(lane_stencil_matvec3(plevel, w3, u, wrap), got),
                    f"{tag}: a second launch differs")
            if parent3 is not None:
                compare(f"parent {tag}", parent3(level, w3, u, wrap), ref, scale, tol)
            row = time_kernel(tag, lambda: lane_stencil_matvec3(plevel, w3, u, wrap),
                              lambda: lane_material_matvec_plain(level, w3, u, wrap), None,
                              reps, flush, *lane_stencil_bound(rows, cols, nb, 3, es, wrap), dtype,
                              parent=parent3 and (lambda: parent3(level, w3, u, wrap)))
            say(f"    launches over the main paths: "
                f"{launches('lane_stencil_matvec3', rows, cols, name)}")
            results[f"lane_stencil_matvec3 {label} {name}"] = dict(max_abs_err=err, **row)
            del ref, u, got
        say("  (lane_stencil_matvec3: no single PyTorch call computes a per-lane weighted sum "
            "of four stencils: library none)")

        # the fused coarse smoother at the material sweep's coarsest levels
        for label, level, plevel, wrap in (
                ("bench coarsest", mat.setup[1][-1], mat.packed[1][-1], False),
                ("wrapped plate coarsest", pmat.setup[1][-1], pmat.packed[1][-1], True)):
            rows, cols = level.sa.shape[-2:]
            route = lc.lane_coarse_route(rows, cols, es)
            require(route == "fused", f"{label} {rows}x{cols} {name}: route {route}, not fused")
            plan = lc.lane_coarse_plan(rows, cols, es)
            level = type(level)(*(s.contiguous() for s in level))
            dinv = _lane_material_center_inv(level, *w3)
            r = rand(2, rows, cols, nb, dtype=dtype)
            tag = f"lane_coarse_smooth3 {label} {rows}x{cols} B={nb} {name}"
            say(f"  {tag}: geometry (m, lanes) = ({plan.m}, {plan.lanes}), {plan.threads} "
                f"threads, {plan.smem} bytes of shared memory")

            def fused():
                return lc.lane_coarse_smooth3(plevel, dinv, w3, r, wrap, COARSE_SWEEPS, OMEGA)

            def plain():
                return lc.lane_coarse_smooth3_plain(level, dinv, w3, r, wrap, COARSE_SWEEPS,
                                                    OMEGA)

            def unfused():  # the per-sweep route: the S = 3 kernel and torch passes
                return lc._smooth(lambda e: lane_stencil_matvec3(plevel, w3, e, wrap), dinv, r,
                                  COARSE_SWEEPS, OMEGA)

            ref = plain()
            # 48 sweeps of rounding in another order: held to max|e|
            got = fused()
            err = compare(tag, got, ref, ref.abs().max(), tol)
            require(torch.equal(fused(), got), f"{tag}: a second launch differs")
            compare(f"unfused {tag}", unfused(), ref, ref.abs().max(), tol)
            fns = {"kernel": fused}
            if parent_coarse is not None:
                def parent():
                    return parent_coarse(plevel.data, dinv, w3, r, wrap, COARSE_SWEEPS, OMEGA)
                compare(f"parent {tag}", parent(), ref, ref.abs().max(), tol)
                fns["parent"] = parent
            fns["unfused"] = unfused
            if parent3 is not None:
                fns["unfused parent"] = lambda: lc._smooth(
                    lambda e: parent3(level, w3, e, wrap), dinv, r, COARSE_SWEEPS, OMEGA)
            med = interleaved(tag, fns, reps, flush, ROUNDS)
            plain_ms = event_ms(plain, reps, flush)
            nbytes, flops = lane_coarse_bound(rows, cols, nb, es, wrap, COARSE_SWEEPS)
            b_ms, b_by = bound(nbytes, flops, dtype)
            ms = med["kernel"]
            par = (f", unfused through the parent's S = 3 {med['unfused parent']:.4f} ms"
                   if "unfused parent" in med else "")
            for k, t in med.items():
                if k == "parent":
                    say(f"    {tag}: {k} {t:.4f} ms ({b_ms / t:.1%} of bound); the kernel "
                        f"{'below' if ms < t else 'NOT below'} it ({ms / t:.3f}x)")
            say(f"  {tag}: kernel {ms:.4f} ms ({b_ms / ms:.1%} of bound {b_ms:.4f} ms by "
                f"{b_by}), unfused {med['unfused']:.4f} ms ({med['unfused'] / ms:.2f}x the "
                f"kernel's){par}, plain {plain_ms:.4f} ms; launches over the main paths: "
                f"{launches('lane_coarse_smooth3', rows, cols, name)}")
            results[f"lane_coarse_smooth3 {label} {name}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
            del dinv, r, ref, got
        del pload, pmat
        if DEV == "cuda":
            torch.cuda.empty_cache()
    for k in ("lane_stencil_matvec", "lane_stencil_matvec3"):
        results[k] = results[f"{k} bench 33x65 float32"]  # the main path's f32 bench call
    results["lane_coarse_smooth3"] = results["lane_coarse_smooth3 bench coarsest float32"]
    return results


def phase_grid_sweeps(args, rand, results, totals, base=None):
    """Phases 15, 16 and 17 on the bench grid, set up once (17 after the
    sweeps, so its lines can quote their launches per shape)."""
    import torch

    say("phases 15-17: the bench grid compiled for both structured sweeps")
    grid = compile_grid_sweeps()
    phase_grid_sweep(grid, totals, False, args.profile)
    phase_grid_sweep(grid, totals, True, args.profile)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=DEV)
    results.update(phase_lane_stencil_kernel(grid, args.reps, flush, rand, totals, base))
    del flush, grid
    torch.cuda.empty_cache()


# ------------- block-Jacobi sweep routes of sweep_solve (phases 18-20) -------


def shuffled_case(case, seed=SHUFFLE_SEED):
    """The plate with its nodes in the order of a numpy permutation (no band
    structure left): ((mesh, bca, md), perm, inv), perm[new] = old,
    inv[old] = new."""
    import numpy as np
    from magnetite_tpu_torch.bc import BCArrays
    from magnetite_tpu_torch.meshing.core import Mesh

    mesh, bca, md = case
    perm = np.random.default_rng(seed).permutation(mesh.num_nodes)
    inv = inverse(perm)
    shuf = (Mesh(coords=mesh.coords[perm], tris=inv[mesh.tris].astype(np.int32)),
            BCArrays(u_known=bca.u_known[perm], u_value=bca.u_value[perm],
                     f_value=bca.f_value[perm]), md)
    return shuf, perm, inv


def lane_ell_bound(n, w, nb, es):
    """(bytes moved once, operations) of one lane ELL matvec: u read and y
    written once, the blocks and the int32 cols once; 8 flops per (slot,
    lane)."""
    return (4 * n * nb + 4 * n * w) * es + 4 * n * w, 8 * n * w * nb


def csr_of_ell(ell, cols):
    """K of block-ELL ell [N, W, 2, 2] / cols [N, W] on the flattened [2, N]
    layout (the padding slots' zero blocks included)."""
    import torch

    n, w = cols.shape
    node = torch.arange(n, device=ell.device)
    rows, cs, vals = [], [], []
    for k in range(w):
        for i in range(2):
            for j in range(2):
                rows.append(i * n + node)
                cs.append(j * n + cols[:, k].long())
                vals.append(ell[:, k, i, j])
    return csr(rows, cs, vals, (2 * n, 2 * n))


def ell_operands(mesh, md, dtype):
    """The port's block-ELL operator of `mesh` on the card: (ell, cols)."""
    import numpy as np
    import torch
    from magnetite_tpu_torch.fem.assembly import assemble_ell, build_ell_structure

    st = build_ell_structure(mesh.tris, mesh.num_nodes)
    ell = assemble_ell(mesh.coords, mesh.tris, md.youngs_modulus, md.poisson_ratio,
                       md.part_thickness, st).to(DEV, dtype)
    return ell, torch.from_numpy(np.ascontiguousarray(st.cols)).to(DEV)


def phase_lane_ell_kernel(case, shuf, reps, flush, rand):
    """Phase 20 (run before 18-19): the lane ELL kernel against its plain
    version at the sweep plate shuffled and as meshed, f32 and f64, B =
    4,096 / 1,000 / 1, each call repeated bit for bit; at B = 4,096 timed
    beside its bound, its plain version and cuSPARSE SpMM of the same CSR
    matrix on u.reshape(2N, B)."""
    import torch
    from magnetite_tpu_torch.kernels.lane_ell_kernel import (
        lane_ell_matvec, lane_ell_matvec_plain,
    )

    say("phase 20: the lane ELL kernel against its plain version")
    for line in ptxas_of("lane_ell_kernel"):
        say(f"  ptxas: {line}")
    results = {}
    for label, (mesh, _, md) in (("shuffled", shuf), ("as meshed", case)):
        for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-13)):
            name, es = str(dtype)[6:], torch.empty((), dtype=dtype).element_size()
            ell, cols = ell_operands(mesh, md, dtype)
            n, w = cols.shape
            for nb in (SWEEP_LANES, 1000, 1):
                u = rand(2, n, nb, dtype=dtype)
                tag = f"lane_ell_matvec {label} N={n} W={w} B={nb} {name}"
                before = lane_ell_matvec.launches
                y, again = lane_ell_matvec(ell, cols, u), lane_ell_matvec(ell, cols, u)
                require(lane_ell_matvec.launches == before + 2, f"{tag}: kernel not launched")
                require(torch.equal(y, again), f"{tag}: a repeated call differs")
                ref = lane_ell_matvec_plain(ell, cols, u)
                scale = lane_ell_matvec_plain(ell.abs(), cols, u.abs()).max()
                err = compare(f"{tag} (repeated bit for bit)", y, ref, scale, tol)
                if nb == SWEEP_LANES:
                    a = csr_of_ell(ell, cols)
                    x = u.reshape(2 * n, nb)
                    compare(f"library CSR SpMM {tag}", torch.sparse.mm(a, x).reshape(u.shape),
                            ref, scale, 1e-5 if dtype == torch.float32 else 1e-12)
                    row = time_kernel(tag, lambda: lane_ell_matvec(ell, cols, u),
                                      lambda: lane_ell_matvec_plain(ell, cols, u),
                                      lambda: torch.sparse.mm(a, x), reps, flush,
                                      *lane_ell_bound(n, w, nb, es), dtype, rounds=ROUNDS)
                    results[f"lane_ell_matvec {label} {name}"] = dict(max_abs_err=err, **row)
                    del a, x
                del u, y, again, ref
        if DEV == "cuda":
            torch.cuda.empty_cache()
    results["lane_ell_matvec"] = results["lane_ell_matvec shuffled float32"]  # the main path's
    return results


def lane_route_residuals(bands64, offsets, free, args, u):
    """Per-lane true relative residual ||b - A u|| / ||b|| in f64 with the
    plain K7 operator of the meshed order: args = (u_values, f_values,
    k_scales), u [B, N, 2], all in the meshed node order."""
    import torch
    from magnetite_tpu_torch.kernels.lane_dia_kernel import lane_dia_matvec_plain

    ks = args[2].to(DEV, torch.float64)

    def lanes(x):  # [B, N, 2] -> [2, N, B], f64
        return x.to(DEV, torch.float64).permute(2, 1, 0).contiguous()

    def k_op(v):
        return lane_dia_matvec_plain(bands64, offsets, v) * ks

    uf, fa, uu = lanes(args[0]), lanes(args[1]), lanes(u)
    b = free * (fa - k_op(uf)) + (1.0 - free) * uf
    r = b - (free * k_op(free * uu) + (1.0 - free) * uu)
    return (r.square().sum(dim=(0, 1)).sqrt() / b.square().sum(dim=(0, 1)).sqrt()).cpu()


def run_lane_route(name, route_case, meshed, order, kernel, dtype, totals, profile=False):
    """sweep_solve(impl="auto") on `route_case` in `dtype` ("float32" |
    "float64") under the launch counters,
    then LANE_SWEEP_WARM fresh batches: first and warm solve_s (set-up
    included: these routes have no compiled object), solves/s. The batches
    are made in the `meshed` order (grid_batch, seeds 0, 1, ...) and
    gathered into the route case's by `order` before the clock starts.
    Returns (u and the batch in the meshed order, counts)."""
    import torch
    from magnetite_tpu_torch.parallel.sweep import sweep_solve

    idx = None if order is None else torch.as_tensor(order, device=DEV)
    back = None if order is None else torch.as_tensor(inverse(order), device=DEV)

    def batch(seed):
        u, f, k = grid_batch(meshed, SWEEP_LANES, seed, getattr(torch, dtype), False)
        return (u, f, k) if idx is None else (u[:, idx], f[:, idx], k)

    def solve(args):
        return sweep_solve(*route_case, *args, iterations=LANE_SWEEP_ITERS, dtype=dtype,
                           impl="auto", device=DEV)

    args = batch(0)
    sync()
    with main_path(name, totals, (kernel,)) as got:
        t0 = time.perf_counter()
        res = solve(args)
        sync()
        first = time.perf_counter() - t0
    warm = []
    for seed in range(1, LANE_SWEEP_WARM + 1):
        a = batch(seed)
        sync()
        t0 = time.perf_counter()
        solve(a)
        sync()
        warm.append(time.perf_counter() - t0)
    med = statistics.median(warm)
    say(f"  {name}: first solve_s {first:.4f}; warm solve_s median {med:.4f} over {len(warm)} "
        f"fresh batches ({' / '.join(f'{t:.4f}' for t in warm)}) -> {SWEEP_LANES / med:.0f} "
        f"solves/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30 if DEV == 'cuda' else 0:.2f} GiB")
    require(bool(torch.isfinite(res.u).all()), f"{name}: non-finite displacements")
    if profile:
        profile_call(f"{name} (one warm sweep_solve)", lambda: solve(args))
    if back is None:
        return res.u, args, got
    return res.u[:, back], grid_batch(meshed, SWEEP_LANES, 0, getattr(torch, dtype), False), got


def inverse(order):
    """inv[order[i]] = i."""
    import numpy as np

    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    return inv


def check_route_launches(name, got, kernel, dtype):
    """Exactly `kernel`'s launches of one block-Jacobi PCG (the CG operator
    at r0, each iteration and the true final residual, plus the RHS), and
    no other kernel: no AMG, no other sweep operator."""
    want = LANE_SWEEP_ITERS + 3
    expect = {kernel: want}
    if kernel == "lane_dia_matvec":  # K7 counts its ring and f64 launches apart
        expect.update({"lane_dia_matvec ring": want,
                       "lane_dia_matvec f64": want if dtype == "float64" else 0})
    other = {k: v for k, v in got.items() if v and k not in expect}
    require(all(got[k] == v for k, v in expect.items()) and not other,
            f"{name}: launches {got}, expected {expect} and nothing else")
    say(f"  {name}: {kernel} launches {got[kernel]} = {LANE_SWEEP_ITERS} + 3"
        + (f" (ring {got['lane_dia_matvec ring']}, f64 {got['lane_dia_matvec f64']})"
           if kernel == "lane_dia_matvec" else "")
        + "; no other kernel launched")


def lane_route_checks(name, sweep_case, bands64, offsets, free, args, u, bar, singles):
    """Every lane's true residual against bar["residual"], lanes 0, 1 and the
    last against converged single f64 solves (bar["single"]; `singles`
    keeps them for the other route)."""
    import torch

    rel = lane_route_residuals(bands64, offsets, free, args, u)
    say(f"  {name}: per-lane true relative residual (f64, plain operator) max "
        f"{float(rel.max()):.3e}, median {float(rel.median()):.3e} (<= {bar['residual']:.3e}: "
        "10 x the JAX package's on the CPU)")
    require(bool(torch.isfinite(rel).all()) and float(rel.max()) <= bar["residual"],
            f"{name}: residual above its bar")
    grid_single_solves(sweep_case, args, u, False, bar["single"], name, singles)
    return float(rel.max())


def phase_lane_sweeps(args, rand, results, totals):
    """Phases 20, 18 and 19 on the sweep plate, then both routes on the card
    against the CPU."""
    import torch
    from magnetite_tpu_torch.fem.assembly import build_ell_structure
    from magnetite_tpu_torch.fem.dia import build_dia_structure
    from magnetite_tpu_torch.parallel.sweep import _assembled_bands

    case = plate_case(args.sweep_h)
    shuf, perm, _ = shuffled_case(case)
    mesh, bca, md = case
    n = mesh.num_nodes
    dia = build_dia_structure(mesh.tris, n)
    require(dia is not None and build_dia_structure(shuf[0].tris, n) is None,
            "the sweep plate must be DIA-compatible as meshed and not once shuffled")
    offsets = tuple(int(o) for o in dia.offsets)
    say(f"phases 18-20: the sweep plate h={args.sweep_h}, {n} nodes as meshed ({len(offsets)} "
        f"offsets, {min(offsets)}..{max(offsets)}, block-ELL width "
        f"{build_ell_structure(mesh.tris, n).width}) and shuffled by numpy seed {SHUFFLE_SEED} "
        f"(no band structure, block-ELL width {build_ell_structure(shuf[0].tris, n).width})")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=DEV)
    t0 = time.perf_counter()
    results.update(phase_lane_ell_kernel(case, shuf, args.reps, flush, rand))
    say(f"  (phase 20: {time.perf_counter() - t0:.1f} s)")
    del flush
    if DEV == "cuda":
        torch.cuda.empty_cache()
    bands64 = _assembled_bands(mesh, md, dia).to(DEV)
    free = torch.from_numpy((~bca.u_known).T.astype("float64")).to(DEV)[:, :, None]
    say(f"phase 18: the DIA block-Jacobi lanes, sweep_solve(impl='auto') on the plate as "
        f"meshed, {SWEEP_LANES} lanes, {LANE_SWEEP_ITERS} iterations, f32 and f64")
    lanes_u, singles = {}, {}
    t0 = time.perf_counter()
    for dtype in ("float32", "float64"):
        name = f"the DIA lane sweep {dtype}"
        u, margs, got = run_lane_route(name, case, case, None, "lane_dia_matvec", dtype,
                                       totals, args.profile)
        check_route_launches(name, got, "lane_dia_matvec", dtype)
        lane_route_checks(name, case, bands64, offsets, free, margs, u,
                          LANE_BARS[f"lanes {dtype}"], singles)
        lanes_u[dtype] = u
    say(f"  (phase 18: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    say(f"phase 19: the vmap route, sweep_solve(impl='auto') on the plate shuffled, "
        f"{SWEEP_LANES} lanes, {LANE_SWEEP_ITERS} iterations, f32 and f64")
    for dtype in ("float32", "float64"):
        name = f"the vmap sweep {dtype}"
        u, margs, got = run_lane_route(name, shuf, case, perm, "lane_ell_matvec", dtype,
                                       totals, args.profile)
        check_route_launches(name, got, "lane_ell_matvec", dtype)
        lane_route_checks(name, case, bands64, offsets, free, margs, u,
                          LANE_BARS[f"vmap {dtype}"], singles)
        scale = float(lanes_u[dtype].abs().max())
        compare(f"{name} mapped back to the meshed order vs phase 18's lanes",
                u.double(), lanes_u[dtype].double(), scale,
                LANE_BARS[f"routes {dtype}"])
    del lanes_u, bands64
    if DEV == "cuda":
        torch.cuda.empty_cache()
    lane_sweeps_card_vs_cpu(LANE_SMALL_H)
    say(f"  (phase 19 with the card against the CPU: {time.perf_counter() - t0:.1f} s)")


def lane_sweeps_card_vs_cpu(h, lanes=32, iterations=400):
    """Both block-Jacobi routes through sweep_solve on the card (K7 / the lane
    ELL kernel) against the CPU (their plain versions), the plate at h as
    meshed and shuffled, f64, 400 iterations: converged (at 200 the two
    summation orders' iterates part by up to ~1e-6 of max|u| at h = 0.08),
    so u within 1e-9 of max|u|."""
    import numpy as np
    import torch
    from magnetite_tpu_torch.kernels.lane_dia_kernel import lane_dia_matvec
    from magnetite_tpu_torch.kernels.lane_ell_kernel import lane_ell_matvec
    from magnetite_tpu_torch.parallel.sweep import sweep_solve

    case = plate_case(h)
    shuf, perm, _ = shuffled_case(case)
    for label, c, order, kernel in (("lanes, as meshed", case, None, lane_dia_matvec),
                                    ("vmap, shuffled", shuf, perm, lane_ell_matvec)):
        out = {}
        for dev in (DEV, "cpu"):
            u, f, k = grid_batch(case, lanes, 18, torch.float64, False)
            if order is not None:
                u, f = u[:, order], f[:, order]
            before = kernel.launches
            out[dev] = sweep_solve(*c, u.to(dev), f.to(dev), k.to(dev), iterations=iterations,
                                   dtype="float64", impl="auto", device=dev).u.cpu().numpy()
            require((kernel.launches > before) == (dev == DEV),
                    f"{label}: {kernel.__name__} launches on the {dev}")
        a, b = out[DEV], out["cpu"]
        rel = float(np.abs(a - b).max() / np.abs(b).max())
        say(f"  {label} sweep card vs CPU, h={h} ({c[0].num_nodes} nodes), {lanes} lanes, f64, "
            f"{iterations} iterations: max|du| {rel:.3e} of max|u| (<= 1e-09)")
        require(np.isfinite(a).all() and rel <= 1e-9, f"{label} sweep: card differs from CPU")


# ------------------- the ELL and dense modes (phase 22) ---------------------


def ell_floor_rounds(tag, data, cols, u, reps, flush, nbytes, flops, dtype, base=None):
    """The ELL kernel at one shape timed in interleaved rounds with the
    launch floor (a kernel that reads one value and writes one, launched
    and timed the same way) and with --baseline the parent tree's kernel,
    held to the kernel's bits; prints each one's share of the bound and of
    bound + floor. Returns the floor's median ms (None on the CPU)."""
    import torch
    from magnetite_tpu_torch.kernels import cuda_lib
    from magnetite_tpu_torch.kernels.ell_kernel import ell_matvec_t

    fns = {"kernel": lambda: ell_matvec_t(data, cols, u)}
    parent = baseline_ell_launcher(base)
    if parent is not None:
        same = torch.equal(parent(data, cols, u), ell_matvec_t(data, cols, u))
        say(f"  {tag}: the parent's kernel bit-identical to the kernel: {same}")
        require(same, f"{tag}: the kernel sums otherwise than the parent's")
        fns["parent"] = lambda: parent(data, cols, u)
    if u.is_cuda:
        x = torch.zeros(1, dtype=torch.float32, device=u.device)
        fns["launch floor"] = lambda: cuda_lib.launch_floor(x)
    med = interleaved(f"{tag} floor", fns, reps, flush, ROUNDS)
    b_ms, b_by = bound(nbytes, flops, dtype)
    floor = med.get("launch floor")
    for key, t in med.items():
        if key != "launch floor":
            plus = f", {(b_ms + floor) / t:.1%} of bound + floor" if floor is not None else ""
            say(f"    {tag} {key}: {t:.4f} ms, {b_ms / t:.1%} of bound {b_ms:.4f} ms by {b_by}"
                f"{plus}")
    if floor is not None:
        say(f"  {tag}: launch floor {floor:.4f} ms (one value read, one written, the same "
            f"timer)")
    return floor


def phase_ell_kernel(mesh, md, reps, flush, rand, base=None):
    """Phase 22a: the ELL kernel against its plain version on the card at
    the Delaunay plate's level-0 operator, f64 and f32, each call repeated
    bit for bit, timed against the plain version and a cuSPARSE CSR SpMV of
    the same matrix (and with --baseline the parent tree's kernel) in
    interleaved rounds; then the kernel and the launch floor in rounds
    (ell_floor_rounds)."""
    import torch
    from magnetite_tpu_torch.kernels.ell_kernel import (
        ell_matvec_t, ell_matvec_t_plain, ell_to_slot_major,
    )

    ell64, cols_nm = ell_operands(mesh, md, torch.float64)
    n, k = cols_nm.shape
    say(f"phase 22: ELL kernel against its plain version on the card, N={n}, K={k}")
    for kernel in ("ell_matvec_kernel", "launch_floor_kernel"):
        for line in ptxas_of(kernel):
            say(f"  ptxas: {line}")
    results = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        data, cols = ell_to_slot_major(ell64.to(dtype), cols_nm)
        u = rand(2, n, dtype=dtype)
        scale = ell_matvec_t_plain(data.abs(), cols, u.abs()).max()
        ref = ell_matvec_t_plain(data, cols, u)
        tag = f"ell_matvec_t K={k} N={n} {str(dtype)[6:]}"
        y = ell_matvec_t(data, cols, u)
        err = compare(tag, y, ref, scale, tol)
        require(torch.equal(y, ell_matvec_t(data, cols, u)), f"{tag}: a second call differs")
        a = csr_of_ell(data.permute(3, 0, 1, 2), cols.T)
        x = u.reshape(-1)
        compare(f"library CSR SpMV {tag}", torch.mv(a, x).reshape(2, n), ref, scale, tol)
        es = data.element_size()
        nbytes, flops = n * k * (4 * es + 4) + 4 * n * es, 8 * n * k
        parent = baseline_ell_launcher(base)
        row = time_kernel(
            tag, lambda: ell_matvec_t(data, cols, u), lambda: ell_matvec_t_plain(data, cols, u),
            lambda: torch.mv(a, x), reps, flush, nbytes, flops, dtype, rounds=ROUNDS,
            parent=parent and (lambda: parent(data, cols, u)),
        )
        ell_floor_rounds(tag, data, cols, u, reps, flush, nbytes, flops, dtype, base)
        if dtype == torch.float64:
            results["ell_matvec_t"] = dict(max_abs_err=err, **row)
        del a, data, cols
    del ell64
    return results


def true_residual_ell(problem, u):
    """The true relative residual with the plain ELL operator; u [N, 2] in
    the problem's node order (the ELL mode never renumbers)."""
    from magnetite_tpu_torch.kernels.ell_kernel import ell_matvec_t_plain

    data, cols = problem.system.data.double(), problem.system.cols
    return true_residual(problem, u, lambda v: ell_matvec_t_plain(data, cols, v))


def expected_ell_launches(iters, sweeps, amg, maxiter, vdtype):
    """The kernel launches of one AMG-preconditioned ELL CG solve: the CG
    runs whole chunks of CHECK_EVERY steps (vcycles), one V-cycle per step
    and one up front; the ELL kernel runs the rhs, r0, each step's operator
    and the force recovery, and in each V-cycle sweeps - 1 pre-smoothing
    residuals, the residual before restriction, the masked operator of
    restrict and of prolong and `sweeps` post-smoothing residuals
    (amg.make_amg_preconditioner); each banded coarse level but the
    coarsest runs the m = 3 band kernel twice per V-cycle (pre-residual and
    post-sweep), a coarsest one without a dense inverse COARSE_SWEEPS
    times (amg.make_coarse_cycle). Returns (counts, m = 3 launches per
    (3, N, dtype))."""
    import torch
    from magnetite_tpu_torch.fem.amg import COARSE_SWEEPS

    v = vcycles([iters], maxiter)
    cg = (v - 1) + 3
    per_v = 2 * sweeps + 2
    last = len(amg.coarse) - 1
    shapes = {}
    for l, cb in enumerate(amg.coarse_bands):
        per = 2 if l < last else (0 if amg.ci is not None else COARSE_SWEEPS)
        if cb is not None and per:
            shapes[(3, cb.bands.shape[-1], vdtype)] = per * v
    counts = {"ell_matvec_t": cg + v * per_v, "prolong0": v, "restrict0": v,
              "dia_matvec m=2": 0, "dia_matvec m=3": sum(shapes.values()),
              # the CG's launches are f64 in both precisions, the V-cycle's
              # in the V-cycle's dtype
              "ell_matvec_t f64": cg + (v * per_v if vdtype == torch.float64 else 0)}
    return counts, shapes


def ell_cli(name, argv, totals, ell_problem, precision):
    """One --operator ell CLI run on the Delaunay plate: operator=ell,
    preconditioner=amg, and exactly the launches its iterations imply, of
    the ELL kernel, the transfers and the m = 3 band kernel and of no
    other kernel. Returns (stdout, iterations, stage times)."""
    import torch
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec

    expect = ("ell_matvec_t", "prolong0", "restrict0", "dia_matvec m=3")
    with main_path(name, totals, expect) as got:
        out, err = run_cli(argv)
    op, pre, refine, iters = cli_summary(out)
    require((op, pre, refine) == ("ell", "amg", str(precision == "mixed")),
            f"{name}: operator={op} preconditioner={pre} refine={refine}")
    require("warning" not in err, f"{name}: warned: {err.strip()[:300]}")
    sweeps = 3 if precision == "mixed" else 1
    vdtype = torch.float32 if precision == "mixed" else torch.float64
    want, shapes = expected_ell_launches(iters, sweeps, ell_problem.system.amg,
                                         ell_problem.maxiter, vdtype)
    others = {k: c for k, c in got.items() if c and k.split(" ")[0] not in (
        "ell_matvec_t", "prolong0", "restrict0", "dia_matvec")}
    got_shapes = {key: c for key, c in dia_matvec.shape_launches.items() if c}
    say(f"  {name}: {iters} iterations, sweeps {sweeps}; launches expected {want}, "
        f"m=3 per shape {shapes}")
    require(all(got[k] == c for k, c in want.items()) and got_shapes == shapes
            and not others, f"{name}: launches {got} / {got_shapes}, expected {want} / "
            f"{shapes} and no other kernel")
    return out, iters, cli_stages(out)


def golden_against(name, nodes, elems, ref_nodes, ref_elems, u_tol=1e-6, s_tol=1e-5):
    """u and stress of one run's CSVs against another's (the golden bars,
    tests/test_golden.py:48-55, by default)."""
    import numpy as np

    require(np.array_equal(nodes[:, :2], ref_nodes[:, :2])
            and np.array_equal(elems[:, :3], ref_elems[:, :3]), f"{name}: mesh differs")
    for what, got, ref, tol in (("u", nodes[:, 2:], ref_nodes[:, 2:], u_tol),
                                ("stress", elems[:, 3], ref_elems[:, 3], s_tol)):
        err, lim = float(np.abs(got - ref).max()), tol * float(np.abs(ref).max())
        say(f"  {name}: {what} max|diff| {err:.3e} <= {lim:.3e} ({tol:g} x max)")
        require(err <= lim, f"{name}: {what} outside its bar")


def warm_solves(label, problems: dict, rounds=3):
    """solve_s of already compiled problems, interleaved; prints and
    returns the lists."""
    times = {k: [] for k in problems}
    for _ in range(rounds):
        for k, p in problems.items():
            times[k].append(p.solve().timings["solve_s"])
    say(f"  {label} warm solve_s: " + "; ".join(
        f"{k} " + " / ".join(f"{t:.4f}" for t in v) for k, v in times.items()))
    return times


# the dense mode's plate (the sweep plate: 3,774 nodes, 2N = 7,548) and
# the f32 bar of its answer: an f32 LU at this plate's conditioning is
# ~1.2e-3 of max|u| off the f64 answer (the CPU's LAPACK, measured), so
# f32 is held to 5e-3 of max|u| and of max stress, against f64 and across
# devices; f64 keeps the golden bars
DENSE_H, DENSE_CUTOFF, DENSE_F32_BAR = 0.03, 10_000, 5e-3


def phase_dense(reps, flush, totals):
    """Phase 22e: dense_cutoff on the sweep plate, f64 and f32, against the
    f64 DIA + AMG answer and against the CPU; the assembly and the LU timed
    apart."""
    import numpy as np
    import torch
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.assembly import assemble_dense
    from magnetite_tpu_torch.fem.element import element_stiffness_matrices
    from magnetite_tpu_torch.fem.solve import compile_problem

    mesh, bca, md = plate_case(DENSE_H)
    n = mesh.num_nodes
    say(f"phase 22e: dense mode (dense_cutoff={DENSE_CUTOFF}) on the plate h={DENSE_H}, "
        f"{n} nodes, 2N = {2 * n}")
    ref = compile_problem(mesh, bca, md, SolverOptions(preconditioner="amg"),
                          device=DEV).solve()
    for dtype in ("float64", "float32"):
        opts = SolverOptions(dense_cutoff=DENSE_CUTOFF, dtype=dtype)
        with main_path(f"the dense solve {dtype}", totals, ()) as got:
            problem = compile_problem(mesh, bca, md, opts, device=DEV)
            res = problem.solve()
        require(problem.mode == "dense" and res.iterations == 0 and not any(got.values()),
                f"dense {dtype}: mode {problem.mode}, {res.iterations} iterations, "
                f"launches {got}")
        u_tol, s_tol = (1e-6, 1e-5) if dtype == "float64" else (DENSE_F32_BAR,) * 2
        for what, a, b, tol in (("u", res.u, ref.u, u_tol),
                                ("stress", res.stress, ref.stress, s_tol)):
            err, lim = float(np.abs(a - b).max()), tol * float(np.abs(b).max())
            say(f"  dense {dtype} against DIA + AMG f64: {what} max|diff| {err:.3e} <= "
                f"{lim:.3e}")
            require(err <= lim, f"dense {dtype}: {what} off the DIA answer")
        cpu = compile_problem(mesh, bca, md, opts, device="cpu").solve()
        c_tol = (1e-8, 1e-7) if dtype == "float64" else (DENSE_F32_BAR,) * 2
        for what, a, b, tol in (("u", res.u, cpu.u, c_tol[0]),
                                ("stress", res.stress, cpu.stress, c_tol[1])):
            err, lim = float(np.abs(a - b).max()), tol * float(np.abs(b).max())
            say(f"  dense {dtype} card against CPU: {what} max|diff| {err:.3e} <= {lim:.3e}")
            require(err <= lim, f"dense {dtype}: card differs from CPU")
        tdt = torch.float64 if dtype == "float64" else torch.float32
        coords, tris = problem.coords, problem.tris

        def assemble():
            ke = element_stiffness_matrices(coords, tris, md.youngs_modulus,
                                            md.poisson_ratio, md.part_thickness)
            return assemble_dense(ke, tris, n)

        kmat = assemble()
        free = (~problem.u_known).to(tdt).reshape(-1)
        a = kmat * (free[:, None] * free[None, :]) + torch.diag(1.0 - free)
        b = torch.ones(2 * n, dtype=tdt, device=DEV)
        asm_ms = event_ms(assemble, max(3, reps // 4), flush)
        lu_ms = event_ms(lambda: torch.linalg.solve(a, b), max(3, reps // 4), flush)
        warm = [problem.solve().timings["solve_s"] for _ in range(2)]
        say(f"  dense {dtype}: first solve_s {res.timings['solve_s']:.4f}, warm {warm}; "
            f"assembly {asm_ms:.4f} ms, LU solve (torch.linalg.solve) {lu_ms:.4f} ms; residual "
            f"{res.residual_rel:.3e}")
        del kmat, a, problem
        torch.cuda.empty_cache()


def phase_ell(problem, mesh, bca, md, args, dia, totals, reps, flush, rand, base=None):
    """Phase 22: the ELL kernel (22a); the --operator ell CLI on the
    Delaunay plate in f64 and mixed, resumed from a case holding phase 5's
    mesh and AMG hierarchy (22b-c), against phases 5-6's DIA runs (`dia`:
    precision -> (nodes, elements, iterations, stages)); --save-case then
    --load-case (22d); warm solve_s beside DIA's; the dense mode (22e).
    Returns the kernel's row."""
    import torch
    from magnetite_tpu_torch import persist
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import compile_problem

    t0 = time.perf_counter()
    results = phase_ell_kernel(mesh, md, reps, flush, rand, base)
    torch.cuda.empty_cache()
    # the hierarchy phase 5 built: no renumbering on either side, so the
    # ELL compile's AMG fingerprint accepts it
    ell64 = compile_problem(mesh, bca, md, SolverOptions(operator="ell"),
                            amg_setup=problem.amg_setup, device=DEV)
    require(ell64.amg_setup is problem.amg_setup and problem.perm is None,
            "phase 5's AMG hierarchy was not reused")
    with tempfile.TemporaryDirectory() as workdir:
        say(f"phase 22b-d: --operator ell through the CLI on the Delaunay plate at h={args.h}")
        paths = write_case_files(workdir, args.h)
        case = os.path.join(workdir, "case.npz")
        persist.save_case(case, mesh, bca, metadata=md)
        persist.save_amg(case + ".amg.npz", problem.amg_setup, values_dtype=None)
        flags = ["--device", DEV, "--skip", "--operator", "ell"]
        runs = {}
        for tag, extra in (("f64", ["--save-case", case]), ("mixed", ["--precision", "mixed"]),
                           ("resumed", [])):
            out_dir = os.path.join(workdir, tag)
            os.makedirs(out_dir)
            out, iters, stages = ell_cli(
                f"the --operator ell CLI run ({tag})",
                [paths[0], "--load-case", case, "--out-dir", out_dir] + flags + extra,
                totals, ell64, "mixed" if tag == "mixed" else "f64")
            nodes, elems = read_csvs(out_dir)
            rel = true_residual_ell(ell64, nodes[:, 2:])
            say(f"  {tag}: true relative residual {rel:.3e} (<= 1e-09); operator cache "
                f"{'hit' if 'operator cache hit' in out else 'none'}")
            require(rel <= 1e-9, f"ELL {tag}: true residual too large")
            runs[tag] = (nodes, elems, iters, stages, out)
        for tag, dia_tag in (("f64", "f64"), ("mixed", "mixed")):
            nodes, elems, iters, stages, _ = runs[tag]
            d_nodes, d_elems, d_iters, d_stages = dia[dia_tag]
            say(f"  ELL {tag}: {iters} iterations (DIA {d_iters}); prep {stages['prep']:.3f} s "
                f"(DIA {d_stages['prep']:.3f} s, meshing and the AMG build included there), "
                f"CLI solve_s {stages['solve_s']:.4f} (DIA {d_stages['solve_s']:.4f})")
            require(abs(iters - d_iters) <= 1, f"ELL {tag}: iterations off DIA's")
            golden_against(f"ELL {tag} against DIA {dia_tag}", nodes, elems, d_nodes, d_elems)
        print_prep("prep stages, ELL f64 / mixed / resumed",
                   {k: runs[k][3] for k in ("f64", "mixed", "resumed")})
        require("info: operator cache hit" not in runs["f64"][4]
                and all("info: operator cache hit" in runs[k][4] for k in ("mixed", "resumed")),
                "the ELL runs after --save-case did not hit the operator cache")
        require(runs["resumed"][2] == runs["f64"][2], "the resumed ELL run's iterations differ")
        golden_against("ELL resumed against ELL f64", runs["resumed"][0], runs["resumed"][1],
                       runs["f64"][0], runs["f64"][1], 1e-12, 1e-12)
    warm_solves("f64, DIA vs ELL", {"DIA": problem, "ELL": ell64})
    mixed = {
        "DIA": compile_problem(mesh, bca, md, SolverOptions(dtype="float32", refine="on"),
                               amg_setup=problem.amg_setup, device=DEV),
        "ELL": compile_problem(mesh, bca, md, SolverOptions(operator="ell", dtype="float32",
                                                            refine="on"),
                               amg_setup=problem.amg_setup, device=DEV),
    }
    warm_solves("mixed, DIA vs ELL", mixed)
    del mixed, ell64
    torch.cuda.empty_cache()
    phase_dense(reps, flush, totals)
    say(f"  (phase 22: {time.perf_counter() - t0:.1f} s)")
    return results


# ------------- device assembly and the sharded pipeline (phase 23) ----------


# shard counts of phase 23's sharded runs on one card (S = 1 is the yardstick
# of warm solve_s)
SHARD_COUNTS = (1, 2, 4)


def assembly_bytes_flops(n_nodes, n_elem, n_slots):
    """(bytes, flops) of one fused assembly: coords [N, 2] f64, tris [E, 3]
    and a-major slot ids [9E] int64 read once, the [2, 2, S] f64 sums
    written once; ~40 flops per pair (its four block scalars)."""
    return 16 * n_nodes + 24 * n_elem + 72 * n_elem + 32 * n_slots, 40 * 9 * n_elem


def count_bytes_flops(n_nodes, n_elem, n_slots):
    """(bytes, flops) of the count kernel: coords, tris and the slot ids
    read once, the counts [S + 1] int32 and the geometry [E, 8] f64
    written once; ~15 flops an element."""
    return 16 * n_nodes + 24 * n_elem + 72 * n_elem + 4 * (n_slots + 1) + 64 * n_elem, \
        15 * n_elem


def fill_bytes_flops(n_elem, n_slots):
    """(bytes, flops) of the fill kernel: the slot ids read once, the bounds
    [S + 1] int32 read and written once, order [9E] int32 written once."""
    return 72 * n_elem + 8 * (n_slots + 1) + 36 * n_elem, 0


def sequential_sum(coords, tris, slot_ids, n_slots, mat):
    """[2, 2, S] f64 on the slot ids' device: each slot's pairs
    (pair_block_fields) added one at a time onto 0 in pair-major order, one
    elementwise add a round over the slots that have a pair left (the
    parent kernel's order of summation)."""
    import torch
    from magnetite_tpu_torch.fem.element import pair_block_fields
    from magnetite_tpu_torch.kernels.assembly_kernel import pair_major_slots

    vals = torch.stack([f.reshape(-1) for f in pair_block_fields(coords, tris, *mat)])
    pm = pair_major_slots(slot_ids, tris.shape[0])
    order = torch.sort(pm, stable=True).indices
    lens = torch.bincount(pm, minlength=n_slots)
    starts = torch.cumsum(lens, 0) - lens
    acc = torch.zeros((4, n_slots), dtype=torch.float64, device=vals.device)
    for r in range(int(lens.max())):
        live = torch.nonzero(lens > r).squeeze(1)
        acc[:, live] += vals[:, order[starts[live] + r]]
    return acc.reshape(2, 2, n_slots)


def relayout(flat, n_nodes, n_bands, ell):
    """[2, 2, S] -> the operator's [D, 2, 2, N] (DIA slots d N + n) or [K,
    2, 2, N] (ELL slots n K + k): the parent tree's relayout after its
    kernel, and the plain version's."""
    if ell:
        return flat.reshape(2, 2, n_nodes, n_bands).permute(3, 0, 1, 2).contiguous()
    return flat.reshape(2, 2, n_bands, n_nodes).permute(2, 0, 1, 3).contiguous()


def parent_assembly(base, coords, tris, slot_ids, n_nodes, n_bands, ell, mat):
    """The parent tree's device assembly (PR 14), stage by stage, through
    --baseline's kernel `mt_assemble_pairs` (one thread a slot over int64
    runs): the pair-major copy of the slot ids, its slot_runs (a stable
    torch.sort, a bincount and a cumsum), the kernel, the relayout.
    Returns ({stage: call on the earlier stages' results}, the whole
    function), or None where the baseline tree has no such kernel."""
    if base is None or not base.has_assemble:
        return None
    import torch
    from magnetite_tpu_torch.fem.element import material_constants
    from magnetite_tpu_torch.kernels import cuda_lib

    e = tris.shape[0]
    n_slots = n_bands * n_nodes
    d0, d1, d2 = material_constants(mat[0], mat[1])

    def pair_major():
        return slot_ids.reshape(e, 3, 3).permute(1, 2, 0).reshape(-1)

    def runs(slots):
        order = torch.sort(slots, stable=True).indices
        counts = torch.bincount(slots, minlength=n_slots)
        starts = torch.zeros(n_slots + 1, dtype=torch.int64, device=slots.device)
        torch.cumsum(counts, 0, out=starts[1:])
        return order, starts

    def kernel(order_starts):
        order, starts = order_starts
        out = torch.empty((2, 2, n_slots), dtype=torch.float64, device=coords.device)
        rc = base.mt_assemble_pairs(coords.data_ptr(), tris.data_ptr(), order.data_ptr(),
                                    starts.data_ptr(), e, n_slots, d0, d1, d2, float(mat[2]),
                                    out.data_ptr(), cuda_lib.stream_of(coords))
        cuda_lib.check(base, rc, "baseline assemble_pairs")
        return out

    def whole():
        return relayout(kernel(runs(pair_major())), n_nodes, n_bands, ell)

    slots = pair_major()
    order_starts = runs(slots)
    flat = kernel(order_starts)
    stages = {"pair-major copy": pair_major, "slot_runs": lambda: runs(slots),
              "kernel": lambda: kernel(order_starts),
              "relayout": lambda: relayout(flat, n_nodes, n_bands, ell)}
    return stages, whole


def phase_assembly_kernel(mesh, md, reps, flush, base=None):
    """Phase 23a: the device assembly (count, cumsum, fill, assembly
    kernel) at the plate's DIA slots (the f64 compile's structure) and its
    ELL slots, f64: bit for bit the sequential pair-major sum, two calls
    bit for bit, within 1e-12 of the plain version, f32 the f64 sums
    rounded once, and with --baseline bit for bit the parent tree's kernel
    plus its relayout; the count and fill kernels against their plain
    versions; then each stage timed, and in interleaved rounds the
    assembly kernel, the parent's kernel, the whole function, the parent's
    whole function (pair-major copy, slot_runs, kernel, relayout) and the
    plain version (pair_block_fields, four index_add_, the layout)."""
    import numpy as np
    import torch
    from magnetite_tpu_torch.fem.assembly import build_ell_structure
    from magnetite_tpu_torch.fem.dia import build_dia_structure
    from magnetite_tpu_torch.fem.element import pair_block_fields
    from magnetite_tpu_torch.kernels.assembly_kernel import (
        assemble_count, assemble_count_plain, assemble_fill, assemble_fill_plain,
        assemble_pairs, assemble_pairs_plain, build_runs, pair_major_slots, scatter_fields,
    )

    n, e = mesh.num_nodes, mesh.num_elements
    coords = torch.from_numpy(np.asarray(mesh.coords, np.float64)).to(DEV)
    tris = torch.from_numpy(np.asarray(mesh.tris, np.int64)).to(DEV)
    mat = (md.youngs_modulus, md.poisson_ratio, md.part_thickness)
    dia = build_dia_structure(mesh.tris, n, max_diags=48)
    ell = build_ell_structure(mesh.tris, n)
    results = {}
    for label, slot_ids, n_bands, is_ell in (
        ("DIA", dia.slot_ids, len(dia.offsets), False),
        ("ELL", ell.slot_ids, ell.cols.shape[1], True),
    ):
        n_slots = n_bands * n
        ids = torch.from_numpy(np.asarray(slot_ids, np.int64)).to(DEV)
        tag = f"assembly {label} slots S={n_slots} E={e}"

        def whole(dtype=torch.float64):
            return assemble_pairs(coords, tris, ids, n, n_bands, *mat, ell=is_ell,
                                  dtype=dtype)[0]

        def plain():
            return assemble_pairs_plain(coords, tris, ids, n, n_bands, *mat, ell=is_ell)[0]

        got = whole()
        require(torch.equal(got, whole()), f"{tag}: a second call differs")
        seq = relayout(sequential_sum(coords, tris, ids, n_slots, mat), n, n_bands, is_ell)
        require(torch.equal(got, seq), f"{tag}: not the sequential pair-major sum")
        del seq
        require(torch.equal(whole(torch.float32), got.to(torch.float32)),
                f"{tag}: f32 is not the f64 sums rounded once")
        ref = plain()
        err = compare(tag, got, ref, ref.abs().max(), 1e-12)
        del ref
        parent = parent_assembly(base, coords, tris, ids, n, n_bands, is_ell, mat)
        say(f"  {tag}: [{n_bands}, 2, 2, {n}] bit for bit the sequential pair-major sum, "
            "two calls alike, f32 the f64 sums rounded once" + (
                "" if parent is None else
                f"; bit for bit the parent tree's: {torch.equal(got, parent[1]())}"))
        if parent is not None:
            require(torch.equal(got, parent[1]()), f"{tag}: differs from the parent tree's")
        del got

        # the count and fill kernels against their plain versions
        counts, geom = assemble_count(coords, tris, ids, n_slots, mat[2])
        counts_p, geom_p = assemble_count_plain(coords, tris, ids, n_slots, mat[2])
        require(torch.equal(counts, counts_p) and torch.equal(geom, geom_p),
                f"{tag}: the count kernel differs from its plain version")
        ends = counts.cumsum(0, dtype=torch.int32)
        bounds, bounds_p = ends.clone(), ends.clone()
        order = assemble_fill(ids, bounds)
        order_p = assemble_fill_plain(ids, bounds_p)
        run = torch.repeat_interleave(torch.arange(n_slots, device=DEV),
                                      (bounds_p[1:] - bounds_p[:-1]).to(torch.int64))
        require(torch.equal(bounds, bounds_p) and torch.equal(
            torch.sort(run * (9 * e) + order.to(torch.int64)).values,
            run * (9 * e) + order_p.to(torch.int64)),
            f"{tag}: the fill kernel's runs differ from its plain version's")
        say(f"  {tag}: count kernel = plain (counts, geometry), fill kernel's runs = "
            "slot_runs' (as sets; the sum orders them)")
        runs = build_runs(coords, tris, ids, n_slots, mat[2])
        del run, order, order_p, bounds_p

        # stages of the whole function, each alone
        fill_b, fill_f = fill_bytes_flops(e, n_slots)
        count_b, count_f = count_bytes_flops(n, e, n_slots)
        stage = {
            "count (+ memset)": event_ms(lambda: assemble_count(coords, tris, ids, n_slots,
                                                                mat[2]), reps, flush),
            "cumsum": event_ms(lambda: counts.cumsum(0, dtype=torch.int32), reps, flush),
            "fill": event_ms(lambda: assemble_fill(ids, bounds), reps, flush,
                             setup=lambda: bounds.copy_(ends)),
        }
        say(f"  {tag} stages: " + "; ".join(f"{k} {v:.4f} ms" for k, v in stage.items())
            + f"; count bound {bound(count_b, count_f, torch.float64)[0]:.4f} ms, fill bound "
            f"{bound(fill_b, fill_f, torch.float64)[0]:.4f} ms")
        if parent is not None:
            say(f"  {tag} parent stages: " + "; ".join(
                f"{k} {event_ms(fn, reps, flush):.4f} ms" for k, fn in parent[0].items()))

        fns = {"kernel": lambda: assemble_pairs(coords, tris, ids, n, n_bands, *mat,
                                                ell=is_ell, runs=runs),
               "parent kernel": None if parent is None else parent[0]["kernel"],
               "whole": whole, "parent whole": None if parent is None else parent[1],
               "plain": plain}
        med = interleaved(tag, {k: f for k, f in fns.items() if f is not None}, reps, flush,
                          ROUNDS)
        pm = pair_major_slots(ids, e)
        fields = pair_block_fields(coords, tris, *mat)
        index_adds = event_ms(lambda: scatter_fields(fields, pm, n_slots), reps, flush)
        nbytes, flops = assembly_bytes_flops(n, e, n_slots)
        b_ms, b_by = bound(nbytes, flops, torch.float64)
        say(f"  {tag}: bound {b_ms:.4f} ms by {b_by}; kernel {med['kernel']:.4f} ms "
            f"({b_ms / med['kernel']:.1%}), whole {med['whole']:.4f} ms "
            f"({b_ms / med['whole']:.1%}), plain {med['plain']:.4f} ms, four index_add_ "
            f"{index_adds:.4f} ms")
        for k in ("kernel", "whole"):
            if f"parent {k}" in med:
                say(f"  {tag}: {k} {med[k]:.4f} ms against the parent's "
                    f"{med['parent ' + k]:.4f} ({med[k] / med['parent ' + k]:.3f}x, "
                    f"{'below' if med[k] < med['parent ' + k] else 'NOT below'})")
        say(f"  {tag}: whole {'below' if med['whole'] < med['plain'] else 'NOT below'} the "
            f"plain version ({med['whole'] / med['plain']:.3f}x)")
        # the count and fill kernels beside their plain versions and library
        # calls at both slot sets; the kernels line keeps the DIA slots'
        timed = {"assemble_pairs": dict(
            max_abs_err=err, ms=med["kernel"], plain_ms=med["plain"], bound_ms=b_ms,
            bound_by=b_by, library_ms=index_adds)}
        b_ms, b_by = bound(count_b, count_f, torch.float64)
        timed["assemble_count"] = dict(
            max_abs_err=0.0, ms=stage["count (+ memset)"], bound_ms=b_ms, bound_by=b_by,
            plain_ms=event_ms(lambda: assemble_count_plain(coords, tris, ids, n_slots,
                                                           mat[2]), reps, flush),
            library_ms=event_ms(lambda: torch.bincount(ids, minlength=n_slots), reps,
                                flush))
        b_ms, b_by = bound(fill_b, fill_f, torch.float64)
        timed["assemble_fill"] = dict(
            max_abs_err=0.0, ms=stage["fill"], bound_ms=b_ms, bound_by=b_by,
            plain_ms=event_ms(lambda: assemble_fill_plain(ids, bounds), reps, flush,
                              setup=lambda: bounds.copy_(ends)),
            library_ms=event_ms(lambda: torch.sort(ids, stable=True), reps, flush))
        for k in ("assemble_count", "assemble_fill"):
            r = timed[k]
            say(f"  {tag} {k}: {r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of bound "
                f"{r['bound_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms")
        if label == "DIA":  # the main path's (the f64 compile's) slots
            results.update(timed)
        del runs, counts, geom, ends, bounds, fields, pm, parent
        torch.cuda.empty_cache()
    return results


def expected_shard_launches(s, iters, sweeps, amg, maxiter, vdtype):
    """The kernel launches of one node-sharded AMG CG solve over s shards:
    the CG runs whole chunks of CHECK_EVERY steps, one V-cycle per step and
    one up front (v in all); each shard's band kernel (m = 2, at the
    halo-extended shape) runs the rhs, r0, each step's operator and K u
    (f64), and in each V-cycle the 2 sweeps level-0 residuals of the
    V(sweeps, sweeps)-cycle (the V-cycle's dtype); restrict0 once per shard
    and V-cycle; the replicated coarse levels once per V-cycle, as on one
    device (amg: the AMGDeviceArrays of the one card). Returns (counts, m =
    3 launches per (3, N, dtype))."""
    import torch
    from magnetite_tpu_torch.fem.amg import COARSE_SWEEPS

    v = vcycles([iters], maxiter)
    cg = (v - 1) + 3
    level0 = v * 2 * sweeps
    last = len(amg.coarse) - 1
    shapes = {}
    for l, cb in enumerate(amg.coarse_bands):
        per = 2 if l < last else (0 if amg.ci is not None else COARSE_SWEEPS)
        if cb is not None and per:
            shapes[(3, cb.bands.shape[-1], vdtype)] = per * v
    counts = {"dia_matvec m=2": s * (cg + level0), "restrict0": s * v, "prolong0": 0,
              "dia_matvec m=3": sum(shapes.values()), "assemble_pairs": 0,
              "assemble_count": 0, "assemble_fill": 0}
    m2 = {(2, None, torch.float64): s * (cg + (level0 if vdtype == torch.float64 else 0))}
    if vdtype != torch.float64:
        m2[(2, None, vdtype)] = s * level0
    return counts, shapes, m2


def sharded_run(name, mesh, bca, md, opts, s, amg_setup, totals):
    """compile_sharded_problem over s shards on cuda:0 and one solve, under
    main_path; the launches checked exactly against the iterations.
    Returns (compiled problem, result, prep seconds)."""
    import torch
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec
    from magnetite_tpu_torch.parallel.pipeline import DeviceMesh, compile_sharded_problem

    t0 = time.perf_counter()
    compiled = compile_sharded_problem(mesh, bca, md, opts,
                                       device_mesh=DeviceMesh((f"{DEV}:0",) * s),
                                       amg_setup=amg_setup)
    prep = time.perf_counter() - t0
    p = compiled.problem
    expect = ("dia_matvec m=2", "dia_matvec m=3", "restrict0")
    with main_path(name, totals, expect) as got:
        res = compiled.solve()
    vdtype = torch.float32 if compiled.refine else torch.float64
    sweeps = 3 if compiled.refine else 1
    amg = p.amg_in(vdtype).coarse[p.devices[0]]
    want, shapes, m2 = expected_shard_launches(s, res.iterations, sweeps, amg,
                                               compiled.maxiter, vdtype)
    width = p.local_n + 2 * p.halo
    m2 = {(2, width, dt): c for (_, _, dt), c in m2.items()}
    got_shapes = {key: c for key, c in dia_matvec.shape_launches.items() if c}
    others = {k: c for k, c in got.items() if c and k.split(" ")[0] not in (
        "dia_matvec", "restrict0")}
    say(f"  {name}: halo {p.halo}, shard size {p.local_n} (+ 2 x halo = {width}), "
        f"{res.iterations} iterations; launches expected {want}, m=2 per shape {m2}, "
        f"m=3 per shape {shapes}")
    require(all(got[k] == c for k, c in want.items()) and got_shapes == {**m2, **shapes}
            and not others, f"{name}: launches {got} / {got_shapes}, expected {want} / "
            f"{m2} {shapes} and no other kernel")
    return compiled, res, prep


def phase_device_assembly(problem, mesh, bca, md, args, dia, totals, reps, flush, base=None):
    """Phases 23a-b: the device assembly's kernels (23a);
    compile_problem(assembly="device") against phase 5 (23b). `dia`:
    precision -> (nodes, elements, iterations, stages) of phases 5-6.
    Returns the assembly kernels' rows."""
    import numpy as np
    import torch
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import compile_problem

    t_phase = time.perf_counter()
    say(f"phase 23a: the device assembly's kernels on the Delaunay plate at h={args.h}")
    results = phase_assembly_kernel(mesh, md, reps, flush, base)

    say("phase 23b: compile_problem(assembly='device') in f64 against phase 5")
    nodes5, elems5, iters5, stages5 = dia["f64"]
    with main_path("the device-assembled f64 solve", totals,
                   ("assemble_count", "assemble_fill", "assemble_pairs", "dia_matvec m=2",
                    "dia_matvec m=3", "prolong0", "restrict0")) as got:
        t0 = time.perf_counter()
        dev = compile_problem(mesh, bca, md, SolverOptions(assembly="device"),
                              amg_setup=problem.amg_setup, device=DEV)
        prep = time.perf_counter() - t0
        res = dev.solve()
    assembly = {k: got[k] for k in ("assemble_count", "assemble_fill", "assemble_pairs")}
    require(set(assembly.values()) == {1} and dev.mode == "dia" and dev.perm is None,
            f"device assembly: launches {assembly}, mode {dev.mode}; expected one of each")
    require(torch.equal(dev.system.bands, compile_problem(
        mesh, bca, md, SolverOptions(assembly="device"), amg_setup=problem.amg_setup,
        device=DEV).system.bands), "device assembly: a second compile's bands differ")
    bands_err = float((dev.system.bands - problem.system.bands).abs().max())
    say(f"  device-assembled bands against phase 5's host-assembled ones: max|diff| "
        f"{bands_err:.3e} ({bands_err / float(problem.system.bands.abs().max()):.2e} of max)")
    say(f"  prep {prep:.3f} s: assemble_device_s {dev.timings['assemble_device_s']:.4f} "
        f"(phase 5 assemble_s {stages5['assemble_s']:.4f}), upload_s "
        f"{dev.timings['upload_s']:.4f} (phase 5 {stages5['upload_s']:.4f}), upload_bytes "
        f"{dev.timings['upload_bytes']}; {res.iterations} iterations (phase 5 {iters5}), "
        f"solve_s {res.timings['solve_s']:.4f}")
    require(abs(res.iterations - iters5) <= 1, "device assembly: iterations off phase 5's")
    golden_against("device assembly against phase 5", np.c_[mesh.coords, res.u],
                   np.c_[mesh.tris, res.stress], nodes5, elems5)
    rel = true_residual_banded(problem, res.u)
    say(f"  true relative residual {rel:.3e} (<= 1e-09)")
    require(rel <= 1e-9, "device assembly: true residual too large")
    del dev
    torch.cuda.empty_cache()
    say(f"  (phases 23a-b: {time.perf_counter() - t_phase:.1f} s)")
    return results


def phase_shard(problem, mesh, bca, md, args, dia, totals):
    """Phases 23c-d: the node-sharded pipeline over S shards of cuda:0 in
    f64 and mixed against phases 5-6 (23c); the CLI's --shard over every
    visible GPU (23d). `dia`: precision -> (nodes, elements, iterations,
    stages) of phases 5-6."""
    import numpy as np
    import torch
    from magnetite_tpu_torch.config import SolverOptions

    t_phase = time.perf_counter()
    nodes5, elems5 = dia["f64"][:2]
    say("phase 23c: compile_sharded_problem over S shards of one card")
    warm = {}
    for precision, opts in (("f64", SolverOptions()),
                            ("mixed", SolverOptions(dtype="float32", refine="on"))):
        nodes_r, elems_r, iters_r, _ = dia[precision]
        for s in SHARD_COUNTS:
            name = f"the sharded {precision} solve, S={s}"
            compiled, res, prep = sharded_run(name, mesh, bca, md, opts, s,
                                              problem.amg_setup, totals)
            stages = {k: v for k, v in compiled.timings.items() if k.endswith("_s")}
            say(f"  {name}: prep {prep:.3f} s ({json.dumps(stages)}), "
                f"{res.iterations} iterations (single device {iters_r}), solve_s "
                f"{res.timings['solve_s']:.4f}, reported residual_rel {res.residual_rel:.3e}")
            require(abs(res.iterations - iters_r) <= 1, f"{name}: iterations off phase 5-6's")
            golden_against(f"{name} against the single-device CLI", np.c_[mesh.coords, res.u],
                           np.c_[mesh.tris, res.stress], nodes_r, elems_r)
            rel = true_residual_banded(problem, res.u)
            say(f"  {name}: true relative residual {rel:.3e} (<= 1e-09)")
            require(rel <= 1e-9, f"{name}: true residual too large")
            warm[f"{precision} S={s}"] = [compiled.solve().timings["solve_s"] for _ in range(3)]
            del compiled
            torch.cuda.empty_cache()
    say("  warm solve_s (3 each): " + "; ".join(
        f"{k} " + " / ".join(f"{t:.4f}" for t in v) for k, v in warm.items()))

    n_gpu = torch.cuda.device_count()
    say(f"phase 23d: the CLI with --shard over every visible GPU ({n_gpu}), f64")
    with tempfile.TemporaryDirectory() as workdir:
        paths = write_case_files(workdir, args.h)
        with main_path("the --shard CLI run", totals, ("dia_matvec m=2", "restrict0")):
            out, err = run_cli(paths + ["--device", DEV, "--backend", "delaunay", "--skip",
                                        "--out-dir", workdir, "--shard"])
        require(f"sharding the solve over {n_gpu} device(s)" in out,
                "--shard did not shard over every visible GPU")
        require("warning" not in err, f"--shard: warned: {err.strip()[:300]}")
        say("  ran --shard over " + (f"{n_gpu} GPUs, one shard on each card" if n_gpu > 1
                                     else "the one visible GPU (S = 1)"))
        nodes, elems = read_csvs(workdir)
        golden_against("--shard CLI against phase 5", nodes, elems, nodes5, elems5)
    say(f"  (phases 23c-d: {time.perf_counter() - t_phase:.1f} s)")


# ------------- structured multi-GPU and lane sharding (phases 24-25) ---------


GRID_LAYOUTS = (1, 2, 4, (2, 2))


def layout_mesh(layout):
    """A 1-D mesh of `layout` shards of cuda:0, or a (R, C) 2-D mesh of them."""
    from magnetite_tpu_torch.parallel.pipeline import DeviceMesh, DeviceMesh2D

    if isinstance(layout, tuple):
        return DeviceMesh2D((f"{DEV}:0",) * (layout[0] * layout[1]), layout)
    return DeviceMesh((f"{DEV}:0",) * layout)


def expected_grid_shard_launches(compiled, res, info):
    """The kernel launches of one sharded structured solve and its recovery,
    per (rows, cols, dtype): (stencil_matvec, mg_presmooth, mg_postsmooth).

    Each shard's stencil_matvec runs at its halo-extended block ([rl + 2,
    C] in 1-D, [rl + 2, cl + 2] in 2-D). The CG runs whole chunks of
    CHECK_EVERY steps (vcycles), one V-cycle per step and one up front; per
    shard: r0 and each step's operator, in each V-cycle the fine level's
    V(2, 2) (the first sweep from zero takes no matvec: 1 + 1 residual + 2),
    and the raw operator for the rhs, K u and the recovery's ||b||. The 1-D
    refinement runs those inner counts per pass in f32, its f64 operator
    once up front and once per pass; the 2-D refined solve is one f64 CG
    around the f32 V-cycle. The replicated coarse levels run once per
    distinct device (here one) per V-cycle: mg_presmooth at each level but
    the coarsest, mg_postsmooth there too, and the coarsest (no dense
    inverse, as in the JAX package) COARSE_SWEEPS / SWEEPS times."""
    import torch
    from magnetite_tpu_torch.fem.multigrid import COARSE_SWEEPS, SWEEPS

    p = compiled.problem
    s = len(p.reduced)
    rl, cl = p.reduced[0].shape[-2:]
    shape = (rl + 2, cl + (2 if compiled.kind == "stencil2d" else 0))
    f64, f32 = torch.float64, torch.float32
    if not compiled.refine:
        v = vcycles([res.iterations], compiled.maxiter)
        fine, vdtype = {f64: s * (5 * v + 3)}, f64
    elif compiled.kind == "stencil":
        v = sum(vcycles([k], compiled.refine_inner_iters) for k in info["refine_inner"])
        fine, vdtype = {f32: s * 5 * v, f64: s * (info["refine_outer"] + 4)}, f32
    else:
        v = vcycles([res.iterations], compiled.maxiter)
        fine, vdtype = {f64: s * (v + 3), f32: s * 4 * v}, f32
    levels = p.cache[("coarse", vdtype)][p.devices[0]]
    pre = {(lv.rows, lv.cols, vdtype): v for lv in levels[:-1]}
    post = dict(pre)
    last = levels[-1]
    post[(last.rows, last.cols, vdtype)] = v * COARSE_SWEEPS // SWEEPS
    return {(*shape, dt): c for dt, c in fine.items()}, pre, post


def shard_stencil_kernel(problem, label, dtypes, rand, checked):
    """stencil_matvec at a shard's halo-extended block against its plain
    version on the card, outside any main path: shard 0's padded reduced
    stencil (the solve's own) and its block of a random field after the
    layout's halo exchange, at 1e-12 (f64) / 1e-5 (f32) of the |st| |u|
    scale, as phase 8; each (block shape, wrap, dtype) of `dtypes` once."""
    import torch
    from magnetite_tpu_torch.kernels.stencil_kernel import stencil_matvec, stencil_matvec_plain
    from magnetite_tpu_torch.parallel.stencil_shard import (
        exchange_halo_2d, exchange_halo_rows, padded_stencils,
    )

    two_d = problem.col_axis is not None
    wrap = problem.wrap_cols and not two_d
    for dtype in dtypes:
        st = padded_stencils(problem, "reduced", dtype)[0]
        rr, cc = st.shape[-2:]
        if (rr, cc, wrap, dtype) in checked:
            continue
        checked.add((rr, cc, wrap, dtype))
        u = [rand(*f.shape, dtype=dtype) for f in problem.free_g.shards]
        ext = (exchange_halo_2d(u, problem.shape, problem.wrap_cols) if two_d
               else exchange_halo_rows(u))[0]
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        compare(f"stencil_matvec {label}: shard 0's block {rr}x{cc} wrap={wrap} "
                f"{str(dtype)[6:]}", stencil_matvec(st, ext, wrap),
                stencil_matvec_plain(st, ext, wrap),
                stencil_matvec_plain(st.abs(), ext.abs(), wrap).max(), tol)


def grid_shard_run(name, mesh, bca, md, opts, layout, totals, rand, checked):
    """compile_sharded_problem over `layout` of cuda:0 and one solve under
    main_path, the launches checked exactly; then the stencil kernel at
    each of the run's block shapes against its plain version. Returns
    (compiled, result, prep seconds)."""
    from magnetite_tpu_torch.kernels.mg_smooth_kernel import mg_postsmooth, mg_presmooth
    from magnetite_tpu_torch.kernels.stencil_kernel import stencil_matvec
    from magnetite_tpu_torch.parallel.pipeline import compile_sharded_problem

    t0 = time.perf_counter()
    compiled = compile_sharded_problem(mesh, bca, md, opts, device_mesh=layout_mesh(layout))
    sync()
    prep = time.perf_counter() - t0
    with main_path(name, totals, ("stencil_matvec", "mg_presmooth", "mg_postsmooth")) as got:
        res = compiled.solve()
    want = expected_grid_shard_launches(compiled, res, res.timings)
    seen = tuple({k: c for k, c in k_.shape_launches.items() if c}
                 for k_ in (stencil_matvec, mg_presmooth, mg_postsmooth))
    others = {k: c for k, c in got.items() if c and k.split(" ")[0] not in (
        "stencil_matvec", "mg_presmooth", "mg_postsmooth")}
    say(f"  {name}: {compiled.kind} {compiled.timings['shard_layout']}, tile "
        f"{tuple(compiled.problem.reduced[0].shape[-2:])}; launches expected per shape: "
        f"stencil_matvec {want[0]}, mg_presmooth {want[1]}, mg_postsmooth {want[2]}")
    require(seen == want and not others,
            f"{name}: launches per shape {seen}, expected {want}, and no other kernel "
            f"(got {others})")
    shard_stencil_kernel(compiled.problem, name, sorted({k[2] for k in want[0]}, key=str), rand,
                         checked)
    return compiled, res, prep


def phase_grid_shard(nr, nt, refs, totals, rand):
    """Phase 24: the structured plate of phase 7 over 1-D meshes of S = 1, 2,
    4 shards of cuda:0 and a 2 x 2 mesh, f64 CG and f32 refined to rtol
    1e-8 (iterations against phase 7's, `refs`, exact launches, the true
    residual); then each compiled problem again at rtol 1e-10 on the golden
    bars of the single-device f64 answer at rtol 1e-10: an answer at rtol
    1e-8 lies ~1.1-1.2e-6 of max|u| from another one, or from the converged
    one, on this plate (measured), above the u bar. Then the CLI with
    --shard-layout 1x1 --load-case on a case saved from the plate."""
    import numpy as np
    import torch
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import compile_problem
    from magnetite_tpu_torch.parallel.stencil_shard import prepare_sharded_stencil_problem_2d
    from magnetite_tpu_torch.persist import save_case

    t_phase = time.perf_counter()
    mesh, bca, md = structured_case(nr, nt)
    say(f"phase 24: the structured plate {mesh.grid_shape} sharded by rows (S = 1, 2, 4) and "
        "2 x 2 tiles, on one card")
    single = compile_problem(mesh, bca, md, SolverOptions(dtype="float64", cg_rtol=1e-10),
                             device=DEV)
    exact = single.solve()
    say(f"  the single-device f64 answer at rtol 1e-10: {exact.iterations} iterations")
    warm, checked = {}, set()
    for key, opts in (("f64", SolverOptions(dtype="float64", cg_rtol=1e-8)),
                      ("f32 refined", SolverOptions(dtype="float32", cg_rtol=1e-8))):
        ref = refs[key]
        counts = {}
        for layout in GRID_LAYOUTS:
            label = f"{layout[0]}x{layout[1]}" if isinstance(layout, tuple) else f"S={layout}"
            name = f"the sharded structured {key} solve, {label}"
            compiled, res, prep = grid_shard_run(name, mesh, bca, md, opts, layout, totals,
                                                 rand, checked)
            t = res.timings
            passes = (f" ({t['refine_outer']} passes, inner {list(map(int, t['refine_inner']))})"
                      if "refine_outer" in t else "")
            counts[label] = (res.iterations, passes)
            rel = true_residual_stencil(single, res)
            say(f"  {name}: prep {prep:.3f} s, {res.iterations} iterations{passes}, phase 7 "
                f"{ref['iterations']}{ref['passes']} ({res.iterations - ref['iterations']:+d}), "
                f"solve_s {t['solve_s']:.4f}, true relative residual (f64) {rel:.3e} (<= 1e-08)")
            require(rel <= 1e-8 and res.residual_rel <= 1e-8, f"{name}: residual above 1e-8")
            say(f"  {name}: against phase 7's {key} answer (both at rtol 1e-8): max|diff| u "
                f"{float(np.abs(res.u - ref['u']).max()):.3e} (max|u| "
                f"{float(np.abs(ref['u']).max()):.3e}), stress "
                f"{float(np.abs(res.stress - ref['stress']).max()):.3e}, von Mises "
                f"{float(np.abs(res.von_mises - ref['vm']).max()):.3e}")
            # the golden bars hold the same compiled problem at rtol 1e-10
            tight = dataclasses.replace(compiled, rtol=1e-10).solve()
            say(f"  {name} at rtol 1e-10: {tight.iterations} iterations (one device "
                f"{exact.iterations} in f64), reported residual_rel {tight.residual_rel:.3e}")
            golden_against(f"{name} at rtol 1e-10 against one device's", np.c_[mesh.coords,
                           tight.u], np.c_[mesh.tris, tight.stress],
                           np.c_[mesh.coords, exact.u], np.c_[mesh.tris, exact.stress])
            vm_err = float(np.abs(tight.von_mises - exact.von_mises).max())
            vm_lim = 1e-5 * float(np.abs(exact.von_mises).max())
            say(f"  {name} at rtol 1e-10: von Mises max|diff| {vm_err:.3e} <= {vm_lim:.3e}")
            require(vm_err <= vm_lim, f"{name}: von Mises outside its bar")
            warm[f"{key} {label}"] = [compiled.solve().timings["solve_s"] for _ in range(3)]
            del compiled
            torch.cuda.empty_cache()
        say(f"  {key} iterations: {counts}")
        if key == "f64":
            require(len(set(counts.values())) == 1,
                    f"{key}: iterations differ across the layouts {counts}")
        else:
            # the inner f32 solves sum their dots per shard in f32, so the
            # shard count rounds them differently: +-1 inner iteration
            one_d = [v[0] for k, v in counts.items() if k.startswith("S=")]
            require(max(one_d) - min(one_d) <= 1,
                    f"{key}: inner iterations more than 1 apart across S {counts}")
    say("  warm solve_s (3 each): " + "; ".join(
        f"{k} " + " / ".join(f"{t:.4f}" for t in v) for k, v in warm.items()))
    del single
    torch.cuda.empty_cache()

    say("phase 24b: the CLI with --shard-layout 1x1 --load-case on the structured plate's case")
    with tempfile.TemporaryDirectory() as workdir:
        case = os.path.join(workdir, "grid.npz")
        save_case(case, mesh, bca, metadata=md)
        argv = [write_case_files(workdir, md.characteristic_length_max)[0], "--load-case", case,
                "--device", DEV, "--skip", "--out-dir", workdir, "--shard-layout", "1x1"]
        with main_path("the --shard-layout 1x1 CLI run", totals,
                       ("stencil_matvec", "mg_presmooth", "mg_postsmooth")):
            out, err = run_cli(argv)
        op, pre, refine, iters = cli_summary(out)
        require("sharding the solve over 1 device(s) (1x1)" in out and op == "stencil"
                and pre == "multigrid", f"1x1 CLI: {op}/{pre}")
        require("warning" not in err, f"1x1 CLI warned: {err.strip()[:300]}")
        nodes, elems = read_csvs(workdir)
        say(f"  1x1 CLI: operator={op} preconditioner={pre} refine={refine}, {iters} iterations")
        golden_against("--shard-layout 1x1 CLI against the rtol 1e-10 answer", nodes, elems,
                       np.c_[mesh.coords, exact.u], np.c_[mesh.tris, exact.stress])
    # the CLI's layout: one 2-D tile, its columns wrapped through the exchange
    one = prepare_sharded_stencil_problem_2d(mesh, bca, md, layout_mesh((1, 1)),
                                             dtype=np.float64)
    shard_stencil_kernel(one, "the 1x1 layout", (torch.float64, torch.float32), rand, checked)
    del one
    say(f"  (phase 24: {time.perf_counter() - t_phase:.1f} s)")


def lane_shard_cases(args):
    """Phase 25's sweeps and their set-ups: (cases, sweeps, grid), each case
    (name, unsharded sweep, make(device_mesh), method, batch(seed), the
    kernels it launches, its bar against the unsharded run, residual(batch,
    result)), compiled at phases 11-12's plate and phases 15-16's grid in
    f32 (with the f64 set-ups the true residuals take); the sharded
    compiles reuse the hierarchies."""
    import numpy as np
    import torch
    from magnetite_tpu_torch.kernels.lane_dia_kernel import (
        lane_dia_matvec3_plain, lane_dia_matvec_plain,
    )
    from magnetite_tpu_torch.parallel import sweep as ps

    say("  the sweep plate and the bench grid compiled (f32, with f64 set-ups for the "
        "residuals)")
    sweeps = compile_sweeps(args.sweep_h)
    grid = compile_grid_sweeps()
    mesh, bca, md = sweeps["case"]
    gmesh, gbca, gmd = gcase = grid["case"]
    load, material = sweeps["load"], sweeps["material"]
    gload, gmat = grid["load float32"], grid["material float32"]
    nb = SWEEP_LANES
    f64 = torch.float64

    def load_batch(seed):
        rng = np.random.default_rng(seed)
        return (rng.uniform(0.5, 2.0, nb).astype(np.float32), np.ones(nb, np.float32),
                rng.uniform(0.5, 2.0, nb))

    def material_batch(seed):
        rng = np.random.default_rng(seed)
        ones = np.ones(nb, dtype=np.float32)
        return (ones, ones, rng.uniform(40e9, 250e9, nb).astype(np.float32),
                rng.uniform(0.22, 0.38, nb).astype(np.float32),
                rng.uniform(0.2, 1.0, nb).astype(np.float32))

    def dense_values(a):  # the factors' [B, N, 2] boundary values, caller's order
        return (torch.as_tensor(bca.u_value.astype(np.float32)[None] * a[0][:, None, None]),
                torch.as_tensor(bca.f_value.astype(np.float32)[None] * a[1][:, None, None]))

    def load_residual(a, res):
        ks = torch.as_tensor(a[2], dtype=f64, device=DEV)
        return lane_residuals(load, sweeps["load64"].bands, res, *dense_values(a),
                              lambda b, v: lane_dia_matvec_plain(b, load.offsets, v) * ks)

    def material_residual(a, res):
        w3 = ps.material_weights(*(torch.as_tensor(x, dtype=f64, device=DEV) for x in a[2:]))
        return lane_residuals(material, sweeps["material64"].bands3, res, *dense_values(a),
                              lambda b3, v: lane_dia_matvec3_plain(b3, w3, material.offsets, v))

    f32 = torch.float32
    cases = [
        ("phase 11's load sweep", load,
         lambda dm: ps.compile_unstructured_sweep(mesh, bca, md, iterations=LOAD_ITERS,
                                                  refined=False, device_mesh=dm,
                                                  amg_setup=load.amg_setup),
         "solve_factors", load_batch, ("lane_dia_matvec",),
         {"u": LANE_SHARD_BARS["load"], "residual": SWEEP_BARS["f32"]["residual"]},
         load_residual),
        ("phase 12's material sweep", material,
         lambda dm: ps.compile_unstructured_material_sweep(
             mesh, bca, iterations=MATERIAL_ITERS, refined=False, device_mesh=dm,
             material_setup=material.material_setup),
         "solve_factors", material_batch, ("lane_dia_matvec3",),
         {"u": LANE_SHARD_BARS["material"], "residual": SWEEP_BARS["f32"]["residual"]},
         material_residual),
        ("phase 15's structured load sweep", gload,
         lambda dm: ps.compile_sweep(gmesh, gbca, gmd, iterations=GRID_ITERS, dtype="float32",
                                     device_mesh=dm, setup=gload.setup),
         "solve", lambda seed: grid_batch(gcase, nb, seed, f32, False),
         ("lane_stencil_matvec",),
         {"u": LANE_SHARD_BARS["grid load"], "residual": GRID_BARS["load float32"]["residual"]},
         lambda a, res: grid_residuals(grid, False, a, res.u)),
        ("phase 16's structured material sweep", gmat,
         lambda dm: ps.compile_material_sweep(gmesh, gbca, iterations=GRID_ITERS,
                                              dtype="float32", device_mesh=dm,
                                              setup=gmat.setup),
         "solve", lambda seed: grid_batch(gcase, nb, seed, f32, True),
         ("lane_stencil_matvec3", "lane_coarse_smooth3"),
         {"u": LANE_SHARD_BARS["grid material"],
          "residual": GRID_BARS["material float32"]["residual"]},
         lambda a, res: grid_residuals(grid, True, a, res.u)),
    ]
    return cases, sweeps, grid


def lane_kernels_at_chunk(sweeps, grid, c, rand):
    """Each lane kernel of the sharded sweeps (f32, as they run) at one
    chunk's lane count c, on the sweeps' own operators, against its plain
    version (phase 10 and 17's tolerances), outside any main path; and its
    chunk-width output against the first c lanes of a full-width call on
    the same fields, bit for bit (does the kernel's arithmetic per lane
    depend on B?)."""
    import torch
    from magnetite_tpu_torch.fem.multigrid import COARSE_SWEEPS
    from magnetite_tpu_torch.kernels import lane_coarse_kernel as lc
    from magnetite_tpu_torch.kernels.lane_dia_kernel import (
        lane_dia_matvec, lane_dia_matvec3, lane_dia_matvec3_plain, lane_dia_matvec_plain,
    )
    from magnetite_tpu_torch.kernels.lane_stencil_kernel import (
        lane_material_matvec_plain, lane_stencil_matvec, lane_stencil_matvec3,
        lane_stencil_matvec_plain,
    )
    from magnetite_tpu_torch.kernels.mg_smooth_kernel import OMEGA
    from magnetite_tpu_torch.parallel.sweep import _lane_material_center_inv, material_weights

    f32, nb = torch.float32, SWEEP_LANES
    load, material = sweeps["load"], sweeps["material"]
    gload, gmat = grid["load float32"], grid["material float32"]
    gen = torch.Generator(device="cpu").manual_seed(25)
    w3 = material_weights(*(
        (lo + (hi - lo) * torch.rand(nb, generator=gen, dtype=torch.float64)).to(DEV, f32)
        for lo, hi in ((40e9, 250e9), (0.22, 0.38), (0.2, 1.0))))
    w3c = tuple(w[:c].contiguous() for w in w3)

    def check(tag, kernel, plain, abs_plain, u, tol):
        """kernel(u, w) at c lanes against plain; then bit for bit against
        the first c lanes of the kernel at all B lanes."""
        uc = u[..., :c].contiguous()
        got = kernel(uc, w3c)
        compare(f"{tag} B={c}", got, plain(uc, w3c), abs_plain(uc, w3c).max(), tol)
        same = torch.equal(kernel(u, w3)[..., :c], got)
        say(f"  {tag}: the first {c} lanes of a B={nb} call bit-identical to the B={c} "
            f"call: {same}")
        require(same, f"{tag}: the kernel's lanes depend on B")

    od = load.offsets_dev
    u = rand(2, load.n_nodes, nb, dtype=f32)
    check(f"lane_dia_matvec D={len(load.offsets)} N={load.n_nodes}",
          lambda v, w: lane_dia_matvec(load.bands, load.offsets, v, od),
          lambda v, w: lane_dia_matvec_plain(load.bands, load.offsets, v),
          lambda v, w: lane_dia_matvec_plain(load.bands.abs(), load.offsets, v.abs()), u, 1e-6)
    b3 = material.bands3
    check(f"lane_dia_matvec3 D={len(material.offsets)} N={material.n_nodes}",
          lambda v, w: lane_dia_matvec3(b3, w, material.offsets, v, material.offsets_dev),
          lambda v, w: lane_dia_matvec3_plain(b3, w, material.offsets, v),
          lambda v, w: lane_dia_matvec3_plain(tuple(b.abs() for b in b3), w, material.offsets,
                                              v.abs()), u, 1e-5)
    del u
    levels = [(gload.setup[1], gload.packed[1])] + [
        (gload.setup[2][lv].stencil, gload.packed[2][lv].stencil)
        for lv in range(1, len(gload.setup[2]) - 1)]
    for st, pst in levels:
        rows, cols = st.shape[-2:]
        st = st.contiguous()
        u = rand(2, rows, cols, nb, dtype=f32)
        check(f"lane_stencil_matvec {rows}x{cols}", lambda v, w: lane_stencil_matvec(pst, v, False),
              lambda v, w: lane_stencil_matvec_plain(st, v, False),
              lambda v, w: lane_stencil_matvec_plain(st.abs(), v.abs(), False), u, 1e-5)
    mlevels = gmat.setup[1]
    for level, plevel in zip(mlevels[:-1], gmat.packed[1][:-1]):
        rows, cols = level[0].shape[-2:]
        level = tuple(x.contiguous() for x in level)
        u = rand(2, rows, cols, nb, dtype=f32)
        check(f"lane_stencil_matvec3 {rows}x{cols}",
              lambda v, w: lane_stencil_matvec3(plevel, w, v, False),
              lambda v, w: lane_material_matvec_plain(level, w, v, False),
              lambda v, w: lane_material_matvec_plain(tuple(x.abs() for x in level), w,
                                                      v.abs(), False), u, 1e-5)
    level = type(mlevels[-1])(*(x.contiguous() for x in mlevels[-1]))
    plevel = gmat.packed[1][-1]
    rows, cols = level.sa.shape[-2:]
    r = rand(2, rows, cols, nb, dtype=f32)

    def dinv(w):
        return _lane_material_center_inv(level, *w)

    # 48 sweeps of rounding in another order: held to max|e|, as phase 17
    plan = lc.lane_coarse_plan(rows, cols, r.element_size())
    check(f"lane_coarse_smooth3 {rows}x{cols} geometry ({plan.m}, {plan.lanes})",
          lambda v, w: lc.lane_coarse_smooth3(plevel, dinv(w), w, v, False, COARSE_SWEEPS, OMEGA),
          lambda v, w: lc.lane_coarse_smooth3_plain(level, dinv(w), w, v, False, COARSE_SWEEPS,
                                                    OMEGA),
          lambda v, w: lc.lane_coarse_smooth3_plain(level, dinv(w), w, v, False, COARSE_SWEEPS,
                                                    OMEGA).abs(), r, 1e-5)


def lane_b_dependence(sweeps, grid, c, rand):
    """The sweeps' torch operations whose work per lane could depend on the
    lane count B (reductions over the nodes, cuBLAS products with B
    columns), each on random f32 fields of the sweeps' shapes: the first c
    lanes of a call at B lanes against the call at c lanes. Printed, not
    required: they explain the sharded-against-unsharded readings."""
    import torch
    from magnetite_tpu_torch.fem.amg import _block_ell_matvec, _dense_apply, ieee_f32
    from magnetite_tpu_torch.parallel.sweep import _lane_dense_coarse

    f32, nb = torch.float32, SWEEP_LANES
    load, material, gload = sweeps["load"], sweeps["material"], grid["load float32"]
    rows, cols = gload.rows, gload.cols
    coarsest = gload.setup[2][-1]
    probes = [
        ("the per-lane dot torch.sum(a * b, dim=(0, 1)) on [2, N, B]",
         lambda x: torch.sum(x * x, dim=(0, 1)), (2, load.n_nodes, nb)),
        ("the structured per-lane dot on [2, R, C, B]",
         lambda x: torch.sum(x * x, dim=(0, 1, 2)), (2, rows, cols, nb)),
    ]
    if load.amg.fast0 is not None:
        _, _, pt0_cols, pt0_vals, _ = load.amg.fast0
        probes.append(("the load AMG's level-0 restriction einsum (cuBLAS bmm)",
                       lambda x: _block_ell_matvec(pt0_cols, pt0_vals.to(f32), x),
                       (load.n_nodes, 2, nb)))
    if material.mamg[1]:
        a_cols, (av_a, _, _), _ = material.mamg[1][0]
        probes.append(("the material AMG's level-1 einsum (cuBLAS bmm)",
                       lambda x: _block_ell_matvec(a_cols, av_a.to(f32), x),
                       (av_a.shape[0], 3, nb)))
    if coarsest.dense_inv is not None:
        probes.append(("the structured load sweep's dense coarse solve (cuBLAS GEMM, B "
                       "columns)", lambda x: _lane_dense_coarse(coarsest.dense_inv.to(f32), x),
                       (2, *coarsest.stencil.shape[-2:], nb)))
    if load.amg.ci is not None and load.amg.fast0 is not None:
        probes.append(("the load AMG's dense coarsest inverse (cuBLAS GEMM, B columns)",
                       lambda x: _dense_apply(load.amg.ci.to(f32), x),
                       (load.amg.ci.shape[0] // 3, 3, nb)))
    say(f"  B-dependence of the sweeps' torch operations (f32, first {c} lanes of B={nb} "
        f"against B={c}):")
    for name, fn, shape in probes:
        x = rand(*shape, dtype=f32)
        with ieee_f32():
            full = fn(x)[..., :c]
            part = fn(x[..., :c].contiguous())
        rel = float((full - part).abs().max() / part.abs().max())
        say(f"    {name} {tuple(shape)}: bit-identical {torch.equal(full, part)}, "
            f"max|diff| / max|y| {rel:.3e}")


def timed_sweep(sweep, method, batch):
    t0 = time.perf_counter()
    res = getattr(sweep, method)(*batch)
    sync()
    return res, time.perf_counter() - t0


def lane_shard_sweeps(cases, shard_counts, totals, device_list=None):
    """Each sweep unsharded, then lane-sharded over each count of
    `shard_counts` (shards of cuda:0, or the cards of `device_list`): every
    kernel's launches S times the unsharded run's (each chunk runs the
    whole solve); each chunk of lanes bit-identical to the unsharded sweep
    run on that chunk's lanes alone; per-lane u against the unsharded run
    at all B lanes within the case's bar and every lane's true relative
    residual (f64, plain operator) within the phase's; first and warm
    solve_s. Raises after every case has printed."""
    import torch
    from magnetite_tpu_torch.parallel.pipeline import DeviceMesh

    failed = []
    for name, sweep, make, method, batch, kernels, bar, residual in cases:
        args = batch(0)
        nb = len(args[0])
        with main_path(f"{name}, unsharded", totals, kernels) as got0:
            res0, first0 = timed_sweep(sweep, method, args)
        warm0 = [timed_sweep(sweep, method, batch(seed))[1] for seed in (1, 2)]
        scale = res0.u.abs().amax(dim=(1, 2))
        for s in shard_counts:
            devices = (f"{DEV}:0",) * s if device_list is None else tuple(device_list)
            label = f"S={s}" + ("" if device_list is None else f" over {len(set(devices))} cards")
            sharded = make(DeviceMesh(devices, "lanes"))
            with main_path(f"{name}, lane-sharded {label}", totals, kernels) as got:
                res, first = timed_sweep(sharded, method, args)
            warm = [timed_sweep(sharded, method, batch(seed))[1] for seed in (1, 2)]
            u = res.u.to(res0.u.device)
            diff = float(((u - res0.u).abs().amax(dim=(1, 2)) / scale).max())
            rel = float(residual(args, res).max())
            c = nb // s
            alone = [getattr(sweep, method)(*(a[i * c:(i + 1) * c] for a in args)).u.to(u.device)
                     for i in range(s)]
            same = all(torch.equal(u[i * c:(i + 1) * c], v) for i, v in enumerate(alone))
            b_diff = float(((torch.cat(alone) - res0.u).abs().amax(dim=(1, 2)) / scale).max())
            say(f"  {name}, {label}: {len(sharded.replicas)} replica(s); first solve_s "
                f"{first:.4f}, warm {' / '.join(f'{w:.4f}' for w in warm)} (unsharded first "
                f"{first0:.4f}, warm {' / '.join(f'{w:.4f}' for w in warm0)}); each chunk "
                f"bit-identical to the unsharded sweep on its {c} lanes alone: {same}; those "
                f"B={c} runs against the B={nb} run {b_diff:.3e}; per-lane max|u - "
                f"u_unsharded| / max|u| {diff:.3e} (<= {bar['u']:g}); per-lane true relative "
                f"residual (f64, plain operator) max {rel:.3e} (<= {bar['residual']:g})")
            launched = {k: c_ for k, c_ in got.items() if c_}
            want = {k: s * c_ for k, c_ in got0.items() if c_}
            if launched != want:
                failed.append(f"{name} {label}: launches {launched}, expected S x the "
                              f"unsharded run's {want}")
            if not same:
                failed.append(f"{name} {label}: a chunk differs from the unsharded sweep on "
                              "its lanes")
            if not (diff <= bar["u"] and rel <= bar["residual"]):
                failed.append(f"{name} {label}: off the unsharded answer or above its "
                              "residual bar")
            del sharded, res, alone
    require(not failed, "; ".join(failed))


def ell_shard_bytes(cols, nl, n_u, es, nb=1):
    """(bytes moved once, operations) of one shard's all-gather ELL matvec
    over nb lanes: the blocks and int32 cols once, the entries of u its
    cols reference once, y written once; 8 flops per slot and lane."""
    import torch

    k = cols.numel() // nl
    touched = int(torch.unique(cols).numel())
    return nl * k * (4 * es + 4) + 2 * (touched + nl) * nb * es, 8 * nl * k * nb


def gathered_csr(data, cols, nl, n_u):
    """The shard's rows of K ([2 nl, 2 n_u] CSR) from slot-major data [K, 2,
    2, nl] and cols [K, nl]: the library yardstick's operand."""
    import torch

    node = torch.arange(nl, device=data.device)
    rows_, cs, vals = [], [], []
    for kk in range(cols.shape[0]):
        for i in range(2):
            for j in range(2):
                rows_.append(i * nl + node)
                cs.append(j * n_u + cols[kk].long())
                vals.append(data[kk, i, j])
    return csr(rows_, cs, vals, (2 * nl, 2 * n_u))


def phase_ell_shard(h, totals, reps, flush, rand, base=None):
    """Phase 25b: the all-gather block-ELL path on the Delaunay plate at h,
    f64. sharded_pcg_solve over 4 shards of cuda:0 to rtol 1e-8: exactly S
    x (1 + vcycles) ELL launches at the shard's rows against the gathered
    field (n_u = Np > n = nl), the true relative residual with the plain
    version; the kernel at that shape against its plain version and a
    cuSPARSE CSR SpMV of the shard's rows. Then sharded_batch_pcg_solve of
    ELL_BATCH_LANES lanes over a 2 x 2 (batch x rows) mesh of cuda:0,
    ELL_BATCH_ITERS fixed iterations: exactly chunks x rows x (iterations
    + 3) lane ELL launches, lanes 0 and the last against the same PCG run
    on that lane alone through the single-vector path (after 3 iterations,
    and by the true residual after the budget); the lane ELL kernel
    at the chunk's shape against its plain version and cuSPARSE SpMM.
    Returns the two kernels' rows at these shapes."""
    import numpy as np
    import torch
    from magnetite_tpu_torch.fem.cg import pcg_fixed_iterations
    from magnetite_tpu_torch.fem.operator import make_constrained_operator, reduced_rhs
    from magnetite_tpu_torch.kernels.ell_kernel import ell_matvec_t, ell_matvec_t_plain
    from magnetite_tpu_torch.kernels.lane_ell_kernel import (
        lane_ell_matvec, lane_ell_matvec_plain,
    )
    from magnetite_tpu_torch.parallel import sharding as psh
    from magnetite_tpu_torch.parallel.dia_shard import ShardVec, shard_dot
    from magnetite_tpu_torch.parallel.pipeline import DeviceMesh, DeviceMesh2D

    s = 4
    mesh, bca, md = plate_case(h)
    t0 = time.perf_counter()
    p = psh.prepare_sharded_problem(mesh, bca, md, DeviceMesh((f"{DEV}:0",) * s, "rows"),
                                    dtype=np.float64)
    sync()
    prep = time.perf_counter() - t0
    nl, n_u = p.free.shards[0].shape[1], p.n_pad
    k = p.cols[0].shape[0]
    say(f"phase 25b: sharded_pcg_solve (all-gather ELL) on the plate at h={h}: "
        f"{mesh.num_nodes} nodes, K={k}, {s} shards of {nl} rows against the gathered "
        f"{n_u}; prep {prep:.3f} s")
    maxiter = 100_000
    with main_path(f"the all-gather ELL solve, S={s}", totals, ("ell_matvec_t",)) as got:
        t0 = time.perf_counter()
        res = psh.sharded_pcg_solve(p, rtol=1e-8, maxiter=maxiter)
        sync()
        solve_s = time.perf_counter() - t0
    iters = int(res.iterations)
    # derived from the iterations this run took
    want = s * (1 + vcycles([iters], maxiter))
    say(f"  {iters} iterations, solve_s {solve_s:.3f}; ell_matvec_t launches "
        f"{got['ell_matvec_t']} (expected {s} x (1 + {vcycles([iters], maxiter)}) = {want}, "
        f"all f64, from the {iters} iterations observed)")
    launched = {kk: c for kk, c in got.items() if c}
    require(bool(res.converged) and launched == {"ell_matvec_t": want, "ell_matvec_t f64": want},
            f"all-gather ELL: launches {launched}")
    totals["ell_matvec_t gathered"] = totals.get("ell_matvec_t gathered", 0) + want
    full = torch.cat(res.x.shards, dim=1)

    def plain_k(v):  # the unreduced K on [2, Np], plain version
        return torch.cat([ell_matvec_t_plain(d, c, v) for d, c in zip(p.ell_data, p.cols)], dim=1)

    free = torch.cat(p.free.shards, dim=1)
    uf = torch.cat(p.u_fixed.shards, dim=1)
    fa = torch.cat(p.f_applied.shards, dim=1)
    b = free * (fa - plain_k(uf)) + (1 - free) * uf
    r = b - (free * plain_k(free * full) + (1 - free) * full)
    rel = float(r.norm() / b.norm())
    say(f"  true relative residual (f64, plain operator) {rel:.3e} (<= 1e-08)")
    require(rel <= 1e-8, "all-gather ELL: true residual too large")
    del res, full, r, b, uf, fa

    rows = {}
    data, cols = p.ell_data[0], p.cols[0]
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        d = data.to(dtype)
        u = rand(2, n_u, dtype=dtype)
        tag = f"ell_matvec_t shard K={k} N={nl} N_u={n_u} {str(dtype)[6:]}"
        ref = ell_matvec_t_plain(d, cols, u)
        y = ell_matvec_t(d, cols, u)
        scale = ell_matvec_t_plain(d.abs(), cols, u.abs()).max()
        err = compare(tag, y, ref, scale, tol)
        require(torch.equal(y, ell_matvec_t(d, cols, u)), f"{tag}: a second call differs")
        a = gathered_csr(d, cols, nl, n_u)
        x = u.reshape(-1)
        nbytes, flops = ell_shard_bytes(cols, nl, n_u, d.element_size())
        parent = baseline_ell_launcher(base)
        r_ = time_kernel(tag, lambda: ell_matvec_t(d, cols, u),
                         lambda: ell_matvec_t_plain(d, cols, u), lambda: torch.mv(a, x), reps,
                         flush, nbytes, flops, dtype, rounds=ROUNDS,
                         parent=parent and (lambda: parent(d, cols, u)))
        ell_floor_rounds(tag, d, cols, u, reps, flush, nbytes, flops, dtype, base)
        if dtype == torch.float64:
            rows["ell_matvec_t gathered"] = dict(max_abs_err=err, **r_)
        del a

    nb, iters_b = ELL_BATCH_LANES, ELL_BATCH_ITERS
    dm = DeviceMesh2D((f"{DEV}:0",) * 4, (2, 2), ("batch", "rows"))
    pb = psh.prepare_sharded_problem(mesh, bca, md, dm, axis="rows", dtype=np.float64)
    nlb, n_ub = pb.free.shards[0].shape[1], pb.n_pad
    rng = np.random.default_rng(25)
    u_fixed = pb.u_fixed.gather().T[None] * rng.uniform(0.5, 2.0, nb)[:, None, None]
    f_applied = np.zeros_like(u_fixed)
    with main_path(f"the all-gather ELL batch solve, {nb} lanes over 2 x 2", totals,
                   ("lane_ell_matvec",)) as got:
        t0 = time.perf_counter()
        ub = psh.sharded_batch_pcg_solve(pb, u_fixed, f_applied, iterations=iters_b)
        sync()
        solve_b = time.perf_counter() - t0
    want = 2 * 2 * (iters_b + 3)
    launched = {kk: c for kk, c in got.items() if c}
    say(f"  batch solve: {nb} lanes, {iters_b} iterations, 2 chunks x 2 row shards of {nlb} "
        f"rows against the gathered {n_ub}: solve_s {solve_b:.3f}; lane_ell_matvec launches "
        f"{got['lane_ell_matvec']} (expected 2 x 2 x ({iters_b} + 3) = {want})")
    require(launched == {"lane_ell_matvec": want} and bool(torch.isfinite(ub).all()),
            f"batch solve: launches {launched}")
    totals["lane_ell_matvec gathered"] = totals.get("lane_ell_matvec gathered", 0) + want
    # lanes 0 and the last against the same PCG run on that lane alone
    # through the single-vector ELL path: after 3 iterations only rounding
    # separates them (1e-12 of max|u|); after the full budget (far from
    # converged: ~5,900 iterations converge) CG carries the two dots'
    # summation orders apart, so there the lanes' true relative residuals
    # (f64, plain operator) are held within 2x of the one-lane solves'
    short = psh.sharded_batch_pcg_solve(pb, u_fixed, f_applied, iterations=3)
    devices = psh._mesh_rows(dm, "rows")

    free_b = torch.cat(pb.free.shards, dim=1)

    def plain_kb(v):  # pb's unreduced K on [2, Np], plain version
        return torch.cat([ell_matvec_t_plain(d, c, v) for d, c in zip(pb.ell_data, pb.cols)],
                         dim=1)

    def true_rel(u_lane, lane):  # u_lane [Np, 2]
        uf_l = torch.as_tensor(u_fixed[lane].T, device=DEV)
        b_l = free_b * (-plain_kb(uf_l)) + (1 - free_b) * uf_l
        v = u_lane.T.to(DEV)
        r_l = b_l - (free_b * plain_kb(free_b * v) + (1 - free_b) * v)
        return float(r_l.norm() / b_l.norm())

    for lane, chunk in ((0, 0), (nb - 1, 1)):
        ell_data, cols_c, free_c, diag_inv = psh._on(pb, devices[chunk])

        def field(a, devs=devices[chunk]):
            t = torch.as_tensor(a.T)
            return ShardVec(t[:, i * nlb:(i + 1) * nlb].to(d_).contiguous()
                            for i, d_ in enumerate(devs))

        mv = psh._gather_matvec(ell_data, cols_c)
        uf_l = field(u_fixed[lane])
        rhs = reduced_rhs(mv, free_c, uf_l, field(f_applied[lane]))
        one = {}
        for n_it in (3, iters_b):
            x_ = pcg_fixed_iterations(make_constrained_operator(mv, free_c), rhs,
                                      preconditioner=psh._block_jacobi(diag_inv), x0=uf_l,
                                      iterations=n_it, dot=shard_dot).x
            one[n_it] = torch.cat([t.to(ub.device) for t in x_.shards], dim=1).T
        diff = float((short[lane] - one[3]).abs().max() / one[3].abs().max())
        far = float((ub[lane] - one[iters_b]).abs().max() / one[iters_b].abs().max())
        rel_b, rel_1 = true_rel(ub[lane], lane), true_rel(one[iters_b], lane)
        say(f"  batch lane {lane} against the same PCG on that lane alone (single-vector ELL "
            f"kernel): after 3 iterations max|diff| / max|u| {diff:.3e} (<= 1e-12); after "
            f"{iters_b} {far:.3e}, true relative residual (f64, plain operator) {rel_b:.3e} "
            f"against {rel_1:.3e} (within 2x)")
        require(diff <= 1e-12 and 0.5 * rel_1 <= rel_b <= 2 * rel_1,
                f"batch lane {lane} off its one-lane solve")
    del ub, short, one
    ell_n, cols_n, _, _ = psh._lanes_on(pb, devices[0])
    ell0, cols0 = ell_n[0], cols_n[0]
    nbc = nb // 2
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        e = ell0.to(dtype)
        u = rand(2, n_ub, nbc, dtype=dtype)
        tag = f"lane_ell_matvec shard N={nlb} N_u={n_ub} W={k} B={nbc} {str(dtype)[6:]}"
        ref = lane_ell_matvec_plain(e, cols0, u)
        y = lane_ell_matvec(e, cols0, u)
        err = compare(tag, y, ref, lane_ell_matvec_plain(e.abs(), cols0, u.abs()).max(), tol)
        require(torch.equal(y, lane_ell_matvec(e, cols0, u)), f"{tag}: a second call differs")
        a = gathered_csr(e.permute(1, 2, 3, 0), cols0.T, nlb, n_ub)
        x = u.reshape(2 * n_ub, nbc)
        r_ = time_kernel(tag, lambda: lane_ell_matvec(e, cols0, u),
                         lambda: lane_ell_matvec_plain(e, cols0, u),
                         lambda: torch.sparse.mm(a, x), reps, flush,
                         *ell_shard_bytes(cols0, nlb, n_ub, e.element_size(), nbc), dtype)
        if dtype == torch.float64:
            rows["lane_ell_matvec gathered"] = dict(max_abs_err=err, **r_)
        del a, u, ref, y
    return rows


def phase_lane_shard(args, totals, rand, base=None):
    """Phase 25: lane sharding of phases 11, 12, 15 and 16's sweeps over 2
    and 4 shards of cuda:0, with each lane kernel at the chunks' lane
    counts (25a); the all-gather ELL path, single-vector and batched (25b);
    dryrun_multichip(4) on repeated cuda:0 (25c); and on a machine with
    more than one GPU the sweeps and the dry run over the distinct cards
    (25d). Returns the kernel rows of 25b."""
    import torch
    from magnetite_tpu_torch.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    say(f"phase 25a: lane-sharded sweeps, {SWEEP_LANES} lanes over 2 and 4 shards of one card")
    cases, sweeps, grid = lane_shard_cases(args)
    for s in (2, 4):
        lane_kernels_at_chunk(sweeps, grid, SWEEP_LANES // s, rand)
    lane_b_dependence(sweeps, grid, SWEEP_LANES // 2, rand)
    lane_shard_sweeps(cases, (2, 4), totals)
    del sweeps, grid
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=DEV)
    rows = phase_ell_shard(args.ell_shard_h, totals, args.reps, flush, rand, base)
    del flush
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = dryrun_multichip(4, device=f"{DEV}:0")
    say(f"phase 25c: dryrun_multichip(4) on cuda:0 x 4 passed in {time.perf_counter() - t0:.2f} "
        f"s: {out}")
    n_gpu = torch.cuda.device_count()
    if n_gpu > 1:
        devices = [f"{DEV}:{i}" for i in range(n_gpu)]
        say(f"phase 25d: the sweeps and the dry run over the {n_gpu} distinct cards")
        lane_shard_sweeps(cases, (n_gpu,), totals, devices)
        out = dryrun_multichip(n_gpu, device=devices)
        say(f"  dryrun_multichip({n_gpu}) over {devices}: {out}")
    else:
        say("phase 25d: one visible GPU: the distinct-card run needs more than one")
    del cases
    torch.cuda.empty_cache()
    say(f"  (phase 25: {time.perf_counter() - t_phase:.1f} s)")
    return rows


# phase 26's bars of entry() on the card against entry(device="cpu"), as
# fractions of the CPU answer's max: those of tests/test_torch_entry.py,
# max(2 x the JAX package's f32 run's distance from its f64 answer, 1e-5),
# taken on the CPU: u and f at the 1e-5 floor (the JAX f32 run's distances,
# 2.96e-8 and 8.32e-7 of max, lie below it), von Mises at 2 x 7.82e-6
ENTRY_BARS = {"u": 1e-5, "f": 1e-5, "von_mises": 1.564e-5}
# the four port examples (examples/torch_*.py) at their default sizes, and
# the lines of their output that phase 27 requires
EXAMPLES = (
    ("torch_plate_benchmark.py", (
        r"^solve: \S+s \(device \S+s\), \d+ inner iterations, relative residual (\S+)$",)),
    ("torch_unstructured_plate.py", (
        r"^warm solve: \S+s \(device \S+s\), \d+ CG iterations, relative residual (\S+)$",)),
    ("torch_design_sweep.py", (
        r"^\d+ variants in \S+s -> \d+ solves/s$",
        r"^material sweep: \d+ \(E, nu, t\) variants in \S+s -> \d+ solves/s",)),
    ("torch_multichip_pipeline.py", (
        r"^sharded pipeline: prep \S+ s, solve\+recovery \S+ s, \d+ iterations",
        r"^ +u: max relative diff \S+  ok$", r"^ +f: max relative diff \S+  ok$",
        r"^ +sigma: max relative diff \S+  ok$", r"^ +stress: max relative diff \S+  ok$",
        r"^ +von_mises: max relative diff \S+  ok$")),
)


def phase_entry(totals, reps):
    """Phase 26: the port's entry() (the 48x96 plate, f32 to rtol 1e-6,
    stencil operator and multigrid) on the card: three calls of
    fn(*args) as one main path (the stencil kernel and the fused
    smoothing pair launched by the first, eager call; the second captures
    the PCG's CUDA graphs, the third replays them), the calls bit for bit
    alike, held against
    entry(device="cpu") (iterations +-2, u, f and von Mises on
    ENTRY_BARS); the warm time the median of CUDA events around fn(*args)."""
    import torch
    from magnetite_tpu_torch.dryrun import entry

    say("phase 26: entry() -- the 48x96 plate, f32, rtol 1e-6, compiled once")
    t0 = time.perf_counter()
    fn, args = entry()
    (problem,) = args
    say(f"  compiled in {time.perf_counter() - t0:.2f} s: mode {problem.mode}, "
        f"preconditioner {problem.preconditioner}, refine {problem.refine}, "
        f"{problem.coords.shape[0]} nodes")
    with main_path("entry()", totals, ("stencil_matvec", "mg_presmooth", "mg_postsmooth")):
        outs = [fn(*args) for _ in range(3)]
        torch.cuda.synchronize()
    names = ("u", "f", "sigma", "stress", "von_mises", "iterations", "resnorm", "converged",
             "bnorm", "history")
    for k, out in enumerate(outs[1:], 2):
        same = [n for n, a, b in zip(names, outs[0], out) if not torch.equal(a, b)]
        require(not same, f"entry(): call {k} differs from call 1 in {same}")
    got = outs[0]
    require(bool(got[7]), "entry(): the solve did not converge")
    ref_fn, ref_args = entry(device="cpu")
    ref = ref_fn(*ref_args)
    iters, ref_iters = int(got[5]), int(ref[5])
    require(abs(iters - ref_iters) <= 2,
            f"entry(): {iters} iterations on the card, {ref_iters} on the CPU")
    for name, i in (("u", 0), ("f", 1), ("von_mises", 4)):
        want = ref[i].double()
        compare(f"entry() {name}, card vs CPU", got[i].cpu().double(), want, want.abs().max(),
                ENTRY_BARS[name])
    times = []
    for _ in range(max(reps, 5)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    say(f"  entry(): three calls bit for bit alike; {iters} iterations (CPU {ref_iters}), "
        f"relative residual {float(got[6] / got[8]):.3e}; warm fn(*args) median "
        f"{statistics.median(times):.4f} ms over {len(times)} calls (CUDA events; "
        f"min {min(times):.4f}, max {max(times):.4f})")
    del outs, got, fn, args, problem
    torch.cuda.empty_cache()


def phase_examples():
    """Phase 27: the four port examples at their default sizes, each a child
    process on the card (exit 0 required); their result lines printed and
    required, the plates' residuals <= 1e-8, the multichip example's
    parity lines all "ok" (it asserts 1e-6 itself)."""
    import torch

    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    say("phase 27: the port's examples at their default sizes, each in a child process")
    t_phase = time.perf_counter()
    for script, patterns in EXAMPLES:
        argv = [sys.executable, os.path.join(root, "examples", script)]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True, timeout=900, cwd=root)
        wall = time.perf_counter() - t0
        say(f"  {' '.join(argv[1:]).replace(root + os.sep, '')}: exit {proc.returncode} "
            f"in {wall:.1f} s")
        for line in proc.stdout.splitlines():
            say(f"    {line}")
        require(proc.returncode == 0, f"{script} failed:\n{proc.stderr[-3000:]}")
        lines = proc.stdout.splitlines()
        for pattern in patterns:
            hit = [m for m in (re.match(pattern, line) for line in lines) if m]
            require(hit, f"{script}: no line matches {pattern!r}")
            if hit[0].groups():
                rel = float(hit[0].group(1))
                require(rel <= 1e-8, f"{script}: relative residual {rel:.3e} above 1e-8")
    say(f"  phase 27 took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    global SWEEP_LANES, PTXAS
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--h", type=float, default=0.00258,
                    help="mesh size of the Delaunay plate (0.00258: ~1M elements)")
    ap.add_argument("--small-h", type=float, default=0.01,
                    help="mesh size of the card-against-CPU Delaunay plate")
    ap.add_argument("--plate", type=int, nargs=2, default=(512, 1024),
                    help="radial x tangential cells of the structured plate (1M elements)")
    ap.add_argument("--big", type=int, nargs=2, default=(1024, 2048),
                    help="the larger structured grid of the stencil kernel phase (4M)")
    ap.add_argument("--rect", type=int, nargs=2, default=(1000, 600),
                    help="x and y cells of the non-wrapped grid of the stencil and "
                    "smoothing kernel phases (1001 cols: not a multiple of 32; its "
                    "hierarchy's coarsest level, 76x126, smooths)")
    ap.add_argument("--small-plate", type=int, nargs=2, default=(64, 128),
                    help="the structured plate of the card-against-CPU phase")
    ap.add_argument("--sweep-h", type=float, default=SWEEP_H,
                    help="mesh size of the design-sweep plate (0.03: 3,774 nodes)")
    ap.add_argument("--lanes", type=int, default=SWEEP_LANES,
                    help="design variants (lanes) of the full-width sweeps")
    ap.add_argument("--sweep-small", type=float, nargs=2, default=(0.04, 128),
                    metavar=("H", "LANES"),
                    help="mesh size and lanes of the sweeps' card-against-CPU phase")
    ap.add_argument("--ell-shard-h", type=float, default=0.003,
                    help="mesh size of the all-gather ELL phase's Delaunay plate (25b)")
    ap.add_argument("--reps", type=int, default=20, help="timed launches per kernel")
    ap.add_argument("--profile", action="store_true",
                    help="trace one structured f32-refined solve and one warm solve of "
                    "each sweep with torch.profiler")
    ap.add_argument("--baseline", metavar="DIR",
                    help="another checkout (e.g. the parent commit unpacked by git archive): "
                    "its dia_matvec and prolong0 kernels (and mg_presmooth / mg_postsmooth, "
                    "the lane stencil kernel, the ELL kernel and the coarse smoother where it "
                    "has them, and PR 14's assembly kernel) are built apart and timed "
                    "beside this tree's in phases 2, 3, "
                    "14, 17, 22, 23a and 25b, in the same interleaved rounds")
    ap.add_argument("--only", choices=("transfers", "lane-kernels", "multigrid",
                                       "structured-sweeps", "lane-sweeps", "resume", "ell",
                                       "assembly", "shard", "grid-shard", "lane-shard",
                                       "entry", "examples"),
                    help="transfers: phases 0 to 3 alone (the Delaunay plate's band and "
                    "transfer kernels); lane-kernels: phases 0, 1 and 10 alone; multigrid: "
                    "phases 0, 1 and 14 alone (the 1M plate's hierarchy built, not solved); "
                    "structured-sweeps: phases 0, 1 and 15-17 alone; lane-sweeps: phases "
                    "0, 1 and 18-20 alone; resume: phases 0, 1 and 21 alone (the "
                    "Delaunay plate compiled, then saved and resumed); ell: phases 0, 1, "
                    "5, 6 and 22 (the DIA CLI runs that phase 22 is held against); assembly: "
                    "phases 0, 1, 5 and 23a-b (the device assembly, held against phase 5); "
                    "shard: phases 0, 1, 5, 6 and 23 (device assembly and the sharded "
                    "pipeline, held against phases 5-6); grid-shard: phases 0, 1, 7 and 24 (the "
                    "structured multi-GPU path, held against phase 7); lane-shard: phases "
                    "0, 1 and 25; entry: phases 0, 1 and 26; examples: phases 0, 1 and 27; "
                    "each ends without the ok line")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    say(f"phase 0: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        say("no CUDA device available: torch.cuda.is_available() is false")
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(f"  device: {kind}; nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from magnetite_tpu_torch import native
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import compile_problem
    from magnetite_tpu_torch.kernels import cuda_lib

    say("phase 1: build")
    seconds, PTXAS = cuda_lib.build()
    say(f"  CUDA kernels (nvcc sm_90a): {seconds:.2f} s")
    for line in PTXAS.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("    " + line.strip())
    say(f"  host library (g++): {native.build():.2f} s")
    base = None
    if args.baseline:
        seconds, base = load_baseline(args.baseline)
        say(f"  baseline kernels of {args.baseline}: {seconds:.2f} s")

    gen = torch.Generator(device=DEV).manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=DEV, dtype=torch.float64).to(dtype)

    SWEEP_LANES = args.lanes
    if args.only == "entry":
        phase_entry({}, args.reps)
        say(f"phases 0, 1 and 26 passed in {time.perf_counter() - t_start:.1f} s "
            "(--only entry: no ok line)")
        return 0
    if args.only == "examples":
        phase_examples()
        say(f"phases 0, 1 and 27 passed in {time.perf_counter() - t_start:.1f} s "
            "(--only examples: no ok line)")
        return 0
    if args.only == "grid-shard":
        refs: dict = {}
        phase_structured(*args.plate, {}, False, refs)
        phase_grid_shard(*args.plate, refs, {}, rand)
        say(f"phases 0, 1, 7 and 24 passed in {time.perf_counter() - t_start:.1f} s "
            "(--only grid-shard: no ok line)")
        return 0
    if args.only == "lane-shard":
        phase_lane_shard(args, {}, rand, base)
        say(f"phases 0, 1 and 25 passed in {time.perf_counter() - t_start:.1f} s "
            "(--only lane-shard: no ok line)")
        return 0
    if args.only == "lane-kernels":
        say(f"phase 10: the sweep plate at h={args.sweep_h} compiled for both sweeps")
        flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=DEV)
        phase_lane_kernels(compile_sweeps(args.sweep_h), args.reps, flush, rand)
        say(f"phases 0, 1 and 10 passed in {time.perf_counter() - t_start:.1f} s "
            "(--only lane-kernels: no ok line)")
        return 0
    if args.only == "structured-sweeps":
        phase_grid_sweeps(args, rand, {}, {}, base)
        say(f"phases 0, 1 and 15-17 passed in {time.perf_counter() - t_start:.1f} s "
            "(--only structured-sweeps: no ok line)")
        return 0
    if args.only == "lane-sweeps":
        phase_lane_sweeps(args, rand, {}, {})
        say(f"phases 0, 1 and 18-20 passed in {time.perf_counter() - t_start:.1f} s "
            "(--only lane-sweeps: no ok line)")
        return 0
    if args.only == "multigrid":
        mesh, bca, md = structured_case(*args.plate)
        levels_1m = compile_problem(mesh, bca, md, SolverOptions(dtype="float64", cg_rtol=1e-8),
                                    device=DEV).system.mg_levels
        say(f"  1M plate hierarchy (f64, not solved): "
            f"{[(lv.rows, lv.cols) for lv in levels_1m]}")
        flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=DEV)
        phase_mg_smooth(levels_1m, args.rect, args.reps, flush, rand, {}, base)
        say(f"phases 0, 1 and 14 passed in {time.perf_counter() - t_start:.1f} s "
            "(--only multigrid: no ok line)")
        return 0

    t0 = time.perf_counter()
    mesh, bca, md = plate_case(args.h)
    problem = compile_problem(mesh, bca, md, SolverOptions(), device=DEV)
    say(f"  Delaunay plate h={args.h}: {mesh.num_nodes} nodes, {mesh.num_elements} "
        f"elements, {len(problem.system.offsets)} offsets, AMG levels "
        f"{problem.timings['amg_levels']}, prepared in {time.perf_counter() - t0:.2f} s")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=DEV)
    if args.only == "resume":
        phase_resume(problem, mesh, bca, md, args, {})
        say(f"phases 0, 1 and 21 passed in {time.perf_counter() - t_start:.1f} s "
            "(--only resume: no ok line)")
        return 0
    results = {}
    if args.only not in ("ell", "assembly", "shard"):
        results = phase_band_and_transfer(problem, args.reps, flush, rand, base)
        if args.only == "transfers":
            say(f"phases 0 to 3 passed in {time.perf_counter() - t_start:.1f} s "
                "(--only transfers: no ok line)")
            return 0
        results.update(phase_df(problem, args.reps, flush, rand))
        torch.cuda.empty_cache()

    totals: dict = {}
    dia = {}
    with tempfile.TemporaryDirectory() as workdir:
        say(f"phase 5: f64 main path through magnetite_tpu_torch.cli at h={args.h}")
        dia["f64"] = cli_path("the f64 CLI run", problem, mesh, args.h, workdir, [], 1e-9,
                              totals)
        if args.only != "assembly":
            say(f"phase 6: mixed main path through the CLI (--precision mixed) at h={args.h}")
            dia["mixed"] = cli_path("the mixed CLI run", problem, mesh, args.h, workdir,
                                    ["--precision", "mixed"], 1e-9, totals)
    if args.only in (None, "ell"):
        results.update(phase_ell(problem, mesh, bca, md, args, dia, totals, args.reps, flush,
                                 rand, base))
    if args.only in (None, "assembly", "shard"):
        results.update(phase_device_assembly(problem, mesh, bca, md, args, dia, totals,
                                             args.reps, flush, base))
    if args.only in (None, "shard"):
        phase_shard(problem, mesh, bca, md, args, dia, totals)
    del dia
    torch.cuda.empty_cache()
    if args.only in ("ell", "assembly", "shard"):
        done = {"ell": "1, 5, 6 and 22", "assembly": "1, 5 and 23a-b",
                "shard": "1, 5, 6 and 23"}[args.only]
        say(f"phases 0, {done} passed in {time.perf_counter() - t_start:.1f} s "
            f"(--only {args.only}: no ok line)")
        return 0
    phase_mixed_df(problem, mesh, bca, md, totals)
    torch.cuda.empty_cache()
    phase_resume(problem, mesh, bca, md, args, totals)
    del problem
    torch.cuda.empty_cache()

    refs = {}
    levels_1m = phase_structured(*args.plate, totals, args.profile, refs)
    phase_grid_shard(*args.plate, refs, totals, rand)
    del refs
    torch.cuda.empty_cache()
    results.update(phase_stencil_kernel(levels_1m, args.big, args.rect, args.reps, flush, rand,
                                        totals))
    results.update(phase_mg_smooth(levels_1m, args.rect, args.reps, flush, rand, totals, base))
    del levels_1m, flush
    torch.cuda.empty_cache()
    phase_card_vs_cpu(args.small_h, args.small_plate)

    say(f"phase 10: the sweep plate at h={args.sweep_h} compiled for both sweeps")
    sweeps = compile_sweeps(args.sweep_h)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=DEV)
    results.update(phase_lane_kernels(sweeps, args.reps, flush, rand))
    for name in ("lane_dia_matvec", "lane_dia_matvec3"):
        results[name] = results[f"{name} float32"]  # the main path's f32 calls
    del flush
    torch.cuda.empty_cache()
    phase_load_sweep(sweeps, totals, SWEEP_BARS, args.profile)
    phase_material_sweep(sweeps, totals, SWEEP_BARS, args.profile)
    del sweeps
    torch.cuda.empty_cache()
    phase_sweeps_card_vs_cpu(args.sweep_small[0], int(args.sweep_small[1]))
    phase_grid_sweeps(args, rand, results, totals, base)
    phase_lane_sweeps(args, rand, results, totals)
    results.update(phase_lane_shard(args, totals, rand, base))
    phase_entry(totals, args.reps)
    phase_examples()

    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    say("launches per shape over the main paths: " + "; ".join(
        f"{k}: {v}" for k, v in totals["per shape"].items()))
    kernels = [
        {
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": totals["dia_matvec m=2" if name == "dia_matvec" else name],
            **{k: results[name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            )},
        }
        for name in KERNELS
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
