"""Lane-batched band SpMV: CUDA kernels `lane_dia_matvec<T>` (K7) and
`lane_dia_matvec3<T>` (K8) and their plain versions.

    K7  y[ci, n, b] = sum_d sum_cj bands[d, ci, cj, n] * u[cj, n + offsets[d], b]
    K8  y_b = (wa_b Ka + wb_b Kb + wc_b Kc) u_b

on [2, N, B] lane fields of design sweeps, the band coefficients shared by
every lane (K8: three basis band sets and per-lane weights [B]). Replace
magnetite_tpu/pallas/lane_dia_kernel.py::_kernel and ::_kernel3 (see
csrc/lane_dia_matvec.cu for what bounds them on Hopper and how the design
answers that). `lane_dia_matvec` / `lane_dia_matvec3` are the entry
points: a CPU operand takes the plain PyTorch version (the JAX package's
roll formulation), a CUDA operand launches the kernel or raises. Both take
f32 and f64, any B >= 1 and any offsets.

Each has two kernels, chosen by shape (`lane_window_plan`, `sets` = 1 for
K7, 3 for K8): the ring kernel, one template over the basis count that
keeps a window of u rows in shared memory, wherever that window and the
staged band values fit at the full tile width, and the direct kernel for
wider offset spans (csrc/lane_dia_matvec.cu).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from . import cuda_lib

# The ring kernel's geometry (csrc/lane_dia_matvec.cu): a lane tile is
# TILE_BYTES of each component row (32 f32 / 16 f64 lanes), a thread
# carries VEC_BYTES of lanes, and a step is at least MIN_ROWS rows. By
# basis count (1: K7, 3: K8) and value size, as csrc's Ring<T, S>: the rows
# each thread computes (the kernel's K), the most threads a block runs, the
# offsets whose band values one stage holds (0: all D) and the stages, the
# fastest measured at the sweep plate (PERF.md). A block may use
# SMEM_LIMIT bytes of dynamic shared memory; an SM holds SM_SMEM, less
# SM_RESERVED per resident block (NVIDIA H100).
TILE_BYTES, VEC_BYTES, MIN_ROWS = 128, 16, 8
# (basis count, value bytes): (rows per thread, threads, offsets per stage, stages)
RING_GEOMETRY = {(1, 4): (2, 256, 0, 2), (1, 8): (1, 512, 0, 2), (3, 4): (1, 512, 9, 3),
                 (3, 8): (1, 512, 5, 3)}
SMEM_LIMIT, SM_SMEM, SM_RESERVED = 232_448, 233_472, 1_024
H100_SMS = 132


@dataclass(frozen=True)
class LanePlan:
    """How K7 / K8 run at one shape: `route` "ring" or "direct"; for the ring,
    the lane tile (`lanes`), the rows per step (`rows`), the row strips
    (`strips` of `strip_rows` rows) and the dynamic shared memory per
    block."""

    route: str
    min_off: int
    max_off: int
    lanes: int = 0
    rows: int = 0
    strips: int = 0
    strip_rows: int = 0
    smem_bytes: int = 0


def ring_smem_bytes(span: int, lanes: int, rows: int, n_diags: int, es: int,
                    sets: int = 1) -> int:
    """Shared memory of one ring block: the ring (span + m steps of rows,
    x 2 components x lanes values), `stages` stages of band coefficients
    (G offsets x `sets` bases x 4 x rows each, G = min(D, RING_GEOMETRY's
    offsets per stage), all D for 0), then the D shifted offsets; m = 1 +
    ceil((stages - 1) / ceil(D / G)), how far ahead the copies run (csrc's
    ring_steps)."""
    _, _, group, stages = RING_GEOMETRY[sets, es]
    group = n_diags if group == 0 else min(n_diags, group)
    steps = 1 + -(-(stages - 1) // -(-n_diags // group))
    bands = stages * group * 4 * sets * rows
    return ((span + steps * rows) * 2 * lanes + bands) * es + 4 * n_diags


def lane_window_plan(offsets, n: int, nb: int, dtype, *, sms: int = H100_SMS,
                     sets: int = 1) -> LanePlan:
    """Route and geometry of K7 (`sets` = 1) or K8 (`sets` = 3, three
    basis band sets) for `offsets` at N = n nodes, B = nb lanes on a card of
    `sms` SMs.

    The ring route needs its rows and its staged band coefficients
    (`ring_smem_bytes`) to fit shared memory at the full tile width with
    some step P >= MIN_ROWS, whatever B is; wider spans take the direct
    kernel (the rule depends on the offsets, the value size, D and the
    basis count alone). The tile is narrowed to B when
    B is smaller; P is the largest step that gives a block at most
    RING_GEOMETRY's threads and fits (a multiple of 2 K and of
    16 bytes of values: the loader pairs threads to the two components and
    copies band values 16 bytes at a time). The strips trade the halo
    against filling the SMs: the count minimises waves x (strip_rows + span
    + P), the rows each block's SM streams, with waves = ceil(tiles x
    strips / (sms x blocks per SM)). Cached: the sweeps ask once per
    launch."""
    return _plan(tuple(offsets), int(n), int(nb), dtype.itemsize, int(sms), int(sets))


def _fit_rows(span, lanes, n_diags, es, sets, rows, quantum):
    """The largest step of at most `rows` rows, a multiple of `quantum` and
    at least MIN_ROWS, whose ring fits a block's shared memory, or None."""
    rows = rows // quantum * quantum
    while rows >= MIN_ROWS:
        if ring_smem_bytes(span, lanes, rows, n_diags, es, sets) <= SMEM_LIMIT:
            return rows
        rows -= quantum
    return None


@functools.lru_cache(maxsize=256)
def _plan(offsets, n, nb, es, sms, sets) -> LanePlan:
    min_off, max_off = int(min(offsets)), int(max(offsets))
    span, vec, d = max_off - min_off, VEC_BYTES // es, len(offsets)
    k, threads, _, _ = RING_GEOMETRY[sets, es]
    quantum = max(2 * k, vec)
    if _fit_rows(span, TILE_BYTES // es, d, es, sets, threads * k, quantum) is None:
        return LanePlan("direct", min_off, max_off)
    lanes = min(TILE_BYTES // es, -(-nb // vec) * vec)
    lt = lanes // vec
    rows = _fit_rows(span, lanes, d, es, sets, threads * k // lt, quantum)
    smem = ring_smem_bytes(span, lanes, rows, d, es, sets)
    per_sm = max(1, min(SM_SMEM // (smem + SM_RESERVED), 2048 // (lt * rows // k), 32))
    tiles = -(-nb // lanes)
    best = None
    for strips in range(1, min(-(-n // rows), 2 * sms * per_sm) + 1):
        strip_rows = -(-(-(-n // strips)) // rows) * rows  # rows per strip, whole steps
        used = -(-n // strip_rows)
        waves = -(-(tiles * used) // (sms * per_sm))
        cost = waves * (strip_rows + span + rows)
        if best is None or cost < best[0]:
            best = (cost, used, strip_rows)
    _, strips, strip_rows = best
    return LanePlan("ring", min_off, max_off, lanes, rows, strips, strip_rows, smem)


def lane_dia_matvec_plain(bands: torch.Tensor, offsets, u: torch.Tensor) -> torch.Tensor:
    """Plain version of K7 (magnetite_tpu/parallel/sweep.py's
    band_matvec_roll): bands [D, 2, 2, N], u [2, N, B] -> K u [2, N, B].

    Rolls wrap, but every band is zero wherever its shifted index would be
    invalid, so the wraparound contributes exactly 0."""
    y0 = torch.zeros_like(u[0])
    y1 = torch.zeros_like(u[1])
    for d_idx, off in enumerate(offsets):
        shifted = torch.roll(u, -int(off), dims=1) if off != 0 else u
        b = bands[d_idx][:, :, :, None]  # [2, 2, N, 1] broadcast over lanes
        y0 = y0 + b[0, 0] * shifted[0] + b[0, 1] * shifted[1]
        y1 = y1 + b[1, 0] * shifted[0] + b[1, 1] * shifted[1]
    return torch.stack([y0, y1])


def lane_dia_matvec3_plain(bands3, w3, offsets, u: torch.Tensor) -> torch.Tensor:
    """Plain version of K8 (magnetite_tpu/parallel/sweep.py::
    _lane_weighted_band_matvec): six per-basis accumulators over one roll
    per offset, combined with the per-lane weights (wa, wb, wc) at the end."""
    acc = [torch.zeros_like(u[0]) for _ in range(6)]
    for d_idx, off in enumerate(offsets):
        s = torch.roll(u, -int(off), dims=1) if off != 0 else u
        for k, bk in enumerate(bands3):
            blk = bk[d_idx][:, :, :, None]  # [2, 2, N, 1]
            acc[2 * k] = acc[2 * k] + blk[0, 0] * s[0] + blk[0, 1] * s[1]
            acc[2 * k + 1] = acc[2 * k + 1] + blk[1, 0] * s[0] + blk[1, 1] * s[1]
    wa, wb, wc = w3
    y0 = acc[0] * wa + acc[2] * wb + acc[4] * wc
    y1 = acc[1] * wa + acc[3] * wb + acc[5] * wc
    return torch.stack([y0, y1])


def offsets_tensor(offsets, device) -> torch.Tensor:
    """The band offsets as the int32 tensor the kernels read (callers that
    launch repeatedly make it once; the plain versions take Python ints)."""
    return torch.tensor([int(o) for o in offsets], dtype=torch.int32, device=device)


def _check_shapes(name, bands_list, u, offsets_dev, ws=()):
    d, n = bands_list[0].shape[0], u.shape[1] if u.dim() == 3 else -1
    bad = (
        u.dim() != 3 or u.shape[0] != 2
        or offsets_dev.dtype != torch.int32 or offsets_dev.numel() != d
        or any(tuple(b.shape) != (d, 2, 2, n) or b.dtype != u.dtype for b in bands_list)
        or any(tuple(w.shape) != (u.shape[2],) or w.dtype != u.dtype for w in ws)
    )
    if bad:
        raise cuda_lib.KernelError(
            f"{name}: bands {[tuple(b.shape) for b in bands_list]} "
            f"{bands_list[0].dtype}, u {tuple(u.shape)} {u.dtype}, weights "
            f"{[tuple(w.shape) for w in ws]}, {offsets_dev.numel()} offsets"
        )


def lane_dia_matvec(
    bands: torch.Tensor,
    offsets,
    u: torch.Tensor,
    offsets_dev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K7: y = K u on [2, N, B] lane fields. `offsets`: the band offsets as
    Python ints; `offsets_dev`: the same as an int32 tensor on the card
    (made here when not given). The route (ring or direct kernel) is
    `lane_window_plan`'s."""
    if u.device.type == "cpu" and bands.device.type == "cpu":
        return lane_dia_matvec_plain(bands, offsets, u)
    u = u.contiguous()
    if offsets_dev is None:
        offsets_dev = offsets_tensor(offsets, u.device)
    cuda_lib.require_cuda("lane_dia_matvec", u.dtype, bands, u, offsets_dev)
    _check_shapes("lane_dia_matvec", [bands], u, offsets_dev)
    _, n, nb = u.shape
    plan = lane_window_plan(offsets, n, nb, u.dtype, sms=cuda_lib.sm_count(u.device))
    return launch_lane_dia(bands, u, offsets_dev, plan)


def launch_lane_dia(bands, u, offsets_dev, plan: LanePlan) -> torch.Tensor:
    """K7 on checked card operands through `plan`'s kernel."""
    _, n, nb = u.shape
    y = torch.empty_like(u)
    args = (cuda_lib.DTYPE_CODES[u.dtype], bands.data_ptr(), offsets_dev.data_ptr(),
            bands.shape[0], u.data_ptr(), y.data_ptr(), n, nb)
    name = f"lane_dia_matvec ({plan.route})"
    if plan.route == "ring":
        cuda_lib.launch(name, "mt_lane_dia_ring", u, *args, plan.min_off, plan.max_off,
                        plan.lanes, plan.rows, plan.strip_rows, plan.smem_bytes)
    else:
        cuda_lib.launch(name, "mt_lane_dia_matvec", u, *args)
    return y


def lane_dia_matvec3(
    bands3,
    w3,
    offsets,
    u: torch.Tensor,
    offsets_dev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K8: y_b = (wa_b Ka + wb_b Kb + wc_b Kc) u_b. bands3: three
    [D, 2, 2, N] basis band sets; w3: (wa, wb, wc), each [B]. The route
    (ring or direct kernel) is `lane_window_plan(..., sets=3)`'s."""
    if u.device.type == "cpu" and bands3[0].device.type == "cpu":
        return lane_dia_matvec3_plain(bands3, w3, offsets, u)
    u = u.contiguous()
    w3 = [w.contiguous() for w in w3]
    if offsets_dev is None:
        offsets_dev = offsets_tensor(offsets, u.device)
    cuda_lib.require_cuda("lane_dia_matvec3", u.dtype, *bands3, *w3, u, offsets_dev)
    _check_shapes("lane_dia_matvec3", list(bands3), u, offsets_dev, w3)
    _, n, nb = u.shape
    plan = lane_window_plan(offsets, n, nb, u.dtype, sms=cuda_lib.sm_count(u.device), sets=3)
    return launch_lane_dia3(bands3, w3, u, offsets_dev, plan)


def launch_lane_dia3(bands3, w3, u, offsets_dev, plan: LanePlan) -> torch.Tensor:
    """K8 on checked card operands through `plan`'s kernel."""
    _, n, nb = u.shape
    y = torch.empty_like(u)
    args = (cuda_lib.DTYPE_CODES[u.dtype], *(b.data_ptr() for b in bands3),
            *(w.data_ptr() for w in w3), offsets_dev.data_ptr(), bands3[0].shape[0],
            u.data_ptr(), y.data_ptr(), n, nb)
    name = f"lane_dia_matvec3 ({plan.route})"
    if plan.route == "ring":
        cuda_lib.launch(name, "mt_lane_dia_ring3", u, *args, plan.min_off, plan.max_off,
                        plan.lanes, plan.rows, plan.strip_rows, plan.smem_bytes)
    else:
        cuda_lib.launch(name, "mt_lane_dia_matvec3", u, *args)
    return y
