"""The structured material sweep's coarsest-level solve in one launch: the
CUDA kernel `lane_coarse_smooth3_kernel<T>` (csrc/lane_coarse_smooth.cu)
and its plain version.

    e = omega D_b^-1 r,  then (sweeps - 1) times  e += omega D_b^-1 (r - K(w_b) e)

per lane b of [2, R, C, B] lane fields, K(w_b) = wa_b Sa + wb_b Sb + wc_b Sc
+ Sfix the lane's operator (the S = 3 lane stencil matvec,
kernels/lane_stencil_kernel.py) and D_b^-1 [2, 2, R, C, B] its inverse
center blocks. This is the JAX package's coarsest-level smoothing in
magnetite_tpu/parallel/sweep.py::_lane_material_vcycle (48 sweeps, omega
0.7), which XLA fuses; there is no `pallas_call` behind it.

`lane_coarse_smooth3` is the entry point. CPU operands take the plain
version. CUDA operands take one of two routes, by shape
(`lane_coarse_route`): "fused", the kernel, where one of its geometries
fits the level's lane slab in one block (`lane_coarse_plan`: the 9x17 and
wrapped 9x16 coarsest levels); "per-sweep" otherwise, the plain loop with
its matvecs through the S = 3 lane stencil kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..fem.blocks import apply_blocks
from . import cuda_lib
from .lane_stencil_kernel import (
    VEC_BYTES, _on_cpu, _require_packed, lane_material_matvec_plain, lane_stencil_matvec3,
)

# csrc geometries (MT_COARSE_F32 / MT_COARSE_F64), per value size, in the
# order a level takes them (the first that fits): M rows a thread, L lanes
# a slab, the instance's block bound. A block's shared memory: the level's
# four stencils (a node's 144 values padded by 16 bytes), e double-buffered
# with a zero border and M - 1 spare zero rows, 6 M values a thread of the
# next slab's dinv and r.
GEOMETRIES = {4: ((3, 7, 384), (1, 2, 320)), 8: ((2, 3, 256), (1, 2, 320))}
MAX_SMEM = 227 * 1024
ROUTES = ("fused", "per-sweep")


class LaneCoarsePlan(NamedTuple):
    m: int  # vertically adjacent nodes of one lane a thread
    lanes: int  # a slab (a block's lanes)
    threads: int  # a block: ceil(rows / m) * cols * lanes, rounded up to a warp
    smem: int  # bytes


def _fit(rows, cols, es, m, lanes, cap) -> Optional[LaneCoarsePlan]:
    threads = -(-(-(-rows // m) * cols * lanes) // 32) * 32
    smem = (rows * cols * (144 + 16 // es) + 2 * (rows + m + 1) * (cols + 2) * lanes * 2
            + 6 * m * threads) * es
    if rows < 1 or cols < 2 or threads > cap or smem > MAX_SMEM:
        return None
    return LaneCoarsePlan(m, lanes, threads, smem)


def lane_coarse_plan(rows: int, cols: int, es: int) -> Optional[LaneCoarsePlan]:
    """The fused launch's block for a rows x cols level in `es`-byte values:
    the first of the value size's GEOMETRIES that fits, or None where none
    does (too many threads for the instance, or past MAX_SMEM bytes of
    shared memory)."""
    for m, lanes, cap in GEOMETRIES[es]:
        plan = _fit(rows, cols, es, m, lanes, cap)
        if plan is not None:
            return plan
    return None


def lane_coarse_route(rows: int, cols: int, es: int) -> str:
    """"fused" where lane_coarse_plan fits the level, else "per-sweep"."""
    return ROUTES[lane_coarse_plan(rows, cols, es) is None]


def _smooth(matvec, dinv, r, sweeps: int, omega: float) -> torch.Tensor:
    """Damped block-Jacobi from zero: the first sweep without the matvec."""
    e = omega * apply_blocks(dinv, r)
    for _ in range(sweeps - 1):
        e = e + omega * apply_blocks(dinv, r - matvec(e))
    return e


def lane_coarse_smooth3_plain(stencils4, dinv, w3, r, wrap: bool, sweeps: int,
                              omega: float) -> torch.Tensor:
    """Plain version: the V-cycle's coarsest-level loop as it was, through
    the plain S = 3 matvec. stencils4 = (Sa, Sb, Sc, Sfix) or packed."""
    return _smooth(lambda e: lane_material_matvec_plain(stencils4, w3, e, wrap), dinv, r,
                   sweeps, omega)


def lane_coarse_smooth3(stencils4, dinv, w3, r, wrap: bool, sweeps: int,
                        omega: float) -> torch.Tensor:
    """e after `sweeps` damped block-Jacobi sweeps from zero on K(w_b) e =
    r: stencils4 (Sa, Sb, Sc, Sfix) (CPU) or packed (CPU or CUDA), dinv [2,
    2, R, C, B], w3 = (wa, wb, wc) each [B], r [2, R, C, B]."""
    if _on_cpu(stencils4, r):
        return lane_coarse_smooth3_plain(stencils4, dinv, w3, r, wrap, sweeps, omega)
    rows, cols = r.shape[-3], r.shape[-2]
    plan = lane_coarse_plan(rows, cols, r.element_size())
    if plan is None:
        return _smooth(lambda e: lane_stencil_matvec3(stencils4, w3, e, wrap), dinv, r,
                       sweeps, omega)
    packed = _require_packed("lane_coarse_smooth3", stencils4, 3)
    r, dinv = r.contiguous(), dinv.contiguous()
    w3 = [w.contiguous() for w in w3]
    _check(packed, dinv, w3, r, sweeps)
    nb = r.shape[3]
    e = torch.empty_like(r)
    cuda_lib.launch(
        "lane_coarse_smooth3", "mt_lane_coarse_smooth3", r,
        cuda_lib.DTYPE_CODES[r.dtype], int(bool(wrap)), packed.data_ptr(), dinv.data_ptr(),
        *(w.data_ptr() for w in w3), r.data_ptr(), e.data_ptr(), rows, cols, nb, int(sweeps),
        float(omega),
    )
    return e


def _check(packed, dinv, w3, r, sweeps):
    cuda_lib.require_cuda("lane_coarse_smooth3", r.dtype, packed, dinv, *w3, r)
    rows, cols = packed.shape[0], packed.shape[1]
    nb = r.shape[-1] if r.dim() == 4 else -1
    bad = (
        r.dim() != 4 or tuple(r.shape) != (2, rows, cols, nb) or sweeps < 1
        or tuple(packed.shape) != (rows, cols, 9, 2, 2, 4)
        or tuple(dinv.shape) != (2, 2, rows, cols, nb)
        or any(tuple(w.shape) != (nb,) for w in w3)
        or any(t.dtype != r.dtype for t in (packed, dinv, *w3))
    )
    if bad:
        raise cuda_lib.KernelError(
            f"lane_coarse_smooth3: packed stencils {tuple(packed.shape)} {packed.dtype}, dinv "
            f"{tuple(dinv.shape)} {dinv.dtype}, r {tuple(r.shape)} {r.dtype}, weights "
            f"{[(tuple(w.shape), w.dtype) for w in w3]}, sweeps {sweeps}"
        )
    if packed.data_ptr() % VEC_BYTES:
        raise cuda_lib.KernelError("lane_coarse_smooth3: packed stencils must be 16-byte aligned")
