"""Fused device assembly: the CUDA kernels of csrc/assemble_pairs.cu and
their plain versions.

    sum[i, j, s] = sum of k_ij(a, b, e) over the pairs with slot_ids[9 e + 3 a + b] == s

k(a, b, e) is the closed-form 2x2 block coupling local nodes a and b of
element e (fem/element.py::pair_block_fields) and `slot_ids` the
structure's a-major slot ids: DIA band slots (S = D N, slot d N + n),
hybrid band + remainder slots (D N + R) or ELL slots (S = N K, slot n K +
k). The JAX package computes this as four `segment_sum`s
(fem/dia.py:210-266, fem/solve.py:919-927) and leaves them to XLA; no
`pallas_call` stands behind it.

`assemble_pairs` is the entry point. It returns the operator's own layout,
(bands [D, 2, 2, N], rem [R, 2, 2]) or, for ELL slots, bands [K, 2, 2,
N], in the caller's dtype: the sums are taken in f64 and rounded once.
CPU operands take the plain version (`pair_block_fields`, four
`index_add_`s, the same layouts); CUDA operands launch the kernels or
raise. On the card the slots' runs are built first (`build_runs`): the
count kernel (`assemble_count`: each element's geometry, the pairs counted
per slot), an inclusive cumsum, the fill kernel (`assemble_fill`: the
pairs grouped by slot); then the assembly kernel sums each run in
pair-major order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import cuda_lib

INT32_MAX = 2**31 - 1


class SlotRuns(NamedTuple):
    """The pairs grouped by slot: slot s's pairs are order[bounds[s]:bounds[s
    + 1]], a-major indices 9 e + 3 a + b (int32; their order within a run
    is not fixed), and geom [E, 8] f64 each element's beta0..2, coef = t /
    (2 A2), gamma0..2 and a zero."""

    bounds: torch.Tensor
    order: torch.Tensor
    geom: torch.Tensor


def pair_major_slots(slot_ids, n_elements: int) -> torch.Tensor:
    """Reorder [E*9] a-major slot ids to the [3, 3, E] pair-major layout of
    element.pair_block_fields (int64; the plain version's scatter index)."""
    return (
        torch.as_tensor(slot_ids).to(torch.int64).reshape(n_elements, 3, 3)
        .permute(1, 2, 0).reshape(-1)
    )


def scatter_fields(fields, slots: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Scatter the four scalar pair fields [3, 3, E] into [2, 2, n_slots]
    by pair-major slot ids (the plain version's scatter: four `index_add_`s;
    JAX's `_scatter_fields`)."""
    out = []
    for k in fields:
        acc = torch.zeros(n_slots, dtype=k.dtype, device=k.device)
        out.append(acc.index_add_(0, slots, k.reshape(-1)))
    k00, k01, k10, k11 = out
    return torch.stack([torch.stack([k00, k01]), torch.stack([k10, k11])])


def operator_layout(flat: torch.Tensor, n_nodes: int, n_bands: int, ell: bool = False,
                    dtype=torch.float64) -> tuple:
    """[2, 2, S] slot sums -> (bands [n_bands, 2, 2, N], rem [S - n_bands N,
    2, 2]) in `dtype`; ELL slots (n K + k) go to [K, 2, 2, N]."""
    band = flat[:, :, : n_bands * n_nodes]
    if ell:
        bands = band.reshape(2, 2, n_nodes, n_bands).permute(3, 0, 1, 2)
    else:
        bands = band.reshape(2, 2, n_bands, n_nodes).permute(2, 0, 1, 3)
    rem = flat[:, :, n_bands * n_nodes:].permute(2, 0, 1)
    return bands.contiguous().to(dtype), rem.contiguous().to(dtype)


def assemble_pairs_plain(coords, tris, slot_ids, n_nodes: int, n_bands: int, youngs_modulus,
                         poisson_ratio, part_thickness, n_rem: int = 0, ell: bool = False,
                         dtype=torch.float64) -> tuple:
    """Plain version: pair_block_fields, four index_add_s, the layout."""
    from ..fem.element import pair_block_fields

    fields = pair_block_fields(coords, tris, youngs_modulus, poisson_ratio, part_thickness)
    slots = pair_major_slots(slot_ids, tris.shape[0]).to(coords.device)
    flat = scatter_fields(fields, slots, n_bands * n_nodes + n_rem)
    return operator_layout(flat, n_nodes, n_bands, ell, dtype)


def slot_runs(slots: torch.Tensor, n_slots: int) -> tuple:
    """(order, starts): the indices of `slots` sorted by slot (stable, so
    each slot's indices stay in order) and each slot's run [starts[s],
    starts[s + 1]) in `order`, int64 on the slots' device (the plain
    version of the fill)."""
    order = torch.sort(slots, stable=True).indices
    counts = torch.bincount(slots, minlength=n_slots)
    starts = torch.zeros(n_slots + 1, dtype=torch.int64, device=slots.device)
    torch.cumsum(counts, 0, out=starts[1:])
    return order, starts


def element_geometry(coords, tris, part_thickness) -> torch.Tensor:
    """[E, 8] f64: each element's beta0..2, coef = t / (2 A2), gamma0..2, 0
    (the count kernel's record; pair_block_fields's order of operations)."""
    p = coords[tris.T]  # [3, E, 2]
    x, y = p[..., 0], p[..., 1]
    beta = [y[1] - y[2], y[2] - y[0], y[0] - y[1]]
    area2 = x[0] * beta[0] + x[1] * beta[1] + x[2] * beta[2]
    coef = torch.full_like(area2, float(part_thickness)) / (2.0 * area2)
    gamma = [x[2] - x[1], x[0] - x[2], x[1] - x[0]]
    return torch.stack([*beta, coef, *gamma, torch.zeros_like(coef)], dim=1)


def assemble_count_plain(coords, tris, slot_ids, n_slots: int, part_thickness) -> tuple:
    """Plain version of the count kernel: (counts [S + 1] int32, the last
    zero, geom [E, 8])."""
    counts = torch.zeros(n_slots + 1, dtype=torch.int32, device=slot_ids.device)
    counts[:n_slots] = torch.bincount(slot_ids.to(torch.int64), minlength=n_slots)
    return counts, element_geometry(coords, tris, part_thickness)


def assemble_fill_plain(slot_ids, bounds) -> torch.Tensor:
    """Plain version of the fill kernel: the a-major pair indices grouped by
    slot (int32, each run in index order); `bounds` (the counts' inclusive
    cumsum) becomes the runs' starts."""
    order, starts = slot_runs(slot_ids.to(torch.int64), bounds.numel() - 1)
    bounds.copy_(starts)
    return order.to(torch.int32)


def _check_sizes(name, n_elem: int, n_slots: int) -> None:
    """The kernels index pairs and slots in int32."""
    if 9 * n_elem > INT32_MAX or n_slots + 1 > INT32_MAX:
        raise cuda_lib.KernelError(
            f"{name}: {n_elem} elements ({9 * n_elem} pairs) and {n_slots} slots; the "
            f"kernels take at most {INT32_MAX} pairs and {INT32_MAX - 1} slots (int32)"
        )


def _mesh_operands(name, coords, tris, slot_ids, n_slots: int) -> tuple:
    """Checked CUDA operands: f64 coords [N, 2] (16-byte aligned), int64
    tris [E, 3], int64 a-major slot ids [9 E]."""
    n_elem = tris.shape[0] if tris.dim() == 2 else -1
    _check_sizes(name, max(n_elem, 0), n_slots)
    coords, tris, slot_ids = coords.contiguous(), tris.contiguous(), slot_ids.contiguous()
    cuda_lib.require_cuda(name, coords.dtype, coords, tris, slot_ids)
    if (
        coords.dtype != torch.float64 or coords.dim() != 2 or coords.shape[1] != 2
        or tris.dtype != torch.int64 or tris.dim() != 2 or tris.shape[1] != 3
        or slot_ids.dtype != torch.int64 or tuple(slot_ids.shape) != (9 * n_elem,)
        or n_elem < 1 or n_slots < 1
    ):
        raise cuda_lib.KernelError(
            f"{name}: coords {tuple(coords.shape)} {coords.dtype}, tris "
            f"{tuple(tris.shape)} {tris.dtype}, slot ids {tuple(slot_ids.shape)} "
            f"{slot_ids.dtype}, {n_slots} slots"
        )
    if coords.data_ptr() % 16:
        coords = coords.clone()
    return coords, tris, slot_ids


def assemble_count(coords, tris, slot_ids, n_slots: int, part_thickness) -> tuple:
    """(counts [S + 1] int32: each slot's pairs, then a zero; geom [E, 8]
    f64). Slot ids outside [0, S) count nowhere on the card."""
    if coords.device.type == "cpu" and slot_ids.device.type == "cpu":
        return assemble_count_plain(coords, tris, slot_ids, n_slots, part_thickness)
    coords, tris, slot_ids = _mesh_operands("assemble_count", coords, tris, slot_ids, n_slots)
    n_elem = tris.shape[0]
    counts = torch.zeros(n_slots + 1, dtype=torch.int32, device=coords.device)
    geom = torch.empty((n_elem, 8), dtype=torch.float64, device=coords.device)
    cuda_lib.launch(
        "assemble_count", "mt_assemble_count", coords, coords.data_ptr(), tris.data_ptr(),
        slot_ids.data_ptr(), n_elem, n_slots, float(part_thickness), geom.data_ptr(),
        counts.data_ptr(),
    )
    return counts, geom


def assemble_fill(slot_ids, bounds) -> torch.Tensor:
    """order [9 E] int32, the a-major pair indices grouped by slot; `bounds`
    [S + 1] int32, each slot's end on entry (the counts' inclusive cumsum),
    holds each slot's start on return. On the card a run's order varies
    from call to call."""
    if slot_ids.device.type == "cpu" and bounds.device.type == "cpu":
        return assemble_fill_plain(slot_ids, bounds)
    n_slots = bounds.numel() - 1
    _check_sizes("assemble_fill", slot_ids.numel() // 9, n_slots)
    cuda_lib.require_cuda("assemble_fill", torch.float64, slot_ids, bounds)  # no float operand
    if slot_ids.dtype != torch.int64 or bounds.dtype != torch.int32 or n_slots < 1 \
            or slot_ids.dim() != 1 or slot_ids.numel() < 1:
        raise cuda_lib.KernelError(
            f"assemble_fill: slot ids {tuple(slot_ids.shape)} {slot_ids.dtype}, bounds "
            f"{tuple(bounds.shape)} {bounds.dtype}"
        )
    order = torch.empty(slot_ids.numel(), dtype=torch.int32, device=slot_ids.device)
    cuda_lib.launch(
        "assemble_fill", "mt_assemble_fill", slot_ids, slot_ids.data_ptr(), slot_ids.numel(),
        n_slots, bounds.data_ptr(), order.data_ptr(),
    )
    return order


def build_runs(coords, tris, slot_ids, n_slots: int, part_thickness) -> SlotRuns:
    """The slots' runs and the elements' geometry: count, cumsum, fill."""
    counts, geom = assemble_count(coords, tris, slot_ids, n_slots, part_thickness)
    bounds = counts.cumsum_(0)
    order = assemble_fill(slot_ids.contiguous(), bounds)
    return SlotRuns(bounds, order, geom)


def assemble_pairs(coords, tris, slot_ids, n_nodes: int, n_bands: int, youngs_modulus,
                   poisson_ratio, part_thickness, n_rem: int = 0, ell: bool = False,
                   dtype=torch.float64, runs: Optional[SlotRuns] = None) -> tuple:
    """(bands [n_bands, 2, 2, N], rem [n_rem, 2, 2]) in `dtype` from f64
    coords [N, 2], int64 tris [E, 3] and the structure's a-major slot ids
    [9 E] (int64 on the card): band slots d N + n then the remainder's, or
    with `ell` slots n K + k (n_bands = K) into [K, 2, 2, N]. `runs`:
    build_runs(coords, tris, slot_ids, S, part_thickness), made here when
    not given."""
    n_slots = n_bands * n_nodes + n_rem
    if coords.device.type == "cpu" and slot_ids.device.type == "cpu":
        return assemble_pairs_plain(coords, tris, slot_ids, n_nodes, n_bands, youngs_modulus,
                                    poisson_ratio, part_thickness, n_rem, ell, dtype)
    _check_sizes("assemble_pairs", tris.shape[0], n_slots)
    if ell and n_rem:
        raise cuda_lib.KernelError("assemble_pairs: ELL slots have no remainder")
    if runs is None:
        runs = build_runs(coords, tris, slot_ids, n_slots, part_thickness)
    n_elem = tris.shape[0]
    bounds, order, geom = runs
    cuda_lib.require_cuda("assemble_pairs", dtype, bounds, order, geom)
    if (
        bounds.dtype != torch.int32 or tuple(bounds.shape) != (n_slots + 1,)
        or order.dtype != torch.int32 or tuple(order.shape) != (9 * n_elem,)
        or geom.dtype != torch.float64 or tuple(geom.shape) != (n_elem, 8)
        or n_nodes < 1 or n_bands < 1 or n_rem < 0
    ):
        raise cuda_lib.KernelError(
            f"assemble_pairs: bounds {tuple(bounds.shape)} {bounds.dtype}, order "
            f"{tuple(order.shape)} {order.dtype}, geom {tuple(geom.shape)} {geom.dtype}; "
            f"{n_elem} elements, {n_nodes} nodes, {n_bands} bands, {n_rem} remainder slots"
        )
    from ..fem.element import material_constants

    dev = geom.device
    bands = torch.empty((n_bands, 2, 2, n_nodes), dtype=dtype, device=dev)
    rem = torch.empty((n_rem, 2, 2), dtype=dtype, device=dev)
    d0, d1, d2 = material_constants(youngs_modulus, poisson_ratio)
    cuda_lib.launch(
        "assemble_pairs", "mt_assemble_runs", geom, cuda_lib.DTYPE_CODES[dtype],
        geom.data_ptr(), order.data_ptr(), bounds.data_ptr(), n_elem, n_slots,
        n_bands * n_nodes, n_nodes, n_bands if ell else 0, d0, d1, d2, bands.data_ptr(),
        rem.data_ptr(),
    )
    return bands, rem
