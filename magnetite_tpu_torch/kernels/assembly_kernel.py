"""Fused device assembly: the CUDA kernel `assemble_pairs_kernel`
(csrc/assemble_pairs.cu) and its plain version.

    out[i, j, s] = sum of k_ij(a, b, e) over the pairs with slots[(3a + b) E + e] == s

k(a, b, e) is the closed-form 2x2 block coupling local nodes a and b of
element e (fem/element.py::pair_block_fields) and `slots` the operator's
pair-major slot ids (fem/dia.py::_pair_major_slots): DIA band slots
(S = D N), hybrid band + remainder slots (D N + R) or ELL slots (N K).
out [2, 2, S] is f64. The JAX package computes this as four
`segment_sum`s (fem/dia.py:210-266, fem/solve.py:919-927) and leaves them
to XLA; no `pallas_call` stands behind it.

`assemble_pairs` is the entry point: CPU operands take the plain version
(`pair_block_fields` and four `index_add_`s), CUDA operands launch the
kernel or raise. The kernel needs the slot ids sorted (`slot_runs`: one
stable sort, a bincount and a cumsum, on the slot ids' device), which the
wrapper makes when not given them. It counts its launches in `.launches`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib


def scatter_fields(fields, slots: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Scatter the four scalar pair fields [3, 3, E] into [2, 2, n_slots]
    (the plain version's scatter: four `index_add_`s; JAX's
    `_scatter_fields`)."""
    out = []
    for k in fields:
        acc = torch.zeros(n_slots, dtype=k.dtype, device=k.device)
        out.append(acc.index_add_(0, slots, k.reshape(-1)))
    k00, k01, k10, k11 = out
    return torch.stack([torch.stack([k00, k01]), torch.stack([k10, k11])])


def assemble_pairs_plain(coords, tris, slots, n_slots: int, youngs_modulus,
                         poisson_ratio, part_thickness) -> torch.Tensor:
    """Plain version: pair_block_fields, then four index_add_s."""
    from ..fem.element import pair_block_fields

    fields = pair_block_fields(coords, tris, youngs_modulus, poisson_ratio, part_thickness)
    return scatter_fields(fields, slots, n_slots)


def slot_runs(slots: torch.Tensor, n_slots: int) -> tuple:
    """(order, starts): the pair-major indices sorted by slot (stable, so
    each slot's pairs stay in pair-major order) and each slot's run
    [starts[s], starts[s + 1]) in `order`, int64 on the slots' device."""
    order = torch.sort(slots, stable=True).indices
    counts = torch.bincount(slots, minlength=n_slots)
    starts = torch.zeros(n_slots + 1, dtype=torch.int64, device=slots.device)
    torch.cumsum(counts, 0, out=starts[1:])
    return order, starts


def assemble_pairs(coords, tris, slots, n_slots: int, youngs_modulus, poisson_ratio,
                   part_thickness, runs: Optional[tuple] = None) -> torch.Tensor:
    """[2, 2, n_slots] f64 assembly of f64 coords [N, 2], int64 tris
    [E, 3] and int64 pair-major slot ids [9 E]. `runs`: slot_runs(slots,
    n_slots), made here when not given."""
    if coords.device.type == "cpu" and slots.device.type == "cpu":
        return assemble_pairs_plain(coords, tris, slots, n_slots, youngs_modulus,
                                    poisson_ratio, part_thickness)
    coords, tris, slots = coords.contiguous(), tris.contiguous(), slots.contiguous()
    order, starts = slot_runs(slots, n_slots) if runs is None else runs
    cuda_lib.require_cuda("assemble_pairs", coords.dtype, coords, tris, slots, order, starts)
    n_elem = tris.shape[0] if tris.dim() == 2 else -1
    if (
        coords.dtype != torch.float64 or coords.dim() != 2 or coords.shape[1] != 2
        or tris.dtype != torch.int64 or tris.dim() != 2 or tris.shape[1] != 3
        or slots.dtype != torch.int64 or tuple(slots.shape) != (9 * n_elem,)
        or order.dtype != torch.int64 or tuple(order.shape) != (9 * n_elem,)
        or starts.dtype != torch.int64 or tuple(starts.shape) != (n_slots + 1,)
        or n_elem < 1 or n_slots < 1
    ):
        raise cuda_lib.KernelError(
            f"assemble_pairs: coords {tuple(coords.shape)} {coords.dtype}, tris "
            f"{tuple(tris.shape)} {tris.dtype}, slots {tuple(slots.shape)} {slots.dtype}, "
            f"order {tuple(order.shape)}, starts {tuple(starts.shape)}, {n_slots} slots"
        )
    from ..fem.element import material_constants

    out = torch.empty((2, 2, n_slots), dtype=torch.float64, device=coords.device)
    d0, d1, d2 = material_constants(youngs_modulus, poisson_ratio)
    cuda_lib.launch(
        "assemble_pairs", "mt_assemble_pairs", coords,
        coords.data_ptr(), tris.data_ptr(), order.data_ptr(), starts.data_ptr(), n_elem,
        n_slots, d0, d1, d2, float(part_thickness), out.data_ptr(),
    )
    assemble_pairs.launches += 1
    return out


assemble_pairs.launches = 0
