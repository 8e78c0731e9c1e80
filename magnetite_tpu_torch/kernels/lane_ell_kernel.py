"""Lane-batched block-ELL SpMV: the CUDA kernel `lane_ell_kernel<T, V>`
(csrc/lane_ell_matvec.cu) and its plain version.

    y[i, n, b] = sum_k sum_j ell[n, k, i, j] * u[j, cols[n, k], b]

for y [2, N, B] and u [2, N_u, B], N_u >= N: the operator of the design
sweeps' fallback route for band-hostile meshes (parallel/sweep.py::
_sweep_vmap, N_u = N), and a shard's rows against the whole gathered lane
fields in the all-gather batch solve (parallel/sharding.py::
sharded_batch_pcg_solve, N_u the padded node count). ell [N, W, 2, 2],
cols [N, W] int32; padding slots point at the row's own node and hold zero
blocks. The JAX package computes this function as fem/operator.py's
`ell_matvec` under `jax.vmap` over the lanes, fused by XLA; there is no
`pallas_call` behind it.

`lane_ell_matvec` is the entry point: CPU operands take the plain version,
CUDA operands launch the kernel or raise. It counts its launches in
`.launches`.
"""

from __future__ import annotations

import torch

from . import cuda_lib

# a thread carries VEC_BYTES of consecutive lanes when B and the pointers
# allow it; a team of at most MAX_TEAM threads shares one node
VEC_BYTES, MAX_TEAM = 16, 32


def lane_ell_matvec_plain(ell: torch.Tensor, cols: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain version: a loop over the W slots, y += ell[:, k] . u[:, cols[:, k]],
    so no [2, N, W, B] gather is ever held."""
    y0 = u.new_zeros((cols.shape[0], u.shape[2]))
    y1 = u.new_zeros((cols.shape[0], u.shape[2]))
    for k in range(cols.shape[1]):
        g = u[:, cols[:, k].long()]  # [2, N, B]
        b = ell[:, k, :, :, None]  # [N, 2, 2, 1] broadcast over lanes
        y0 = y0 + b[:, 0, 0] * g[0] + b[:, 0, 1] * g[1]
        y1 = y1 + b[:, 1, 0] * g[0] + b[:, 1, 1] * g[1]
    return torch.stack([y0, y1])


def lane_ell_plan(nb: int, es: int, aligned: bool) -> tuple:
    """(lanes per thread, threads per node) of one launch: 16 bytes of
    lanes per thread when B is a multiple of that and the lane fields are
    16-byte aligned (else one lane), and a team of the least power of two
    covering the node's lane vectors, at most 32 (B = 1 puts 256 nodes in
    a block, B >= 128 f32 one warp per node and lane tile)."""
    vec = VEC_BYTES // es if aligned and nb % (VEC_BYTES // es) == 0 else 1
    nvec = nb // vec
    team = 1
    while team < min(nvec, MAX_TEAM):
        team *= 2
    return vec, team


def _check(name, ell, cols, u):
    cuda_lib.require_cuda(name, u.dtype, ell, cols, u)
    n, w = cols.shape if cols.dim() == 2 else (-1, -1)
    bad = (
        cols.dtype != torch.int32 or ell.dtype != u.dtype or w < 1
        or tuple(ell.shape) != (n, w, 2, 2)
        or u.dim() != 3 or u.shape[0] != 2 or u.shape[1] < n or u.shape[2] < 1
    )
    if bad:
        raise cuda_lib.KernelError(
            f"{name}: ell {tuple(ell.shape)} {ell.dtype}, cols {tuple(cols.shape)} "
            f"{cols.dtype}, u {tuple(u.shape)} {u.dtype}"
        )
    return n, w, u.shape[2]


def lane_ell_matvec(ell: torch.Tensor, cols: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y = K u for block-ELL ell [N, W, 2, 2] / cols [N, W] int32 (each in
    [0, N_u)) and lane fields u [2, N_u, B], N_u >= N, f32 or f64, any
    B >= 1 and W >= 1; y is [2, N, B]."""
    if u.device.type == "cpu" and ell.device.type == "cpu":
        return lane_ell_matvec_plain(ell, cols, u)
    u = u.contiguous()
    n, w, nb = _check("lane_ell_matvec", ell, cols, u)
    y = torch.empty((2, n, nb), dtype=u.dtype, device=u.device)
    aligned = u.data_ptr() % VEC_BYTES == 0 and y.data_ptr() % VEC_BYTES == 0
    vec, team = lane_ell_plan(nb, u.element_size(), aligned)
    cuda_lib.launch(
        "lane_ell_matvec", "mt_lane_ell_matvec", u,
        cuda_lib.DTYPE_CODES[u.dtype], vec, team, ell.data_ptr(), cols.data_ptr(),
        u.data_ptr(), y.data_ptr(), n, u.shape[1], w, nb,
    )
    lane_ell_matvec.launches += 1
    return y


lane_ell_matvec.launches = 0
