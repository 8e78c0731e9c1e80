"""CST (constant-strain-triangle) element math, batched over all elements.

PyTorch port of magnetite_tpu/fem/element.py: the same formulas on [E, ...]
tensors, in the dtype and on the device of the coordinates.

  area  A = 0.5*(x0(y1-y2) + x1(y2-y0) + x2(y0-y1))
  B [3,6] from beta_i = y_{i+1}-y_{i+2}, gamma_i = x_{i+2}-x_{i+1}, / 2A
  D [3,3] = E/(1-nu^2) * [[1,nu,0],[nu,1,0],[0,0,(1-nu)/2]]

The banded and ELL stiffness is assembled on the host in C++
(native.amg_assemble) unless assembly="device" asks for the fused device
assembly, whose plain version reads `pair_block_fields`; the device needs
B, D and the areas for stress recovery, and the dense mode the element
stiffness matrices (`element_stiffness_matrices`).
"""

from __future__ import annotations

import torch


def gather_element_coords(coords: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """coords [N,2], tris [E,3] -> [E,3,2] per-element corner coordinates."""
    return coords[tris]


def element_areas(ecoords: torch.Tensor) -> torch.Tensor:
    """Signed areas of all elements. ecoords [E,3,2] -> [E]."""
    x, y = ecoords[..., 0], ecoords[..., 1]
    return 0.5 * (
        x[..., 0] * (y[..., 1] - y[..., 2])
        + x[..., 1] * (y[..., 2] - y[..., 0])
        + x[..., 2] * (y[..., 0] - y[..., 1])
    )


def strain_displacement_matrices(
    ecoords: torch.Tensor, areas: torch.Tensor
) -> torch.Tensor:
    """Batched B matrices. ecoords [E,3,2] -> [E,3,6].

    Row layout (strain = [eps_x, eps_y, gamma_xy]):
      [beta0  0      beta1  0      beta2  0    ]
      [0      gam0   0      gam1   0      gam2 ]   all / (2A)
      [gam0   beta0  gam1   beta1  gam2   beta2]
    """
    x, y = ecoords[..., 0], ecoords[..., 1]
    beta = torch.stack(
        [y[..., 1] - y[..., 2], y[..., 2] - y[..., 0], y[..., 0] - y[..., 1]],
        dim=-1,
    )  # [E,3]
    gamma = torch.stack(
        [x[..., 2] - x[..., 1], x[..., 0] - x[..., 2], x[..., 1] - x[..., 0]],
        dim=-1,
    )
    zero = torch.zeros_like(beta)
    row0 = torch.stack([beta, zero], dim=-1).reshape(*beta.shape[:-1], 6)
    row1 = torch.stack([zero, gamma], dim=-1).reshape(*beta.shape[:-1], 6)
    row2 = torch.stack([gamma, beta], dim=-1).reshape(*beta.shape[:-1], 6)
    b = torch.stack([row0, row1, row2], dim=-2)  # [E,3,6]
    return b / (2.0 * areas)[..., None, None]


def stress_strain_matrix(youngs_modulus, poisson_ratio, dtype, device=None):
    """Plane-stress isotropic D [3,3]."""
    nu = float(poisson_ratio)
    d = torch.tensor(
        [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, (1.0 - nu) / 2.0]],
        dtype=dtype,
        device=device,
    )
    e = torch.tensor(float(youngs_modulus), dtype=dtype, device=device)
    nu_t = torch.tensor(nu, dtype=dtype, device=device)
    return d * (e / (1.0 - nu_t * nu_t))



def element_stiffness_matrices(coords, tris, youngs_modulus, poisson_ratio, part_thickness):
    """All element stiffness matrices ke = B^T D B * A * t, [E, 6, 6].

    The JAX package's two contractions as broadcast products and sums, so
    no TF32 path can reach them."""
    ecoords = gather_element_coords(coords, tris)
    areas = element_areas(ecoords)
    b = strain_displacement_matrices(ecoords, areas)  # [E, 3, 6]
    d = stress_strain_matrix(youngs_modulus, poisson_ratio, coords.dtype, coords.device)
    db = (d[None, :, :, None] * b[:, None, :, :]).sum(dim=2)  # [E, 3, 6]
    ke = (b[:, :, :, None] * db[:, :, None, :]).sum(dim=1)  # [E, 6, 6]
    return ke * (areas * float(part_thickness))[:, None, None]


def material_constants(youngs_modulus, poisson_ratio) -> tuple:
    """(d0, d1, d2): the plane-stress D matrix's distinct entries E / (1 -
    nu^2), nu d0 and (1 - nu) d0 / 2, as Python floats."""
    nu = float(poisson_ratio)
    d0 = float(youngs_modulus) / (1.0 - nu * nu)
    return d0, nu * d0, 0.5 * (1.0 - nu) * d0


def pair_block_fields(coords, tris, youngs_modulus, poisson_ratio, part_thickness):
    """Closed-form per-node-pair stiffness blocks as four scalar fields
    (k00, k01, k10, k11), each [3, 3, E] (a-major, E minormost): the 2x2
    block coupling local nodes (a, b) of every element, without the
    [E, 6, 6] tensor. k_ab = t / (4A) * B_a^T D B_b expanded, in the JAX
    package's order of operations (magnetite_tpu/fem/element.py:81)."""
    p = coords[tris.T]  # [3, E, 2]
    x, y = p[..., 0], p[..., 1]
    beta = torch.stack([y[1] - y[2], y[2] - y[0], y[0] - y[1]])  # [3, E]
    gamma = torch.stack([x[2] - x[1], x[0] - x[2], x[1] - x[0]])
    area2 = x[0] * (y[1] - y[2]) + x[1] * (y[2] - y[0]) + x[2] * (y[0] - y[1])
    # t / (4A) as one rounded division (a Python float over a tensor is a
    # reciprocal and a product in torch: two roundings)
    coef = torch.full_like(area2, float(part_thickness)) / (2.0 * area2)
    d0, d1, d2 = material_constants(youngs_modulus, poisson_ratio)
    ba, bb = beta[:, None, :], beta[None, :, :]  # [3, 3, E]
    ga, gb = gamma[:, None, :], gamma[None, :, :]
    k00 = coef * (d0 * ba * bb + d2 * ga * gb)
    k01 = coef * (d1 * ba * gb + d2 * ga * bb)
    k10 = coef * (d1 * ga * bb + d2 * ba * gb)
    k11 = coef * (d0 * ga * gb + d2 * ba * bb)
    return k00, k01, k10, k11
