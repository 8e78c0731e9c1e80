"""Plain float64 plane-stress finite elements: the benchmark's reference.

Linear (constant-strain) triangles under plane stress, written from the
textbook element and nothing else: NumPy and SciPy only. It imports no
module of the program under test, and it takes from a run only the mesh
that the run solved on and the answers that it judges.

    B_e = 1 / (2 A) [[b0, 0, b1, 0, b2, 0], [0, c0, 0, c1, 0, c2],
                     [c0, b0, c1, b1, c2, b2]]
    b_i = y_j - y_k,  c_i = x_k - x_j  (i, j, k cyclic),  2 A = signed area x 2
    D   = E / (1 - nu^2) [[1, nu, 0], [nu, 1, 0], [0, 0, (1 - nu) / 2]]
    K_e = t |A| B_e^T D B_e,  sigma_e = D B_e u_e

The operator is applied element by element (`apply_stiffness`): K u is
the sum over elements of t |A| B_e^T sigma_e scattered to the element's
nodes, which is K assembled and multiplied, without holding K.
`stiffness_matrix` assembles K itself (SciPy COO) for small meshes.
"""

from __future__ import annotations

import numpy as np


def element_geometry(coords: np.ndarray, tris: np.ndarray):
    """(b [E, 3], c [E, 3], twice the signed areas [E]) of every element."""
    x = coords[:, 0][tris]
    y = coords[:, 1][tris]
    b = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], axis=1)
    c = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], axis=1)
    area2 = x[:, 0] * b[:, 0] + x[:, 1] * b[:, 1] + x[:, 2] * b[:, 2]
    return b, c, area2


def elasticity(youngs_modulus: float, poisson_ratio: float) -> np.ndarray:
    """The plane-stress D [3, 3]."""
    nu = float(poisson_ratio)
    return (float(youngs_modulus) / (1.0 - nu * nu)) * np.array(
        [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, (1.0 - nu) / 2.0]]
    )


def strain_matrices(coords: np.ndarray, tris: np.ndarray) -> tuple:
    """(B [E, 3, 6], twice the signed areas [E])."""
    b, c, area2 = element_geometry(coords, tris)
    e = tris.shape[0]
    bm = np.zeros((e, 3, 6))
    bm[:, 0, 0::2] = b
    bm[:, 1, 1::2] = c
    bm[:, 2, 0::2] = c
    bm[:, 2, 1::2] = b
    return bm / area2[:, None, None], area2


def stresses(coords, tris, u, youngs_modulus, poisson_ratio, rows: int = 1 << 18):
    """sigma [E, 3] = [sx, sy, txy] of every element, from u [N, 2], in
    blocks of `rows` elements."""
    d = elasticity(youngs_modulus, poisson_ratio)
    out = np.empty((tris.shape[0], 3))
    for s in range(0, tris.shape[0], rows):
        t = tris[s : s + rows]
        bm, _ = strain_matrices(coords, t)
        strain = np.einsum("erj,ej->er", bm, u[t].reshape(t.shape[0], 6))
        out[s : s + rows] = strain @ d.T
    return out


def apply_stiffness(coords, tris, u, youngs_modulus, poisson_ratio, thickness,
                    rows: int = 1 << 18) -> np.ndarray:
    """K u [N, 2] for u [N, 2], element by element."""
    d = elasticity(youngs_modulus, poisson_ratio)
    n = coords.shape[0]
    out = np.zeros(2 * n)
    for s in range(0, tris.shape[0], rows):
        t = tris[s : s + rows]
        bm, area2 = strain_matrices(coords, t)
        sigma = np.einsum("erj,ej->er", bm, u[t].reshape(t.shape[0], 6)) @ d.T
        fe = np.einsum("erj,er->ej", bm, sigma) * (thickness * 0.5 * np.abs(area2))[:, None]
        dofs = (2 * t[:, :, None] + np.arange(2)).reshape(-1, 6)
        out += np.bincount(dofs.ravel(), weights=fe.ravel(), minlength=2 * n)
    return out.reshape(n, 2)


def stiffness_matrix(coords, tris, youngs_modulus, poisson_ratio, thickness):
    """The assembled K (SciPy CSR, 2N x 2N, dofs node-major) of a small mesh."""
    from scipy.sparse import coo_matrix

    d = elasticity(youngs_modulus, poisson_ratio)
    bm, area2 = strain_matrices(coords, tris)
    ke = np.einsum("eri,erj->eij", bm, np.einsum("rs,esj->erj", d, bm))
    ke *= (thickness * 0.5 * np.abs(area2))[:, None, None]
    dofs = (2 * tris[:, :, None] + np.arange(2)).reshape(-1, 6)
    rows = np.repeat(dofs, 6, axis=1).ravel()
    cols = np.tile(dofs, (1, 6)).ravel()
    n2 = 2 * coords.shape[0]
    return coo_matrix((ke.ravel(), (rows, cols)), shape=(n2, n2)).tocsr()


def scalar_stress(sigma: np.ndarray, sign_threshold: float = 1.0) -> np.ndarray:
    """sqrt(sx^2 + sy^2), negative where sx + sy < sign_threshold."""
    mag = np.hypot(sigma[:, 0], sigma[:, 1])
    return np.where(sigma[:, 0] + sigma[:, 1] < sign_threshold, -mag, mag)


def von_mises(sigma: np.ndarray) -> np.ndarray:
    """sqrt(sx^2 - sx sy + sy^2 + 3 txy^2)."""
    sx, sy, txy = sigma[:, 0], sigma[:, 1], sigma[:, 2]
    return np.sqrt(sx * sx - sx * sy + sy * sy + 3.0 * txy * txy)
