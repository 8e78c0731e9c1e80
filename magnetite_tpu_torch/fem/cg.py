"""Preconditioned conjugate gradient on the device (port of
magnetite_tpu/fem/cg.py::pcg).

The JAX loop is a `lax.while_loop` that never leaves the device. Here the
loop is Python, and its state -- including a device-side `active` flag --
stays on the device: an iteration run after the stopping test has been met
is a no-op (alpha is zeroed, p / rz / the counter are held), so `iterations`
is exactly what the JAX loop reports. The host reads the flag once every
CHECK_EVERY iterations, which is the only synchronisation in the loop.

Stopping rule and breakdown guards as in the JAX package:
||r|| <= max(rtol * ||b||, atol); alpha = 0 when p.Ap <= 0; rz == 0 is
replaced by 1 in beta's denominator.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

MatVec = Callable[[torch.Tensor], torch.Tensor]

# iterations between host reads of the device-side convergence flag; up to
# CHECK_EVERY - 1 frozen iterations run after convergence
CHECK_EVERY = 16


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # int64 scalar, on the device
    residual_norm: torch.Tensor  # final ||r||_2
    converged: torch.Tensor  # bool scalar


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def pcg(
    matvec: MatVec,
    b: torch.Tensor,
    *,
    preconditioner: Optional[MatVec] = None,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1e-10,
    atol: float = 0.0,
    maxiter: int = 10_000_000,
) -> CGResult:
    """Solve A x = b for SPD A."""
    m = preconditioner if preconditioner is not None else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = m(r)
    p = z
    rz = _dot(r, z)
    rnorm2 = _dot(r, r)
    bnorm = torch.sqrt(_dot(b, b))
    threshold = torch.clamp(rtol * bnorm, min=atol)
    thresh2 = threshold * threshold
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    steps = 0
    while steps < maxiter:
        for _ in range(min(CHECK_EVERY, maxiter - steps)):
            active = rnorm2 > thresh2
            ap = matvec(p)
            pap = _dot(p, ap)
            alpha = torch.where(
                (pap > 0) & active, rz / torch.where(pap == 0, one, pap), zero
            )
            x = x + alpha * p
            r = r - alpha * ap
            z = m(r)
            rz_new = _dot(r, z)
            beta = rz_new / torch.where(rz == 0, one, rz)
            p = torch.where(active, z + beta * p, p)
            rz = torch.where(active, rz_new, rz)
            rnorm2 = torch.where(active, _dot(r, r), rnorm2)
            k = k + active.to(torch.int64)
            steps += 1
        if not bool(rnorm2 > thresh2):
            break
    return CGResult(
        x=x,
        iterations=k,
        residual_norm=torch.sqrt(rnorm2),
        converged=rnorm2 <= thresh2,
    )
