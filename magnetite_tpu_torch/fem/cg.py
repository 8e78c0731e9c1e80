"""Preconditioned conjugate gradient on the device (port of
magnetite_tpu/fem/cg.py: `pcg`, and `pcg_fixed_iterations` for sweeps).

The JAX loop is a `lax.while_loop` that never leaves the device. Here the
loop is Python, and its state -- including a device-side `active` flag --
stays on the device: an iteration run after the stopping test has been met
is a no-op (alpha is zeroed, p / rz / the counter are held), so `iterations`
is exactly what the JAX loop reports. The host reads the flag once every
CHECK_EVERY iterations, which is the only synchronisation in the loop (the
span `solve.wait`, as is each progress read).

Stopping rule and breakdown guards as in the JAX package:
||r|| <= max(rtol * ||b||, atol); alpha = 0 when p.Ap <= 0; rz == 0 is
replaced by 1 in beta's denominator.

Observability, as the JAX package's `history` / `progress_every`: the
residual history is a device buffer written under a device-side mask (the
entry of the active iteration k, never in a frozen one), and progress
reads the host once every `progress_every` iterations, printing JAX's
iteration numbers. With both off the loop is exactly the plain one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.logging import span

MatVec = Callable[[torch.Tensor], torch.Tensor]

# iterations between host reads of the device-side convergence flag; up to
# CHECK_EVERY - 1 frozen iterations run after convergence
CHECK_EVERY = 16


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # int64 scalar, on the device
    residual_norm: torch.Tensor  # final ||r||_2
    converged: torch.Tensor  # bool scalar
    # ||r|| of the first `history` active iterations, shape [history] (0-size
    # when not requested); entries past `iterations` keep the init value 0
    history: Optional[torch.Tensor] = None


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def empty_history(history: int, b: torch.Tensor) -> torch.Tensor:
    """`history` zeros in b's dtype (no allocation kernel when 0)."""
    if not history:
        return torch.empty(0, dtype=b.dtype, device=b.device)
    return torch.zeros(history, dtype=b.dtype, device=b.device)


def default_progress_printer(k, rnorm, bnorm):
    """Host-side observer: one log line per reporting interval (the JAX
    package's text)."""
    print(
        f"info: cg iteration {int(k)}: residual {float(rnorm):.6e} "
        f"(relative {float(rnorm) / max(float(bnorm), 1e-300):.3e})",
        flush=True,
    )


def pcg(
    matvec: MatVec,
    b: torch.Tensor,
    *,
    preconditioner: Optional[MatVec] = None,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1e-10,
    atol: float = 0.0,
    maxiter: int = 10_000_000,
    history: int = 0,
    progress_every: int = 0,
    progress_callback: Optional[Callable] = None,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = _dot,
) -> CGResult:
    """Solve A x = b for SPD A.

    `history` > 0 records ||r|| after each of the first `history`
    iterations. `progress_every` > 0 calls `progress_callback(k, ||r||,
    ||b||)` (default: a log-line printer) after every iteration k that is
    a multiple of it, up to the converged one: one host read each.

    `dot(a, b)` is the inner product (the JAX package's hook): the sharded
    solve passes the sum over shards and a node-sharded vector type
    (parallel/dia_shard.py::ShardVec) as b; the scalars stay on b.device."""
    m = preconditioner if preconditioner is not None else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = m(r)
    p = z
    rz = dot(r, z)
    rnorm2 = dot(r, r)
    bnorm = torch.sqrt(dot(b, b))
    threshold = torch.clamp(rtol * bnorm, min=atol)
    thresh2 = threshold * threshold
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    hist = empty_history(history, b)
    slots = torch.arange(history, device=b.device) if history else None
    callback = progress_callback or default_progress_printer
    reporting = progress_every > 0

    steps = 0
    while steps < maxiter:
        for _ in range(min(CHECK_EVERY, maxiter - steps)):
            active = rnorm2 > thresh2
            ap = matvec(p)
            pap = dot(p, ap)
            alpha = torch.where(
                (pap > 0) & active, rz / torch.where(pap == 0, one, pap), zero
            )
            x = x + alpha * p
            r = r - alpha * ap
            z = m(r)
            rz_new = dot(r, z)
            beta = rz_new / torch.where(rz == 0, one, rz)
            p = torch.where(active, z + beta * p, p)
            rz = torch.where(active, rz_new, rz)
            rnorm2 = torch.where(active, dot(r, r), rnorm2)
            if history:
                # entry k is the residual after iteration k + 1
                hist = torch.where((slots == k) & active, torch.sqrt(rnorm2), hist)
            k = k + active.to(torch.int64)
            steps += 1
            if reporting and steps % progress_every == 0:
                # one host read: k falls behind `steps` once converged, and
                # frozen iterations report nothing
                with span("solve.wait"):
                    done, rnorm, bn = (
                        torch.stack([k.to(b.dtype), torch.sqrt(rnorm2), bnorm]).cpu().tolist()
                    )
                if int(done) < steps:
                    reporting = False
                else:
                    callback(steps, rnorm, bn)
        with span("solve.wait"):
            pending = bool(rnorm2 > thresh2)
        if not pending:
            break
    return CGResult(
        x=x,
        iterations=k,
        residual_norm=torch.sqrt(rnorm2),
        converged=rnorm2 <= thresh2,
        history=hist,
    )


def pcg_fixed_iterations(
    matvec: MatVec,
    b: torch.Tensor,
    *,
    preconditioner: Optional[MatVec] = None,
    x0: Optional[torch.Tensor] = None,
    iterations: int = 100,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = _dot,
) -> CGResult:
    """Fixed-iteration PCG (port of magnetite_tpu/fem/cg.py::
    pcg_fixed_iterations): the shape for lane-batched sweeps, where a
    per-lane stop would serialize on the slowest lane anyway. `dot` may
    reduce to one value per lane ([2, N, B] -> [B]); alpha and beta then
    broadcast over the trailing lane axis. The loop never reads the host."""
    m = preconditioner if preconditioner is not None else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = m(r)
    p = z
    rz = dot(r, z)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _ in range(iterations):
        ap = matvec(p)
        pap = dot(p, ap)
        alpha = torch.where(pap > 0, rz / torch.where(pap == 0, one, pap), zero)
        x = x + alpha * p
        r = r - alpha * ap
        z = m(r)
        rz_new = dot(r, z)
        beta = torch.where(rz == 0, zero, rz_new / torch.where(rz == 0, one, rz))
        p = z + beta * p
        rz = rz_new
    # TRUE final residual, not the recursion's r (which keeps shrinking
    # below the working precision's stagnation level and would overstate
    # convergence by orders of magnitude in f32 sweeps)
    r_true = b - matvec(x)
    return CGResult(
        x=x,
        iterations=torch.tensor(int(iterations), device=b.device),
        residual_norm=torch.sqrt(dot(r_true, r_true)),
        converged=torch.ones((), dtype=torch.bool, device=b.device),
    )
