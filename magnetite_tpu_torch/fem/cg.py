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

A warm solve replays the loop from CUDA graphs (`PCGGraph`): the host
then issues one graph launch and one read per CHECK_EVERY iterations
instead of every kernel of them.
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


class _State(NamedTuple):
    """The PCG iteration's state, all on the device."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    rnorm2: torch.Tensor
    k: torch.Tensor  # int64 scalar: the active iterations so far


def _start(matvec, m, b, x0, rtol, atol, dot):
    """The state before the first iteration, ||b|| and the squared stopping
    threshold."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = m(r)
    rz = dot(r, z)
    rnorm2 = dot(r, r)
    bnorm = torch.sqrt(dot(b, b))
    threshold = torch.clamp(rtol * bnorm, min=atol)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    return _State(x, r, z, rz, rnorm2, k), bnorm, threshold * threshold


def _step(matvec, m, dot, s: _State, thresh2, one, zero):
    """One iteration from state s: (the next state, whether it was active).
    A frozen iteration (the stopping test met) holds every value."""
    active = s.rnorm2 > thresh2
    ap = matvec(s.p)
    pap = dot(s.p, ap)
    alpha = torch.where(
        (pap > 0) & active, s.rz / torch.where(pap == 0, one, pap), zero
    )
    x = s.x + alpha * s.p
    r = s.r - alpha * ap
    z = m(r)
    rz_new = dot(r, z)
    beta = rz_new / torch.where(s.rz == 0, one, s.rz)
    p = torch.where(active, z + beta * s.p, s.p)
    rz = torch.where(active, rz_new, s.rz)
    rnorm2 = torch.where(active, dot(r, r), s.rnorm2)
    return _State(x, r, p, rz, rnorm2, s.k + active.to(torch.int64)), active


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
    graph: Optional["PCGGraph"] = None,
) -> CGResult:
    """Solve A x = b for SPD A.

    `history` > 0 records ||r|| after each of the first `history`
    iterations. `progress_every` > 0 calls `progress_callback(k, ||r||,
    ||b||)` (default: a log-line printer) after every iteration k that is
    a multiple of it, up to the converged one: one host read each.

    `dot(a, b)` is the inner product (the JAX package's hook): the sharded
    solve passes the sum over shards and a node-sharded vector type
    (parallel/dia_shard.py::ShardVec) as b; the scalars stay on b.device.

    `graph`, a PCGGraph, replays the loop from CUDA graphs where it takes
    the call's vectors (`PCGGraph.takes`); the loop's body and its results
    are the same. The caller passes one only for a CUDA solve with no
    `history` or `progress_every` (fem/solve.SolveGraphs.bind). Each chunk
    of iterations run here is the span `cg.chunk`."""
    m = preconditioner if preconditioner is not None else (lambda r: r)
    if graph is not None and graph.takes(b, x0):
        return graph.solve(matvec, m, b, x0, rtol, atol, maxiter, dot)
    s, bnorm, thresh2 = _start(matvec, m, b, x0, rtol, atol, dot)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    hist = empty_history(history, b)
    slots = torch.arange(history, device=b.device) if history else None
    callback = progress_callback or default_progress_printer
    reporting = progress_every > 0

    steps = 0
    while steps < maxiter:
        with span("cg.chunk"):
            for _ in range(min(CHECK_EVERY, maxiter - steps)):
                k = s.k
                s, active = _step(matvec, m, dot, s, thresh2, one, zero)
                if history:
                    # entry k is the residual after iteration k + 1
                    hist = torch.where((slots == k) & active, torch.sqrt(s.rnorm2), hist)
                steps += 1
                if reporting and steps % progress_every == 0:
                    # one host read: k falls behind `steps` once converged, and
                    # frozen iterations report nothing
                    with span("solve.wait"):
                        done, rnorm, bn = (
                            torch.stack([s.k.to(b.dtype), torch.sqrt(s.rnorm2), bnorm])
                            .cpu().tolist()
                        )
                    if int(done) < steps:
                        reporting = False
                    else:
                        callback(steps, rnorm, bn)
        with span("solve.wait"):
            pending = bool(s.rnorm2 > thresh2)
        if not pending:
            break
    return CGResult(
        x=s.x,
        iterations=s.k,
        residual_norm=torch.sqrt(s.rnorm2),
        converged=s.rnorm2 <= thresh2,
        history=hist,
    )


def _distinct(s: _State, *taken) -> _State:
    """s with each field that shares memory with an earlier field, or with
    one of `taken`, cloned in its own layout. Without a preconditioner the
    set-up's p is its r, one tensor: a chunk that copies its state back
    field by field needs each field in memory of its own."""
    seen = {t.untyped_storage().data_ptr() for t in taken if t is not None}
    fields = []
    for t in s:
        ptr = t.untyped_storage().data_ptr()
        fields.append(t.clone() if ptr in seen else t)
        seen.add(ptr)
    return _State(*fields)


class PCGGraph:
    """`pcg`'s loop on one CUDA device as two CUDA graphs: its set-up (the
    initial residual, its preconditioning and the dots) and one chunk of
    CHECK_EVERY iterations, V-cycles included. Both are captured at the
    first call and replayed by every later one. The graphs read static
    buffers (the right-hand side and x0) that each call refills with
    `copy_`; the set-up graph writes the state, and the chunk ends by
    copying its state back, so replaying it again continues the iteration.
    The host reads the convergence flag between chunks, as the eager loop
    does. The captured code is `_start` and `_step`, the eager loop's own,
    and the state keeps the eager loop's memory layouts (a reduction's
    order follows its operand's layout), so a replayed solve gives the
    eager solve's bits.

    The matvec and the preconditioner of the first call are captured: the
    caller passes closures over tensors that stay (the system's operator
    and the static copies of its per-solve tensors), never over tensors of
    one solve. Spans: `cg.capture` for each graph captured, `cg.replay`
    for each replay, `cg.chunk` for a last chunk shorter than CHECK_EVERY
    (run eagerly on the static state). `kernels.cuda_lib.launches`
    counts the wrappers' calls: a capture counts its kernels once, a
    replay nothing."""

    def __init__(self, pool):
        self.pool = pool  # the owner's memory pool (torch.cuda.graph_pool_handle)
        self.stream = None  # the side stream of the captures
        self.b = self.x0 = self.one = self.zero = None
        self.state = self.thresh2 = None  # written by the set-up graph
        self.start = self.chunk = None  # torch.cuda.CUDAGraph

    def takes(self, b, x0) -> bool:
        """Whether this call replays: any call before the first capture;
        after it, vectors of the captured shape, dtype, device and layout,
        x0 given or not as at capture."""
        if self.b is None:
            return True
        return (
            (b.shape, b.stride(), b.dtype, b.device)
            == (self.b.shape, self.b.stride(), self.b.dtype, self.b.device)
            and (x0 is None) == (self.x0 is None)
        )

    def _capture(self, body):
        graph = torch.cuda.CUDAGraph()
        with span("cg.capture"):
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                body()
        return graph

    @staticmethod
    def _replay(graph):
        with span("cg.replay"):
            graph.replay()

    def _iterate(self, matvec, m, dot, n) -> bool:
        """n iterations from the static state, written back into it;
        whether the state came out in the layouts it went in with."""
        s = self.state
        for _ in range(n):
            s, _ = _step(matvec, m, dot, s, self.thresh2, self.one, self.zero)
        for dst, src in zip(self.state, s):
            dst.copy_(src)
        return all(dst.stride() == src.stride() for dst, src in zip(self.state, s))

    def solve(self, matvec, m, b, x0, rtol, atol, maxiter, dot) -> CGResult:
        """The loop from the graphs."""
        if self.b is None:
            # empty_like keeps the layout: the eager loop's reductions see it
            self.stream = torch.cuda.Stream(b.device)
            self.b = torch.empty_like(b)
            self.x0 = None if x0 is None else torch.empty_like(x0)
            self.one = torch.ones((), dtype=b.dtype, device=b.device)
            self.zero = torch.zeros((), dtype=b.dtype, device=b.device)
        self.b.copy_(b)
        if x0 is not None:
            self.x0.copy_(x0)
        if self.start is None:
            def start():
                # the set-up's own outputs are the state: the eager layouts
                s, _, self.thresh2 = _start(matvec, m, self.b, self.x0, rtol, atol, dot)
                self.state = _distinct(s, self.b, self.x0)

            self.start = self._capture(start)
        self._replay(self.start)
        steps = 0
        while steps < maxiter:
            n = min(CHECK_EVERY, maxiter - steps)
            if n == CHECK_EVERY:
                if self.chunk is None:
                    stable = []
                    self.chunk = self._capture(
                        lambda: stable.append(self._iterate(matvec, m, dot, n))
                    )
                    # replays from a layout that moved would sum in other
                    # orders than the eager loop
                    assert stable[0], "the PCG state changed its memory layout in a chunk"
                self._replay(self.chunk)
            else:
                with span("cg.chunk"):
                    self._iterate(matvec, m, dot, n)
            steps += n
            with span("solve.wait"):
                pending = bool(self.state.rnorm2 > self.thresh2)
            if not pending:
                break
        s = self.state
        # copies: the next call overwrites the static state
        return CGResult(
            x=s.x.clone(),
            iterations=s.k.clone(),
            residual_norm=torch.sqrt(s.rnorm2),
            converged=s.rnorm2 <= self.thresh2,
            history=empty_history(0, b),
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
