"""Preconditioned conjugate gradient on the device (port of
magnetite_tpu/fem/cg.py: `pcg`, and `pcg_fixed_iterations` for sweeps).

The JAX loop is a `lax.while_loop` that never leaves the device. Here the
loop is Python, and its state -- including a device-side `active` flag --
stays on the device: an iteration run after the stopping test has been met
is a no-op (alpha is zeroed, p / rz / the counter are held), so `iterations`
is exactly what the JAX loop reports. The eager loop reads the flag once
every CHECK_EVERY iterations, which is its only synchronisation (the span
`solve.wait`, as is each progress read).

Stopping rule and breakdown guards as in the JAX package:
||r|| <= max(rtol * ||b||, atol); alpha = 0 when p.Ap <= 0; rz == 0 is
replaced by 1 in beta's denominator.

Observability, as the JAX package's `history` / `progress_every`: the
residual history is a device buffer written under a device-side mask (the
entry of the active iteration k, never in a frozen one), and progress
reads the host once every `progress_every` iterations, printing JAX's
iteration numbers. With both off the loop is exactly the plain one.

A warm solve replays the loop from CUDA graphs (`PCGGraph`): the host
issues one graph launch an iteration instead of every kernel of it, and
reads each iteration's flag while the next one runs, so a replayed call
issues at most one iteration past convergence.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.logging import span

MatVec = Callable[[torch.Tensor], torch.Tensor]

# iterations between host reads of the device-side convergence flag in the
# eager loop (up to CHECK_EVERY - 1 frozen iterations run after convergence)
CHECK_EVERY = 16


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # int64 scalar, on the device
    residual_norm: torch.Tensor  # final ||r||_2
    converged: torch.Tensor  # bool scalar
    # ||r|| of the first `history` active iterations, shape [history] (0-size
    # when not requested); entries past `iterations` keep the init value 0
    history: Optional[torch.Tensor] = None
    # iterations issued on the device, frozen ones included (0 where the
    # caller did not count them)
    issued: int = 0


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


def _step(matvec, m, dot, s: _State, thresh2, one, zero, out: Optional[_State] = None):
    """One iteration from state s: (the next state, whether it was active).
    A frozen iteration (the stopping test met) holds every value. With
    `out`, a state of tensors of their own in s's layouts, each field's last
    operation writes the next state into out's tensor: the same arithmetic,
    and no copy."""
    active = s.rnorm2 > thresh2
    ap = matvec(s.p)
    pap = dot(s.p, ap)
    alpha = torch.where(
        (pap > 0) & active, s.rz / torch.where(pap == 0, one, pap), zero
    )
    if out is None:
        x = s.x + alpha * s.p
        r = s.r - alpha * ap
    else:
        x = torch.add(s.x, alpha * s.p, out=out.x)
        r = torch.sub(s.r, alpha * ap, out=out.r)
    z = m(r)
    rz_new = dot(r, z)
    beta = rz_new / torch.where(s.rz == 0, one, s.rz)
    if out is None:
        p = torch.where(active, z + beta * s.p, s.p)
        rz = torch.where(active, rz_new, s.rz)
        rnorm2 = torch.where(active, dot(r, r), s.rnorm2)
        k = s.k + active.to(torch.int64)
    else:
        p = torch.where(active, z + beta * s.p, s.p, out=out.p)
        rz = torch.where(active, rz_new, s.rz, out=out.rz)
        rnorm2 = torch.where(active, dot(r, r), s.rnorm2, out=out.rnorm2)
        k = torch.add(s.k, active.to(torch.int64), out=out.k)
    return _State(x, r, p, rz, rnorm2, k), active


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
        issued=steps,
    )


def _distinct(s: _State, *taken) -> _State:
    """s with each field that shares memory with an earlier field, or with
    one of `taken`, cloned in its own layout. Without a preconditioner the
    set-up's p is its r, one tensor: a graph that writes its state field by
    field needs each field in memory of its own."""
    seen = {t.untyped_storage().data_ptr() for t in taken if t is not None}
    fields = []
    for t in s:
        ptr = t.untyped_storage().data_ptr()
        fields.append(t.clone() if ptr in seen else t)
        seen.add(ptr)
    return _State(*fields)


def _same_layouts(a: _State, b: _State) -> bool:
    return all(u.stride() == v.stride() for u, v in zip(a, b))


class _Graph(NamedTuple):
    """A captured CUDA graph, the state it writes, and that state's stop
    flag (rnorm2 > thresh2, a device bool written last in the graph)."""

    graph: torch.cuda.CUDAGraph
    state: _State
    flag: torch.Tensor


class PCGGraph:
    """`pcg`'s loop on one CUDA device from CUDA graphs, V-cycles included:
    its set-up (the initial residual, its preconditioning and the dots),
    which writes the static state A; one iteration from A into a second
    static state B, and one from B back into A. Each graph is captured at
    its first use and replayed by every later call. The graphs read static
    buffers (the right-hand side and x0) that each call refills with
    `copy_`. The captured code is `_start` and `_step`, the eager loop's
    own; a graph whose state is A or B writes it with `_step`'s `out`, and
    both states keep the eager loop's memory layouts (a reduction's order
    follows its operand's layout), so a replayed solve gives the eager
    solve's bits.

    Each graph ends with its state's stop flag, which the host copies to
    page-locked memory behind an event. The host launches iteration j + 1
    before it waits for iteration j's flag (the set-up's is iteration
    0's), so the device does not wait on the read as long as the host's
    turn-around is shorter than an iteration, and a call issues at most
    one iteration past convergence; two slots hold the flags in flight.

    The matvec and the preconditioner of the first call are captured: the
    caller passes closures over tensors that stay (the system's operator
    and the static copies of its per-solve tensors), never over tensors of
    one solve. Spans: `cg.capture` for each graph captured, `cg.replay`
    for each replay, `solve.wait` for each wait on a flag.
    `kernels.cuda_lib.launches` counts the wrappers' calls: a capture
    counts its kernels once, a replay nothing."""

    def __init__(self, pool):
        self.pool = pool  # the owner's memory pool (torch.cuda.graph_pool_handle)
        self.stream = None  # the side stream of the captures
        self.b = self.x0 = self.one = self.zero = None
        self.thresh2 = None  # written by the set-up graph
        self.start = None  # the set-up _Graph; start.state is A
        self.steps = []  # the one-iteration _Graphs: A -> B, then B -> A
        self.flags = self.events = None  # page-locked flag slots, their events

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

    def _capture(self, body) -> _Graph:
        """body(), which returns the state it writes, and that state's stop
        flag as one CUDA graph."""
        graph = torch.cuda.CUDAGraph()
        with span("cg.capture"):
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                s = body()
                flag = s.rnorm2 > self.thresh2
        return _Graph(graph, s, flag)

    def _replay(self, g: _Graph) -> _Graph:
        with span("cg.replay"):
            g.graph.replay()
        return g

    def _single(self, i, matvec, m, dot) -> _Graph:
        """The one-iteration graph from A (i = 0) or B (i = 1), captured at
        its first use."""
        if i < len(self.steps):
            return self.steps[i]
        a = self.start.state
        if i == 0:
            g = self._capture(
                lambda: _step(matvec, m, dot, a, self.thresh2, self.one, self.zero)[0]
            )
            # B is A's layouts, or replays would sum in other orders than
            # the eager loop
            assert _same_layouts(g.state, a), "the PCG state changed its memory layout"
        else:
            g = self._capture(lambda: _step(
                matvec, m, dot, self.steps[0].state, self.thresh2, self.one, self.zero, out=a
            )[0])
        self.steps.append(g)
        return g

    @staticmethod
    def _device_parts(device) -> tuple:
        """The captures' side stream, two page-locked flag slots and their
        events."""
        slots = torch.empty(2, dtype=torch.bool, pin_memory=True)
        return torch.cuda.Stream(device), slots, (torch.cuda.Event(), torch.cuda.Event())

    def _post(self, g: _Graph, slot: int):
        """g's stop flag on its way to page-locked slot `slot`, the slot's
        event behind it."""
        self.flags[slot].copy_(g.flag, non_blocking=True)
        self.events[slot].record(torch.cuda.current_stream(self.b.device))

    def _pending(self, slot: int) -> bool:
        """Whether the flag in `slot` says the residual is above the
        threshold, once it has arrived."""
        with span("solve.wait"):
            self.events[slot].synchronize()
        return bool(self.flags[slot])

    def solve(self, matvec, m, b, x0, rtol, atol, maxiter, dot) -> CGResult:
        """The loop from the graphs."""
        if self.b is None:
            # empty_like keeps the layout: the eager loop's reductions see it
            self.b = torch.empty_like(b)
            self.x0 = None if x0 is None else torch.empty_like(x0)
            self.one = torch.ones((), dtype=b.dtype, device=b.device)
            self.zero = torch.zeros((), dtype=b.dtype, device=b.device)
            self.stream, self.flags, self.events = self._device_parts(b.device)
        self.b.copy_(b)
        if x0 is not None:
            self.x0.copy_(x0)
        if self.start is None:
            def start():
                # the set-up's own outputs are A: the eager layouts
                s, _, self.thresh2 = _start(matvec, m, self.b, self.x0, rtol, atol, dot)
                return _distinct(s, self.b, self.x0)

            self.start = self._capture(start)
        g = self._replay(self.start)
        self._post(g, 0)
        # issued: the iterations issued; its flag is in slot issued % 2, and
        # the one before it, still unread, in the other
        issued = 0
        while issued < maxiter:
            g = self._replay(self._single(issued % 2, matvec, m, dot))
            issued += 1
            self._post(g, issued % 2)
            if not self._pending((issued - 1) % 2):
                break
        s = g.state
        # copies: the next call overwrites the static state
        return CGResult(
            x=s.x.clone(),
            iterations=s.k.clone(),
            residual_norm=torch.sqrt(s.rnorm2),
            converged=s.rnorm2 <= self.thresh2,
            history=empty_history(0, b),
            issued=issued,
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
        issued=iterations,
    )
