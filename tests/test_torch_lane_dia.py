"""The lane band matvecs (K7, K8) of the port against the JAX package's.

The port's plain versions -- what its wrappers run on CPU tensors, and what
the CUDA kernels are held to on the card (tests/test_torch_cuda.py) -- are
compared with the JAX package's Pallas lane kernels in interpreter mode and
with its roll formulations, on the same inputs drawn with numpy; the f64
instances against an exact (long double) product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magnetite_tpu.pallas.lane_dia_kernel import make_lane_dia_matvec, make_lane_dia_matvec3
from magnetite_tpu.parallel.sweep import _lane_weighted_band_matvec
from magnetite_tpu_torch.kernels import cuda_lib
from magnetite_tpu_torch.kernels.lane_dia_kernel import (
    RING_GEOMETRY,
    SMEM_LIMIT,
    TILE_BYTES,
    VEC_BYTES,
    lane_dia_matvec,
    lane_dia_matvec3,
    lane_dia_matvec3_plain,
    lane_dia_matvec_plain,
    lane_window_plan,
    ring_smem_bytes,
)
from tests.torch_cases import one_thread  # noqa: F401  (autouse)
from tests.torch_cases import random_bands

# the JAX package's own test offsets (tests/test_lane_dia_kernel.py)
OFFSETS = tuple(sorted({0, 1, -1, 5, -5, 37, -37, 120, -120, 199, -199}))
N, B = 700, 128


def _jax_roll(bands, offsets, u):
    """The JAX package's roll formulation (parallel/sweep.py,
    band_matvec_roll)."""
    y0 = jnp.zeros_like(u[0])
    y1 = jnp.zeros_like(u[1])
    for d_idx, off in enumerate(offsets):
        s = jnp.roll(u, -off, axis=1) if off != 0 else u
        b = bands[d_idx][:, :, :, None]
        y0 = y0 + b[0, 0] * s[0] + b[0, 1] * s[1]
        y1 = y1 + b[1, 0] * s[0] + b[1, 1] * s[1]
    return jnp.stack([y0, y1])


def _exact(bands, offsets, u):
    """y = K u in long double by direct indexing (no rolls, no wraparound)."""
    bands, u = bands.astype(np.longdouble), u.astype(np.longdouble)
    n = u.shape[1]
    y = np.zeros(u.shape, dtype=np.longdouble)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        for ci in range(2):
            for cj in range(2):
                y[ci, lo:hi] += bands[d, ci, cj, lo:hi, None] * u[cj, lo + off:hi + off]
    return y


def _inputs(seed, nbases=1, dtype=np.float32):
    rng = np.random.default_rng(seed)
    bands = [random_bands(N, OFFSETS, 2, seed + 1 + k).astype(dtype) for k in range(nbases)]
    u = rng.standard_normal((2, N, B)).astype(dtype)
    w3 = tuple(rng.uniform(0.5, 2.0, B).astype(dtype) for _ in range(3))
    return bands, u, w3


def test_k7_plain_matches_jax_kernel_and_roll():
    (bands,), u, _ = _inputs(0)
    got = lane_dia_matvec_plain(torch.as_tensor(bands), OFFSETS, torch.as_tensor(u)).numpy()
    mv = make_lane_dia_matvec(OFFSETS, N, B, jnp.float32, interpret=True)
    assert mv is not None  # the Pallas kernel applies at this shape
    for ref in (mv(jnp.asarray(bands), jnp.asarray(u)),
                _jax_roll(jnp.asarray(bands), OFFSETS, jnp.asarray(u))):
        ref = np.asarray(ref)
        # the JAX test's kernel-versus-roll bar (tests/test_lane_dia_kernel.py)
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_k8_plain_matches_jax_kernel_and_roll():
    bands3, u, w3 = _inputs(10, nbases=3)
    got = lane_dia_matvec3_plain(
        tuple(torch.as_tensor(b) for b in bands3), tuple(torch.as_tensor(w) for w in w3),
        OFFSETS, torch.as_tensor(u),
    ).numpy()
    jb3 = tuple(jnp.asarray(b) for b in bands3)
    jw3 = tuple(jnp.asarray(w) for w in w3)
    mv3 = make_lane_dia_matvec3(OFFSETS, N, B, jnp.float32, interpret=True)
    assert mv3 is not None
    for ref in (mv3(jb3, jw3, jnp.asarray(u)),
                _lane_weighted_band_matvec(jb3, OFFSETS, *jw3, jnp.asarray(u))):
        ref = np.asarray(ref)
        # the Pallas kernel combines the coefficients first (another f32
        # summation order): the JAX test's bar
        assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("material", [False, True], ids=["k7", "k8"])
def test_f64_plain_matches_exact_product(material):
    bands3, u, w3 = _inputs(20, nbases=3, dtype=np.float64)
    t3 = tuple(torch.as_tensor(b) for b in bands3)
    if material:
        got = lane_dia_matvec3_plain(t3, tuple(torch.as_tensor(w) for w in w3),
                                     OFFSETS, torch.as_tensor(u)).numpy()
        ws = [w.astype(np.longdouble) for w in w3]
        ref = sum(_exact(b, OFFSETS, u) * w for b, w in zip(bands3, ws))
        scale = sum(_exact(np.abs(b), OFFSETS, np.abs(u)) * w for b, w in zip(bands3, ws))
    else:
        got = lane_dia_matvec_plain(t3[0], OFFSETS, torch.as_tensor(u)).numpy()
        ref = _exact(bands3[0], OFFSETS, u)
        scale = _exact(np.abs(bands3[0]), OFFSETS, np.abs(u))
    # f64 rounding of ~4 D terms per output
    assert float(np.abs(got - ref).max()) <= 1e-13 * float(scale.max())


def test_wrappers_take_the_plain_versions_on_cpu_tensors():
    """On CPU tensors the wrappers ARE the plain versions, and count no
    kernel launch."""
    bands3, u, w3 = _inputs(30, nbases=3)
    t3 = tuple(torch.as_tensor(b) for b in bands3)
    tw = tuple(torch.as_tensor(w) for w in w3)
    tu = torch.as_tensor(u)
    counts = (lambda: (cuda_lib.launched("mt_lane_dia_ring", "mt_lane_dia_matvec"),
                       cuda_lib.launched("mt_lane_dia_ring"),
                       cuda_lib.launched("mt_lane_dia_ring3", "mt_lane_dia_matvec3")))
    before = counts()
    assert torch.equal(lane_dia_matvec(t3[0], OFFSETS, tu),
                       lane_dia_matvec_plain(t3[0], OFFSETS, tu))
    assert torch.equal(lane_dia_matvec3(t3, tw, OFFSETS, tu),
                       lane_dia_matvec3_plain(t3, tw, OFFSETS, tu))
    assert counts() == before


# The design-sweep plate's 35 band offsets at h = 0.03 (3,774 nodes, no
# renumbering; compile_unstructured_sweep on chip_smoke.plate_case(0.03)),
# and the card tests' offsets that reach past N = 997 (chip_smoke.py).
SWEEP_OFFSETS = (-200, -199, -186, -185, -174, -173, -102, -101, -100, -99, -89, -88, -87,
                 -86, -85, -84, -1, 0, 1, 84, 85, 86, 87, 88, 89, 99, 100, 101, 102, 173,
                 174, 185, 186, 199, 200)
LANE_OFFSETS = (-1300, -512, -200, -199, -37, -1, 0, 1, 37, 199, 200, 512, 1300)


@pytest.mark.parametrize("sets", [1, 3], ids=["k7", "k8"])
@pytest.mark.parametrize("offsets,n,nb,dtype,route", [
    (SWEEP_OFFSETS, 3774, 4096, torch.float32, "ring"),
    (SWEEP_OFFSETS, 3774, 4096, torch.float64, "ring"),
    (SWEEP_OFFSETS, 3774, 1000, torch.float32, "ring"),
    (SWEEP_OFFSETS, 3774, 1, torch.float64, "ring"),
    (SWEEP_OFFSETS, 150, 64, torch.float32, "ring"),  # N smaller than the span
    (LANE_OFFSETS, 997, 4096, torch.float32, "direct"),
    (LANE_OFFSETS, 997, 1000, torch.float64, "direct"),
    (LANE_OFFSETS, 2011, 1, torch.float32, "direct"),
    ((3, 4, 9, 40), 500, 37, torch.float32, "ring"),  # all positive
    ((-40, -9, -4, -3), 500, 37, torch.float64, "ring"),  # all negative
    ((0,), 100, 7, torch.float32, "ring"),
    ((0,), 1, 1, torch.float64, "ring"),
], ids=["plate-f32", "plate-f64", "plate-b1000", "plate-b1-f64", "n-below-span",
        "past-n-f32", "past-n-f64", "past-n-b1", "positive", "negative", "zero", "one-node"])
def test_lane_window_plan(offsets, n, nb, dtype, route, sets):
    """The route rule and the ring's geometry, for K7 (one basis) and K8
    (three basis band sets, staged a few offsets at a time): the ring
    wherever its rows fit shared memory at the full tile width (the plate's
    35 offsets in f32 and f64 alike; +-1300 past N = 997 takes the direct
    kernel), a tile that covers B in 16-byte lane vectors, a step the
    loaders can split, and strips that cover [0, N) exactly once."""
    plan = lane_window_plan(offsets, n, nb, dtype, sets=sets)
    assert plan.route == route
    assert (plan.min_off, plan.max_off) == (min(offsets), max(offsets))
    if route == "direct":
        return
    es = torch.empty((), dtype=dtype).element_size()
    vec = VEC_BYTES // es
    lt = plan.lanes // vec
    k, threads, _, _ = RING_GEOMETRY[sets, es]
    assert plan.lanes == min(TILE_BYTES // es, -(-nb // vec) * vec)
    assert plan.rows >= 8 and plan.rows % max(2 * k, vec) == 0
    assert lt * plan.rows // k <= threads
    span, d = plan.max_off - plan.min_off, len(offsets)
    assert plan.smem_bytes == ring_smem_bytes(span, plan.lanes, plan.rows, d, es, sets)
    if sets == 1:  # span + 2 P ring rows and two steps of all D offsets' band values
        assert plan.smem_bytes == ((span + 2 * plan.rows) * 2 * plan.lanes
                                   + 2 * plan.rows * d * 4) * es + 4 * d
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    assert plan.strip_rows % plan.rows == 0
    assert (plan.strips - 1) * plan.strip_rows < n <= plan.strips * plan.strip_rows
    covered = np.zeros(n, dtype=int)
    for k in range(plan.strips):
        covered[k * plan.strip_rows:min(n, (k + 1) * plan.strip_rows)] += 1
    assert (covered == 1).all()
