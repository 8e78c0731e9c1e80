"""The port's block-ELL layer against the JAX package's, on the CPU.

`fem/operator.py` (the ELL matvec, the masked operator, the reduced RHS and
the three preconditioners), `fem/assembly.py` (the ELL assembly and the
diagonal blocks) and the plain version of the lane ELL kernel
(kernels/lane_ell_kernel.py) on the plate with a hole at h = 0.08 (552
nodes), as meshed and with its nodes shuffled, and on random inputs from
numpy seeds.

(tests/test_torch_host.py holds the ELL structure identical to the JAX
package's.) Bar, everything in f64: 1e-12 of the result's scale -- the two packages sum the same terms in another order
(the port's ELL values come from the C++ closed-form element blocks, the
JAX package's from its [E, 6, 6] element matrices), so they part at a few
ulps of the largest term.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magnetite_tpu.fem import assembly as ja
from magnetite_tpu.fem import operator as jo
from magnetite_tpu.fem.element import element_stiffness_matrices
from magnetite_tpu.fem.solve import assemble_ell_arrays
from magnetite_tpu_torch.fem import assembly as pa
from magnetite_tpu_torch.fem import operator as po
from magnetite_tpu_torch.kernels import cuda_lib
from magnetite_tpu_torch.kernels.lane_ell_kernel import (
    lane_ell_matvec, lane_ell_matvec_plain, lane_ell_plan,
)
from tests.torch_cases import E_MOD, NU, THICK, jax_plate, shuffled
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

TOL = 1e-12


@pytest.fixture(scope="module", params=["as_meshed", "shuffled"])
def case(request):
    """The h = 0.08 plate (shuffled with numpy seed 7), its JAX ELL
    structure and assembled ELL data, and random free masks and fields."""
    mesh, bca, _ = jax_plate(0.08)
    if request.param == "shuffled":
        mesh, bca = shuffled(mesh, bca, seed=7)
    n = mesh.num_nodes
    st = ja.build_ell_structure(mesh.tris, n)
    ke = element_stiffness_matrices(jnp.asarray(mesh.coords), jnp.asarray(mesh.tris), E_MOD,
                                    NU, THICK)
    ell = np.array(assemble_ell_arrays(ke, jnp.asarray(st.slot_ids), n, st.width))
    rng = np.random.default_rng(21)
    return dict(mesh=mesh, n=n, st=st, ell=ell, free=(~bca.u_known).astype(np.float64),
                u=rng.standard_normal((n, 2)), f=rng.standard_normal((n, 2)),
                rand_free=(rng.uniform(size=(n, 2)) < 0.8).astype(np.float64))


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_ell_assembly_and_block_diagonal(case):
    """The ELL data (C++ blocks into the ELL slots) against the JAX
    package's assemble_ell_arrays; the diagonal blocks against its
    extract_block_diagonal."""
    mesh, st = case["mesh"], case["st"]
    got = pa.assemble_ell(mesh.coords, mesh.tris, E_MOD, NU, THICK, st)
    assert got.dtype == torch.float64
    close(got.numpy(), case["ell"])
    cols = torch.from_numpy(st.cols)
    close(pa.extract_block_diagonal(got, cols).numpy(),
          ja.extract_block_diagonal(jnp.asarray(case["ell"]), jnp.asarray(st.cols)))


@pytest.mark.parametrize("mask", ["bcs", "random"])
def test_operator_functions_match_jax(case, mask):
    """ell_matvec, the masked operator, reduced_rhs and the three
    preconditioners, on the same numpy inputs (the plate's BC mask, or a
    random one)."""
    ell, cols = case["ell"], case["st"].cols
    free = case["free" if mask == "bcs" else "rand_free"]
    u, f = case["u"], case["f"]
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         dict(ell=ell, cols=cols, free=free, u=u, f=f).items()}
    j = {k: jnp.asarray(v) for k, v in dict(ell=ell, cols=cols, free=free, u=u, f=f).items()}
    close(po.ell_matvec(t["ell"], t["cols"], t["u"]), jo.ell_matvec(j["ell"], j["cols"], j["u"]))
    pm, jm = po.make_ell_operator(t["ell"], t["cols"]), jo.make_ell_operator(j["ell"], j["cols"])
    close(po.make_constrained_operator(pm, t["free"])(t["u"]),
          jo.make_constrained_operator(jm, j["free"])(j["u"]))
    close(po.reduced_rhs(pm, t["free"], t["u"], t["f"]),
          jo.reduced_rhs(jm, j["free"], j["u"], j["f"]))
    diag_t = pa.extract_block_diagonal(t["ell"], t["cols"])
    diag_j = ja.extract_block_diagonal(j["ell"], j["cols"])
    for name in ("block_jacobi_preconditioner", "jacobi_preconditioner"):
        close(getattr(po, name)(diag_t, t["free"])(t["f"]),
              getattr(jo, name)(diag_j, j["free"])(j["f"]))
    assert torch.equal(po.identity_preconditioner()(t["f"]), t["f"])


def test_block_jacobi_has_no_det_guard():
    """As in the JAX package, a singular block gives inf / nan (the lanes
    route's block-Jacobi guards det == 0; this one does not)."""
    diag = torch.zeros((2, 2, 2), dtype=torch.float64)
    diag[0] = torch.eye(2, dtype=torch.float64)
    free = torch.ones((2, 2), dtype=torch.float64)
    inv = po.block_jacobi_inverse(diag, free)
    assert torch.equal(inv[0], torch.eye(2, dtype=torch.float64))
    assert not torch.isfinite(inv[1]).any()
    jinv = jo.block_jacobi_preconditioner(jnp.asarray(diag.numpy()), jnp.asarray(free.numpy()))
    assert not np.isfinite(np.asarray(jinv(jnp.ones((2, 2))))[1]).any()


@pytest.mark.parametrize("nb", [1, 5, 16])
def test_lane_ell_plain_matches_jax_vmap(case, nb):
    """lane_ell_matvec_plain on [2, N, B] lane fields against the JAX
    package's ell_matvec vmapped over the lanes; the wrapper takes the
    plain version on CPU tensors and launches nothing."""
    import jax

    ell, cols, n = case["ell"], case["st"].cols, case["n"]
    u = np.random.default_rng(nb).standard_normal((nb, n, 2))
    want = jax.vmap(lambda v: jo.ell_matvec(jnp.asarray(ell), jnp.asarray(cols), v))(
        jnp.asarray(u))  # [B, N, 2]
    lanes = torch.from_numpy(u.transpose(2, 1, 0).copy())  # [2, N, B]
    t_ell, t_cols = torch.from_numpy(ell), torch.from_numpy(cols)
    got = lane_ell_matvec_plain(t_ell, t_cols, lanes)
    close(got.numpy().transpose(2, 1, 0), want)
    before = cuda_lib.launched("mt_lane_ell_matvec")
    assert torch.equal(lane_ell_matvec(t_ell, t_cols, lanes), got)
    assert cuda_lib.launched("mt_lane_ell_matvec") == before


@pytest.mark.parametrize("nb,es,aligned,want", [
    (4096, 4, True, (4, 32)), (4096, 8, True, (2, 32)), (1000, 4, True, (4, 32)),
    (37, 4, True, (1, 32)), (16, 4, True, (4, 4)), (16, 4, False, (1, 16)),
    (1, 8, True, (1, 1)), (6, 8, True, (2, 4)),
])
def test_lane_ell_plan(nb, es, aligned, want):
    """16 bytes of lanes per thread when B and the pointers allow it, and a
    team of the least power of two (<= 32) covering a node's vectors."""
    assert lane_ell_plan(nb, es, aligned) == want
