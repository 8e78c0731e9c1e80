"""The port's native host library stands alone and computes what the JAX
package's computes.

- A copy of `magnetite_tpu_torch/` alone (no `_build/`, no
  `__pycache__/`, no JAX package beside it) runs the CLI with JAX
  unimportable and builds its host library from its own sources, inside
  the copy.
- Every function the library exports gives outputs bit-identical to the
  JAX package's library (`magnetite_tpu/native.py`) on the same seeded
  inputs.
- `native._SRC_DIR` lies inside the port's package.

(`tests/test_torch_no_jax.py` holds that no file of the port imports JAX
or names the JAX package's directory.)
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_cases import OUTER, HOLE, write_case
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
from magnetite_tpu_torch import cli, native
rc = cli.main(sys.argv[1:])
leaked = [m for m in sys.modules
          if m == "jax" and sys.modules[m] is not None
          or m == "magnetite_tpu" or m.startswith("magnetite_tpu.")]
print("LEAKED", leaked)
print("SRC", native._SRC_DIR)
print("SO", native._SO_PATH)
sys.exit(rc)
"""


def test_package_copy_runs_alone_and_builds_its_own_library(tmp_path):
    pkg = tmp_path / "pkg"
    shutil.copytree(os.path.join(REPO, "magnetite_tpu_torch"), pkg / "magnetite_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    work = tmp_path / "work"
    work.mkdir()
    paths = write_case(str(work), 0.05)
    env = dict(os.environ, PYTHONPATH=str(pkg), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, *paths,
         "--device", "cpu", "--skip", "--out-dir", str(work)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(work),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LEAKED []" in proc.stdout
    so = pkg / "magnetite_tpu_torch" / "_build" / "libmagnetite_native.so"
    assert f"SRC {pkg / 'magnetite_tpu_torch' / '_native' / 'src'}" in proc.stdout
    assert f"SO {so}" in proc.stdout
    assert so.is_file()
    nodes = np.loadtxt(work / "nodes.csv", delimiter=",", skiprows=1)
    assert nodes.shape[1] == 4 and np.isfinite(nodes).all()


def test_native_sources_lie_inside_the_port():
    from magnetite_tpu_torch import native

    pkg = os.path.join(REPO, "magnetite_tpu_torch")
    src = os.path.realpath(native._SRC_DIR)
    assert os.path.commonpath([src, os.path.realpath(pkg)]) == os.path.realpath(pkg)
    names = sorted(os.path.basename(s) for s in native._sources())
    assert names == ["amg_setup.cpp", "msh_parser.cpp", "structure.cpp"]


# ------------------- parity with the JAX package's library -------------------


def _msh_text(coords, tris, rng):
    """MSH 4.1 text of the mesh with sparse, shuffled node tags and a 1-D
    entity block the parser must skip."""
    n = coords.shape[0]
    tags = np.sort(rng.choice(np.arange(1, 3 * n + 1), size=n, replace=False))
    order = rng.permutation(n)
    lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$Nodes",
             f"1 {n} {tags.min()} {tags.max()}", f"2 1 0 {n}"]
    lines += [str(tags[i]) for i in order]
    lines += [f"{coords[i, 0]!r} {coords[i, 1]!r} 0" for i in order]
    e = tris.shape[0]
    lines += ["$EndNodes", "$Elements", f"2 {e + 1} 1 {e + 1}", "1 1 1 1", f"1 {tags[0]} {tags[1]}",
              f"2 1 2 {e}"]
    lines += [f"{k + 2} {tags[a]} {tags[b]} {tags[c]}" for k, (a, b, c) in enumerate(tris)]
    lines += ["$EndElements", ""]
    return "\n".join(lines)


@pytest.fixture(scope="module")
def case():
    """A seeded case: the plate (h = 0.1) with its nodes shuffled, a random
    free mask, the stiffness in block COO, an aggregation and a tentative
    prolongator of the AMG setup's shapes."""
    from magnetite_tpu_torch import native
    from magnetite_tpu_torch.meshing.delaunay_backend import triangulate

    rng = np.random.default_rng(18)
    mesh = triangulate([np.array(OUTER), np.array(HOLE)], 0.0, 0.1)
    n = mesh.num_nodes
    perm = rng.permutation(n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    coords = mesh.coords[perm]
    tris = inv[mesh.tris].astype(np.int32)
    free = (rng.random((n, 2)) > 0.1).astype(np.float64)
    mat = (69e9 * rng.uniform(0.5, 2.0), rng.uniform(0.2, 0.4), rng.uniform(0.2, 1.0))
    keys, vals = native.assemble_coo_blocks(coords, tris, free, *mat, n)
    diag = np.zeros((n, 2, 2))
    on = keys // n == keys % n
    np.add.at(diag, keys[on] // n, vals[on])
    diag += np.eye(2) * (np.abs(diag).max() * 1e-9)
    n_agg = n // 5
    agg = rng.permutation(np.arange(n) % n_agg)
    return dict(
        rng=rng, coords=coords, tris=tris, sorted_tris=mesh.tris, n=n, free=free, mat=mat,
        keys=keys, vals=vals, diag_inv=np.linalg.inv(diag), n_agg=n_agg, agg=agg,
        p0=rng.standard_normal((n, 2, 3)),
    )


def _msh_parse(lib, c):
    return lib.msh_parse(_msh_text(c["coords"], c["tris"], np.random.default_rng(5)))


def _ell_structure(lib, c):
    return lib.ell_structure(c["tris"], c["n"])


def _dia_structure(lib, c):
    # the mesh as meshed (band-friendly), and shuffled past the band cap
    return (lib.dia_structure(c["sorted_tris"], c["n"], 48),
            lib.dia_structure(c["tris"], c["n"], 48))


def _amg_assemble(lib, c):
    cols, slot_ids, width = _ell_structure(lib, c)
    e = c["tris"].shape[0]
    pm = slot_ids.astype(np.int64).reshape(e, 3, 3).transpose(1, 2, 0).reshape(-1)
    return lib.amg_assemble(c["coords"], c["tris"], c["free"], *c["mat"], pm, c["n"] * width)


def _sort_reduce_blocks(lib, c):
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 300, 2000)
    return lib.sort_reduce_blocks(keys, rng.standard_normal((2000, 3, 3)))


def _assemble_coo_blocks(lib, c):
    return lib.assemble_coo_blocks(c["coords"], c["tris"], c["free"], *c["mat"], c["n"])


def _coo_matvec_blocks(lib, c):
    x = np.random.default_rng(9).standard_normal((c["n"], 2))
    return lib.coo_matvec_blocks(c["keys"], c["vals"], c["n"], x)


def _smooth_prolongator_blocks(lib, c):
    return lib.smooth_prolongator_blocks(c["keys"], c["vals"], c["n"], c["diag_inv"], c["p0"],
                                         c["agg"], c["n_agg"], 0.61)


def _rap_blocks(lib, c):
    from magnetite_tpu_torch import native

    p_keys, p_vals = native.smooth_prolongator_blocks(
        c["keys"], c["vals"], c["n"], c["diag_inv"], c["p0"], c["agg"], c["n_agg"], 0.61)
    return lib.rap_blocks(c["keys"], c["vals"], c["n"], p_keys, p_vals, c["n_agg"])


CALLS = {f.__name__.lstrip("_"): f for f in (
    _msh_parse, _ell_structure, _dia_structure, _amg_assemble, _sort_reduce_blocks,
    _assemble_coo_blocks, _coo_matvec_blocks, _smooth_prolongator_blocks, _rap_blocks,
)}


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


@pytest.mark.parametrize("name", list(CALLS))
def test_native_function_matches_the_jax_package(case, name):
    import magnetite_tpu.native as jax_native
    from magnetite_tpu_torch import native

    assert jax_native.available()
    got = _leaves(CALLS[name](native, case))
    want = _leaves(CALLS[name](jax_native, case))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes(), name
        else:
            assert type(g) is type(w) and g == w, name
    assert any(isinstance(w, np.ndarray) and w.size for w in want), name
