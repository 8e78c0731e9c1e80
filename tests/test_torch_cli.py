"""Both CLIs on the same input.json + CSV geometry, the port CLI's mixed
precision, and its 2-D shard layout (a structured case, and the typed
error on a Delaunay one).

The CSVs must agree within the bars of tests/test_golden.py:48-55:
displacements within 1e-6 of max|u|, stress within 1e-5 of max|stress|;
mesh coordinates and connectivity exactly (the same host mesher).
"""

import os

import numpy as np
import pytest

from tests.torch_cases import write_case
from tests.torch_cases import one_thread  # noqa: F401  (autouse)


def _read(dirname):
    with open(os.path.join(dirname, "nodes.csv")) as f:
        assert f.readline().strip() == "x,y,ux,uy"
    with open(os.path.join(dirname, "elements.csv")) as f:
        assert f.readline().strip() == "n0,n1,n2,stress"
    nodes = np.loadtxt(os.path.join(dirname, "nodes.csv"), delimiter=",", skiprows=1)
    elems = np.loadtxt(os.path.join(dirname, "elements.csv"), delimiter=",", skiprows=1)
    return nodes, elems


@pytest.mark.parametrize("von_mises", [False, True])
def test_port_cli_matches_jax_cli(tmp_path, von_mises):
    from magnetite_tpu import cli as jax_cli
    from magnetite_tpu_torch import cli as port_cli

    paths = write_case(str(tmp_path), 0.05)
    extra = ["--skip", "--backend", "delaunay"] + (["--von-mises"] if von_mises else [])
    out_j, out_p = tmp_path / "jax", tmp_path / "port"
    out_j.mkdir()
    out_p.mkdir()
    assert jax_cli.main(paths + extra + ["--precision", "f64", "--out-dir", str(out_j)]) == 0
    assert port_cli.main(paths + extra + ["--device", "cpu", "--out-dir", str(out_p)]) == 0
    nodes_j, elems_j = _read(out_j)
    nodes_p, elems_p = _read(out_p)
    np.testing.assert_array_equal(nodes_p[:, :2], nodes_j[:, :2])
    np.testing.assert_array_equal(elems_p[:, :3], elems_j[:, :3])
    u_scale = np.abs(nodes_j[:, 2:]).max()
    assert np.abs(nodes_p[:, 2:] - nodes_j[:, 2:]).max() <= 1e-6 * u_scale
    s_scale = np.abs(elems_j[:, 3]).max()
    assert np.abs(elems_p[:, 3] - elems_j[:, 3]).max() <= 1e-5 * s_scale


@pytest.mark.parametrize(
    "flags",
    [
        ["--shard", "--shard-layout", "1x1"],
        ["--shard-layout", "1x1"],
    ],
    ids=lambda f: f[0].lstrip("-"),
)
def test_unported_flags_raise_not_yet_ported(tmp_path, capsys, flags):
    """The 2-D layout (RxC, here 1x1 to match the one visible device), with
    or without --shard. "shard": a structured case (saved from a generated
    grid) resumed with --load-case runs the sharded stencil path and
    matches the unsharded CLI on the golden bars. "shard-layout": the SVG
    case, Delaunay and not grid-local, exits with the JAX package's typed
    2-D error and writes nothing."""
    from magnetite_tpu_torch import cli
    from magnetite_tpu_torch.config import ModelMetadata
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect
    from magnetite_tpu_torch.persist import save_case

    paths = write_case(str(tmp_path), 0.05)
    if flags[0] == "--shard-layout":
        rc = cli.main(paths + ["--device", "cpu", "--skip", "--out-dir", str(tmp_path)] + flags)
        assert rc == 1
        err = capsys.readouterr().err
        assert err.startswith("Received error: Solver error: a 2D device mesh shards the "
                              "structured stencil operator")
        assert not (tmp_path / "nodes.csv").exists()
        return
    mesh = plate_with_hole_mesh(16, 32)
    case = str(tmp_path / "grid.npz")
    save_case(case, mesh, tensile_bcs_for_rect(mesh.coords),
              metadata=ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.05))
    outs = {}
    for name, extra in (("single", []), ("sharded", flags)):
        out = tmp_path / name
        out.mkdir()
        argv = [paths[0], "--load-case", case, "--device", "cpu", "--skip", "--out-dir", str(out)]
        assert cli.main(argv + extra) == 0
        outs[name] = (capsys.readouterr().out,) + _read(out)
    log, nodes, elems = outs["sharded"]
    assert "sharding the solve over 1 device(s) (1x1)" in log
    assert "info: operator=stencil preconditioner=multigrid" in log
    _, nodes1, elems1 = outs["single"]
    np.testing.assert_array_equal(nodes[:, :2], nodes1[:, :2])
    assert np.abs(nodes[:, 2:] - nodes1[:, 2:]).max() <= 1e-6 * np.abs(nodes1[:, 2:]).max()
    assert np.abs(elems[:, 3] - elems1[:, 3]).max() <= 1e-5 * np.abs(elems1[:, 3]).max()


def test_port_cli_mixed_precision_matches_its_f64_run(tmp_path):
    """--precision mixed: f32 storage, f64 CG around the f32 V-cycle; the
    CSVs agree with the f64 run's within the golden bars."""
    from magnetite_tpu_torch import cli

    paths = write_case(str(tmp_path), 0.05)
    outs = {}
    for precision in ("mixed", "f64"):
        out = tmp_path / precision
        out.mkdir()
        assert cli.main(paths + ["--device", "cpu", "--skip", "--precision", precision,
                                 "--preconditioner", "amg", "--out-dir", str(out)]) == 0
        outs[precision] = _read(out)
    (nodes_m, elems_m), (nodes_d, elems_d) = outs["mixed"], outs["f64"]
    np.testing.assert_array_equal(nodes_m[:, :2], nodes_d[:, :2])
    assert np.abs(nodes_m[:, 2:] - nodes_d[:, 2:]).max() <= 1e-6 * np.abs(nodes_d[:, 2:]).max()
    assert np.abs(elems_m[:, 3] - elems_d[:, 3]).max() <= 1e-5 * np.abs(elems_d[:, 3]).max()


def test_cuda_device_without_cuda_never_runs_on_cpu(tmp_path, capsys):
    import torch

    from magnetite_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path is not reachable")
    paths = write_case(str(tmp_path), 0.05)
    rc = cli.main(paths + ["--device", "cuda", "--skip", "--out-dir", str(tmp_path)])
    assert rc == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert not (tmp_path / "nodes.csv").exists()


def test_input_errors_keep_the_jax_cli_format(tmp_path, capsys):
    from magnetite_tpu_torch import cli

    paths = write_case(str(tmp_path), 0.05)
    rc = cli.main([paths[0], str(tmp_path / "part.dxf"), "--device", "cpu", "--skip"])
    assert rc == 1
    assert "Received error: Input error: Unrecognized geometry filetype" in (
        capsys.readouterr().err
    )
