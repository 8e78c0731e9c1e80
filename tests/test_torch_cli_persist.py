"""The port CLI's --save-case / --load-case, alone and with the JAX CLI's
files.

A resumed run reads no geometry, hits the operator cache and loads the AMG
hierarchy; its CSVs hold the bars of tests/test_golden.py:48-55 against the
run that saved the case (displacements within 1e-6 of max|u|, stress
within 1e-5 of max|stress|; mesh coordinates and connectivity exactly).
"""

import numpy as np

from tests.test_torch_cli import _read
from tests.torch_cases import write_case
from tests.torch_cases import one_thread  # noqa: F401  (autouse)


def _agree(out_a, out_b):
    (nodes_a, elems_a), (nodes_b, elems_b) = _read(out_a), _read(out_b)
    np.testing.assert_array_equal(nodes_a[:, :2], nodes_b[:, :2])
    np.testing.assert_array_equal(elems_a[:, :3], elems_b[:, :3])
    assert np.abs(nodes_a[:, 2:] - nodes_b[:, 2:]).max() <= 1e-6 * np.abs(nodes_b[:, 2:]).max()
    assert np.abs(elems_a[:, 3] - elems_b[:, 3]).max() <= 1e-5 * np.abs(elems_b[:, 3]).max()


def _resumed(out: str, err: str):
    assert "resumed case from" in out
    assert "info: loaded AMG hierarchy cache" in out
    assert "info: loaded assembled-operator cache" in out
    assert "info: operator cache hit" in out
    assert "warning" not in err  # no miss, no AMG rebuild


def _port(argv, tmp_path, name):
    from magnetite_tpu_torch import cli

    out = tmp_path / name
    out.mkdir()
    assert cli.main(argv + ["--device", "cpu", "--skip", "--out-dir", str(out)]) == 0
    return out


def test_save_then_resume_without_geometry(tmp_path, capsys):
    paths = write_case(str(tmp_path), 0.05)
    case = str(tmp_path / "case")  # the CLI appends .npz, as np.savez does
    fresh = _port(paths + ["--save-case", case], tmp_path, "fresh")
    out = capsys.readouterr().out
    assert "info: checkpointed case to" in out
    assert "info: cached AMG hierarchy to" in out and "info: cached assembled operator to" in out
    for suffix in ("", ".amg.npz", ".op.npz"):
        assert (tmp_path / f"case.npz{suffix}").exists()
    resumed = _port([paths[0], "--load-case", case + ".npz"], tmp_path, "resumed")
    captured = capsys.readouterr()
    _resumed(captured.out, captured.err)
    _agree(resumed, fresh)


def test_refresh_invocation_does_not_rewrite_caches(tmp_path, capsys):
    paths = write_case(str(tmp_path), 0.05)
    case = str(tmp_path / "case.npz")
    _port(paths + ["--save-case", case], tmp_path, "fresh")
    stamps = {s: (tmp_path / f"case.npz{s}").stat().st_mtime_ns for s in (".amg.npz", ".op.npz")}
    capsys.readouterr()
    _port([paths[0], "--load-case", case, "--save-case", case], tmp_path, "refresh")
    out = capsys.readouterr().out
    assert "info: AMG hierarchy cache is current; not rewriting" in out
    assert "info: assembled-operator cache is current; not rewriting" in out
    for s, stamp in stamps.items():
        assert (tmp_path / f"case.npz{s}").stat().st_mtime_ns == stamp


def test_no_geometry_and_no_case_is_an_input_error(tmp_path, capsys):
    from magnetite_tpu_torch import cli

    paths = write_case(str(tmp_path), 0.05)
    assert cli.main([paths[0], "--device", "cpu", "--skip", "--out-dir", str(tmp_path)]) == 1
    err = capsys.readouterr().err
    assert err.startswith("Received error: Input error: no geometry files given")
    assert not (tmp_path / "nodes.csv").exists()


def test_jax_cli_case_resumes_in_the_port_cli(tmp_path, capsys):
    from magnetite_tpu import cli as jax_cli

    paths = write_case(str(tmp_path), 0.05)
    case = str(tmp_path / "jax_case.npz")
    out_j = tmp_path / "jax"
    out_j.mkdir()
    assert jax_cli.main(paths + ["--skip", "--backend", "delaunay", "--precision", "f64",
                                 "--save-case", case, "--out-dir", str(out_j)]) == 0
    capsys.readouterr()
    resumed = _port([paths[0], "--load-case", case], tmp_path, "port")
    captured = capsys.readouterr()
    _resumed(captured.out, captured.err)
    _agree(resumed, out_j)
