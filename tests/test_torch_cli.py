"""PyTorch port, the ``cuppen`` CLI: ``symmetric_eigenvalue_tpu_torch.cli
.main(argv + ["--device", "cpu"])`` against ``symmetric_eigenvalue_tpu.cli
.main(argv)`` on the same argv (both with ``--devices 1``: one device, no
mesh), at n <= 100.  Each JAX CLI run happens once, in a module-scoped
fixture.

Tolerances: return codes and stderr prefixes equal; stdout the same lines
but for the timings, the output file's name and the backend; output files
with the same line count and the same lines with and without a residual,
eigenvalues within 1e-12 ||T|| of each other and every residual <= 1e-10
in both; --f32 at the JAX package's float32 grades (eigenvalues within
1e-4 ||T||, residuals within 1e-3 ||T||).
"""

import contextlib
import io
import re

import numpy as np
import pytest

from symmetric_eigenvalue_tpu import cli as jcli
from symmetric_eigenvalue_tpu_torch import cli as tcli
from symmetric_eigenvalue_tpu_torch.core.tridiag import eigenvalues_of_scheme2
from symmetric_eigenvalue_tpu_torch.io.results import read_results

TINYL = """%%MatrixMarket matrix coordinate real general
%matrix L
4 4 10
1 1 2
2 1 -1
1 2 -1
2 2 2
3 2 -1
2 3 -1
3 3 2
4 3 -1
3 4 -1
4 4 2
"""

# name -> argv before "--devices 1" and the output file; "{tmp}" is the
# module's directory
CASES = {
    "scheme1": ["-s", "1", "-n", "20"],
    "scheme1_e": ["-s", "1", "-n", "20", "-e"],
    "scheme2": ["-s", "2", "-n", "12"],
    "scheme2_e": ["-s", "2", "-n", "96", "-e"],
    "evfile": ["-s", "1", "-n", "20", "-e{tmp}/ev.txt"],
    "evfile_none_valid": ["-s", "2", "-n", "16", "-e{tmp}/ev_bad.txt"],
    "tinyl": ["-i", "{tmp}/tinyL.mtx", "-e"],
    "f32": ["--f32", "-s", "1", "-n", "64", "-e"],
}


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _argv(name, tmp, out):
    return [a.format(tmp=tmp) for a in CASES[name]] + ["--devices", "1",
                                                       str(out)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (tmp dir, JAX run, port run)} with each run (rc, stdout,
    stderr, output file)."""
    tmp = tmp_path_factory.mktemp("cli")
    (tmp / "ev.txt").write_text("1\n5\n5\n20\nbogus\n99\n0\n")
    (tmp / "ev_bad.txt").write_text("0\n17\nx\n")
    (tmp / "tinyL.mtx").write_text(TINYL)
    got = {}
    for name in CASES:
        both = []
        for tag, main, extra in (("jax", jcli.main, []),
                                 ("port", tcli.main, ["--device", "cpu"])):
            out = tmp / f"{name}_{tag}.txt"
            both.append((*_run(main, _argv(name, tmp, out) + extra), out))
        got[name] = (tmp, *both)
    return got


def _mask(stdout):
    """stdout with the timings, the output file's name and the device
    line's backend masked."""
    subs = ((r"\d+\.\d+ seconds", "T seconds"),
            (r"^Output file: .*", "Output file: F"),
            (r"\(backend: \w+\)", "(backend: B)"))
    lines = stdout.splitlines()
    for pat, rep in subs:
        lines = [re.sub(pat, rep, ln) for ln in lines]
    return lines


def test_preprocess_argv_same():
    for argv in (["-efoo.txt"], ["-e"], ["-s", "1"], ["-e=x"],
                 ["-i", "a.mtx", "-eidx.txt", "out.txt"]):
        assert tcli._preprocess_argv(argv) == jcli._preprocess_argv(argv)


def test_help_no_args(capsys):
    assert tcli.main([]) == 0
    text = capsys.readouterr().out
    assert text.startswith("usage: cuppen")
    port_opts = {s for a in tcli.build_parser()._actions
                 for s in a.option_strings}
    jax_opts = {s for a in jcli.build_parser()._actions
                for s in a.option_strings}
    assert jax_opts <= port_opts and "--device" in port_opts


@pytest.mark.parametrize("argv", [["-n", "0"], ["-s", "3"]])
def test_invalid_arguments(argv):
    rc, out, err = _run(tcli.main, argv + ["--device", "cpu"])
    rc_j, _, err_j = _run(jcli.main, argv)
    assert rc == rc_j == 1 and err == err_j


@pytest.mark.parametrize("argv", [
    ["--devices", "2"], ["--coordinator", "localhost:1234"],
    ["--num-processes", "2"], ["--process-id", "0"]])
def test_multi_device_not_ported(argv):
    rc, out, err = _run(tcli.main, ["-s", "1", "-n", "8", "--device", "cpu",
                                    *argv])
    assert rc == 1 and "not ported" in err and out == ""


@pytest.mark.parametrize("bad", ["missing", "malformed"])
def test_unreadable_input(tmp_path, bad):
    p = tmp_path / "bad.mtx"
    if bad == "malformed":
        p.write_text("%%MatrixMarket matrix coordinate real general\n"
                     "3 3 2\n1 1 1.0\n3 1 5.0\n")
    rc, out, err = _run(tcli.main, ["-i", str(p), "--device", "cpu"])
    rc_j, out_j, err_j = _run(jcli.main, ["-i", str(p), "--devices", "1"])
    assert rc == rc_j == 1
    assert err.startswith("Could not read input file: ") and err == err_j
    assert out == out_j == f"Input file: {p}\n"


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_output_as_jax(runs, name):
    tmp, (rc_j, out_j, err_j, f_j), (rc, out, err, f) = runs[name]
    assert rc == rc_j == 0, (err, err_j)
    assert "Program finished successfully!" in out
    assert _mask(out) == _mask(out_j)
    assert err == err_j == ""
    lam_j, res_j = read_results(f_j)
    lam, res = read_results(f)
    assert lam.shape == lam_j.shape
    assert [r is None for r in res] == [r is None for r in res_j]
    norm_t = np.abs(lam_j).max()
    tol = 1e-4 if name == "f32" else 1e-12
    assert np.abs(lam - lam_j).max() <= tol * norm_t
    given = [r for r in res if r is not None]
    given_j = [r for r in res_j if r is not None]
    limit = 1e-3 * norm_t if name == "f32" else 1e-10
    assert max(given + given_j, default=0.0) <= limit
    if name in ("scheme2", "scheme2_e", "tinyl"):
        exact = eigenvalues_of_scheme2(lam.shape[0])
        assert np.abs(lam - exact).max() <= 1e-13 * 4


def test_selection_lines(runs):
    """-eFILE: residuals on exactly the valid, deduplicated lines; a file
    with no valid line computes no vector at all."""
    lam, res = read_results(runs["evfile"][2][3])
    assert [i for i, r in enumerate(res) if r is not None] == [0, 4, 19]
    lam, res = read_results(runs["evfile_none_valid"][2][3])
    assert lam.shape == (16,) and all(r is None for r in res)
    lam, res = read_results(runs["scheme1"][2][3])
    assert all(r is None for r in res)


def test_streamed_branch_same_output(runs, tmp_path, monkeypatch):
    """The streamed branch, forced, writes the resident run's eigenvalues
    bit for bit and a residual on every line, each <= 1e-10; its report
    reads the streamed backtransformation."""
    tmp, _, (rc_r, out_r, _, f_r) = runs["scheme2_e"]
    asked = []

    def gate(n, compute_ev, select, device):
        asked.append((n, compute_ev, select, str(device)))
        return True

    monkeypatch.setattr(tcli, "_use_streamed", gate)
    f_s = tmp_path / "streamed.txt"
    rc, out, err = _run(tcli.main, ["-s", "2", "-n", "96", "-e", str(f_s),
                                    "--device", "cpu"])
    assert rc == 0 and asked == [(96, True, None, "cpu")]
    assert _mask(out) == _mask(out_r)
    lam_r, _ = read_results(f_r)
    lam_s, res_s = read_results(f_s)
    assert np.array_equal(lam_r, lam_s)
    assert all(r is not None for r in res_s) and max(res_s) <= 1e-10


def test_streamed_gate():
    """Never on the CPU, never with a selection or without vectors."""
    assert not tcli._use_streamed(10 ** 6, True, None, "cpu")
    assert not tcli._use_streamed(10 ** 6, True, np.arange(3), "cpu")
    assert not tcli._use_streamed(10 ** 6, False, None, "cpu")
    assert tcli._STREAM_SHARE == pytest.approx(12e9 / 14.5e9)


def test_profile_dir_writes_a_trace(tmp_path):
    rc, out, _ = _run(tcli.main, ["-s", "1", "-n", "40", "-e", "--device",
                                  "cpu", "--profile-dir",
                                  str(tmp_path / "trace")])
    assert rc == 0
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    """The default --device cuda without a card raises; nothing falls back
    to the CPU and no output file is written."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.txt"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run(tcli.main, ["-s", "1", "-n", "8", "-e", str(out)])
    assert not out.exists()
