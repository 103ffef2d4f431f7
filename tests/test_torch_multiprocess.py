"""PyTorch port, multi-process execution through ``distributed_init``: the
counterpart of ``tests/test_multihost.py``.

Two Python processes on the gloo backend, 4 logical CPU shards each (8
global shards), solve the same tridiagonal matrix (n=256, leaf 8, seed
7) through the sharded upsweep and the column-sharded downsweep, the f64
path, the default mixed one and the grouped route (its switch and group
width made to differ between the processes, which must agree on them);
each process checks its own eigenvalues against numpy and its residual,
<= 1e-12 of the spectrum's scale, and the
parent holds process 0's eigenvalues against the JAX package's solve on
its 8-device mesh to 1e-13.  A second test runs the ``cuppen`` CLI in two
processes and compares the output file with a one-process run's.  Each
subprocess has a 300 s timeout.
"""

import os
import socket
import subprocess
import sys

import numpy as np

import symmetric_eigenvalue_tpu as se
from symmetric_eigenvalue_tpu.dist.mesh import make_mesh as jax_make_mesh
from symmetric_eigenvalue_tpu_torch.io.results import read_results

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
proc_id, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]

import numpy as np
import torch
import torch.distributed as dist
import symmetric_eigenvalue_tpu_torch as st
from symmetric_eigenvalue_tpu_torch.core.tridiag import dense_from_tridiag
from symmetric_eigenvalue_tpu_torch.dist.mesh import (distributed_init,
                                                      make_mesh)

distributed_init(coordinator=f"localhost:{port}", num_processes=2,
                 process_id=proc_id)
mesh = make_mesh(devices=[torch.device("cpu")] * 4)
assert (mesh.size, mesh.num_processes, mesh.process_index) == (8, 2, proc_id)

n = 256
rng = np.random.default_rng(7)
d = rng.standard_normal(n) * 2
e = rng.standard_normal(n - 1)
T = dense_from_tridiag(d, e)
wref = np.linalg.eigvalsh(T)
scale = np.abs(wref).max()
lam, V = st.eigh_tridiagonal(d, e, config=st.SolverConfig(leaf_size=8),
                             mesh=mesh)
res, _ = st.solve_tridiagonal_staged(d, e,
                                     config=st.SolverConfig(leaf_size=8),
                                     compute_vectors=True, mesh=mesh)
# the grouped route's switch and group width read each process's own
# memory: here they differ, and the processes must still agree
from symmetric_eigenvalue_tpu_torch import driver
driver._grouped_bt_bytes = lambda device: 1.0 if proc_id == 0 else 1e30
driver._group_width = lambda n, config, device: 128 * (1 + proc_id)
grp, timer = st.solve_tridiagonal_staged(
    d, e, config=st.SolverConfig(leaf_size=8), compute_vectors=True,
    mesh=mesh)
assert "bt.downsweep_refine_grouped" in timer.times, timer.times
for name, lam_p, V_p in (("f64", lam, V),
                         ("mixed", res.eigenvalues, res.eigenvectors),
                         ("grouped", grp.eigenvalues, grp.eigenvectors)):
    lam_p, V_p = lam_p.numpy(), V_p.numpy()
    lam_err = np.abs(lam_p - wref).max()
    resid = np.abs(T @ V_p - V_p * lam_p[None, :]).max()
    assert lam_err < 1e-12 * scale, f"{name}: eigenvalue error {lam_err}"
    assert resid < 1e-12 * scale, f"{name}: residual {resid}"
    print(f"proc {proc_id} {name}: lam_err {lam_err:.2e} "
          f"residual {resid:.2e} OK")
if proc_id == 0:
    np.save(out, lam.numpy())
dist.destroy_process_group()
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two(argv_of):
    """Start two processes (argv_of(i)) and wait for both, 300 s each."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(argv_of(i), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
    return outs


def test_two_process_distributed_solve(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    lam_file = tmp_path / "lam0.npy"
    outs = _run_two(lambda i: [sys.executable, str(script), str(i),
                               str(port), str(lam_file)])
    for i, out in enumerate(outs):
        assert all(f"proc {i} {name}:" in out
                   for name in ("f64", "mixed", "grouped")), out
    rng = np.random.default_rng(7)
    d = rng.standard_normal(256) * 2
    e = rng.standard_normal(255)
    lam_j = np.asarray(se.eigh_tridiagonal(
        d, e, eigvals_only=True, config=se.SolverConfig(leaf_size=8),
        mesh=jax_make_mesh()))
    lam = np.load(lam_file)
    assert np.abs(lam - lam_j).max() <= 1e-13 * np.abs(lam_j).max()


def test_two_process_cli(tmp_path):
    """``--coordinator/--num-processes/--process-id`` with ``--devices 8``
    (4 CPU shards a process): both exit 0 and the file process 0 writes is
    the one-process run's."""
    port = _free_port()
    argv = ["-s", "1", "-n", "256", "-e", "--device", "cpu"]
    cli = [sys.executable, "-m", "symmetric_eigenvalue_tpu_torch"]
    outs = _run_two(lambda i: cli + argv + [
        "--devices", "8", "--coordinator", f"localhost:{port}",
        "--num-processes", "2", "--process-id", str(i),
        str(tmp_path / "two.txt")])
    for out in outs:
        assert "Number of devices is: 8  (backend: cpu)" in out
        assert "Program finished successfully!" in out
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])
    subprocess.run(cli + argv + [str(tmp_path / "one.txt")], env=env,
                   check=True, capture_output=True, timeout=300)
    lam2, res2 = read_results(tmp_path / "two.txt")
    lam1, res1 = read_results(tmp_path / "one.txt")
    assert np.array_equal(lam1, lam2)
    assert max(res2) <= 1e-10 and max(res1) <= 1e-10
