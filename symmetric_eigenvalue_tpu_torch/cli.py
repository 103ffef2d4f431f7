"""Command-line driver ``cuppen`` of the PyTorch/CUDA port: flag parity with
the reference binary and with the JAX package's ``cli.py``.

Reference usage (main.c:703-734 ``showHelp``):
    cuppens [options] [outputfile]
      -h            help
      -i FILENAME   tridiagonal matrix in MTX format
      -s NUM        predefined scheme 1|2 (ignored when -i given)
      -n NUM        dimension for -s (default 1000)
      -e(FILENAME)  compute eigenvectors: bare -e = all; -eFILE = indices from
                    file (no blank between option and filename; a blank also
                    works here)
Extras: --leaf-size, --devices, --profile-dir, --f32, --device.

The port's deltas from the JAX package's CLI:

- ``--device {cuda,cpu}`` (default ``cuda``) takes the place of the JAX
  package's ``JAX_PLATFORMS``.  A ``cuda`` request without a card raises
  (``config.resolve_device``); nothing falls back to the CPU.
- ``--devices N`` shards the solve over a mesh (``dist.mesh``): on CUDA
  N distinct cards (fewer than N visible prints so and returns 1, where
  ``jax.make_mesh`` would cut the list), with ``--device cpu`` N logical
  shards of the CPU (the JAX package's virtual CPU devices).  Without
  ``--devices`` the run takes one device (one card a process), where the
  JAX CLI takes every device: the port's mesh gathers the basis on the
  lead card (the JAX package's stays sharded), so a mesh would not widen
  what fits, and a run with a mesh never takes the streamed branch.
  ``--coordinator``, ``--num-processes`` and
  ``--process-id`` start ``torch.distributed`` (NCCL on CUDA, gloo on the
  CPU; each process must see its own cards); they go together, and an
  incomplete or inconsistent set prints so and returns 1.  Only process 0
  writes the output file.
- The output file's residual column is computed on the device in column
  chunks (``driver.residuals``), not in one pass over the whole basis,
  whose temporaries would not fit beside the largest resident solves.
- The streamed branch (all eigenvectors, no selection: the output file
  holds eigenvalues and residuals, never the vectors, so columns are made
  in halo'd windows, checked on the device and released) is taken on CUDA
  when 12 n^2 bytes pass 12/14.5 of the card's usable memory
  (:func:`_use_streamed`; the JAX package's 12e9 bytes of a 16 GB chip, as
  a share).  There is no environment variable for it.
- ``--profile-dir`` writes a ``torch.profiler`` Chrome trace.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

# The JAX package streams past 12e9 bytes of 12*n^2 on a chip with ~14.5e9
# usable bytes; here the same share of the run device's usable memory.
_STREAM_SHARE = 12e9 / 14.5e9


def _preprocess_argv(argv: List[str]) -> List[str]:
    """getopt ``-e::`` semantics: the filename must be glued (``-eFILE``); a
    bare ``-e`` means all eigenvectors (main.c:123-127: 'there is no blank
    between the option and the filename')."""
    out = []
    for a in argv:
        if a.startswith("-e") and len(a) > 2 and not a.startswith("-e="):
            out.extend(["--evfile", a[2:]])
        else:
            out.append(a)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cuppen",
        description="Compute all eigenpairs of a symmetric tridiagonal matrix "
                    "with a parallel Cuppen divide-and-conquer algorithm on "
                    "a CUDA GPU (PyTorch port). Results can be written to an "
                    "output file.",
    )
    p.add_argument("-i", metavar="FILENAME", dest="inputfile", default=None,
                   help="file containing a tridiagonal matrix in mtx format")
    p.add_argument("-s", metavar="NUM", dest="scheme", type=int, default=1,
                   help="predefined matrix scheme: 1 = [-1, d_i, -1] with d_i "
                        "evenly spaced in [1,100]; 2 = Poisson [-1,2,-1] "
                        "(eigenvalue i is 2+2cos(pi*i/(n+1)))")
    p.add_argument("-n", metavar="NUM", dest="dim", type=int, default=1000,
                   help="dimension of the matrix chosen with -s "
                        "(default 1000)")
    p.add_argument("-e", dest="eall", action="store_true",
                   help="compute all eigenvectors; use -eFILENAME (no blank) "
                        "to read 1-based indices from a file (one per line)")
    p.add_argument("--evfile", dest="evfile", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("outputfile", nargs="?", default=None)
    p.add_argument("--leaf-size", type=int, default=None,
                   help="target base-case block size of the merge tree "
                        "(default: auto — 32)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the solve runs (default: cuda; no fallback "
                        "to the CPU)")
    p.add_argument("--devices", type=int, default=None,
                   help="number of devices to shard over (default: one "
                        "a process)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace to this directory")
    p.add_argument("--f32", action="store_true",
                   help="solve in float32 (~1e-5 residuals)")
    # multi-process bootstrap (mpd.hosts / mpirun -f analog, Makefile:37)
    p.add_argument("--coordinator", default=None,
                   help="coordinator address (host:port) for "
                        "multi-process execution")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def _use_streamed(n: int, compute_ev: bool, select, device) -> bool:
    """The streamed branch's gate: all eigenvectors, no selection, a CUDA
    device, and 12 n^2 bytes (the resident route's f32 downsweep output
    and f64 copy) above ``_STREAM_SHARE`` of ``usable_device_bytes``.  A
    run with a mesh never streams (the mesh shards the resident solve)."""
    import torch

    from .config import usable_device_bytes
    dev = torch.device(device)
    return (compute_ev and select is None and dev.type == "cuda"
            and 12.0 * float(n) * n > _STREAM_SHARE * usable_device_bytes(dev))


def _process_flags_error(args) -> Optional[str]:
    """Why the multi-process flags cannot start a run, or None: they go
    together, with 0 <= process id < process count."""
    given = (args.coordinator is not None, args.num_processes is not None,
             args.process_id is not None)
    if not any(given):
        return None
    if not all(given):
        return ("--coordinator, --num-processes and --process-id must be "
                "given together.")
    if args.num_processes < 1 or not 0 <= args.process_id < \
            args.num_processes:
        return (f"--process-id {args.process_id} is outside [0, "
                f"--num-processes {args.num_processes}).")
    return None


def _shard_count(args) -> int:
    """The mesh's size: ``--devices``, else one device a process."""
    import torch.distributed as dist
    if args.devices is not None:
        return args.devices
    return dist.get_world_size() if dist.is_initialized() else 1


def _make_run_mesh(ndev: int, dev):
    """The mesh of ``ndev`` global shards on ``dev``'s type: distinct cards
    on CUDA, logical shards of the CPU.  Raises ValueError when it cannot
    be made."""
    import torch.distributed as dist

    from .dist.mesh import make_mesh
    if dev.type == "cuda":
        return make_mesh(ndev)
    nproc = dist.get_world_size() if dist.is_initialized() else 1
    if ndev % nproc:
        raise ValueError(f"--devices {ndev} is not a multiple of the "
                         f"{nproc} processes")
    return make_mesh(devices=[dev] * (ndev // nproc))


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        build_parser().print_help()
        return 0
    args = build_parser().parse_args(_preprocess_argv(argv))

    if args.inputfile is None and args.scheme not in (1, 2):
        print("Invalid argument for option -s. See help.", file=sys.stderr)
        return 1
    if args.dim < 1:
        print("Invalid argument for option -n. See help.", file=sys.stderr)
        return 1
    if args.devices is not None and args.devices < 1:
        print("Invalid argument for option --devices. See help.",
              file=sys.stderr)
        return 1
    why = _process_flags_error(args)
    if why is not None:
        print(why, file=sys.stderr)
        return 1

    # Heavy imports after arg validation (fast ``-h``).
    import torch
    import torch.distributed as dist

    if args.coordinator is not None:
        from .dist.mesh import distributed_init
        distributed_init(args.coordinator, args.num_processes,
                         args.process_id,
                         backend="nccl" if args.device == "cuda" else "gloo")
    try:
        return _run(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args) -> int:
    """The CLI's run after its flags are checked (and torch.distributed
    started, for several processes)."""
    import torch
    import torch.distributed as dist

    from .config import SolverConfig, resolve_device
    from .core.tridiag import create_matrix_scheme1, create_matrix_scheme2
    from .driver import (EighTridiagonalResult, _residual_norms_chunked,
                         residuals, solve_tridiagonal_staged,
                         solve_tridiagonal_streamed)
    from .io.evselect import determine_eigenvectors_to_compute
    from .io.mtx import read_symmetric_tridiagonal
    from .io.results import write_results
    from .utils.timing import PhaseTimer, maybe_profile

    dev = resolve_device(args.device)
    dtype = torch.float32 if args.f32 else torch.float64
    ndev, mesh = _shard_count(args), None
    if ndev > 1:
        try:
            mesh = _make_run_mesh(ndev, dev)
        except ValueError as exc:
            print(f"Cannot shard over {ndev} devices: {exc}", file=sys.stderr)
            return 1
        dev = mesh.lead

    if args.inputfile is not None:
        print(f"Input file: {args.inputfile}")
        try:
            d_np, e_np = read_symmetric_tridiagonal(args.inputfile)
        except (OSError, ValueError) as exc:
            # clean diagnostic + nonzero exit, matching the reference's file
            # error handling (main.c:181 MPI_ABORT path); MTXFormatError is a
            # ValueError subclass
            print(f"Could not read input file: {exc}", file=sys.stderr)
            return 1
        n = d_np.shape[0]
        d = torch.as_tensor(d_np, dtype=dtype).to(dev)
        e = torch.as_tensor(e_np, dtype=dtype).to(dev)
    else:
        n = args.dim
        print(f"Use a matrix of scheme {args.scheme} with dimension {n}")
        gen = (create_matrix_scheme1 if args.scheme == 1
               else create_matrix_scheme2)
        d, e = gen(n, dtype=dtype, device=dev)

    compute_ev = args.eall or args.evfile is not None
    ev_filename = args.evfile
    if compute_ev:
        if ev_filename is not None:
            print(f"Compute the eigenvectors defined in: {ev_filename}")
        else:
            print("Program will compute all eigenvectors")
    if args.outputfile is not None:
        print(f"Output file: {args.outputfile}")

    print()
    print(f"Number of devices is: {ndev}  (backend: {dev.type})")

    selection = determine_eigenvectors_to_compute(compute_ev, ev_filename, n)
    select = None
    if selection.indices is not None:
        select = np.asarray(sorted(set(selection.indices)), dtype=np.int64)
        if select.size == 0 and not selection.all:
            compute_ev = False
            select = None

    config = SolverConfig(leaf_size=args.leaf_size, dtype=dtype,
                          device=dev.type)
    chunk = max(1, min(config.vec_chunk, config.resolved_refine_chunk(n, dev)))

    print("Start divide phase ...")
    print("Apply batched eigensolver on leaves ...")
    print("Start Conquer Phase ...")
    timer = PhaseTimer(dev)
    res_vals = None
    computed_idx = None
    with maybe_profile(args.profile_dir):
        if mesh is None and _use_streamed(n, compute_ev, select, dev):
            lam, blocks, timer = solve_tridiagonal_streamed(
                d, e, config=config, timer=timer, device=dev)
            parts = []
            for a, Vo in blocks:
                w = int(Vo.shape[1])
                parts.append(_residual_norms_chunked(d, e, lam[a:a + w], Vo,
                                                     min(chunk, w)))
                del Vo
            res_vals = torch.cat(parts).cpu().numpy()
            result = EighTridiagonalResult(eigenvalues=lam,
                                           eigenvectors=None)
        else:
            result, timer = solve_tridiagonal_staged(
                d, e, config=config,
                compute_vectors=(compute_ev and select is None),
                select=select, timer=timer, device=dev, mesh=mesh)

    print()
    print(timer.report())

    if args.outputfile is not None:
        print()
        print("Write results to file ...")
        if result.eigenvectors is not None:
            res_vals = residuals(d, e, result, select, chunk).cpu().numpy()
            computed_idx = select
        if not dist.is_initialized() or dist.get_rank() == 0:
            write_results(args.outputfile, result.eigenvalues.cpu().numpy(),
                          res_vals, computed_idx)

    print()
    print("Program finished successfully!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
