"""Device mesh construction and sharding helpers.

Port of ``symmetric_eigenvalue_tpu/dist/mesh.py``.  The JAX package's mesh
is one controller per process over that process's devices (spanning every
process under ``jax.distributed``), and its helpers wrap a function in
``shard_map``.  Here a :class:`Mesh` is a value: this process's shard
devices, the process count and this process's index.  The helpers run the
function once per local shard, one shard after another from the host, on
that shard's device and on its slice of the inputs copied there, then
gather the outputs on the lead device (shard 0 of this process).  A
shard's card runs on while the host enqueues the next shard's work only
as far as the function is fetch-free: a host fetch inside it waits for
its own card, and the solver's sharded functions still make some of the
single-device code's fetches (the leaf eigensolve's, the downsweep's row
map), so on those calls the cards run one after another
(``rows_through_merge`` reads its rotation logs on the card and makes
none).  Across processes the outputs are
then all-gathered with ``torch.distributed`` (NCCL on CUDA, gloo on the
CPU), so every process holds the whole result, as the JAX package's
multi-process run asks with replicated out-shardings.

Global shards are ordered process-major, as ``jax.devices()`` orders
devices: process p holds global shards p*L .. p*L + L - 1 (L local
shards each).  One device may hold several shards (``make_mesh(devices=
[cpu] * 8)``, ``[cuda:0] * 4``): the counterpart of the JAX test suite's
virtual CPU devices.  The functions given to the helpers are
collective-free, as the JAX package's are; the sharded solve's only
collectives are these gathers.

``make_mesh`` is the analog of the reference's MPI bootstrap (main.c:23-36);
``distributed_init`` is the multi-process hook.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS = "dev"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` are this process's shards (shard 0, the lead
    device, holds gathered results and runs replicated work), repeated
    devices allowed; ``num_processes`` processes hold as many shards each."""

    devices: Tuple[torch.device, ...]
    num_processes: int = 1
    process_index: int = 0

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if not 0 <= self.process_index < self.num_processes:
            raise ValueError(f"process_index {self.process_index} outside "
                             f"[0, {self.num_processes})")

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def size(self) -> int:
        """Global shard count (the JAX mesh's ``devices.size``)."""
        return len(self.devices) * self.num_processes

    @property
    def first_shard(self) -> int:
        """Global index of this process's shard 0."""
        return self.process_index * len(self.devices)


def _process_layout() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _checked_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"unsupported mesh device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {dev} requested but "
                           "torch.cuda.is_available() is False")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"mesh device cuda:{index} does not exist "
                         f"({torch.cuda.device_count()} visible)")
    return torch.device("cuda", index)


def make_mesh(num_devices: Optional[int] = None, *,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``num_devices`` distinct CUDA cards (all visible ones
    when None), or over the explicit ``devices`` list, which may repeat a
    device (logical shards).  Under :func:`distributed_init`,
    ``num_devices`` counts the global shards (a multiple of the process
    count, each process taking its first num_devices / P cards) and the
    mesh spans every process.  Asking for more cards than are visible
    raises: unlike ``jax.make_mesh``'s slice, nothing is cut silently."""
    nproc, rank = _process_layout()
    if devices is not None:
        if num_devices is not None:
            raise ValueError("give num_devices or devices, not both")
        devs = tuple(_checked_device(d) for d in devices)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes CUDA cards and none is "
                               "visible; pass devices=[...] for CPU shards")
        visible = torch.cuda.device_count()
        per = visible
        if num_devices is not None:
            if num_devices < 1 or num_devices % nproc:
                raise ValueError(f"num_devices={num_devices} is not a "
                                 f"positive multiple of the {nproc} "
                                 "process(es)")
            per = num_devices // nproc
            if per > visible:
                raise ValueError(
                    f"asked for {num_devices} device(s) ({per} a process) "
                    f"but {visible} CUDA card(s) are visible")
        devs = tuple(torch.device("cuda", i) for i in range(per))
    return Mesh(devs, nproc, rank)


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None) -> None:
    """Multi-process bootstrap (analog of MPI_Init; see Makefile:37 /
    mpd.hosts): ``torch.distributed.init_process_group`` over
    ``tcp://<coordinator>`` ("host:port"), NCCL when CUDA is available and
    gloo otherwise (or ``backend``).  Each process must see its own cards
    (``CUDA_VISIBLE_DEVICES``): NCCL does not let two ranks share one."""
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("distributed_init needs coordinator, num_processes "
                         "and process_id")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, "
                         f"{num_processes})")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    # NCCL binds each rank to its first visible card (its lead device)
    bind = ({"device_id": torch.device("cuda", 0)} if backend == "nccl"
            else {})
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            **bind)


def agreed(mesh: Optional[Mesh], value: float) -> float:
    """``value`` made the same in every process of ``mesh``: the least over
    them.  For a decision read from a process's own state (its free
    memory) that changes which collectives follow: every process must
    take the same one."""
    if mesh is None or mesh.num_processes == 1:
        return value
    lead = mesh.lead
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=lead if lead.type == "cuda" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return float(t.item())


def _tree_map(fn, *trees):
    """``fn`` over the tensors of equally shaped trees (tensors, tuples,
    lists, NamedTuples; None stays None)."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if t is None:
        return None
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    raise TypeError(f"unsupported value in a sharded call: {type(t)}")


def _to(x, device):
    return _tree_map(lambda t: t.to(device), x)


def _device_scope(device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _on_shard(fn, args, device, shard: Optional[int]):
    """One shard's work, run with ``device`` current.  Every helper launches
    its per-shard work through here, and ``shard`` (the local index; None:
    replicated work on the lead device) is passed for instrumentation
    only: a caller that counts kernel launches by shard wraps this
    function (the mesh tests, ``chip_smoke.py``)."""
    with _device_scope(device):
        return fn(*args)


class Replicas:
    """``value`` copied once to each distinct device of ``mesh`` (a
    replicated argument that several sharded calls share): pass it where
    :func:`last_axis_sharded` takes a replicated argument."""

    def __init__(self, mesh: Mesh, value):
        self._copies = {}
        for dev in mesh.devices:
            if dev not in self._copies:
                self._copies[dev] = _to(value, dev)
        self.lead = self._copies[mesh.lead]

    def on(self, device: torch.device):
        return self._copies[device]


def _all_gather(x, mesh: Mesh, dim: int):
    """Every process's ``x`` concatenated along ``dim`` in process order."""
    if mesh.num_processes == 1:
        return x
    was_bool = x.dtype == torch.bool
    src = (x.to(torch.uint8) if was_bool else x).contiguous()
    P = mesh.num_processes
    if src.is_cuda:
        # NCCL: one buffer, the processes' blocks stacked along dim 0
        out = torch.empty((P * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src)
        if dim % src.ndim:
            out = torch.cat(out.chunk(P, dim=0), dim=dim)
    else:
        parts = [torch.empty_like(src) for _ in range(P)]
        dist.all_gather(parts, src)
        out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if was_bool else out


def _gather(outs, mesh: Mesh, dim: int):
    """The local shards' outputs (equally shaped trees) concatenated along
    ``dim`` on the lead device, then across processes."""
    lead = mesh.lead

    def cat(*parts):
        if len(parts) == 1:
            local = parts[0].to(lead)
        else:
            shape = list(parts[0].shape)
            shape[dim] = sum(p.shape[dim] for p in parts)
            local = torch.empty(shape, dtype=parts[0].dtype, device=lead)
            o = 0
            for p in parts:
                w = p.shape[dim]
                local.narrow(dim, o, w).copy_(p)
                o += w
        return _all_gather(local, mesh, dim)

    return _tree_map(cat, *outs)


def batch_mapped(fn, mesh: Optional[Mesh], batch: int):
    """Run a collective-free batched ``fn`` sharded over its leading batch
    axis: every argument's dim 0 is the batch, and global shard g takes rows
    g*b .. g*b + b - 1 (b = batch / ndev).  When the batch does not divide
    the mesh (or is smaller), ``fn`` runs replicated, whole, on the lead
    device (the reference's non-owner ranks at the top of the tree,
    eigenvalues.c:63-66).  Outputs: trees of tensors with the batch
    leading."""
    if mesh is None:
        return fn
    ndev = mesh.size
    if batch % ndev or batch < ndev:
        return replicated(fn, mesh)
    b = batch // ndev

    def run(*args):
        outs = []
        for s, dev in enumerate(mesh.devices):
            lo = (mesh.first_shard + s) * b
            part = tuple(_tree_map(lambda t: t[lo:lo + b].to(dev), a)
                         for a in args)
            outs.append(_on_shard(fn, part, dev, s))
        return _gather(outs, mesh, 0)

    return run


def last_axis_sharded(fn, mesh: Mesh, in_ndims, out_ndim: int):
    """``fn`` with each positional argument's *last* axis sharded over the
    mesh (None in ``in_ndims``: a replicated argument, copied whole to each
    shard's device, or a :class:`Replicas`), used for the column-sharded
    downsweep and the slot-sharded root merges: every shard computes its
    own contiguous columns end to end, with no collectives.  The sharded
    axis must be a multiple of the mesh size; outputs (``out_ndim``-D
    tensors, or trees of them) are concatenated along their last axis."""

    def run(*args):
        if len(args) != len(in_ndims):
            raise ValueError(f"expected {len(in_ndims)} arguments, got "
                             f"{len(args)}")
        widths = {a.shape[-1] for a, nd in zip(args, in_ndims)
                  if nd is not None}
        if len(widths) != 1:
            raise ValueError(f"sharded arguments disagree on their last "
                             f"axis: {sorted(widths)}")
        C = widths.pop()
        if C % mesh.size or C < mesh.size:
            raise ValueError(f"last axis {C} does not divide over "
                             f"{mesh.size} shards")
        w = C // mesh.size
        outs = []
        for s, dev in enumerate(mesh.devices):
            lo = (mesh.first_shard + s) * w
            part = []
            for a, nd in zip(args, in_ndims):
                if nd is not None:
                    part.append(a[..., lo:lo + w].to(dev))
                elif isinstance(a, Replicas):
                    part.append(a.on(dev))
                else:
                    part.append(_to(a, dev))
            outs.append(_on_shard(fn, tuple(part), dev, s))

        def check(t):
            if t.ndim != out_ndim:
                raise ValueError(f"expected {out_ndim}-D outputs, got "
                                 f"{t.ndim}-D")
            return t

        _tree_map(check, outs[0])
        return _gather(outs, mesh, -1)

    return run


def replicated(fn, mesh: Optional[Mesh]):
    """Run ``fn`` once on the lead device (its arguments copied there).
    Every process computes it itself: the same inputs give the same
    bits."""
    if mesh is None:
        return fn

    def run(*args):
        return _on_shard(fn, tuple(_to(a, mesh.lead) for a in args),
                         mesh.lead, None)

    return run
