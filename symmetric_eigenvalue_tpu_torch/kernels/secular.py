"""Secular-equation merge: deflation + vectorized shifted root finding.

Port of ``symmetric_eigenvalue_tpu/kernels/secular.py``.  Every function
works on a whole tree level at once: where the JAX package vmaps one merge
over the level, here every tensor carries an explicit leading batch
dimension k (the level's merges), the root finder's ``lax.while_loop``
becomes one ``secular_solve`` launch per level on the card, and the
deflation tree one ``deflation_tree`` launch per level.

Per merge: sort the poles, deflate negligible z entries and close poles
(Givens rotations on a static binary wave tree), stably partition the
active slots first, solve every root by a safeguarded Newton / dlaed4
"middle way" iteration in shifted coordinates tau = lambda - d_shift (the
``secular_sums`` and ``secular_solve`` kernels), recompute z by
the Gu-Eisenstat (Lowner) formula and take the eigenvector column norms.
The tearing always gives rho >= 0, so only that interlacing branch exists.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..dist.mesh import last_axis_sharded
from .deflation_tree import deflation_tree
from .secular_sums import RootSetup, secular_solve, secular_sums


class MergeRep(NamedTuple):
    """Compact representation of the k rank-one merges of one level.

    Every field has a leading batch dimension k.  Index spaces refer to the
    *partitioned* ordering: poles sorted ascending, then stably partitioned
    so non-deflated ("active") slots come first; ``p12`` maps back to the
    original (concat-of-children) order.  Index fields are int64.
    """

    poles: torch.Tensor      # (k, m) post-rotation pole values
    poles_sec: torch.Tensor  # (k, m) poles with far sentinels in inactive slots
    zhat: torch.Tensor       # (k, m) unit-scale z (Gu-Eisenstat); 0 if inactive
    rho: torch.Tensor        # (k,) effective rho (rho * ||z_active||^2)
    tau: torch.Tensor        # (k, m) root offset from its shift pole
    shift_idx: torch.Tensor  # (k, m) slot index of the shift pole per root
    colnorm: torch.Tensor    # (k, m) eigenvector column norms (1 if inactive)
    K: torch.Tensor          # (k,) number of active slots
    p12: torch.Tensor        # (k, m) original index held by partitioned slot j
    rot_a: torch.Tensor      # (k, m) rotation log: deflated slot
    rot_b: torch.Tensor      # (k, m) rotation log: surviving slot
    rot_c: torch.Tensor      # (k, m) cosines
    rot_s: torch.Tensor      # (k, m) sines
    rot_wave: torch.Tensor   # (k, m) wave (tree level, 1-based) of each rotation
    nrot: torch.Tensor       # (k,) number of logged rotations
    nwave: torch.Tensor      # (k,) number of waves
    colperm: torch.Tensor    # (k, m) slot index of the i-th ascending eigenvalue
    lam_sorted: torch.Tensor  # (k, m) eigenvalues ascending


def widened(rep: MergeRep) -> MergeRep:
    """``rep`` with its floating fields in f64 (the same tensors where they
    already are): f32 mode's backtransform runs on the f64 mode's kernels."""
    return MergeRep(*(t.to(torch.float64) if t.is_floating_point() else t
                      for t in rep))


class MergePartition(NamedTuple):
    """Sort/deflation/partition state (stage 1 of a merge): O(m) data only."""

    poles: torch.Tensor
    poles_sec: torch.Tensor
    zu: torch.Tensor
    rho_e: torch.Tensor
    K: torch.Tensor
    p12: torch.Tensor
    rot_a: torch.Tensor
    rot_b: torch.Tensor
    rot_c: torch.Tensor
    rot_s: torch.Tensor
    rot_wave: torch.Tensor
    nrot: torch.Tensor
    nwave: torch.Tensor


def _slot_chunks(fn, slots, block: int, args) -> torch.Tensor:
    """``fn(slot_block, *args)`` over contiguous blocks of ``slots``,
    concatenated along dim 1; the block is |slots| halved while it exceeds
    ``block`` (the JAX package's rule)."""
    ms = slots.shape[0]
    B = ms
    while B > block and B % 2 == 0:
        B //= 2
    B = max(1, min(B, ms))
    if B == ms:
        return fn(slots, *args)
    return torch.cat([fn(slots[o:o + B], *args) for o in range(0, ms, B)],
                     dim=1)


def map_slot_blocks(fn: Callable, m: int, block: int, device, mesh=None,
                    args=()) -> torch.Tensor:
    """Run ``fn(slot_indices, *args)`` over contiguous blocks of [0, m) and
    concatenate along dim 1 (the slot dimension of (k, m, ...) results).

    Bounds live memory to O(k * block * m) in the O(m^2) phases; the block
    is m halved while it exceeds ``block`` (the JAX package's rule).

    With ``mesh`` (and m a multiple of its size), [0, m) is first split
    into contiguous slot ranges over the shards (``last_axis_sharded``):
    each shard runs its own blocks on its device, on copies of ``args``
    (the O(m) tensors ``fn`` reads; it reads no other tensor), and the
    (k, m) results are gathered on the lead device.  This is how the wide
    top-of-tree merges use the whole mesh."""
    slots = torch.arange(m, device=device)
    if mesh is not None and m % mesh.size == 0 and m >= mesh.size:
        def shard(sl, *a):
            return _slot_chunks(fn, sl, block, a)

        return last_axis_sharded(shard, mesh, (1,) + (None,) * len(args),
                                 2)(slots, *args)
    return _slot_chunks(fn, slots, block, args)


def inverse_permutation(perm):
    """inv with inv[b, perm[b, j]] = j (the JAX package's argsort(perm))."""
    inv = torch.empty_like(perm)
    src = torch.arange(perm.shape[-1], device=perm.device).expand_as(perm)
    return inv.scatter_(-1, perm, src.contiguous())


def _deflation_tree(ds, zs, defl0, tol):
    """Wave-tree Givens deflation over ascending poles, batched over merges.

    Level l pairs, within every aligned block of 2^(l+1) slots, the LAST
    active slot of the left half with the FIRST active slot of the right half
    and rotates the earlier pole away when the induced off-diagonal
    |c s (d_b - d_a)| stays under tol; the levels are the replay waves.
    Returns (d, z, defl, rotation log), the log packed level by level.  One
    ``deflation_tree`` launch on the card; CPU tensors run its plain
    version, the torch loop (``kernels/deflation_tree.py``).
    """
    return deflation_tree(ds, zs, defl0, tol)


def merge_partition(d, z, rho, *, eps: float,
                    deflation_factor: float) -> MergePartition:
    """Stage 1: sort, z-deflation, Givens deflation, stable partition.

    d, z: (k, m); rho: (k,) >= 0."""
    with torch.profiler.record_function("merge.partition"):
        return _merge_partition(d, z, rho, eps, deflation_factor)


def _merge_partition(d, z, rho, eps: float,
                     deflation_factor: float) -> MergePartition:
    k, m = d.shape
    dev, dt = d.device, d.dtype

    perm1 = torch.argsort(d, dim=1, stable=True)
    ds = d.gather(1, perm1)
    zs = z.gather(1, perm1)

    znorm0_sq = torch.sum(zs * zs, dim=1)
    znorm0 = torch.sqrt(znorm0_sq)
    # deflation scale over *real* slots only: pad sentinels (z == 0, poles
    # far above the spectrum) would otherwise inflate the tolerance
    pole_scale = torch.abs(torch.where(zs != 0.0, ds,
                                       torch.zeros_like(ds))).amax(dim=1)
    pole_scale = torch.where(pole_scale > 0, pole_scale,
                             torch.abs(ds).amax(dim=1))
    scale = torch.maximum(pole_scale, torch.abs(rho) * znorm0_sq)
    scale = scale.clamp(min=1e-30)
    tol = deflation_factor * eps * scale

    # type-1 deflation: negligible z component
    zdef = (torch.abs(rho) * znorm0)[:, None] * torch.abs(zs) <= tol[:, None]
    zs0 = torch.where(zdef, torch.zeros_like(zs), zs)

    # type-2 deflation: close poles, Givens rotations
    d2, z2, defl, (ra, rb, rc, rs, rw, nrot, nwave) = _deflation_tree(
        ds, zs0, zdef, tol)

    # stable partition: active slots first
    perm2 = torch.argsort(defl.to(torch.uint8), dim=1, stable=True)
    da = d2.gather(1, perm2)
    za = z2.gather(1, perm2)
    K = m - defl.sum(dim=1)
    inv2 = inverse_permutation(perm2)      # sorted position -> partitioned slot
    ra_p = inv2.gather(1, ra)
    rb_p = inv2.gather(1, rb)
    p12 = perm1.gather(1, perm2)

    idx = torch.arange(m, device=dev)
    active = idx[None, :] < K[:, None]

    znorm_sq = torch.sum(za * za, dim=1)
    znorm = torch.sqrt(znorm_sq.clamp(min=1e-30))
    zu = torch.where(active, za / znorm[:, None], torch.zeros_like(za))
    rho_e = rho * znorm_sq

    # sentinel poles in inactive slots keep every denominator nonzero
    sent_base = 4.0 * scale + 4.0
    sent_step = 1e-3 * scale + 1e-3
    poles_sec = torch.where(active, da, sent_base[:, None]
                            + idx.to(dt)[None, :] * sent_step[:, None])

    return MergePartition(poles=da, poles_sec=poles_sec, zu=zu, rho_e=rho_e,
                          K=K, p12=p12, rot_a=ra_p, rot_b=rb_p, rot_c=rc,
                          rot_s=rs, rot_wave=rw, nrot=nrot, nwave=nwave)


def _root_setup(poles_sec, zu, rho_e, K, active, slots=None):
    """The root finder's state before its iteration, for the roots at
    ``slots`` ((B,) slot indices; None: every slot) of every merge of the
    level: one midpoint sweep (``secular_sums``) picks each root's nearest
    pole as its shift, and the bracket of tau = lambda - d_shift, the
    starting tau and the middle-way model's bracket poles follow.

    For active slot i (rho_e > 0) the root lies in (d_i, d_{i+1}), or in
    (d_{K-1}, d_{K-1} + rho_e] for the exterior root.  Returns (RootSetup,
    shift_idx) with the per-root fields (k, B); each root's fields are
    bit for bit the same whatever ``slots`` holds besides it."""
    k, m = poles_sec.shape
    dev = poles_sec.device
    idx = torch.arange(m, device=dev) if slots is None else slots
    B = idx.shape[0]
    sl = idx.expand(k, B).contiguous()
    last = (K - 1).clamp(min=0)
    d_last = poles_sec.gather(1, last[:, None])
    rho_pos = rho_e.clamp(min=1e-30)[:, None]
    rho = rho_e[:, None]
    own = poles_sec.gather(1, sl)
    nxt = (idx + 1).clamp(max=m - 1).expand(k, B)
    interior = (idx + 1)[None, :] < K[:, None]
    right = torch.where(interior, poles_sec.gather(1, nxt), d_last + rho_pos)
    gap = right - own
    gap = torch.where(gap > 0, gap, torch.ones_like(gap))
    zu2 = zu * zu

    mid = own + 0.5 * gap
    S1mid = secular_sums(poles_sec, zu2, mid, torch.zeros_like(mid), sl, K)[0]
    fmid = 1.0 + rho * S1mid
    is_exterior = idx[None, :] == (K - 1)[:, None]
    shift_left = (fmid > 0) | is_exterior
    shift_idx = torch.where(shift_left, sl, nxt)
    shift_val = poles_sec.gather(1, shift_idx)
    zero = torch.zeros_like(gap)
    lo = torch.where(shift_left, torch.where(fmid > 0, zero, 0.5 * gap),
                     -0.5 * gap)
    hi = torch.where(shift_left, torch.where(fmid > 0, 0.5 * gap, gap), zero)
    tau0 = 0.5 * (lo + hi)
    zs2 = zu2.gather(1, shift_idx)
    # bracket poles for the middle-way model: delta_lo at slot sl, delta_hi
    # at sl+1 (or a far fake pole for the exterior root)
    delta_lo = own - shift_val
    delta_hi = torch.where(interior, poles_sec.gather(1, nxt) - shift_val,
                           4.0 * (torch.abs(gap) + 1.0))
    setup = RootSetup(poles_sec=poles_sec, zu2=zu2, rho_e=rho_e, K=K,
                      shift_val=shift_val, zs2=zs2, lo=lo, hi=hi, tau0=tau0,
                      delta_lo=delta_lo, delta_hi=delta_hi,
                      done0=~active.gather(1, sl))
    return setup, shift_idx


_PER_ROOT = ("shift_val", "zs2", "lo", "hi", "tau0", "delta_lo", "delta_hi")


def _embedded(setup: RootSetup, slots, m: int) -> RootSetup:
    """A (k, B) setup of the roots at ``slots`` as the (k, m) setup that
    ``secular_solve`` takes: every other root done before it starts (its
    fields 0), so its block of 32 roots leaves at once."""
    k = setup.poles_sec.shape[0]
    fields = setup._asdict()
    for name in _PER_ROOT:
        full = setup.poles_sec.new_zeros((k, m))
        full[:, slots] = fields[name]
        fields[name] = full
    done0 = torch.ones((k, m), dtype=torch.bool, device=slots.device)
    done0[:, slots] = setup.done0
    fields["done0"] = done0
    return RootSetup(**fields)


def _solve_slot_roots(slots, poles_sec, zu, rho_e, K, active, tolf,
                      max_iters):
    """tau, shift_idx and shift_val (each (k, B)) of the roots at ``slots``
    (None: all): their setup, then one ``secular_solve`` over the level
    with every other root done.  A root's iteration reads only its own
    state, so each tau is bit for bit the one an all-slot solve gives."""
    setup, shift_idx = _root_setup(poles_sec, zu, rho_e, K, active, slots)
    if slots is not None and slots.shape[0] < poles_sec.shape[1]:
        tau, _ = secular_solve(_embedded(setup, slots, poles_sec.shape[1]),
                               tolf, max_iters)
        tau = tau[:, slots]
    else:
        tau, _ = secular_solve(setup, tolf, max_iters)
    return tau, shift_idx, setup.shift_val


def _solve_roots(poles_sec, zu, rho_e, K, active, eps, max_iters, tol_factor,
                 slot_mesh=None):
    """Safeguarded Newton / middle-way iteration on the shifted secular
    equation, for every root of every merge of the level at once.

    After the setup (:func:`_root_setup`), the iteration solves for
    tau = lambda - d_shift on h(tau) = tau D(tau) - rho_e z_s^2, which keeps
    full relative accuracy for roots arbitrarily close to their pole; a
    converged root is frozen, as is one whose pass leaves tau and its
    bracket unchanged (a fixed point).  On the card the whole iteration is one
    ``secular_solve`` launch (each block of roots iterates until its own
    roots converge, as the JAX package's per-slot-block while_loop does; no
    host sync); CPU tensors run its plain version.  Returns (tau, shift_idx,
    shift_val) in the poles' dtype.

    ``slot_mesh``: the slots [0, m) split over the mesh's shards (m a
    multiple of its size), each shard setting up and solving its own roots
    on its device (:func:`_solve_slot_roots`), the results gathered on the
    lead device: bit for bit the unsharded tau.

    f32 mode: the kernels are f64-only (as the JAX package's, which run
    only in f64), so the setup and the iteration take the operands widened
    to f64 and tau comes back rounded to f32; the tolerance is still the
    f32 ``eps`` the caller passes.
    """
    dt = poles_sec.dtype
    m = poles_sec.shape[1]
    args = (*(t.to(torch.float64) for t in (poles_sec, zu, rho_e)), K,
            active)
    with torch.profiler.record_function("secular.solve_roots"):
        if (slot_mesh is not None and m % slot_mesh.size == 0
                and m >= slot_mesh.size):
            def shard(slots, *a):
                return _solve_slot_roots(slots, *a, tol_factor * eps,
                                         max_iters)

            tau, shift_idx, shift_val = last_axis_sharded(
                shard, slot_mesh, (1,) + (None,) * len(args), 2)(
                torch.arange(m, device=poles_sec.device), *args)
        else:
            tau, shift_idx, shift_val = _solve_slot_roots(
                None, *args, tol_factor * eps, max_iters)
    return tau.to(dt), shift_idx, shift_val.to(dt)


def _z2_block(js, poles_sec, shift_val, tau, active):
    """zhat^2 at the poles ``js`` by the Lowner product (see
    :func:`_gu_eisenstat_z`): (k, |js|)."""
    m = poles_sec.shape[1]
    idx = torch.arange(m, device=poles_sec.device)
    pj = poles_sec[:, js]                                       # (k, J)
    A = (shift_val[:, :, None] - pj[:, None, :]) + tau[:, :, None]
    Bm = poles_sec[:, :, None] - pj[:, None, :]
    use = active[:, :, None] & (idx[:, None] != js[None, :])[None]
    B_safe = torch.where(use, Bm, torch.ones_like(Bm))
    ratio = torch.where(use, A / B_safe, torch.ones_like(A))
    prod = torch.prod(ratio, dim=1)
    lam_minus_d = (shift_val[:, js] - pj) + tau[:, js]
    return prod * lam_minus_d


def _gu_eisenstat_z(poles_sec, zu, tau, shift_val, active, block,
                    slot_mesh=None):
    """Recompute z so the computed lambdas are *exact* eigenvalues of the
    model (Lowner formula; LAPACK dlaed3):

    zhat_j^2 = prod_{k active, k != j} (lam_k - d_j)/(d_k - d_j) * (lam_j - d_j)

    with lam_k - d_j evaluated as (shift_k - d_j) + tau_k.  Per j-block,
    the blocks sharded over ``slot_mesh`` when given."""
    m = poles_sec.shape[1]
    z2 = map_slot_blocks(_z2_block, m, block, poles_sec.device,
                         mesh=slot_mesh,
                         args=(poles_sec, shift_val, tau, active))
    zhat = torch.sign(zu) * torch.sqrt(z2.clamp(min=0.0))
    return torch.where(active, zhat, torch.zeros_like(zhat))


def _norm_block(sl, poles_sec, shift_val, tau, zvec):
    """Column norms N_i = ||zhat_j / (d_j - lam_i)|| of the roots ``sl``,
    ratio first: (k, |sl|)."""
    dif = ((poles_sec[:, None, :] - shift_val[:, sl, None])
           - tau[:, sl, None])
    ratio = zvec[:, None, :] / dif
    return torch.sqrt(torch.sum(ratio * ratio, dim=2))


def merge_roots(part: MergePartition, *, eps: float, max_secular_iters: int,
                secular_tol_factor: float, use_gu_eisenstat: bool,
                block_size: int = 2048, slot_mesh=None) -> MergeRep:
    """Stage 2: the O(m^2) slot-parallel work — root finding, Gu-Eisenstat z,
    column norms, eigenvalue order.  With ``slot_mesh`` the first three are
    sharded over the mesh's shards by slot (each shard's roots, z entries
    and norms on its device, gathered on the lead device); the eigenvalue
    order runs on the lead device."""
    da = part.poles
    poles_sec = part.poles_sec
    k, m = da.shape
    dev = da.device
    active = torch.arange(m, device=dev)[None, :] < part.K[:, None]

    tau, shift_idx, shift_val = _solve_roots(
        poles_sec, part.zu, part.rho_e, part.K, active, eps,
        max_secular_iters, secular_tol_factor, slot_mesh=slot_mesh)

    with torch.profiler.record_function("merge.z_colnorm"):
        zvec = part.zu
        if use_gu_eisenstat:
            zvec = _gu_eisenstat_z(poles_sec, part.zu, tau, shift_val, active,
                                   block_size, slot_mesh=slot_mesh)
        colnorm = map_slot_blocks(_norm_block, m, block_size, dev,
                                  mesh=slot_mesh,
                                  args=(poles_sec, shift_val, tau, zvec))
    colnorm = torch.where(active & (colnorm > 0), colnorm,
                          torch.ones_like(colnorm))

    lam_slot = torch.where(active, shift_val + tau, da)
    colperm = torch.argsort(lam_slot, dim=1, stable=True)
    lam_sorted = lam_slot.gather(1, colperm)

    return MergeRep(poles=da, poles_sec=poles_sec, zhat=zvec, rho=part.rho_e,
                    tau=tau, shift_idx=shift_idx, colnorm=colnorm, K=part.K,
                    p12=part.p12, rot_a=part.rot_a, rot_b=part.rot_b,
                    rot_c=part.rot_c, rot_s=part.rot_s,
                    rot_wave=part.rot_wave, nrot=part.nrot, nwave=part.nwave,
                    colperm=colperm, lam_sorted=lam_sorted)


def merge_decompose(d, z, rho, *, eps: float, deflation_factor: float,
                    max_secular_iters: int, secular_tol_factor: float,
                    use_gu_eisenstat: bool, block_size: int = 2048) -> MergeRep:
    """Solve the k rank-one merges D + rho z z^T of one level -> MergeRep.

    ``d``: (k, m) child eigenvalues (any order; pads carry large sentinels
    and exactly/near-zero z).  ``z``: (k, m).  ``rho``: (k,) >= 0.
    """
    part = merge_partition(d, z, rho, eps=eps,
                           deflation_factor=deflation_factor)
    return merge_roots(part, eps=eps, max_secular_iters=max_secular_iters,
                       secular_tol_factor=secular_tol_factor,
                       use_gu_eisenstat=use_gu_eisenstat,
                       block_size=block_size)
