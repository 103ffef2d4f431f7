"""Secular-equation merge: deflation + vectorized shifted root finding.

Port of ``symmetric_eigenvalue_tpu/kernels/secular.py``.  Every function
works on a whole tree level at once: where the JAX package vmaps one merge
over the level, here every tensor carries an explicit leading batch
dimension k (the level's merges), and ``lax.while_loop`` becomes a Python
loop with one host sync per iteration for all merges together.

Per merge: sort the poles, deflate negligible z entries and close poles
(Givens rotations on a static binary wave tree), stably partition the
active slots first, solve every root by a safeguarded Newton / dlaed4
"middle way" iteration in shifted coordinates tau = lambda - d_shift (the
per-iteration sums go through the ``secular_sums`` kernel), recompute z by
the Gu-Eisenstat (Lowner) formula and take the eigenvector column norms.
The tearing always gives rho >= 0, so only that interlacing branch exists.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .secular_sums import secular_sums


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


def map_slot_blocks(fn: Callable, m: int, block: int, device) -> torch.Tensor:
    """Run ``fn(slot_indices)`` over contiguous blocks of [0, m) and
    concatenate along dim 1 (the slot dimension of (k, m, ...) results).

    Bounds live memory to O(k * block * m) in the O(m^2) phases; the block
    is m halved while it exceeds ``block`` (the JAX package's rule)."""
    B = m
    while B > block and B % 2 == 0:
        B //= 2
    B = max(1, min(B, m))
    slots = torch.arange(m, device=device)
    if B == m:
        return fn(slots)
    return torch.cat([fn(slots[o:o + B]) for o in range(0, m, B)], dim=1)


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
    |c s (d_b - d_a)| stays under tol; rotations within a level touch
    disjoint slots, so each level is one gather/rotate/scatter and the levels
    are the replay waves.  Returns (d, z, defl, rotation log), the log packed
    level by level with masked-out writes dumped into slot m (trimmed).
    """
    k, m = ds.shape
    dev, dt = ds.device, ds.dtype
    L = max(1, (m - 1).bit_length())     # ceil(log2(m))
    M2 = 1 << L

    pad = M2 - m
    if pad:
        ds = torch.cat([ds, torch.zeros((k, pad), dtype=dt, device=dev)], 1)
        zs = torch.cat([zs, torch.zeros((k, pad), dtype=dt, device=dev)], 1)
        defl0 = torch.cat([defl0, torch.ones((k, pad), dtype=torch.bool,
                                             device=dev)], 1)

    d, z, defl = ds.clone(), zs.clone(), defl0.clone()
    ra = torch.zeros((k, m + 1), dtype=torch.int64, device=dev)
    rb = torch.zeros_like(ra)
    rc = torch.zeros((k, m + 1), dtype=dt, device=dev)
    rs = torch.zeros_like(rc)
    rw = torch.zeros_like(ra)
    nrot = torch.zeros(k, dtype=torch.int64, device=dev)

    for lvl in range(L):
        B = 1 << (lvl + 1)
        half = B >> 1
        nb = M2 // B
        act = (~defl).reshape(k, nb, B)
        ih = torch.arange(half, device=dev)
        neg = torch.full((), -1, dtype=torch.int64, device=dev)
        top = torch.full((), half, dtype=torch.int64, device=dev)
        la = torch.where(act[:, :, :half], ih, neg).amax(dim=2)
        fi = torch.where(act[:, :, half:], ih, top).amin(dim=2)
        have = (la >= 0) & (fi < half)
        base = torch.arange(nb, device=dev) * B
        a = base + la.clamp(min=0)
        b = base + half + fi.clamp(max=half - 1)
        da = d.gather(1, a)
        db = d.gather(1, b)
        za = z.gather(1, a)
        zb = z.gather(1, b)
        r = torch.sqrt(za * za + zb * zb)
        pos_r = r > 0
        rsafe = torch.where(pos_r, r, torch.ones_like(r))
        c = torch.where(pos_r, zb / rsafe, torch.ones_like(r))
        s = torch.where(pos_r, za / rsafe, torch.zeros_like(r))
        do = have & pos_r & (torch.abs(c * s * (db - da)) <= tol[:, None])
        d.scatter_(1, a, torch.where(do, c * c * da + s * s * db, da))
        d.scatter_(1, b, torch.where(do, s * s * da + c * c * db, db))
        z.scatter_(1, a, torch.where(do, torch.zeros_like(za), za))
        z.scatter_(1, b, torch.where(do, r, zb))
        defl.scatter_(1, a, defl.gather(1, a) | do)
        # pack this level's rotations densely after the previous levels'
        do_i = do.to(torch.int64)
        pos = nrot[:, None] + torch.cumsum(do_i, dim=1) - 1
        pos = torch.where(do, pos, torch.full_like(pos, m))
        ra.scatter_(1, pos, torch.where(do, a, ra.gather(1, pos)))
        rb.scatter_(1, pos, torch.where(do, b, rb.gather(1, pos)))
        rc.scatter_(1, pos, torch.where(do, c, rc.gather(1, pos)))
        rs.scatter_(1, pos, torch.where(do, s, rs.gather(1, pos)))
        rw.scatter_(1, pos, torch.where(do, torch.full_like(a, lvl + 1),
                                        rw.gather(1, pos)))
        nrot = nrot + do_i.sum(dim=1)

    nwave = rw[:, :m].amax(dim=1)
    return (d[:, :m], z[:, :m], defl[:, :m],
            (ra[:, :m], rb[:, :m], rc[:, :m], rs[:, :m], rw[:, :m], nrot,
             nwave))


def merge_partition(d, z, rho, *, eps: float,
                    deflation_factor: float) -> MergePartition:
    """Stage 1: sort, z-deflation, Givens deflation, stable partition.

    d, z: (k, m); rho: (k,) >= 0."""
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


def _solve_roots(poles_sec, zu, rho_e, K, active, eps, max_iters, tol_factor):
    """Safeguarded Newton / middle-way iteration on the shifted secular
    equation, for every root of every merge of the level at once.

    For active slot i (rho_e > 0) the root lies in (d_i, d_{i+1}), or in
    (d_{K-1}, d_{K-1} + rho_e] for the exterior root.  One midpoint
    evaluation picks the nearest pole and the iteration solves for
    tau = lambda - d_shift on h(tau) = tau D(tau) - rho_e z_s^2, which keeps
    full relative accuracy for roots arbitrarily close to their pole.  A
    converged root is frozen; the loop stops when all are (one host sync per
    iteration) or after ``max_iters``.  Returns (tau, shift_idx, shift_val).
    """
    k, m = poles_sec.shape
    dev, dt = poles_sec.device, poles_sec.dtype
    idx = torch.arange(m, device=dev)
    sl = idx.expand(k, m).contiguous()
    last = (K - 1).clamp(min=0)
    d_last = poles_sec.gather(1, last[:, None])
    rho_pos = rho_e.clamp(min=1e-30)[:, None]
    rho = rho_e[:, None]
    nxt = (idx + 1).clamp(max=m - 1).expand(k, m)
    interior = (idx + 1)[None, :] < K[:, None]
    right = torch.where(interior, poles_sec.gather(1, nxt), d_last + rho_pos)
    gap = right - poles_sec
    gap = torch.where(gap > 0, gap, torch.ones_like(gap))
    zu2 = zu * zu
    tolf = tol_factor * eps

    mid = poles_sec + 0.5 * gap
    S1mid = secular_sums(poles_sec, zu2, mid, torch.zeros_like(mid), sl)[0]
    fmid = 1.0 + rho * S1mid
    is_exterior = idx[None, :] == (K - 1)[:, None]
    shift_left = (fmid > 0) | is_exterior
    shift_idx = torch.where(shift_left, sl, nxt)
    shift_val = poles_sec.gather(1, shift_idx)
    zero = torch.zeros_like(gap)
    lo = torch.where(shift_left, torch.where(fmid > 0, zero, 0.5 * gap),
                     -0.5 * gap)
    hi = torch.where(shift_left, torch.where(fmid > 0, 0.5 * gap, gap), zero)
    tau = 0.5 * (lo + hi)
    zs2 = zu2.gather(1, shift_idx)
    # bracket poles for the middle-way model: delta_lo at slot sl, delta_hi
    # at sl+1 (or a far fake pole for the exterior root)
    delta_lo = poles_sec - shift_val
    delta_hi = torch.where(interior, poles_sec.gather(1, nxt) - shift_val,
                           4.0 * (torch.abs(gap) + 1.0))
    big = torch.tensor(1e30, dtype=dt, device=dev)
    one = torch.ones_like(gap)

    done = ~active
    it = 0
    while it < max_iters and not bool(done.all()):
        S1, S2, S1L, S2L = secular_sums(poles_sec, zu2, shift_val, tau, sl)
        # the shift slot's dif is -tau exactly (shift_val is the pole)
        inv_s = 1.0 / -tau
        t1s = zs2 * inv_s
        t2s = t1s * inv_s
        psi = rho * S1L
        psi1 = rho * S2L
        phi = rho * S1 - psi
        phi1 = rho * S2 - psi1
        f = 1.0 + psi + phi
        # convergence test on h = tau*D - rho*z_s^2 (singular term isolated)
        Ds = 1.0 + rho * (S1 - t1s)
        h = tau * Ds - rho * zs2
        scale_h = torch.abs(tau) * (1.0 + torch.abs(rho)
                                    * torch.abs(S1 - t1s)) + rho * zs2
        done_now = torch.abs(h) <= tolf * scale_h
        # sign(f) = sign(h) * sign(tau); f > 0 => root below tau
        f_pos = (h > 0) ^ (tau < 0)
        hi = torch.where(f_pos, torch.minimum(hi, tau), hi)
        lo = torch.where(f_pos, lo, torch.maximum(lo, tau))
        # middle-way model: c3 + c1/(Dlo - eta) + c2/(Dhi - eta) fitted to
        # f and f'  ->  a eta^2 - b eta + c = 0
        Dlo = delta_lo - tau
        Dhi = delta_hi - tau
        c1 = psi1 * Dlo * Dlo
        c2 = phi1 * Dhi * Dhi
        c3 = f - Dlo * psi1 - Dhi * phi1
        a = c3
        b = c3 * (Dlo + Dhi) + c1 + c2
        c = f * Dlo * Dhi
        disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
        sq = torch.sqrt(disc)
        q = 0.5 * (b + torch.where(b >= 0, sq, -sq))
        e1 = torch.where(a != 0, q / torch.where(a != 0, a, one), big)
        e2 = torch.where(q != 0, c / torch.where(q != 0, q, one), big)
        cand1 = tau + e1
        cand2 = tau + e2
        in1 = (cand1 > lo) & (cand1 < hi)
        in2 = (cand2 > lo) & (cand2 < hi)
        # prefer the smaller step (tangent root) among in-bracket options
        pick1 = in1 & (~in2 | (torch.abs(e1) <= torch.abs(e2)))
        t_quad = torch.where(pick1, cand1, cand2)
        ok_quad = (in1 | in2) & torch.isfinite(t_quad)
        # fallbacks: safeguarded Newton on h, then bisection
        hp = Ds + tau * rho * (S2 - t2s)
        t_newton = tau - h / torch.where(hp != 0, hp, one)
        in_n = (t_newton > lo) & (t_newton < hi)
        t_next = torch.where(ok_quad, t_quad,
                             torch.where(in_n, t_newton, 0.5 * (lo + hi)))
        done = done | done_now
        tau = torch.where(done, tau, t_next)
        it += 1
    return tau, shift_idx, shift_val


def _gu_eisenstat_z(poles_sec, zu, tau, shift_val, active, block):
    """Recompute z so the computed lambdas are *exact* eigenvalues of the
    model (Lowner formula; LAPACK dlaed3):

    zhat_j^2 = prod_{k active, k != j} (lam_k - d_j)/(d_k - d_j) * (lam_j - d_j)

    with lam_k - d_j evaluated as (shift_k - d_j) + tau_k.  Per j-block."""
    k, m = poles_sec.shape
    idx = torch.arange(m, device=poles_sec.device)

    def j_block(js):
        pj = poles_sec[:, js]                                   # (k, J)
        A = (shift_val[:, :, None] - pj[:, None, :]) + tau[:, :, None]
        Bm = poles_sec[:, :, None] - pj[:, None, :]
        use = active[:, :, None] & (idx[:, None] != js[None, :])[None]
        B_safe = torch.where(use, Bm, torch.ones_like(Bm))
        ratio = torch.where(use, A / B_safe, torch.ones_like(A))
        prod = torch.prod(ratio, dim=1)
        lam_minus_d = (shift_val[:, js] - pj) + tau[:, js]
        return prod * lam_minus_d

    z2 = map_slot_blocks(j_block, m, block, poles_sec.device)
    zhat = torch.sign(zu) * torch.sqrt(z2.clamp(min=0.0))
    return torch.where(active, zhat, torch.zeros_like(zhat))


def merge_roots(part: MergePartition, *, eps: float, max_secular_iters: int,
                secular_tol_factor: float, use_gu_eisenstat: bool,
                block_size: int = 2048) -> MergeRep:
    """Stage 2: the O(m^2) slot-parallel work — root finding, Gu-Eisenstat z,
    column norms, eigenvalue order."""
    da = part.poles
    poles_sec = part.poles_sec
    k, m = da.shape
    dev = da.device
    active = torch.arange(m, device=dev)[None, :] < part.K[:, None]

    tau, shift_idx, shift_val = _solve_roots(
        poles_sec, part.zu, part.rho_e, part.K, active, eps,
        max_secular_iters, secular_tol_factor)

    zvec = part.zu
    if use_gu_eisenstat:
        zvec = _gu_eisenstat_z(poles_sec, part.zu, tau, shift_val, active,
                               block_size)

    # column norms N_i = ||zhat_j / (d_j - lam_i)||, ratio-first, per block
    def norm_block(sl):
        dif = ((poles_sec[:, None, :] - shift_val[:, sl, None])
               - tau[:, sl, None])
        ratio = zvec[:, None, :] / dif
        return torch.sqrt(torch.sum(ratio * ratio, dim=2))

    colnorm = map_slot_blocks(norm_block, m, block_size, dev)
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
