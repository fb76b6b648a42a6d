"""Environment (inactive) iterative triples from DF factors.

Port of ``pyscf_mpcc_tpu/cc/ccsdt_env.py`` (the role of the fork's
uccsd_t_inactive_iterative.py: :634 iterative_kernel, :733
inactive_energy, :347 update_amps_small), on the machinery of the active
solver (cc/ccsdt_act.py):

*   t3 is solved on the complement of the all-active block at fixed
    (t1, t2).  Every t3-bound index runs over its full range, so t3 is
    the four canonical spin blocks.
*   The sweep is the oracle's t3_residual with the chosen model's
    [H, T3] couplings ('ccsdt-1' is the fork's Fock-only
    update_amps_small iteration; 'ccsdt-3'/'ccsdt' add more), the drive
    built once per (t1, t2) from the dressed DF factors.
*   The active block is pinned: zero by default (the oracle's
    env_triples_kernel), or a fixed active-solver t3 seed (the fork's
    iterative_kernel, coupling active -> env through the off-diagonal
    Fock blocks).

Energy:  E_env = <t1', R1(t3_env)> + pairing of <t2', R2(t3_env)>, the
adjoint contraction of the t3 feedback, with ``env_amplitudes=True``
zeroing the active amplitude blocks in the pairing (the fork's
inactive_energy convention).
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.cc.ccsdt_act import (
    DressedDF, T3_CANONICAL, d3_blocks, diis_blocks, dress_df, expand_t3,
    feedback_act, mo_energy_like, reduce_t3, t3_residual_act)
from pyscf_mpcc_tpu_torch.cc.spinsum import t2_st
from pyscf_mpcc_tpu_torch.lib import device as _dev

MODELS = ("ccsdt", "ccsdt-3", "ccsdt-1")


def _full_dd(nocc, nmo, device):
    """DressedDF whose 'active' ranges are the full ranges."""
    return DressedDF(nocc, nmo,
                     [np.arange(nocc[s]) for s in (0, 1)],
                     [np.arange(nmo[s] - nocc[s]) for s in (0, 1)],
                     device=device)


def env_masks(nocc, nmo, act_hole, act_particle):
    """Per-canonical-signature numpy bool arrays, True on the environment
    (every element but the all-active block)."""
    out = {}
    for sig in T3_CANONICAL:
        marks = []
        for ax, c in enumerate(sig):
            s = "ab".index(c)
            if ax < 3:
                m = np.zeros(nocc[s], bool)
                m[np.asarray(act_hole[s], int)] = True
            else:
                m = np.zeros(nmo[s] - nocc[s], bool)
                m[np.asarray(act_particle[s], int)] = True
            marks.append(m.reshape([-1 if i == ax else 1
                                    for i in range(6)]))
        allact = marks[0]
        for m in marks[1:]:
            allact = allact & m
        out[sig] = ~allact
    return out


def _seed_blocks(nocc, nmo, act_hole, act_particle, t3_act, like):
    """Scatter a canonical active-block t3 dict into full-range zeros
    (dtype and device of ``like``)."""
    out = {}
    kw = dict(dtype=like.dtype, device=like.device)
    for sig in T3_CANONICAL:
        sp = ["ab".index(c) for c in sig]
        shape = tuple(nocc[s] for s in sp[:3]) + tuple(
            nmo[s] - nocc[s] for s in sp[3:])
        base = torch.zeros(shape, **kw)
        if t3_act is not None and t3_act.get(sig) is not None:
            idx = ([np.asarray(act_hole[s], int) for s in sp[:3]]
                   + [np.asarray(act_particle[s], int) for s in sp[3:]])
            ix = tuple(torch.as_tensor(x, device=like.device).view(
                [-1 if a == ax else 1 for a in range(6)])
                for ax, x in enumerate(idx))
            base.index_put_(ix, torch.as_tensor(t3_act[sig], **kw))
        out[sig] = base
    return out


def solve_t3_env(t2_blocks, nocc, nmo, act_hole, act_particle, arrs,
                 mo_energy, model="ccsdt-3", driving="full",
                 max_cycle=60, conv_tol=1e-8, verbose=0, t3_act=None,
                 one_shot=False, diis_space=6):
    """Solve the environment t3 at fixed (t1, t2).

    t2_blocks: (t2aa, t2ab, t2bb) tensors in the frame matching ``arrs``
    (built by ccsdt_act.dress_df from the same t1).  t3_act: optional
    canonical active-block dict held fixed in the active slot during the
    sweep (the fork's iterative_kernel seeding); by default the active
    block is pinned to zero (the oracle's env_triples_kernel).  Returns
    (t3_canonical dict over the full ranges, converged)."""
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}")
    log = lg.Logger(verbose=verbose)
    like = arrs["fa"]
    dd = _full_dd(nocc, nmo, like.device)
    d3 = d3_blocks(dd, mo_energy_like(mo_energy, like))
    masks = {k: torch.as_tensor(v, device=like.device) for k, v in
             env_masks(nocc, nmo, act_hole, act_particle).items()}
    seed = _seed_blocks(nocc, nmo, act_hole, act_particle, t3_act, like)
    t2st = t2_st(tuple(t2_blocks))

    drive = reduce_t3(t3_residual_act(t2st, None, dd, arrs, model=model,
                                      driving=driving))
    canon = {k: torch.where(masks[k], 0.0, seed[k]) for k in T3_CANONICAL}
    keys = sorted(canon.keys())
    diis = DIIS(space=diis_space) if diis_space else None
    converged = one_shot
    for it in range(1 if one_shot else max_cycle):
        coup = reduce_t3(t3_residual_act(t2st, expand_t3(canon), dd, arrs,
                                         model=model, driving="none"))
        new, dn = {}, 0.0
        for k in T3_CANONICAL:
            r = drive[k] + coup[k]
            nk = torch.where(masks[k], canon[k] + r / d3[k], seed[k])
            dn = dn + torch.linalg.norm(nk - canon[k])
            new[k] = nk
        dn = float(dn)
        canon = diis_blocks(diis, new, keys) if diis is not None else new
        log.info("t3-env cycle %2d  |dt3| = %9.3e", it, dn)
        if not one_shot and dn < conv_tol:
            converged = True
            break
    return canon, converged


def env_energy(t3_canon, nocc, nmo, act_hole, act_particle, arrs,
               t1, t2, env_amplitudes=False):
    """Adjoint env-triples energy <t1', R1(t3)> + <t2', R2(t3)>.

    t3_canon: full-range canonical dict (the active block is zeroed here,
    so a seeded solve contributes only its environment part, as the fork
    zeroes it before lhs_env_triples).  Pairing weights follow the
    spin-orbital sum 1/4 <t2_so, R2_so>: 1/4 (aa) + 1/4 (bb) + 1 (ab)."""
    like = arrs["fa"]
    dev = like.device
    dd = _full_dd(nocc, nmo, dev)
    masks = env_masks(nocc, nmo, act_hole, act_particle)
    t3z = {k: torch.as_tensor(t3_canon[k], dtype=like.dtype, device=dev)
           * torch.as_tensor(masks[k], device=dev) for k in T3_CANONICAL}
    (r1a, r1b), (r2aa, r2ab, r2bb) = feedback_act(
        expand_t3(t3z), dd, arrs)
    t1a, t1b = t1
    t2aa, t2ab, t2bb = t2
    if env_amplitudes:
        m1 = []
        for s, t in ((0, t1a), (1, t1b)):
            m = np.zeros(t.shape, bool)
            m[np.ix_(np.asarray(act_hole[s], int),
                     np.asarray(act_particle[s], int))] = True
            m1.append(torch.as_tensor(m, device=dev))
        t1a = torch.where(m1[0], 0.0, t1a)
        t1b = torch.where(m1[1], 0.0, t1b)
        t2aa = torch.where(m1[0][:, None, :, None] & m1[0][None, :, None, :],
                           0.0, t2aa)
        t2ab = torch.where(m1[0][:, None, :, None] & m1[1][None, :, None, :],
                           0.0, t2ab)
        t2bb = torch.where(m1[1][:, None, :, None] & m1[1][None, :, None, :],
                           0.0, t2bb)

    def vdot(a, b):
        return torch.vdot(a.reshape(-1), b.reshape(-1))

    e = (vdot(t1a, r1a) + vdot(t1b, r1b)
         + 0.25 * vdot(t2aa, r2aa) + vdot(t2ab, r2ab)
         + 0.25 * vdot(t2bb, r2bb))
    return float(e)


def kernel(B, h, t1, t2, nocc, act_hole, act_particle, mo_energy,
           model="ccsdt-3", driving="full", max_cycle=60, conv_tol=1e-8,
           verbose=0, t3_act=None, one_shot=False,
           env_amplitudes=False, *, device=None, dtype=None):
    """One-call environment-triples correction at fixed (t1, t2).

    B: per-spin full-MO 3-center factors (naux, nmo, nmo); h: per-spin
    one-electron MO integrals; t1/t2: per-spin UCCSD amplitudes; arrays
    or tensors, taken to ``device`` (CUDA unless a CPU device is passed)
    in ``dtype`` (lib/device's policy unless given).
    Returns (e_env, t3_canonical, converged)."""
    device, dtype = _dev.resolve(device, dtype)

    def tensors(xs):
        return tuple(torch.as_tensor(x, dtype=dtype, device=device)
                     for x in xs)

    B, h, t1, t2 = tensors(B), tensors(h), tensors(t1), tensors(t2)
    nmo = (B[0].shape[1], B[1].shape[1])
    arrs = dress_df(B, h, t1, nocc)
    t3, conv = solve_t3_env(t2, nocc, nmo, act_hole, act_particle, arrs,
                            mo_energy, model=model, driving=driving,
                            max_cycle=max_cycle, conv_tol=conv_tol,
                            verbose=verbose, t3_act=t3_act,
                            one_shot=one_shot)
    e = env_energy(t3, nocc, nmo, act_hole, act_particle, arrs, t1, t2,
                   env_amplitudes=env_amplitudes)
    return e, t3, conv
