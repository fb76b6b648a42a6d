"""Fragmented MP-CC workflows — the fork's flagship end-to-end pipeline.

Port of ``pyscf_mpcc_tpu/mpcc/workflow.py`` (reference:
examples/cc/44-mpcc/n2_rohf_umpccsd.py, get_localized_orbs :12,
fragmented_mpcc :254-299, fragmented_mpcc_unrestricted :300): localize
orbitals (host, ``lo.pm``; per spin for the unrestricted pipeline), solve
non-canonical iterative MP2 in the localized basis (the bath), then for
each fragment run MP-CC with the fragment's active holes/particles,
chaining t1/t2 between fragments.  The MO integrals, the bath and the
amplitude solves run on the device the caller names (CUDA unless a CPU
device is passed).
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.lo.pm import lowdin_populations, pm_localize
from pyscf_mpcc_tpu_torch.mp import mp2
from pyscf_mpcc_tpu_torch.mpcc import rmpccsd, umpccsd


def localize_occ_vir(mol, mf, n_core=0, max_sweeps=100):
    """PM-localize the valence-occupied and virtual blocks separately.

    Returns the localized coefficient matrix (core orbitals untouched).
    """
    C = np.asarray(mf.mo_coeff).copy()
    nocc = mol.nelectron // 2
    S = mf.S
    if nocc - n_core > 1:
        C[:, n_core:nocc], _ = pm_localize(mol, C[:, n_core:nocc], S=S,
                                           max_sweeps=max_sweeps)
    if C.shape[1] - nocc > 1:
        C[:, nocc:], _ = pm_localize(mol, C[:, nocc:], S=S,
                                     max_sweeps=max_sweeps)
    return C


def fragment_spaces(mol, mf, c_loc, fragments, pop_threshold=0.3):
    """Assign localized orbitals to atom-set fragments by Lowdin population.

    fragments: list of atom-index lists.  Returns per-fragment
    (act_hole, act_particle) index arrays (occupied-block / virtual-block
    relative), the form rmpccsd.kernel consumes.
    """
    nocc = mol.nelectron // 2
    q = lowdin_populations(mol, c_loc, S=mf.S)  # (natm, nmo)
    out = []
    for atoms in fragments:
        frag_pop = q[np.asarray(atoms, dtype=int)].sum(axis=0)
        act_hole = np.where(frag_pop[:nocc] > pop_threshold)[0]
        act_particle = np.where(frag_pop[nocc:] > pop_threshold)[0]
        out.append((act_hole, act_particle))
    return out


def fragmented_mpcc(mol, mf, fragments, idx_s, idx_d, eri_ao=None,
                    pop_threshold=0.3, n_core=0, verbose=0,
                    mp2_conv=1e-10, cc_conv=1e-8, *, device=None,
                    dtype=None):
    """Run the fragmented restricted MP-CC pipeline.

    The localization and the AO integrals stay on the host; the incore
    MO integrals, the MP2 bath and the fragment solves live on ``device``
    (CUDA unless a CPU device is passed) in ``dtype`` (lib/device's
    policy unless given).  Returns (e_corr, t1, t2, c_loc, spaces).
    """
    device, dtype = _dev.resolve(device, dtype)
    nocc = mol.nelectron // 2
    c_loc = localize_occ_vir(mol, mf, n_core=n_core)
    if eri_ao is None:
        eri_ao = gto.intor_eri(mol)
    dm = mf.make_rdm1()
    fock_ao = mf.get_fock(dm)
    er = eris_mod.make_eris_incore(eri_ao, c_loc, fock_ao, nocc, dtype,
                                   device=device)

    # the MP2 bath: non-canonical iterative solver in the localized basis
    e_mp2, t2_bath, conv = mp2.iterative_kernel(
        er.ovov, er.fock[:nocc, :nocc], er.fock[nocc:, nocc:],
        conv_tol=mp2_conv, max_cycle=200, verbose=verbose)
    if not conv:
        raise RuntimeError("bath MP2 did not converge")

    spaces = fragment_spaces(mol, mf, c_loc, fragments, pop_threshold)
    t1 = torch.zeros((nocc, er.nvir), dtype=dtype, device=device)
    t2 = t2_bath
    e = e_mp2
    for (act_hole, act_particle) in spaces:
        conv, e, t1, t2 = rmpccsd.kernel(
            er, act_hole, act_particle, idx_s, idx_d, t1=t1, t2=t2,
            conv_tol=cc_conv, verbose=verbose, max_cycle=100)
        if not conv:
            raise RuntimeError("fragment MP-CC did not converge")
    return e, t1, t2, c_loc, spaces


def localize_occ_vir_u(mol, mf, n_core=0, max_sweeps=100):
    """PM-localize each spin's occupied and virtual blocks separately.

    The per-spin rotations keep each spin channel's occupied/virtual split
    (so the localized Fock keeps fov == 0 per spin and the non-canonical
    iterative UMP2 with foo/fvv blocks is exact), the reference's UHF
    localization branch (examples/cc/44-mpcc/n2_rohf_umpccsd.py:16-42).

    Returns (c_loc_a, c_loc_b).
    """
    na, nb = mol.nelec
    S = mf.S
    out = []
    for s, nocc in ((0, na), (1, nb)):
        C = np.asarray(mf.mo_coeff[s]).copy()
        if nocc - n_core > 1:
            C[:, n_core:nocc], _ = pm_localize(mol, C[:, n_core:nocc], S=S,
                                               max_sweeps=max_sweeps)
        if C.shape[1] - nocc > 1:
            C[:, nocc:], _ = pm_localize(mol, C[:, nocc:], S=S,
                                         max_sweeps=max_sweeps)
        out.append(C)
    return out[0], out[1]


def fragment_spaces_u(mol, mf, c_loc, fragments, pop_threshold=0.3):
    """Per-spin fragment assignment by Lowdin population.

    Returns per-fragment ((act_hole_a, act_hole_b),
    (act_particle_a, act_particle_b)) with virtual-block-relative particle
    indices, the form umpccsd.kernel consumes (the reference passes
    `act_particle = [frag[1][0] - nocca, frag[1][1] - noccb]`,
    n2_rohf_umpccsd.py:314).
    """
    na, nb = mol.nelec
    qa = lowdin_populations(mol, c_loc[0], S=mf.S)
    qb = lowdin_populations(mol, c_loc[1], S=mf.S)
    out = []
    for atoms in fragments:
        idx = np.asarray(atoms, dtype=int)
        pa = qa[idx].sum(axis=0)
        pb = qb[idx].sum(axis=0)
        act_hole = (np.where(pa[:na] > pop_threshold)[0],
                    np.where(pb[:nb] > pop_threshold)[0])
        act_particle = (np.where(pa[na:] > pop_threshold)[0],
                        np.where(pb[nb:] > pop_threshold)[0])
        out.append((act_hole, act_particle))
    return out


def fragmented_mpcc_unrestricted(mol, mf, fragments, idx_s, idx_d,
                                 eri_ao=None, pop_threshold=0.3, n_core=0,
                                 verbose=0, mp2_conv=1e-10, cc_conv=1e-8,
                                 oo_mp2_relax=False,
                                 oomp2_variant="standard", *, device=None,
                                 dtype=None):
    """Unrestricted fragmented MP-CC, the fork's flagship pipeline.

    Reference: fragmented_mpcc_unrestricted
    (examples/cc/44-mpcc/n2_rohf_umpccsd.py:300): localize per spin (host),
    solve the non-canonical iterative UMP2 bath in the localized basis,
    then for each fragment run UMPCC with the fragment's per-spin active
    spaces, chaining (t1, t2) from fragment to fragment.  The incore MO
    integrals, the bath and the solves live on ``device`` (CUDA unless a
    CPU device is passed) in ``dtype`` (lib/device's policy unless given).

    mf must be a UHF (or ROHF-through-UHF-view) mean field.  With
    oo_mp2_relax=True an OO-MP2 bath-relaxation pass (the reference's
    oo_mp2 update family) runs after each fragment solve with the
    fragment's all-active blocks frozen.

    Returns (e_corr, t1, t2, c_loc, spaces).
    """
    from pyscf_mpcc_tpu_torch.cc import uccsd
    from pyscf_mpcc_tpu_torch.mp import ump2

    device, dtype = _dev.resolve(device, dtype)
    na, nb = mol.nelec
    c_loc = localize_occ_vir_u(mol, mf, n_core=n_core)
    if eri_ao is None:
        eri_ao = gto.intor_eri(mol)
    focka, fockb = np.asarray(mf.get_fock(mf.make_rdm1()))
    er = uccsd.make_eris_incore(eri_ao, c_loc[0], c_loc[1], focka, fockb,
                                na, nb, dtype, device=device)

    e_mp2, t2_bath, conv = ump2.iterative_kernel(
        er, conv_tol=mp2_conv, max_cycle=200, verbose=verbose)
    if not conv:
        raise RuntimeError("bath UMP2 did not converge")

    spaces = fragment_spaces_u(mol, mf, c_loc, fragments, pop_threshold)
    t1 = (torch.zeros((na, er.ovov.shape[1]), dtype=dtype, device=device),
          torch.zeros((nb, er.OVOV.shape[1]), dtype=dtype, device=device))
    t2 = t2_bath
    e = e_mp2
    for (act_hole, act_particle) in spaces:
        conv, e, t1, t2 = umpccsd.kernel(
            er, act_hole, act_particle, idx_s, idx_d, t1=t1, t2=t2,
            conv_tol=cc_conv, verbose=verbose, max_cycle=100)
        if not conv:
            raise RuntimeError("fragment UMPCC did not converge")
        if oo_mp2_relax:
            # relax the bath at MP2 cost with the fragment's all-active
            # blocks frozen at their CC values (reference oo_mp2 kwarg,
            # umpccsd.py:2550; all-active = singles block 3 / doubles 15)
            conv, e, t1, t2 = umpccsd.kernel(
                er, act_hole, act_particle, idx_s=[3], idx_d=[15],
                t1=t1, t2=t2, oo_mp2=True, oomp2_variant=oomp2_variant,
                conv_tol=cc_conv, verbose=verbose, max_cycle=100)
            if not conv:
                raise RuntimeError("OO-MP2 bath relaxation did not converge")
    return e, t1, t2, c_loc, spaces
