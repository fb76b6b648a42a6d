"""Fragmented MP-CC workflows — the fork's flagship end-to-end pipeline.

Port of the restricted part of ``pyscf_mpcc_tpu/mpcc/workflow.py``
(reference: examples/cc/44-mpcc/n2_rohf_umpccsd.py, get_localized_orbs
:12, fragmented_mpcc :254-299): localize orbitals (host, ``lo.pm``), solve
non-canonical iterative MP2 in the localized basis (the bath), then for
each fragment run MP-CC with the fragment's active holes/particles,
chaining t1/t2 between fragments.  The amplitude solves run on the
device the caller names (CUDA unless a CPU device is passed).

The unrestricted pipeline is ROADMAP A15b: its entry points raise
NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.lo.pm import lowdin_populations, pm_localize
from pyscf_mpcc_tpu_torch.mp import mp2
from pyscf_mpcc_tpu_torch.mpcc import rmpccsd


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


def _open_shell(*args, **kwargs):
    raise NotImplementedError(
        "the unrestricted MP-CC workflow is ROADMAP A15b, not ported yet")


localize_occ_vir_u = fragment_spaces_u = _open_shell
fragmented_mpcc_unrestricted = _open_shell
