"""QCISD(T) on the device.

Port of ``pyscf_mpcc_tpu/cc/qcisd.py`` (the role of the reference's
RHF-QCISD and QCISD(T)):

  * the QCISD equations run on the spin-orbital engine, cc/gccsd.py's
    update with variant='qcisd';
  * for a closed-shell reference the converged spin-orbital amplitudes map
    exactly onto restricted ones, and QCISD(T) is the restricted triples
    engine cc/ccsd_t.py with vfac=2 (QCISD(T)'s disconnected term is
    CCSD(T)'s times two, JCP 94, 442 (1991)).

So the (T) step runs through the same hand-written CUDA tile kernels as
CCSD(T) on the card: the combine kernel (engine 'fused', full precision)
and the resident kernel (dot_precision='high' on engine 'auto').  A build
or launch failure raises; nothing falls back to engine='xla'.
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.lib import device as _dev


def _spin_block(phys, key, no, nmo, dtype):
    """One antisymmetrized spinor block <PQ||RS> of the closed-shell
    spinor layout [occ-a, occ-b, vir-a, vir-b] from the spatial
    physicists' tensor phys[p,q,r,s] = <pq|rs>:
    <PQ||RS> = <pq|rs> d(sP,sR) d(sQ,sS) - <pq|sr> d(sP,sS) d(sQ,sR)."""
    rng = {"o": (slice(0, no), no), "v": (slice(no, nmo), nmo - no)}
    sl = [rng[c][0] for c in key]
    n = [rng[c][1] for c in key]
    direct = phys[sl[0], sl[1], sl[2], sl[3]].to(dtype)
    exch = phys[sl[0], sl[1], sl[3], sl[2]].permute(0, 1, 3, 2).to(dtype)
    out = phys.new_zeros([2 * m for m in n], dtype=dtype)

    def sub(*spins):
        return tuple(slice(s * m, (s + 1) * m) for s, m in zip(spins, n))

    for sp in (0, 1):
        for sq in (0, 1):
            out[sub(sp, sq, sp, sq)] += direct
            out[sub(sp, sq, sq, sp)] -= exch
    return out


def make_geris_rhf(mf, frozen=0, dtype=None, *, device=None):
    """Spin-orbital GERIs from a closed-shell RHF in the fixed spinor
    layout [occ-a, occ-b, vir-a, vir-b] (no energy sort: the closed-shell
    amplitude map below needs fixed spin blocks).  frozen: the number of
    frozen spatial core orbitals.  The spatial MO integrals are made on the
    device in fp64 and each of the nine blocks is assembled there from
    them in the working dtype."""
    from pyscf_mpcc_tpu_torch import ao2mo, gto
    from pyscf_mpcc_tpu_torch.cc.gccsd import GERIs
    device, dtype = _dev.resolve(device, dtype)
    f64 = torch.float64
    mol = mf.mol
    C = np.asarray(mf.mo_coeff)[:, int(frozen):]
    no = mol.nelectron // 2 - int(frozen)
    nmo = C.shape[1]
    nv = nmo - no
    mo_eri = ao2mo.full(torch.tensor(gto.intor_eri(mol), device=device,
                                     dtype=f64),
                        torch.tensor(C, device=device, dtype=f64))
    phys = mo_eri.permute(0, 2, 1, 3)             # <pq|rs>
    blocks = {key: _spin_block(phys, key, no, nmo, dtype)
              for key in GERIs.BLOCKS}
    del mo_eri, phys

    spat = np.concatenate([np.arange(no), np.arange(no),
                           np.arange(no, nmo), np.arange(no, nmo)])
    spin = np.concatenate([np.zeros(no), np.ones(no),
                           np.zeros(nv), np.ones(nv)]).astype(int)
    f_ao = mf.get_fock(mf.make_rdm1())
    f_mo = C.T @ f_ao @ C
    fock = f_mo[np.ix_(spat, spat)] * (spin[:, None] == spin[None, :])
    return GERIs(blocks, fock, 2 * no, device=device, dtype=dtype)


def map_closed_shell(t1g, t2g, no, nv):
    """Restricted (t1, t2) from closed-shell spin-orbital amplitudes in the
    make_geris_rhf layout: t1R[i,a] = t1G[i_a, a_a];
    t2R[i,j,a,b] = t2G[i_a, j_b, a_a, b_b] (the mixed-spin block)."""
    return (t1g[:no, :nv].contiguous(),
            t2g[:no, no:, :nv, nv:].contiguous())


class QCISD:
    """Driver facade: ``QCISD(rhf_mf).run()`` then ``.ccsd_t()``.

    run() converges spin-orbital QCISD on the device; ccsd_t() maps the
    amplitudes to the restricted frame and evaluates the (T) correction
    with the tile engine at vfac=2.  The device defaults to the card
    (lib/device.resolve)."""

    conv_tol = 1e-9
    conv_tol_normt = 1e-7
    max_cycle = 100

    def __init__(self, mf, frozen=0, verbose=None, device=None, dtype=None):
        self.mf = mf
        self.frozen = int(frozen)
        self.verbose = (getattr(mf, "verbose", 0)
                        if verbose is None else verbose)
        self.device, self.dtype = _dev.resolve(device, dtype)
        self.converged = False
        self.e_corr = None
        self.t1 = self.t2 = None
        self._geris = None

    def kernel(self):
        from pyscf_mpcc_tpu_torch.cc import gccsd
        self._geris = make_geris_rhf(self.mf, self.frozen, self.dtype,
                                     device=self.device)
        e, t1, t2, conv = gccsd.kernel(
            self._geris, max_cycle=self.max_cycle,
            conv_tol=self.conv_tol, conv_tol_normt=self.conv_tol_normt,
            verbose=self.verbose, variant="qcisd")
        self.e_corr, self.t1, self.t2, self.converged = e, t1, t2, conv
        return self

    run = kernel

    def triples_inputs(self):
        """The (t1, t2, eris) that :meth:`ccsd_t` hands ccsd_t.kernel: the
        mapped restricted amplitudes and the integrals of the unfrozen
        orbitals (AO ERI built on the host)."""
        from pyscf_mpcc_tpu_torch import gto
        from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
        mf = self.mf
        no = mf.mol.nelectron // 2 - self.frozen
        C = np.asarray(mf.mo_coeff)[:, self.frozen:]
        nv = C.shape[1] - no
        t1, t2 = map_closed_shell(self.t1, self.t2, no, nv)
        er = eris_mod.make_eris_incore(
            gto.intor_eri(mf.mol), C,
            np.asarray(mf.get_fock(mf.make_rdm1())), no, self.dtype,
            device=self.device)
        return t1, t2, er

    def ccsd_t(self, tile=4, **kw):
        """The QCISD(T) correction through the restricted tile engine
        (ccsd_t.kernel, vfac=2) on the mapped amplitudes; kw (engine,
        dot_precision, chunk, ...) go to ccsd_t.kernel."""
        from pyscf_mpcc_tpu_torch.cc import ccsd_t
        return float(ccsd_t.kernel(*self.triples_inputs(), tile=tile,
                                   vfac=2.0, **kw))

    @property
    def e_tot(self):
        return float(self.mf.e_tot) + float(self.e_corr)
