"""GCCSD on the device: spin-orbital CCSD on generalized (spinor) MOs.

Port of ``pyscf_mpcc_tpu/cc/gccsd.py``: CCSD over one spinor orbital set,
the correlation method on a GHF reference (scf/ghf.py).  Every contraction
is a dense two-operand einsum over device-resident antisymmetrized blocks;
the host sees the DIIS vector once a cycle.  The equations are the Stanton
et al. set of the NumPy oracle cc/gccsd_slow.py, and ``variant='qcisd'``
is the QCI truncation that cc/qcisd.py drives.

The nine blocks are built on the device one at a time (``make_eris_ghf``
and ``qcisd.make_geris_rhf``), never as one nso^4 host array: GCCSD keeps
16 times the storage of RCCSD at equal nmo, and at nso = 228 one fp64
nso^4 copy is 21.6 GB.
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.lib import logger as lg
from pyscf_mpcc_tpu_torch.lib.diis import DIIS

einsum = torch.einsum


class GERIs:
    """Antisymmetrized spinor-MO blocks <pq||rs> as device tensors, and
    the spinor Fock matrix."""

    BLOCKS = ("oovv", "ooov", "ovvv", "oooo", "vvvv", "ovov", "ovvo",
              "ovoo", "vvvo")

    def __init__(self, blocks, fock, nocc, device=None, dtype=None):
        device, dtype = _dev.resolve(device, dtype)

        def t(x):
            if isinstance(x, torch.Tensor):
                return x.to(device, dtype)
            return torch.tensor(np.asarray(x), device=device, dtype=dtype)

        self.b = {k: t(v) for k, v in blocks.items()}
        self.fock = t(fock)
        self.nocc = int(nocc)
        self.nso = int(self.fock.shape[0])
        self.mo_energy = torch.diagonal(self.fock).cpu().numpy().astype(
            np.float64)

    def block(self, key):
        """The block as a numpy array (the NumPy oracles' accessor)."""
        return self.b[key].cpu().numpy()


def _ranges(key, nocc, nso):
    sl = {"o": slice(0, nocc), "v": slice(nocc, nso)}
    return tuple(sl[c] for c in key)


def _pair(eri, ca, cb):
    """sum over spin of (A B | . .): eri (n, n, m) with the first two AO
    indices contracted against the spinor coefficients (2nao, nA), (2nao,
    nB), alpha rows on top.  Returns (nA, nB, m)."""
    nao = eri.shape[0]
    out = None
    for s in (slice(0, nao), slice(nao, 2 * nao)):
        x = einsum("pqm,pA->Aqm", eri, ca[s])
        x = einsum("Aqm,qB->ABm", x, cb[s])
        out = x if out is None else out + x
    return out


def _spinor_chem(eri, ca, cb, cc, cd):
    """Spinor chemists' (A B | C D) over the spin-free AO integrals."""
    nao = eri.shape[0]
    x = _pair(eri.reshape(nao, nao, nao * nao), ca, cb)
    x = _pair(x.reshape(-1, nao, nao).permute(1, 2, 0), cc, cd)
    return x.permute(2, 0, 1).reshape(ca.shape[1], cb.shape[1],
                                      cc.shape[1], cd.shape[1])


def make_eris_ghf(mf, frozen=0, dtype=None, *, device=None):
    """Spinor-MO antisymmetrized blocks from a converged GHF (or a
    convert_to_ghf embedding), built block by block on the device from the
    AO integrals in fp64 and cast to the working dtype.  ``frozen`` drops
    the lowest ``frozen`` spinors (twice the spatial count of the R/U
    conventions)."""
    from pyscf_mpcc_tpu_torch import gto
    device, dtype = _dev.resolve(device, dtype)
    f64 = torch.float64
    C = np.asarray(mf.mo_coeff)[:, int(frozen):]
    occ = np.asarray(mf.mo_occ)[int(frozen):]
    # occupied spinors first (aufbau gives this already; enforce anyway)
    order = np.argsort(-occ, kind="stable")
    C = C[:, order]
    nocc = int(round(occ.sum()))
    nso = C.shape[1]
    f_ao = mf.get_fock(mf.make_rdm1())
    fock = C.T @ f_ao @ C

    eri = torch.tensor(gto.intor_eri(mf.mol), device=device, dtype=f64)
    Cd = torch.tensor(C, device=device, dtype=f64)
    blocks = {}
    for key in GERIs.BLOCKS:
        P, Q, R, S = (Cd[:, r] for r in _ranges(key, nocc, nso))
        # <PQ||RS> = (PR|QS) - (PS|QR)
        anti = _spinor_chem(eri, P, R, Q, S).permute(0, 2, 1, 3).to(dtype)
        anti -= _spinor_chem(eri, P, S, Q, R).permute(0, 2, 3, 1).to(dtype)
        blocks[key] = anti.contiguous()
        del anti
    return GERIs(blocks, fock, nocc, device=device, dtype=dtype)


def _denoms(fock, nocc):
    eo = torch.diagonal(fock)[:nocc]
    ev = torch.diagonal(fock)[nocc:]
    d1 = eo[:, None] - ev[None, :]
    d2 = (eo[:, None, None, None] + eo[None, :, None, None]
          - ev[None, None, :, None] - ev[None, None, None, :])
    return d1, d2


def _asym(x, dims):
    """x - x with the two axes of ``dims`` swapped."""
    return x - x.transpose(*dims)


def _update(t1, t2, b, fock, nocc, variant="ccsd"):
    """Jacobi update, Stanton Eqs. (1)-(13), the term structure of the
    oracle gccsd_slow.update_amps.

    variant='qcisd' applies the QCI truncation: every T1-nonlinear term is
    dropped (tau is t2, the Fae/Fmi/W intermediates keep only their t2
    parts, the doubles see t1 only through the linear vvvo/ovoo terms);
    Fme keeps its t1 term."""
    qci = variant == "qcisd"
    f = fock
    fov = f[:nocc, nocc:]
    foo = f[:nocc, :nocc]
    fvv = f[nocc:, nocc:]
    eo = torch.diagonal(foo)
    ev = torch.diagonal(fvv)
    oovv, ooov, ovvv = b["oovv"], b["ooov"], b["ovvv"]
    oooo, vvvv, ovov = b["oooo"], b["vvvv"], b["ovov"]
    ovvo, ovoo, vvvo = b["ovvo"], b["ovoo"], b["vvvo"]

    if qci:
        tau_t = tau = t2
    else:
        t1t1 = _asym(einsum("ia,jb->ijab", t1, t1), (2, 3))
        tau_t = t2 + 0.5 * t1t1
        tau = t2 + t1t1
        del t1t1

    Fae = fvv - torch.diag(ev)
    if not qci:
        Fae = Fae - 0.5 * einsum("me,ma->ae", fov, t1)
        Fae = Fae + einsum("mf,mafe->ae", t1, ovvv)
    Fae = Fae - 0.5 * einsum("mnaf,mnef->ae", tau_t, oovv)

    Fmi = foo - torch.diag(eo)
    if not qci:
        Fmi = Fmi + 0.5 * einsum("ie,me->mi", t1, fov)
        Fmi = Fmi + einsum("ne,mnie->mi", t1, ooov)
    Fmi = Fmi + 0.5 * einsum("inef,mnef->mi", tau_t, oovv)

    Fme = fov + einsum("nf,mnef->me", t1, oovv)

    Wmnij = oooo
    if not qci:
        Wmnij = Wmnij + _asym(einsum("je,mnie->mnij", t1, ooov), (2, 3))
    Wmnij = Wmnij + 0.25 * einsum("ijef,mnef->mnij", tau, oovv)

    # vvvv-sized: accumulated in place, so one v^4 temporary at a time
    Wabef = einsum("mnab,mnef->abef", tau, oovv)
    Wabef *= 0.25
    Wabef += vvvv
    if not qci:
        Wabef += _asym(einsum("mb,maef->abef", t1, ovvv), (0, 1))

    oovo = -ooov.transpose(2, 3)
    Wmbej = ovvo
    if not qci:
        Wmbej = Wmbej + einsum("jf,mbef->mbej", t1, ovvv)
        Wmbej = Wmbej - einsum("nb,mnej->mbej", t1, oovo)
        Wmbej = Wmbej - einsum("jnfb,mnef->mbej",
                               0.5 * t2 + einsum("jf,nb->jnfb", t1, t1),
                               oovv)
    else:
        Wmbej = Wmbej - 0.5 * einsum("jnfb,mnef->mbej", t2, oovv)

    t1new = fov
    t1new = t1new + einsum("ie,ae->ia", t1, Fae)
    t1new = t1new - einsum("ma,mi->ia", t1, Fmi)
    t1new = t1new + einsum("imae,me->ia", t2, Fme)
    t1new = t1new - einsum("nf,naif->ia", t1, ovov)
    t1new = t1new - 0.5 * einsum("imef,maef->ia", t2, ovvv)
    t1new = t1new - 0.5 * einsum("mnae,nmei->ia", t2, oovo)

    t2new = oovv
    t2new = t2new + _asym(einsum(
        "ijae,be->ijab", t2,
        Fae if qci else Fae - 0.5 * einsum("mb,me->be", t1, Fme)), (2, 3))
    t2new = t2new - _asym(einsum(
        "imab,mj->ijab", t2,
        Fmi if qci else Fmi + 0.5 * einsum("je,me->mj", t1, Fme)), (0, 1))
    t2new = t2new + 0.5 * einsum("mnab,mnij->ijab", tau, Wmnij)
    t2new = t2new + 0.5 * einsum("ijef,abef->ijab", tau, Wabef)
    del Wabef
    tmp = einsum("imae,mbej->ijab", t2, Wmbej)
    if not qci:
        # ie,ma,mbej->ijab as two pairwise contractions
        tmp = tmp - einsum("ma,mbij->ijab", t1,
                           einsum("ie,mbej->mbij", t1, ovvo))
    tmp = _asym(tmp, (2, 3))
    t2new = t2new + _asym(tmp, (0, 1))
    t2new = t2new + _asym(einsum("ie,abej->ijab", t1, vvvo), (0, 1))
    t2new = t2new - _asym(einsum("ma,mbij->ijab", t1, ovoo), (2, 3))

    d1, d2 = _denoms(fock, nocc)
    return t1new / d1, t2new / d2


def _energy(t1, t2, oovv, fock, nocc, variant="ccsd"):
    fov = fock[:nocc, nocc:]
    e = (fov * t1).sum()
    e = e + 0.25 * (oovv * t2).sum()
    if variant != "qcisd":      # the QCI energy has no t1^2 term
        e = e + 0.5 * einsum("jb,ijab->ia", t1, oovv).mul(t1).sum()
    return e


def energy(t1, t2, eris, variant="ccsd"):
    return float(_energy(t1, t2, eris.b["oovv"], eris.fock, eris.nocc,
                         variant=variant))


def init_amps(eris):
    d1, d2 = _denoms(eris.fock, eris.nocc)
    t1 = eris.fock[:eris.nocc, eris.nocc:] / d1
    t2 = eris.b["oovv"] / d2
    emp2 = 0.25 * float((t2 * eris.b["oovv"]).sum())
    return emp2, t1, t2


def kernel(eris, max_cycle=100, conv_tol=1e-9, conv_tol_normt=1e-7,
           diis_space=6, verbose=0, t1=None, t2=None, variant="ccsd"):
    """Jacobi iterations with the host DIIS.  Returns (e_corr, t1, t2,
    converged)."""
    log = lg.Logger(verbose=verbose)
    emp2, t1_0, t2_0 = init_amps(eris)
    dev, dt = eris.fock.device, eris.fock.dtype
    t1 = t1_0 if t1 is None else torch.as_tensor(t1, device=dev, dtype=dt)
    t2 = t2_0 if t2 is None else torch.as_tensor(t2, device=dev, dtype=dt)
    del t1_0, t2_0
    log.info("G%s MP2 init E_corr = %.14f", variant.upper(), emp2)
    nov = t1.numel()
    diis = DIIS(space=diis_space)
    e_last = energy(t1, t2, eris, variant=variant)
    converged = False
    e = e_last
    for it in range(max_cycle):
        t1new, t2new = _update(t1, t2, eris.b, eris.fock, eris.nocc,
                               variant=variant)
        normt = float(torch.linalg.norm(t1new - t1)
                      + torch.linalg.norm(t2new - t2))
        vec = np.concatenate([t1new.cpu().numpy().ravel(),
                              t2new.cpu().numpy().ravel()])
        del t1, t2, t1new
        vec = torch.from_numpy(diis.update(vec)).to(dev, dt)
        t1 = vec[:nov].reshape(t2new.shape[0], -1)
        t2 = vec[nov:].reshape(t2new.shape)
        del t2new, vec
        e = energy(t1, t2, eris, variant=variant)
        log.info("cycle %2d  E_corr(GCCSD) = %.14f  dE = %9.3e  "
                 "|dt| = %9.3e", it, e, e - e_last, normt)
        if abs(e - e_last) < conv_tol and normt < conv_tol_normt:
            converged = True
            break
        e_last = e
    return float(e), t1, t2, converged


class GCCSD:
    """Driver facade: ``GCCSD(ghf_mf).run()``; mf may be a GHF or any
    R/U mean field (embedded by convert_to_ghf).  The device defaults to
    the card (lib/device.resolve)."""

    conv_tol = 1e-9
    conv_tol_normt = 1e-7
    max_cycle = 100
    diis_space = 6

    def __init__(self, mf, frozen=0, verbose=None, device=None, dtype=None):
        from pyscf_mpcc_tpu_torch.scf.ghf import GHF, convert_to_ghf
        if not isinstance(mf, GHF):
            mf = convert_to_ghf(mf)
        self.mf = mf
        self.frozen = int(frozen)
        self.verbose = (mf.verbose if verbose is None else verbose)
        self.device, self.dtype = _dev.resolve(device, dtype)
        self.converged = False
        self.e_corr = None
        self.t1 = self.t2 = None

    def run(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        eris = make_eris_ghf(self.mf, frozen=self.frozen, dtype=self.dtype,
                             device=self.device)
        e, t1, t2, conv = kernel(
            eris, max_cycle=self.max_cycle, conv_tol=self.conv_tol,
            conv_tol_normt=self.conv_tol_normt,
            diis_space=self.diis_space, verbose=self.verbose)
        self.e_corr, self.t1, self.t2, self.converged = e, t1, t2, conv
        self.e_tot = float(self.mf.e_tot) + e
        return self

    kernel = run
