"""Unrestricted MP2: canonical, SCS, DF, and the non-canonical iterative
solver.

Port of ``pyscf_mpcc_tpu/mp/ump2.py``: spin-blocked energies over
(gaa, gab, gbb) with the same antisymmetrized same-spin combinations as
cc.uccsd.init_amps, plain functions on tensors run on the device the
tensors live on.  ``iterative_kernel`` extrapolates with the host DIIS,
as the JAX package does.  ``df_kernel_from_scf`` transforms the DF
factors in fp64 on the target device (CUDA unless a CPU device is
passed) and contracts them in the working dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from pyscf_mpcc_tpu_torch.cc.eris import _pair
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.mp.dfmp2 import _mo_factor

einsum = torch.einsum


def kernel_from_ueris(eris):
    """Canonical UMP2 energy and amplitudes from a cc.uccsd.UERIs."""
    from pyscf_mpcc_tpu_torch.cc import uccsd
    emp2, _, t2 = uccsd.init_amps(eris)
    return float(emp2), t2


def _dd(eo1, eo2, ev1, ev2):
    return (eo1[:, None, None, None] + eo2[None, :, None, None]
            - ev1[None, None, :, None] - ev2[None, None, None, :])


def update_amps(t2, g, fooa, foob, fvva, fvvb):
    """Non-canonical Jacobi sweep for (t2aa, t2ab, t2bb).

    g = (gaa, gab, gbb): antisymmetrized (same-spin) / plain (ab) MO
    integrals in physicists' oovv layout.  Returns (t2_new, residuals)."""
    eoa, eob = torch.diagonal(fooa), torch.diagonal(foob)
    eva, evb = torch.diagonal(fvva), torch.diagonal(fvvb)

    def resid(t2x, gx, foo1, foo2, fvv1, fvv2):
        r = gx + einsum("ac,ijcb->ijab", fvv1, t2x)
        r = r + einsum("bc,ijac->ijab", fvv2, t2x)
        r = r - einsum("ik,kjab->ijab", foo1, t2x)
        return r - einsum("jk,ikab->ijab", foo2, t2x)

    t2aa, t2ab, t2bb = t2
    gaa, gab, gbb = g
    raa = resid(t2aa, gaa, fooa, fooa, fvva, fvva)
    rab = resid(t2ab, gab, fooa, foob, fvva, fvvb)
    rbb = resid(t2bb, gbb, foob, foob, fvvb, fvvb)
    return ((t2aa + raa / _dd(eoa, eoa, eva, eva),
             t2ab + rab / _dd(eoa, eob, eva, evb),
             t2bb + rbb / _dd(eob, eob, evb, evb)), (raa, rab, rbb))


def energy(t2, g):
    t2aa, t2ab, t2bb = t2
    gaa, gab, gbb = g
    e = 0.25 * einsum("ijab,ijab->", t2aa, gaa)
    e = e + 0.25 * einsum("ijab,ijab->", t2bb, gbb)
    e = e + einsum("ijab,ijab->", t2ab, gab)
    return float(e)


def _g_blocks(eris):
    gaa = eris.ovov.permute(0, 2, 1, 3) - eris.ovov.permute(0, 2, 3, 1)
    gbb = eris.OVOV.permute(0, 2, 1, 3) - eris.OVOV.permute(0, 2, 3, 1)
    return gaa, eris.ovOV.permute(0, 2, 1, 3), gbb


def iterative_kernel(eris, max_cycle=100, conv_tol=1e-9, diis_space=6,
                     verbose=0):
    """Non-canonical iterative UMP2 from a UERIs container (host DIIS on
    the three blocks).  Returns (e, t2, converged)."""
    from pyscf_mpcc_tpu_torch.cc import uccsd
    from pyscf_mpcc_tpu_torch.lib import logger as lg
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    log = lg.Logger(verbose=verbose)
    na, nb = uccsd._nocc(eris)
    g = _g_blocks(eris)
    fooa, fvva = eris.focka[:na, :na], eris.focka[na:, na:]
    foob, fvvb = eris.fockb[:nb, :nb], eris.fockb[nb:, nb:]
    t2 = tuple(torch.zeros_like(x) for x in g)
    dev, dt = g[1].device, g[1].dtype
    shapes = [x.shape for x in g]
    diis = DIIS(space=diis_space)
    e_last = 0.0
    converged = False
    for it in range(max_cycle):
        t2, r = update_amps(t2, g, fooa, foob, fvva, fvvb)
        vec = np.concatenate([x.cpu().numpy().ravel() for x in t2])
        err = np.concatenate([x.cpu().numpy().ravel() for x in r])
        del t2, r
        vec = torch.from_numpy(diis.update(vec, xerr=err)).to(dev, dt)
        out, p = [], 0
        for s in shapes:
            n = int(np.prod(s))
            out.append(vec[p:p + n].view(s))
            p += n
        t2 = tuple(out)
        e = energy(t2, g)
        log.info("UMP2 cycle %d  E = %.12f  dE = %.3e", it, e, e - e_last)
        if abs(e - e_last) < conv_tol:
            converged = True
            break
        e_last = e
    return e, t2, converged


def scs_energy(eris, css=1.0 / 3.0, cos=1.2):
    """SCS-UMP2 (Grimme's factors by default): (E, E_ss, E_os)."""
    from pyscf_mpcc_tpu_torch.cc import uccsd
    _, _, t2 = uccsd.init_amps(eris)
    gaa, gab, gbb = _g_blocks(eris)
    e_ss = float(0.25 * einsum("ijab,ijab->", t2[0], gaa)
                 + 0.25 * einsum("ijab,ijab->", t2[2], gbb))
    e_os = float(einsum("ijab,ijab->", t2[1], gab))
    return css * e_ss + cos * e_os, e_ss, e_os


def df_kernel(mo_energy, Lov_a, Lov_b):
    """DF-UMP2 from per-spin 3-center MO factors: mo_energy =
    ((eoa, eva), (eob, evb)); Lov_s = B[L, i_s, a_s].
    Returns (e_total, (e_aa, e_ab, e_bb))."""
    (eoa, eva), (eob, evb) = mo_energy

    def d(eo1, ev1, eo2, ev2):
        return (eo1[:, None, None, None] - ev1[None, :, None, None]
                + eo2[None, None, :, None] - ev2[None, None, None, :])

    def same_spin(L, eo, ev):
        g = _pair(L, L)
        g = g - g.permute(0, 3, 2, 1)
        return 0.25 * einsum("iajb,iajb->", g / d(eo, ev, eo, ev), g)

    e_aa = same_spin(Lov_a, eoa, eva)
    e_bb = same_spin(Lov_b, eob, evb)
    gab = _pair(Lov_a, Lov_b)
    e_ab = einsum("iajb,iajb->", gab / d(eoa, eva, eob, evb), gab)
    return (float(e_aa + e_bb + e_ab),
            (float(e_aa), float(e_ab), float(e_bb)))


def df_kernel_from_scf(mf, frozen=0, *, device=None, dtype=None):
    """DF-UMP2 from a (UHF or RHF) mean field carrying a DF object; the
    factors are transformed in fp64 on ``device`` (CUDA by default) and
    contracted in the working dtype."""
    device, dtype = _dev.resolve(device, dtype)
    B = torch.as_tensor(np.asarray(mf.with_df.B_ao()), dtype=torch.float64,
                        device=device)
    mo = np.asarray(mf.mo_coeff)
    moe = np.asarray(mf.mo_energy)
    if mo.ndim == 2:
        mo = np.array([mo, mo])
        moe = np.array([moe, moe])
    na, nb = mf.mol.nelec
    f = int(frozen or 0)
    Ls, ens = [], []
    for s, no in ((0, na), (1, nb)):
        c = torch.as_tensor(mo[s], dtype=torch.float64, device=device)
        Ls.append(_mo_factor(B, c[:, f:no], c[:, no:]).to(dtype))
        e = torch.as_tensor(moe[s], dtype=dtype, device=device)
        ens.append((e[f:no], e[no:]))
    return df_kernel((ens[0], ens[1]), Ls[0], Ls[1])
