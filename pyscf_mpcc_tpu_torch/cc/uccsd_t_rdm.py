"""Lambda-UCCSD(T) and UCCSD(T) response density matrices by autograd.

Port of ``pyscf_mpcc_tpu/cc/uccsd_t_rdm.py``, the open-shell twin of
cc/ccsd_t_rdm.py.  The (T)-perturbed Lambda equations and the response
densities come from ``torch.autograd.grad`` of one differentiable
spin-orbital (T) energy functional:

    Lambda:   0 = d/dt [ E_UCCSD(t) + E_(T)(t) + <lambda, R(t)> ]
    RDMs:     gamma = d/d(integrals) of the stationary Lagrangian

The functional (``e_t_so``) is the dense antisymmetrized spin-orbital (T)
(JCP 98, 8718 (1993)) with the f_vo disconnected term, zero at canonical
convergence but not in the response: its integral dependence, and that of
the Fock-diagonal denominators, gives the orbital-response blocks.  It is
dense over the spin-orbital cube, in plain torch (the CUDA (T) kernels
have no backward), so the module serves small and medium molecules.  The
Lambda solve is lambda_ad.kernel_u with E(T) added to the energy; the
densities are lambda_ad.make_rdm12_u's gradient of a Lagrangian that adds
E(T) rebuilt from the same integrals.
"""

from __future__ import annotations

from functools import partial

import torch

from pyscf_mpcc_tpu_torch.cc import lambda_ad, uccsd, uccsd_t

einsum = torch.einsum


def _antisym_phys(c_ooov, c_ovov, c_ovvv):
    """Antisymmetrized physicists' blocks <pq||rs> from spin-orbital
    chemists' tensors (uccsd_t._so_chem_* layout):
      oovv[i,j,x,y] = <ij||xy>, ooov[i,j,m,x] = <ij||mx>,
      ovvv[i,x,y,z] = <ix||yz>."""
    oovv = einsum("ixjy->ijxy", c_ovov) - einsum("iyjx->ijxy", c_ovov)
    ooov = einsum("imjx->ijmx", c_ooov) - einsum("jmix->ijmx", c_ooov)
    ovvv = einsum("iyxz->ixyz", c_ovvv) - einsum("izxy->ixyz", c_ovvv)
    return oovv, ooov, ovvv


def e_t_so(T1, T2, fso, oovv, ooov, ovvv, nocc, v_fac=1.0):
    """Dense differentiable spin-orbital (T) energy (a 0-d tensor).

    E(T) = (1/36) sum_{ijkabc} W (W + v_fac V) / D with W, V fully
    P(i/jk)P(a/bc)-antisymmetrized and the disconnected V carrying both
    the t1<jk||bc> and the f_vo t2 terms.  v_fac=2 gives QCISD(T)."""
    mo_e = torch.diagonal(fso)
    eo, ev = mo_e[:nocc], mo_e[nocc:]
    fvo = fso[nocc:, :nocc]
    w = (einsum("jkae,iecb->ijkabc", T2, ovvv)
         - einsum("imbc,jkma->ijkabc", T2, ooov))
    v = (einsum("ia,jkbc->ijkabc", T1, oovv)
         + einsum("ai,jkbc->ijkabc", fvo, T2))

    def pijk(x):
        return (x - x.permute(1, 0, 2, 3, 4, 5)
                - x.permute(2, 1, 0, 3, 4, 5))

    def pabc(x):
        return (x - x.permute(0, 1, 2, 4, 3, 5)
                - x.permute(0, 1, 2, 5, 4, 3))

    W = pabc(pijk(w))
    del w
    V = pabc(pijk(v))
    del v
    d3 = (eo[:, None, None, None, None, None]
          + eo[None, :, None, None, None, None]
          + eo[None, None, :, None, None, None]
          - ev[None, None, None, :, None, None]
          - ev[None, None, None, None, :, None]
          - ev[None, None, None, None, None, :])
    return (1.0 / 36.0) * (W * (W + v_fac * V) / d3).sum()


def _so_fock_of(fa, fb, nocca, noccb):
    """Spin-orbital Fock in the [occ_a, occ_b | vir_a, vir_b] ordering
    from the per-spin Focks (differentiable)."""
    nmoa, nmob = fa.shape[0], fb.shape[0]
    na, nb = nocca, noccb
    va = nmoa - na
    O = na + nb
    f = fa.new_zeros((nmoa + nmob, nmoa + nmob))
    f[:na, :na] = fa[:na, :na]
    f[:na, O:O + va] = fa[:na, na:]
    f[O:O + va, :na] = fa[na:, :na]
    f[O:O + va, O:O + va] = fa[na:, na:]
    f[na:O, na:O] = fb[:nb, :nb]
    f[na:O, O + va:] = fb[:nb, nb:]
    f[O + va:, na:O] = fb[nb:, :nb]
    f[O + va:, O + va:] = fb[nb:, nb:]
    return f


def _so_consts(eris_u, dtype):
    """The spin-orbital Fock and antisymmetrized blocks of a UERIs
    container (constants of the Lambda solve's (T) functional)."""
    c_ooov = uccsd_t._so_chem_ooov(eris_u, dtype)
    c_ovov = uccsd_t._so_chem_ovov(eris_u, dtype)
    c_ovvv = uccsd_t._so_chem_ovvv(eris_u, dtype)
    oovv, ooov, ovvv = _antisym_phys(c_ooov, c_ovov, c_ovvv)
    fso = _so_fock_of(eris_u.focka.to(dtype), eris_u.fockb.to(dtype),
                      eris_u.nocca, eris_u.noccb)
    return fso, oovv, ooov, ovvv


def e_t_dense_u(t1, t2, eris_u, v_fac=1.0, _consts=None):
    """Dense UCCSD(T) energy, differentiable in the amplitudes and in
    eris_u's Fock and integral blocks (it checks the tiled engine
    uccsd_t.kernel at small sizes)."""
    na, nb = eris_u.nocca, eris_u.noccb
    if _consts is None:
        _consts = _so_consts(eris_u, t2[1].dtype)
    fso, oovv, ooov, ovvv = _consts
    T1, T2 = uccsd.to_spin_orbital(t1, t2, (na, nb))
    return e_t_so(T1, T2, fso, oovv, ooov, ovvv, na + nb, v_fac=v_fac)


def lambda_kernel_u(t1, t2, eris_u, max_cycle=60, conv_tol=1e-6,
                    diis_space=6, verbose=0, v_fac=1.0):
    """Lambda-UCCSD(T): solve lambda^T dR/dt = -d(E_UCCSD + E_(T))/dt.
    Returns (conv, l1, l2)."""
    consts = _so_consts(eris_u, t2[1].dtype)
    return lambda_ad.kernel_u(
        t1, t2, eris_u, max_cycle=max_cycle, conv_tol=conv_tol,
        diis_space=diis_space, verbose=verbose,
        e_extra=partial(e_t_dense_u, v_fac=v_fac, _consts=consts))


def make_rdm12(h_a, h_b, g_aa, g_ab, g_bb, t1, t2, l1, l2, nocca, noccb,
               v_fac=1.0):
    """UCCSD(T) response densities ((dm1a, dm1b), (dm2aa, dm2ab, dm2bb))
    in the per-spin MO bases, chemists' convention, satisfying

        E_tot = h_a.dm1a + h_b.dm1b + 1/2 g_aa.dm2aa + 1/2 g_bb.dm2bb
                + g_ab.dm2ab

    with E_tot the stationary CCSD(T) Lagrangian.  l1/l2 from
    :func:`lambda_kernel_u`."""
    return lambda_ad.make_rdm12_u(
        h_a, h_b, g_aa, g_ab, g_bb, t1, t2, l1, l2, nocca, noccb,
        e_extra=partial(e_t_dense_u, v_fac=v_fac))
