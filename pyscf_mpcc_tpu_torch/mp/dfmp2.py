"""Native DF-MP2 with unrelaxed AND orbital-relaxed densities.

Port of ``pyscf_mpcc_tpu/mp/dfmp2.py`` (the reference's
mp/dfmp2_native.py: DFRMP2 :31, make_rdm1 :146, make_natorbs :181,
SCSDFRMP2 :255).  The orbital gradient is the exact derivative of the
Hylleraas functional under a Cayley orbital rotation, the CPHF operator
the exact Hessian-vector product of the HF energy (``torch.func.jvp`` of
``torch.func.grad``, forward over reverse), solved by conjugate
gradients, and the relaxed density the derivative of the stationary
Lagrangian with respect to the one-electron Hamiltonian:

    L(h) = E_HF(kappa=0, h) + E_Hyl(kappa=0, h) + <z, dE_HF/dkappa (h)>
    gamma_relaxed(AO) = dL/dh      (exact, by construction)

E_Hyl is stationary in t2 (Hylleraas) and L is stationary in kappa (the
z-vector), so this derivative needs no amplitude or orbital response.
SCS scaling enters through the generalized contraction
t~ = (ps+pt) t - pt t^T.

The JAX package takes CG and GMRES from ``jax.scipy.sparse.linalg``;
``_cg`` and ``_gmres`` here reproduce their stopping rules (not their
iteration counts), so densities agree to the solver tolerance.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad, jvp, vjp

from pyscf_mpcc_tpu_torch.convert import to_numpy
from pyscf_mpcc_tpu_torch.lib import device as _dev
from pyscf_mpcc_tpu_torch.mp import mp2 as mp2_mod

einsum = torch.einsum


def _cg(A, b, tol, maxiter):
    """Conjugate gradients for A x = b from x = 0, stopping as
    jax.scipy.sparse.linalg.cg does (atol 0): once |r|^2 <= tol^2 |b|^2,
    or after maxiter steps."""
    x = torch.zeros_like(b)
    r = b
    p = r
    gamma = torch.sum(r * r)
    bound = tol ** 2 * float(gamma)
    for _ in range(maxiter):
        if float(gamma) <= bound:
            break
        Ap = A(p)
        alpha = gamma / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = torch.sum(r * r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
    return x


def _gmres(A, b, tol, restart, maxiter):
    """Restarted GMRES for A x = b (b a flat vector) from x = 0, stopping
    as jax.scipy.sparse.linalg.gmres does (atol 0): the true residual
    |b - A x| is tested against tol |b| after each cycle of ``restart``
    Arnoldi steps, for at most ``maxiter`` cycles.  Arnoldi orthogonalizes
    by two passes of classical Gram-Schmidt and stops a cycle early on
    breakdown (the new direction's norm at or under eps times |A v|)."""
    restart = min(restart, b.numel())
    eps = torch.finfo(b.dtype).eps
    atol = tol * float(torch.linalg.norm(b))
    x = torch.zeros_like(b)
    r = b
    rnorm = float(torch.linalg.norm(r))
    for _ in range(maxiter):
        if rnorm <= atol:
            break
        V = torch.zeros((restart + 1, b.numel()), dtype=b.dtype,
                        device=b.device)
        V[0] = r / rnorm
        H = np.zeros((restart + 1, restart))
        m = restart
        for k in range(restart):
            w = A(V[k])
            wnorm0 = float(torch.linalg.norm(w))
            h = torch.zeros(k + 1, dtype=b.dtype, device=b.device)
            for _ in range(2):
                c = V[:k + 1] @ w
                w = w - V[:k + 1].T @ c
                h = h + c
            wnorm = float(torch.linalg.norm(w))
            H[:k + 1, k] = to_numpy(h)
            if wnorm <= eps * wnorm0:
                m = k + 1
                break
            H[k + 1, k] = wnorm
            V[k + 1] = w / wnorm
        beta = np.zeros(m + 1)
        beta[0] = rnorm
        y = np.linalg.lstsq(H[:m + 1, :m], beta, rcond=None)[0]
        x = x + V[:m].T @ torch.as_tensor(y, dtype=b.dtype, device=b.device)
        r = b - A(x)
        rnorm = float(torch.linalg.norm(r))
    return x


def _cayley(kappa_vo, nocc, nmo):
    """Orthogonal U = (I - K/2)^-1 (I + K/2) from the free vo block.  K is
    built out of place (a pad, no indexed write) so that torch.func can
    differentiate through it."""
    K = F.pad(kappa_vo, (0, nmo - nocc, nocc, 0))   # kappa at [nocc:, :nocc]
    K = K - K.T
    eye = torch.eye(nmo, dtype=kappa_vo.dtype, device=kappa_vo.device)
    return torch.linalg.solve(eye - 0.5 * K, eye + 0.5 * K)


def _jk(B_ao, P):
    rho = einsum("Lrs,rs->L", B_ao, P)
    J = einsum("Lpq,L->pq", B_ao, rho)
    K = einsum("Lps,Lqs->pq", einsum("Lpr,rs->Lps", B_ao, P), B_ao)
    return J, K


def _mo_factor(B_ao, Co, Cv):
    """L[P,i,a] = sum_pq B[P,p,q] Co[p,i] Cv[q,a]."""
    return einsum("Liq,qa->Lia", einsum("Lpq,pi->Liq", B_ao, Co), Cv)


def _hylleraas(B_ao, Co, Cv, f_ao, t2, ps, pt):
    """2<t~|V> + <t~|F t> with the MO Fock blocks and (ia|jb) of the
    orbitals (Co, Cv) and the AO Fock f_ao."""
    foo = Co.T @ f_ao @ Co
    fvv = Cv.T @ f_ao @ Cv
    Lov = _mo_factor(B_ao, Co, Cv)
    V = einsum("Lia,Ljb->ijab", Lov, Lov)
    tt = (ps + pt) * t2 - pt * t2.permute(0, 1, 3, 2)
    Ft = (einsum("ac,ijcb->ijab", fvv, t2)
          + einsum("bc,ijac->ijab", fvv, t2)
          - einsum("ik,kjab->ijab", foo, t2)
          - einsum("jk,ikab->ijab", foo, t2))
    return (2.0 * einsum("ijab,ijab->", tt, V)
            + einsum("ijab,ijab->", tt, Ft))


def _e_hf(kappa, h, B_ao, C0, nocc):
    C = C0 @ _cayley(kappa, nocc, C0.shape[1])
    Co = C[:, :nocc]
    P = 2.0 * Co @ Co.T
    J, K = _jk(B_ao, P)
    return (torch.sum(P * h) + 0.5 * torch.sum(P * J)
            - 0.25 * torch.sum(P * K))


def _e_hyl(kappa, h, B_ao, C0, nocc, t2, ps, pt):
    """Hylleraas functional 2<t~|V> + <t~|F t> at fixed t2: stationary in
    t2, equals E_MP2 at the solution, and its kappa/h derivatives give
    the exact orbital gradient / correlation density."""
    C = C0 @ _cayley(kappa, nocc, C0.shape[1])
    Co = C[:, :nocc]
    P = 2.0 * Co @ Co.T
    J, K = _jk(B_ao, P)
    return _hylleraas(B_ao, Co, C[:, nocc:], h + J - 0.5 * K, t2, ps, pt)


def _relaxed_rdm1_ao(B_ao, C0, h_ao, t2, nocc, ps=1.0, pt=1.0):
    cg_tol = 1e-10
    nmo = C0.shape[1]
    k0 = torch.zeros((nmo - nocc, nocc), dtype=t2.dtype, device=t2.device)

    def e_hf(k, h):
        return _e_hf(k, h, B_ao, C0, nocc)

    def e_hyl(k, h):
        return _e_hyl(k, h, B_ao, C0, nocc, t2, ps, pt)

    g_hyl = grad(e_hyl, argnums=0)(k0, h_ao)
    g_hf_fn = grad(e_hf, argnums=0)

    def hvp(z):
        return jvp(lambda k: g_hf_fn(k, h_ao), (k0,), (z,))[1]

    z = _cg(hvp, -g_hyl, tol=cg_tol, maxiter=200)

    def lagrangian(h):
        return (e_hf(k0, h) + e_hyl(k0, h)
                + torch.sum(z * g_hf_fn(k0, h)))

    return grad(lagrangian)(h_ao)


def _relaxed_rdm1_ao_frozen(B_ao, C0, h_ao, t2, nocc, nfro, ps=1.0, pt=1.0):
    """Frozen-core relaxed density (reference dfmp2_native.py:146-181).

    With a frozen core the correlation energy is no longer invariant
    under occupied-occupied rotations that mix frozen and active
    orbitals, so the plain vo Z-vector is not enough.  The constrained
    Lagrangian gains the frozen-active canonicality conditions:

        L(h) = E_HF + E_Hyl + z_vo . g_HF_vo(kappa,h) + z_fa . F_fa(kappa,h)

    where F_fa is the frozen x active-occ block of the MO Fock (zero for
    the converged canonical reference).  Stationarity in kappa over both
    blocks gives one linear system J^T z = -dE_Hyl/dkappa with J the
    constraint Jacobian -- nonsymmetric because the canonicality rows
    are not the gradient of a scalar, hence GMRES on the constraint vjp
    instead of the CG/HVP used in the no-frozen path.

    nocc = total occupied INCLUDING the nfro frozen; t2 spans active occ.
    """
    nmo = C0.shape[1]
    nvir = nmo - nocc
    nact = nocc - nfro

    def cayley2(kvo, kfa):
        K = (F.pad(kvo, (0, nvir, nocc, 0))              # [nocc:, :nocc]
             + F.pad(kfa, (nfro, nvir, 0, nmo - nfro)))  # [:nfro, nfro:nocc]
        K = K - K.T
        eye = torch.eye(nmo, dtype=kvo.dtype, device=kvo.device)
        return torch.linalg.solve(eye - 0.5 * K, eye + 0.5 * K)

    def fock_ao(kvo, kfa, h):
        C = C0 @ cayley2(kvo, kfa)
        Co = C[:, :nocc]
        P = 2.0 * Co @ Co.T
        J, K = _jk(B_ao, P)
        return C, P, h + J - 0.5 * K

    def e_hf(kvo, kfa, h):
        C, P, f = fock_ao(kvo, kfa, h)
        return torch.sum(P * h) + 0.5 * torch.sum(P * (f - h))

    def e_hyl(kvo, kfa, h):
        C, P, f = fock_ao(kvo, kfa, h)
        return _hylleraas(B_ao, C[:, nfro:nocc], C[:, nocc:], f, t2, ps, pt)

    def constraints(kvo, kfa, h):
        g_vo = grad(e_hf, argnums=0)(kvo, kfa, h)
        C, P, f = fock_ao(kvo, kfa, h)
        c_fa = C[:, :nfro].T @ f @ C[:, nfro:nocc]
        return g_vo, c_fa

    k0v = torch.zeros((nvir, nocc), dtype=t2.dtype, device=t2.device)
    k0f = torch.zeros((nfro, nact), dtype=t2.dtype, device=t2.device)
    g_hyl = grad(e_hyl, argnums=(0, 1))(k0v, k0f, h_ao)

    _, c_vjp = vjp(lambda kv, kf: constraints(kv, kf, h_ao), k0v, k0f)
    nv = k0v.numel()

    def apply(zz):
        a, b = c_vjp((zz[:nv].view(k0v.shape), zz[nv:].view(k0f.shape)))
        return torch.cat([a.reshape(-1), b.reshape(-1)])

    rhs = -torch.cat([g_hyl[0].reshape(-1), g_hyl[1].reshape(-1)])
    zz = _gmres(apply, rhs, tol=1e-10, restart=20, maxiter=400)
    z = (zz[:nv].view(k0v.shape), zz[nv:].view(k0f.shape))

    def lagrangian(h):
        c = constraints(k0v, k0f, h)
        return (e_hf(k0v, k0f, h) + e_hyl(k0v, k0f, h)
                + torch.sum(z[0] * c[0]) + torch.sum(z[1] * c[1]))

    return grad(lagrangian)(h_ao)


def _unrelaxed_rdm1_ao(C0, t2, nocc):
    dm_mo = mp2_mod.make_rdm1(t2, nocc)
    return C0 @ dm_mo @ C0.T


class DFRMP2:
    """DF-MP2 driver with relaxed/unrelaxed densities and natural
    orbitals (reference dfmp2_native.DFRMP2 surface).  Runs on the CUDA
    device unless a CPU device is passed; the dtype follows lib/device
    (fp64 on the CPU, fp32 on CUDA) unless given.  Densities and natural
    orbitals are tensors on that device.  The relaxed density's solvers
    stop at 1e-10 of the right-hand side, which fp32 cannot reach (they
    then run to their iteration limits): ask for it in fp64."""

    ps = 1.0
    pt = 1.0

    def __init__(self, mf, frozen=0, auxbasis=None, *, device=None,
                 dtype=None):
        self.device, self.dtype = _dev.resolve(device, dtype)
        if getattr(mf, "with_df", None) is None:
            mf = mf.density_fit(auxbasis)
        self._scf = mf
        self.mol = mf.mol
        self.frozen = int(frozen or 0)
        self.nocc = mf.mol.nelectron // 2 - self.frozen
        self.mo_coeff = np.asarray(mf.mo_coeff)[:, self.frozen:]
        self.mo_energy = np.asarray(mf.mo_energy)[self.frozen:]
        self.e_corr = None
        self.t2 = None
        self._B_ao = None

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    @property
    def B_ao(self):
        if self._B_ao is None:
            self._B_ao = self._tensor(self._scf.with_df.B_ao())
        return self._B_ao

    def kernel(self):
        C = self._tensor(self.mo_coeff)
        no = self.nocc
        Lov = _mo_factor(self.B_ao, C[:, :no], C[:, no:])
        eo = self._tensor(self.mo_energy[:no])
        ev = self._tensor(self.mo_energy[no:])
        e, t2 = mp2_mod.df_kernel(eo, ev, Lov)
        if (self.ps, self.pt) != (1.0, 1.0):
            ovov = einsum("Lia,Ljb->iajb", Lov, Lov)
            e_ss, e_os = mp2_mod.kernel_ss_os(eo, ev, ovov)
            e = self.ps * e_os + self.pt * e_ss
        self.e_corr = float(e)
        self.t2 = t2
        return self.e_corr

    calculate_energy = kernel

    def run(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        self.kernel()
        return self

    @property
    def e_tot(self):
        return self._scf.e_tot + self.e_corr

    # ------------------------------------------------------------ density
    def make_rdm1(self, relaxed=False, ao_repr=False):
        if self.t2 is None:
            self.kernel()
        C = self._tensor(self.mo_coeff)
        if relaxed:
            h = self._tensor(self._scf.get_hcore())
            if self.frozen:
                dm_ao = _relaxed_rdm1_ao_frozen(
                    self.B_ao, self._tensor(self._scf.mo_coeff), h, self.t2,
                    self.nocc + self.frozen, self.frozen,
                    ps=self.ps, pt=self.pt)
            else:
                dm_ao = _relaxed_rdm1_ao(self.B_ao, C, h, self.t2,
                                         self.nocc, ps=self.ps, pt=self.pt)
        else:
            dm_ao = _unrelaxed_rdm1_ao(C, self.t2, self.nocc)
        if ao_repr:
            return dm_ao
        proj = self._tensor(self._scf.get_ovlp()) @ self._mo_basis(relaxed)
        return proj.T @ dm_ao @ proj

    def _mo_basis(self, relaxed):
        """The orbitals of the MO representation: all of them for a
        relaxed density with a frozen core (it has frozen-core blocks),
        the correlated ones otherwise."""
        if relaxed and self.frozen:
            return self._tensor(self._scf.mo_coeff)
        return self._tensor(self.mo_coeff)

    def make_rdm1_unrelaxed(self, ao_repr=False):
        return self.make_rdm1(relaxed=False, ao_repr=ao_repr)

    def make_rdm1_relaxed(self, ao_repr=False):
        return self.make_rdm1(relaxed=True, ao_repr=ao_repr)

    def make_natorbs(self, rdm1_mo=None, relaxed=False):
        """(natural occupations, natural orbitals), most occupied first
        (reference dfmp2_native.make_natorbs :181).  The orbitals are
        those of the density's MO representation: with a frozen core and
        relaxed=True all of them (the JAX package multiplies the
        correlated ones and raises on the shape there)."""
        dm = self.make_rdm1(relaxed=relaxed) if rdm1_mo is None else rdm1_mo
        w, v = torch.linalg.eigh(dm)
        return w.flip(0), self._mo_basis(relaxed) @ v.flip(1)


class SCSDFRMP2(DFRMP2):
    """Spin-component-scaled DF-MP2 (reference dfmp2_native.SCSDFRMP2
    :255; Grimme's ps=6/5, pt=1/3 defaults)."""

    ps = 6.0 / 5.0
    pt = 1.0 / 3.0

    def __init__(self, mf, ps=6.0 / 5.0, pt=1.0 / 3.0, frozen=0,
                 auxbasis=None, *, device=None, dtype=None):
        super().__init__(mf, frozen=frozen, auxbasis=auxbasis,
                         device=device, dtype=dtype)
        self.ps = ps
        self.pt = pt
