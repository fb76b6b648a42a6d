"""EOM-CCSD excitation, ionization and attachment energies via the CCSD
Jacobian.

Port of ``pyscf_mpcc_tpu/cc/eom.py``.  The EE-EOM-CCSD matrix is the
Jacobian of the ground-state amplitude residual, A_{mu nu} = dR_mu/dt_nu
(linear-response CC), so the sigma vector is one ``torch.func.jvp`` of
the same residual the ground-state solver iterates (``lambda_ad.residual``,
``residual_u``): no hand-derived H-bar intermediates.  The Davidson solver
(lib/linalg, a host copy of the JAX package's) keeps its vectors on the
host in fp64; each matvec moves one vector to the device in the working
dtype and its sigma back.  ``kernel_ee``, whose vectors are the size of
t2 (30 MB at benzene/cc-pVDZ), runs lib/device_davidson instead: the
same algorithm with its fp64 subspace beside the amplitudes.

IP/EA sectors (restricted and unrestricted) are EE spaces of a system
augmented by one zero-interaction orbital, so the same Jacobian sigma
serves every sector.  The spin-orbital kernels (``kernel_sf``,
``kernel_ee_g``, ``kernel_ip_g``, ``kernel_ea_g``) stay host NumPy over
the host copy cc/gccsd_slow, as in the JAX package: central differences
of its residual.

Forward mode runs under ``torch.no_grad()``, so the backward pass's
checkpoints of cc/rccsd (``_remat``) stay off.  ``ntile`` (the DF
ladder's tiling) defaults to the memory planner's choice for a backward
sweep (``lib/memory.plan_ladder_ntile(vjp=True)``): a jvp carries a
tangent beside every ladder block as a vjp carries a cotangent.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pyscf_mpcc_tpu_torch import config
from pyscf_mpcc_tpu_torch.cc import lambda_ad
from pyscf_mpcc_tpu_torch.convert import to_numpy
from pyscf_mpcc_tpu_torch.lib import device_davidson
from pyscf_mpcc_tpu_torch.lib.linalg import davidson


def plan_ntile(eris, ntile=None, nvir_extra=0):
    """The DF ladder tiling of a sigma: ``ntile`` where given; else the
    planner's backward-sweep tiling where the integrals are DF and the
    device's memory can be read (CUDA, or ``config.MAX_MEMORY`` set), and
    1 otherwise (incore integrals have no tiled ladder)."""
    if ntile:
        return int(ntile)
    if eris.vvvv is not None or (eris.Lvv is None
                                 and eris.Lvv_stream is None):
        return 1
    dev = eris.fock.device
    if dev.type != "cuda" and not config.MAX_MEMORY:
        return 1
    from pyscf_mpcc_tpu_torch.lib import memory
    return memory.plan_ladder_ntile(eris.nocc, eris.nvir + nvir_extra,
                                    eris.Lov.shape[0], eris.fock.dtype,
                                    vjp=True, device=dev)


def ee_sigma(t1, t2, eris, r1, r2, ntile=1):
    """sigma = (dR/dt) . r at the converged amplitudes."""
    def rfun(x1, x2):
        return lambda_ad.residual(x1, x2, eris, ntile=ntile)

    with torch.no_grad():
        _, (s1, s2) = torch.func.jvp(rfun, (t1, t2), (r1, r2))
    # A = dR/dt has diagonal -D = (e_a - e_i) > 0; its eigenvalues are the
    # (positive) excitation energies directly
    return s1, s2


def _to_dev(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _to_host(*xs):
    return np.concatenate([to_numpy(x).ravel().astype(np.float64)
                           for x in xs])


def kernel_ee(t1, t2, eris, nroots=3, tol=1e-7, max_cycle=100, verbose=0,
              ntile=None):
    """Lowest EE-EOM-CCSD excitation energies (singlet space).

    Returns (converged, omegas, vectors)."""
    nocc, nvir = t1.shape
    ntile = plan_ntile(eris, ntile)
    n1 = nocc * nvir
    eo = to_numpy(eris.mo_energy[:nocc])
    ev = to_numpy(eris.mo_energy[nocc:])
    eia = ev[None, :] - eo[:, None]
    # packed diag: [r1 (i,a)], [r2 (i,j,a,b)]
    diag = np.concatenate([eia.ravel(),
                           (eia[:, None, :, None]
                            + eia[None, :, None, :]).ravel()])
    t2s = t2.shape

    def matvec(x):
        r1 = x[:n1].reshape(nocc, nvir).to(t1.dtype)
        r2 = x[n1:].reshape(t2s).to(t2.dtype)
        r2 = 0.5 * (r2 + r2.permute(1, 0, 3, 2))
        s1, s2 = ee_sigma(t1, t2, eris, r1, r2, ntile=ntile)
        s2 = 0.5 * (s2 + s2.permute(1, 0, 3, 2))
        return torch.cat([s1.reshape(-1), s2.reshape(-1)]).double()

    # initial guesses: lowest orbital-energy-difference singles
    x0 = _guesses(diag, n1, nroots)
    conv, e, vecs = device_davidson.davidson(
        matvec, x0, torch.as_tensor(diag, device=t2.device), nroots=nroots,
        tol=tol, max_cycle=max_cycle, verbose=verbose, pick="follow")
    return conv, e, [None if v is None else to_numpy(v) for v in vecs]


# ---------------------------------------------------------------------------
# unrestricted EE (spin-blocked Jacobian; includes the triplet sector)
# ---------------------------------------------------------------------------

def ee_sigma_u(t1, t2, eris_u, r1, r2):
    def rfun(x1, x2):
        return lambda_ad.residual_u(x1, x2, eris_u)

    with torch.no_grad():
        _, (s1, s2) = torch.func.jvp(rfun, (t1, t2), (r1, r2))
    return s1, s2


def _p4(z):
    """Idempotent antisymmetrizer over the (ij) and (ab) pairs."""
    return 0.25 * (z - z.permute(1, 0, 2, 3) - z.permute(0, 1, 3, 2)
                   + z.permute(1, 0, 3, 2))


def kernel_ee_u(t1, t2, eris_u, nroots=3, tol=1e-7, max_cycle=100,
                verbose=0):
    """Lowest EE-EOM-UCCSD roots (covers singlet and triplet sectors)."""
    from pyscf_mpcc_tpu_torch.cc import uccsd as umod
    na, nb = umod._nocc(eris_u)
    ea, eb = (to_numpy(x) for x in eris_u.mo_energy)
    eia_a = ea[None, na:] - ea[:na, None]
    eia_b = eb[None, nb:] - eb[:nb, None]
    shapes = [x.shape for x in (*t1, *t2)]
    sizes = [int(np.prod(s)) for s in shapes]
    daa = (eia_a[:, None, :, None] + eia_a[None, :, None, :])
    dab = (eia_a[:, None, :, None] + eia_b[None, :, None, :])
    dbb = (eia_b[:, None, :, None] + eia_b[None, :, None, :])
    diag = np.concatenate([eia_a.ravel(), eia_b.ravel(),
                           daa.ravel(), dab.ravel(), dbb.ravel()])
    like = t1[0]

    def unpack(x):
        out, p = [], 0
        for s, n in zip(shapes, sizes):
            out.append(_to_dev(x[p:p + n].reshape(s), like))
            p += n
        return (out[0], out[1]), (out[2], out[3], out[4])

    def matvec(x):
        r1, r2 = unpack(x)
        s1, s2 = ee_sigma_u(t1, t2, eris_u, r1,
                            (_p4(r2[0]), r2[1], _p4(r2[2])))
        return _to_host(*s1, _p4(s2[0]), s2[1], _p4(s2[2]))

    n1 = na * t1[0].shape[1] + nb * t1[1].shape[1]
    x0 = _guesses(diag, n1, nroots)
    return davidson(matvec, x0, diag, nroots=nroots, tol=tol,
                    max_cycle=max_cycle, verbose=verbose, pick="follow")


# ---------------------------------------------------------------------------
# IP / EA via the continuum-orbital embedding
# ---------------------------------------------------------------------------
#
# Append one *zero-interaction* orbital (all integrals zero, orbital energy
# zero).  The CCSD fixed point is untouched (no amplitude can couple to it),
# and the EE-EOM Jacobian restricted to the fake-orbital sector IS the
# IP-EOM (fake virtual X: excitations i->X remove an electron from the
# interacting system) or EA-EOM (fake occupied Y: excitations Y->a attach
# one) similarity-transformed Hamiltonian, exactly.  The N+-1 sigmas
# reuse the EE jvp.

_RERIS_AXES = {
    "fock": "pp", "mo_energy": "p",
    "oooo": "oooo", "ovoo": "ovoo", "ovov": "ovov", "oovv": "oovv",
    "ovvo": "ovvo", "ovvv": "ovvv", "vvvv": "vvvv",
    "Lvv": "Lvv", "Lov": "Lov", "Loo": "Loo",
}


def _pad_axes(x, spec, which):
    """Zero-pad by one at the end of every axis whose spec character is
    in ``which``."""
    cfg = []
    for c in reversed(spec):
        cfg += [0, 1 if c in which else 0]
    return F.pad(x, cfg)


def _split_pp(x, nocc):
    """An (nmo, nmo) matrix with a zero row and column inserted at nocc
    (the new occupied orbital, last of the occupied range)."""
    z = x.new_zeros(1, x.shape[1])
    x = torch.cat([x[:nocc], z, x[nocc:]], dim=0)
    z = x.new_zeros(x.shape[0], 1)
    return torch.cat([x[:, :nocc], z, x[:, nocc:]], dim=1)


def _check_resident(eris):
    if getattr(eris, "Lvv_stream", None) is not None:
        raise ValueError("IP/EA embed the integrals in a larger orbital "
                         "space; pass device-resident (stream_vv=False) "
                         "integrals")


def _augment_virtual(t1, t2, eris):
    """(t1, t2, eris) with one zero-interaction virtual X appended."""
    _check_resident(eris)
    fields = {}
    for name, spec in _RERIS_AXES.items():
        x = getattr(eris, name)
        if x is None:
            fields[name] = None
        elif spec == "pp":
            fields[name] = F.pad(x, (0, 1, 0, 1))
        elif spec == "p":
            fields[name] = F.pad(x, (0, 1))
        else:
            fields[name] = _pad_axes(x, spec, "v")
    er = type(eris)(**fields)
    return F.pad(t1, (0, 1)), F.pad(t2, (0, 1, 0, 1)), er


def _augment_occupied(t1, t2, eris):
    """(t1, t2, eris) with one zero-interaction occupied Y appended.

    Y sits at the END of the occupied range (index nocc); the virtual
    block shifts by one in fock/mo_energy, which are rebuilt blockwise."""
    _check_resident(eris)
    nocc = t1.shape[0]
    fields = {}
    for name, spec in _RERIS_AXES.items():
        x = getattr(eris, name)
        if x is None:
            fields[name] = None
        elif spec == "pp":
            fields[name] = _split_pp(x, nocc)
        elif spec == "p":
            fields[name] = torch.cat([x[:nocc], x.new_zeros(1), x[nocc:]])
        else:
            fields[name] = _pad_axes(x, spec, "o")
    er = type(eris)(**fields)
    return (F.pad(t1, (0, 0, 0, 1)), F.pad(t2, (0, 0, 0, 0, 0, 1, 0, 1)),
            er)


def _guesses(diag, n1, nroots, nrandom=0, seed=7, project=None):
    """Unit-vector guesses: the n1 leading-block entries sorted by diag,
    then (if more roots requested than the 1h/1p block holds) the lowest
    remaining double-excitation diagonals.

    nrandom > 0 appends fixed-seed random vectors, the JAX package's
    (numpy's default_rng, same seed, same order).  Unit guesses have
    EXACTLY zero overlap with point-group sectors absent from the seeded
    configurations, so an interior 2h1p/2p1h-dominated root of another
    irrep is invisible to the Davidson subspace no matter how many
    cycles run (H2O/cc-pVDZ EA against the reference pin: the 0.5101 Ha
    root was unreachable from any pure 1p guess).  Random vectors
    overlap every sector; the reference instead orders guesses by its
    hand-derived interacting H-bar diagonal (eom_rccsd.py get_diag),
    which this package deliberately does not carry."""
    order1 = np.argsort(diag[:n1])
    idx = list(order1[:min(nroots, n1)])
    if len(idx) < nroots:
        order2 = n1 + np.argsort(diag[n1:])
        idx += list(order2[:nroots - len(idx)])
    x0 = []
    for k in idx:
        v = np.zeros(diag.size)
        v[k] = 1.0
        x0.append(v)
    rng = np.random.default_rng(seed)
    for _ in range(nrandom):
        x0.append(rng.standard_normal(diag.size))
    if project is not None:
        # coordinate maps with a null space (e.g. the (ij)- or (ab)-
        # antisymmetrized same-spin blocks of the U kernels) would turn
        # the null component of a random guess into a spurious zero
        # eigenvalue; project every guess onto the physical row space
        # (davidson drops any vector projected to ~0)
        x0 = [project(v) for v in x0]
    return x0


def ip_sigma(t1p, t2p, erp, x, ntile=1):
    """The IP sigma of one packed vector x = [r1 (i), r2 (i,j,a)] (a
    tensor on the device) on the virtual-augmented system; returns the
    packed sigma.  Written without in-place writes, so ``torch.func.vmap``
    batches it over kets (cc/momgfccsd)."""
    nocc, nvir = t1p.shape[0], t1p.shape[1] - 1
    r1 = x[:nocc]
    r2 = x[nocc:].reshape(nocc, nocc, nvir)
    # r1 in column X = nvir, r2 in [:, :, :nvir, X]
    r1p = F.pad(r1[:, None], (nvir, 0))
    r2p = F.pad(r2[..., None], (nvir, 0, 0, 1))
    r2p = r2p + r2p.permute(1, 0, 3, 2)
    s1p, s2p = ee_sigma(t1p, t2p, erp, r1p, r2p, ntile=ntile)
    s2p = 0.5 * (s2p + s2p.permute(1, 0, 3, 2))
    return torch.cat([s1p[:, nvir], s2p[:, :, :nvir, nvir].reshape(-1)])


def ea_sigma(t1p, t2p, erp, x, ntile=1):
    """The EA sigma of one packed vector x = [r1 (a), r2 (j,a,b)] on the
    occupied-augmented system; see ip_sigma."""
    nocc, nvir = t1p.shape[0] - 1, t1p.shape[1]
    r1 = x[:nvir]
    r2 = x[nvir:].reshape(nocc, nvir, nvir)
    # r1 in row Y = nocc, r2 in [Y, :nocc, :, :]
    r1p = F.pad(r1[None, :], (0, 0, nocc, 0))
    r2p = F.pad(r2[None], (0, 0, 0, 0, 0, 1, nocc, 0))
    r2p = r2p + r2p.permute(1, 0, 3, 2)
    s1p, s2p = ee_sigma(t1p, t2p, erp, r1p, r2p, ntile=ntile)
    s2p = 0.5 * (s2p + s2p.permute(1, 0, 3, 2))
    return torch.cat([s1p[nocc], s2p[nocc, :nocc].reshape(-1)])


def kernel_ip(t1, t2, eris, nroots=3, tol=1e-7, max_cycle=100, verbose=0,
              ntile=None):
    """Lowest IP-EOM-CCSD roots (ionization energies, positive).

    Vector layout: r1[i] (1h) + r2[i,j,a] (2h1p, amplitude of the
    symmetric pair {ij->aX, ji->Xa}).  Returns (conv, e_ip, vectors)."""
    nocc = t1.shape[0]
    t1p, t2p, erp = _augment_virtual(t1, t2, eris)
    ntile = plan_ntile(eris, ntile, 1)
    eo = to_numpy(eris.mo_energy[:nocc])
    ev = to_numpy(eris.mo_energy[nocc:])
    diag = np.concatenate([
        -eo,
        (-eo[:, None, None] - eo[None, :, None] + ev[None, None, :]).ravel(),
    ])

    def matvec(x):
        return _to_host(ip_sigma(t1p, t2p, erp, _to_dev(x, t1), ntile))

    # lowest-pick + random sector-coverage guesses: IP/EA parity means
    # "the nroots lowest eigenvalues", exactly as the reference's
    # ipccsd/eaccsd davidson; see _guesses on why random vectors are
    # required for completeness
    x0 = _guesses(diag, nocc, nroots, nrandom=nroots)
    return davidson(matvec, x0, diag, nroots=nroots, tol=tol,
                    max_cycle=max_cycle, verbose=verbose, pick="lowest")


def kernel_ea(t1, t2, eris, nroots=3, tol=1e-7, max_cycle=100, verbose=0,
              ntile=None):
    """Lowest EA-EOM-CCSD roots (electron attachment energies).

    Vector layout: r1[a] (1p) + r2[j,a,b] (2p1h, pair {Yj->ab, jY->ba})."""
    nocc, nvir = t1.shape
    t1p, t2p, erp = _augment_occupied(t1, t2, eris)
    ntile = plan_ntile(eris, ntile)
    eo = to_numpy(eris.mo_energy[:nocc])
    ev = to_numpy(eris.mo_energy[nocc:])
    diag = np.concatenate([
        ev,
        (-eo[:, None, None] + ev[None, :, None] + ev[None, None, :]).ravel(),
    ])

    def matvec(x):
        return _to_host(ea_sigma(t1p, t2p, erp, _to_dev(x, t1), ntile))

    x0 = _guesses(diag, nvir, nroots, nrandom=nroots)
    return davidson(matvec, x0, diag, nroots=nroots, tol=tol,
                    max_cycle=max_cycle, verbose=verbose, pick="lowest")


# ---------------------------------------------------------------------------
# restricted TRIPLET EE (reference EOMEETriplet, pyscf/cc/eom_rccsd.py:977)
# ---------------------------------------------------------------------------
#
# At a closed-shell reference the UCCSD Jacobian commutes with global
# alpha/beta exchange (sigma); Ms = 0 excitation space splits into the
# sigma-symmetric (singlet) and sigma-antisymmetric (triplet) sectors.
# The spin-adapted kernel_ee covers the singlet; here the tangent is
# constrained to the antisymmetric sector —
#     r1b = -r1a,   rbb = -raa,   rab[J,i,B,a] = -rab[i,J,a,B]
# — and the same ee_sigma_u drives the Davidson solve.


def embed_restricted(t1, t2):
    """RCCSD amplitudes -> UCCSD tuples at a closed-shell reference."""
    t2aa = t2 - t2.permute(0, 1, 3, 2)
    return (t1, t1), (t2aa, t2, t2aa)


def kernel_ee_triplet(t1, t2, eris_u, nroots=3, tol=1e-7, max_cycle=100,
                      verbose=0):
    """Lowest TRIPLET (Ms=0) EE-EOM-CCSD roots at a closed-shell reference.

    t1, t2: converged RCCSD amplitudes; eris_u: a uccsd.UERIs built with
    the same spatial orbitals for both spins (uccsd.make_eris_incore /
    make_eris_df with mo_a == mo_b).  Vector layout: r1[i,a] +
    raa[i,j,a,b] (pair-antisymmetric coords) + rab[i,J,a,B]
    (sigma-antisymmetric coords).  Returns (conv, omegas, vectors)."""
    t1u, t2u = embed_restricted(t1, t2)
    nocc, nvir = t1.shape
    eo = to_numpy(eris_u.mo_energy[0][:nocc])
    ev = to_numpy(eris_u.mo_energy[0][nocc:])
    eia = ev[None, :] - eo[:, None]
    d2 = eia[:, None, :, None] + eia[None, :, None, :]
    n1 = nocc * nvir
    n2 = n1 * n1
    diag = np.concatenate([eia.ravel(), d2.ravel(), d2.ravel()])

    def proj(x):
        r1 = _to_dev(x[:n1].reshape(nocc, nvir), t1)
        raa = _p4(_to_dev(x[n1:n1 + n2].reshape(t2.shape), t1))
        rab = _to_dev(x[n1 + n2:].reshape(t2.shape), t1)
        rab = 0.5 * (rab - rab.permute(1, 0, 3, 2))
        return r1, raa, rab

    def matvec(x):
        r1, raa, rab = proj(x)
        s1, s2 = ee_sigma_u(t1u, t2u, eris_u, (r1, -r1), (raa, rab, -raa))
        o1 = 0.5 * (s1[0] - s1[1])
        oaa = _p4(0.5 * (s2[0] - s2[2]))
        oab = 0.5 * (s2[1] - s2[1].permute(1, 0, 3, 2))
        return _to_host(o1, oaa, oab)

    x0 = _guesses(diag, n1, nroots)
    return davidson(matvec, x0, diag, nroots=nroots, tol=tol,
                    max_cycle=max_cycle, verbose=verbose, pick="follow")


# ---------------------------------------------------------------------------
# unrestricted IP / EA (same embedding, per ionized/attached spin channel)
# ---------------------------------------------------------------------------

_UERIS_AXES = {
    "focka": "pp", "fockb": "..",
    "oooo": "oooo", "ovoo": "ovoo", "ovov": "ovov", "oovv": "oovv",
    "ovvo": "ovvo",
    "OOOO": "....", "OVOO": "....", "OVOV": "....", "OOVV": "....",
    "OVVO": "....",
    "ooOO": "oo..", "ovOO": "ov..", "OVoo": "..oo", "ovOV": "ov..",
    "ooVV": "oo..", "OOvv": "..vv", "ovVO": "ov..", "OVvo": "..vo",
    "ovvv": "ovvv", "OVVV": "....", "ovVV": "ov..", "OVvv": "..vv",
    "vvvv": "vvvv", "VVVV": "....", "vvVV": "vv..",
    "Lov_a": ".ov", "Lvv_a": ".vv", "Lov_b": "...", "Lvv_b": "...",
}


def _spin_swap_u(t1, t2, eris):
    """Exchange the roles of alpha and beta everywhere."""
    from pyscf_mpcc_tpu_torch.cc.uccsd import UERIs

    def perm(x, *axes):
        return None if x is None else x.permute(*axes)

    er = UERIs(
        focka=eris.fockb, fockb=eris.focka,
        nocca=eris.noccb, noccb=eris.nocca,
        oooo=eris.OOOO, ovoo=eris.OVOO, ovov=eris.OVOV, oovv=eris.OOVV,
        ovvo=eris.OVVO,
        OOOO=eris.oooo, OVOO=eris.ovoo, OVOV=eris.ovov, OOVV=eris.oovv,
        OVVO=eris.ovvo,
        ooOO=eris.ooOO.permute(2, 3, 0, 1),
        ovOO=eris.OVoo, OVoo=eris.ovOO,
        ovOV=eris.ovOV.permute(2, 3, 0, 1),
        ooVV=eris.OOvv, OOvv=eris.ooVV,
        ovVO=eris.OVvo, OVvo=eris.ovVO,
        ovvv=eris.OVVV, OVVV=eris.ovvv,
        ovVV=eris.OVvv, OVvv=eris.ovVV,
        vvvv=eris.VVVV, VVVV=eris.vvvv,
        vvVV=perm(eris.vvVV, 2, 3, 0, 1),
        Lov_a=eris.Lov_b, Lvv_a=eris.Lvv_b,
        Lov_b=eris.Lov_a, Lvv_b=eris.Lvv_a,
    )
    (t1a, t1b), (t2aa, t2ab, t2bb) = t1, t2
    return (t1b, t1a), (t2bb, t2ab.permute(1, 0, 3, 2), t2aa), er


def _augment_u(t1, t2, eris, which):
    """UERIs (+amplitudes) with one zero-interaction ALPHA orbital appended
    (which='v': virtual, for IP; which='o': occupied, for EA)."""
    nocca = t1[0].shape[0]
    fields = {"nocca": eris.nocca + (1 if which == "o" else 0),
              "noccb": eris.noccb}
    for name, spec in _UERIS_AXES.items():
        x = getattr(eris, name)
        if x is None:
            fields[name] = None
        elif spec == "pp":
            fields[name] = (F.pad(x, (0, 1, 0, 1)) if which == "v"
                            else _split_pp(x, nocca))
        else:
            fields[name] = _pad_axes(x, spec, which)
    er = type(eris)(**fields)
    (t1a, t1b), (t2aa, t2ab, t2bb) = t1, t2
    if which == "v":
        t1a = F.pad(t1a, (0, 1))
        t2aa = F.pad(t2aa, (0, 1, 0, 1))
        t2ab = F.pad(t2ab, (0, 0, 0, 1))
    else:
        t1a = F.pad(t1a, (0, 0, 0, 1))
        t2aa = F.pad(t2aa, (0, 0, 0, 0, 0, 1, 0, 1))
        t2ab = F.pad(t2ab, (0, 0, 0, 0, 0, 0, 0, 1))
    return (t1a, t1b), (t2aa, t2ab, t2bb), er


def _asym4(z):
    return 0.5 * (z - z.permute(1, 0, 2, 3) - z.permute(0, 1, 3, 2)
                  + z.permute(1, 0, 3, 2))


def kernel_ip_u(t1, t2, eris_u, nroots=3, tol=1e-7, max_cycle=100,
                verbose=0, spin="a"):
    """Lowest IP-EOM-UCCSD roots for removal of a ``spin`` electron.

    Vector: r1[i] + r2aa[i,j,a] (same-spin 2h1p, antisym coords) +
    r2ab[i,J,B] (opposite-spin 2h1p)."""
    if spin == "b":
        t1, t2, eris_u = _spin_swap_u(t1, t2, eris_u)
    t1p, t2p, erp = _augment_u(t1, t2, eris_u, "v")
    na = t1[0].shape[0]
    nb = t1[1].shape[0]
    nva = t1[0].shape[1]
    nvb = t1[1].shape[1]
    ea, eb = (to_numpy(x) for x in eris_u.mo_energy)
    eoa, eva = ea[:na], ea[na:]
    eob, evb = eb[:nb], eb[nb:]
    diag = np.concatenate([
        -eoa,
        (-eoa[:, None, None] - eoa[None, :, None]
         + eva[None, None, :]).ravel(),
        (-eoa[:, None, None] - eob[None, :, None]
         + evb[None, None, :]).ravel(),
    ])
    naa = na * na * nva
    like = t1[0]

    def matvec(x):
        r1 = _to_dev(x[:na], like)
        raa = _to_dev(x[na:na + naa].reshape(na, na, nva), like)
        rab = _to_dev(x[na + naa:].reshape(na, nb, nvb), like)
        # r1 in column X = nva; raa in [:, :, :nva, X]; rab in [:, :, X, :]
        r1ap = F.pad(r1[:, None], (nva, 0))
        raap = _asym4(F.pad(raa[..., None], (nva, 0, 0, 1)))
        rabp = F.pad(rab[:, :, None, :], (0, 0, nva, 0))
        z1b = torch.zeros_like(t1p[1])
        zbb = torch.zeros_like(t2p[2])
        s1, s2 = ee_sigma_u(t1p, t2p, erp, (r1ap, z1b), (raap, rabp, zbb))
        # sigma of an antisymmetric tangent is antisymmetric; the slot
        # values ARE the coordinates
        return _to_host(s1[0][:, nva], s2[0][:, :, :nva, nva],
                        s2[1][:, :, nva, :])

    def _proj_ip(x):
        # physical coords: raa antisymmetric in (i,j) (see matvec _asym4)
        x = np.array(x)
        raa = x[na:na + naa].reshape(na, na, nva)
        x[na:na + naa] = 0.5 * (raa - raa.transpose(1, 0, 2)).ravel()
        return x

    x0 = _guesses(diag, na, nroots, nrandom=nroots, project=_proj_ip)
    return davidson(matvec, x0, diag, nroots=nroots, tol=tol,
                    max_cycle=max_cycle, verbose=verbose, pick="lowest")


def kernel_ea_u(t1, t2, eris_u, nroots=3, tol=1e-7, max_cycle=100,
                verbose=0, spin="a"):
    """Lowest EA-EOM-UCCSD roots for attachment of a ``spin`` electron.

    Vector: r1[a] + r2aa[j,a,b] (same-spin 2p1h, antisym coords) +
    r2ab[J,a,B] (opposite-spin 2p1h)."""
    if spin == "b":
        t1, t2, eris_u = _spin_swap_u(t1, t2, eris_u)
    t1p, t2p, erp = _augment_u(t1, t2, eris_u, "o")
    na = t1[0].shape[0]
    nb = t1[1].shape[0]
    nva = t1[0].shape[1]
    nvb = t1[1].shape[1]
    ea, eb = (to_numpy(x) for x in eris_u.mo_energy)
    eoa, eva = ea[:na], ea[na:]
    eob, evb = eb[:nb], eb[nb:]
    diag = np.concatenate([
        eva,
        (-eoa[:, None, None] + eva[None, :, None]
         + eva[None, None, :]).ravel(),
        (-eob[:, None, None] + eva[None, :, None]
         + evb[None, None, :]).ravel(),
    ])
    naa = na * nva * nva
    like = t1[0]

    def matvec(x):
        r1 = _to_dev(x[:nva], like)
        raa = _to_dev(x[nva:nva + naa].reshape(na, nva, nva), like)
        rab = _to_dev(x[nva + naa:].reshape(nb, nva, nvb), like)
        # r1 in row Y = na; raa in [Y, :na, :, :]; rab in [Y, :, :, :]
        r1ap = F.pad(r1[None, :], (0, 0, na, 0))
        raap = _asym4(F.pad(raa[None], (0, 0, 0, 0, 0, 1, na, 0)))
        rabp = F.pad(rab[None], (0, 0, 0, 0, 0, 0, na, 0))
        z1b = torch.zeros_like(t1p[1])
        zbb = torch.zeros_like(t2p[2])
        s1, s2 = ee_sigma_u(t1p, t2p, erp, (r1ap, z1b), (raap, rabp, zbb))
        return _to_host(s1[0][na, :], s2[0][na, :na], s2[1][na])

    def _proj_ea(x):
        # physical coords: raa antisymmetric in (a,b) (see matvec _asym4)
        x = np.array(x)
        raa = x[nva:nva + naa].reshape(na, nva, nva)
        x[nva:nva + naa] = 0.5 * (raa - raa.transpose(0, 2, 1)).ravel()
        return x

    x0 = _guesses(diag, nva, nroots, nrandom=nroots, project=_proj_ea)
    return davidson(matvec, x0, diag, nroots=nroots, tol=tol,
                    max_cycle=max_cycle, verbose=verbose, pick="lowest")


# ---------------------------------------------------------------------------
# Spin-flip EE-EOM (Ms = -1 sector) over the spin-orbital Jacobian: host
# NumPy over the host copy cc/gccsd_slow, as in the JAX package.
#
# Role of the reference's EOMEESpinFlip (pyscf/cc/eom_rccsd.py SF classes):
# target Ms = +-1 states from a closed- or open-shell reference.  The
# sigma is the directional derivative of the SPIN-ORBITAL residual,
# restricted to the Delta-Ms = -1 amplitude blocks (H-bar conserves Ms, so
# projecting input and output onto the sector is exact).  The residual is
# a quartic polynomial in t, so a central difference gives the Jacobian
# action to O(eps^2 * |r|^3) — machine-precision-grade at eps ~ 1e-5 in
# fp64.  Small systems (spin-orbital einsums).
# ---------------------------------------------------------------------------
def _gccsd_residual(t1, t2, eris):
    from pyscf_mpcc_tpu_torch.cc import gccsd_slow
    nocc = eris.nocc
    f = eris.fock
    eo = np.diag(f)[:nocc]
    ev = np.diag(f)[nocc:]
    d1 = eo[:, None] - ev[None, :]
    d2 = (eo[:, None, None, None] + eo[None, :, None, None]
          - ev[None, None, :, None] - ev[None, None, None, :])
    t1n, t2n = gccsd_slow.update_amps(t1, t2, eris)
    return (t1n - t1) * d1, (t2n - t2) * d2


def kernel_sf(t1, t2, eris_so, nroots=2, tol=1e-6, max_cycle=100,
              verbose=0, eps=1e-5):
    """Lowest spin-flip (Ms: 0 -> -1) EE-EOM-CCSD roots.

    t1, t2: converged SPIN-ORBITAL amplitudes (numpy); eris_so: a
    gccsd_slow.SpinOrbERIs (carries per-spin-orbital labels).
    Returns (conv, e_sf, vectors)."""
    return kernel_ee_g(t1, t2, eris_so, nroots=nroots, delta_ms=-1,
                       tol=tol, max_cycle=max_cycle, verbose=verbose,
                       eps=eps)


def kernel_ee_g(t1, t2, eris_so, nroots=2, delta_ms=0, tol=1e-6,
                max_cycle=100, verbose=0, eps=1e-5):
    """EE-EOM-GCCSD roots in the chosen Delta-Ms sector (reference
    eom_gccsd.EOMEE role; delta_ms=0 covers singlets AND triplets,
    +-1 are the spin-flip sectors).  Spin-orbital amplitudes/ERIs as in
    kernel_sf; the sigma is the central-difference directional derivative
    of the GCCSD residual (exact to O(eps^2): the residual is quartic)."""
    nocc, nvir = t1.shape
    so = np.asarray(eris_so.spins[:nocc])
    sv = np.asarray(eris_so.spins[nocc:])
    # beta label = 1: Delta-Ms = -(net alpha->beta flips)
    m1 = (sv[None, :] - so[:, None]) == -delta_ms
    m2 = ((sv[None, None, :, None] + sv[None, None, None, :]
           - so[:, None, None, None] - so[None, :, None, None])
          == -delta_ms)
    n1 = nocc * nvir

    f = eris_so.fock
    eo = np.diag(f)[:nocc]
    ev = np.diag(f)[nocc:]
    diag1 = (ev[None, :] - eo[:, None])
    diag2 = (ev[None, None, :, None] + ev[None, None, None, :]
             - eo[:, None, None, None] - eo[None, :, None, None])
    diag = np.concatenate([np.where(m1, diag1, 1e6).ravel(),
                           np.where(m2, diag2, 1e6).ravel()])

    def proj(x):
        """Idempotent projector onto the antisymmetric Delta-Ms block."""
        r1 = np.where(m1, x[:n1].reshape(nocc, nvir), 0.0)
        r2 = x[n1:].reshape(t2.shape)
        r2 = 0.5 * (r2 - r2.transpose(1, 0, 2, 3))
        r2 = 0.5 * (r2 - r2.transpose(0, 1, 3, 2))
        r2 = np.where(m2, r2, 0.0)
        return r1, r2

    def matvec(x):
        r1, r2 = proj(x)
        p1, q1 = _gccsd_residual(t1 + eps * r1, t2 + eps * r2, eris_so)
        p2, q2 = _gccsd_residual(t1 - eps * r1, t2 - eps * r2, eris_so)
        s1 = np.where(m1, (p1 - p2) / (2 * eps), 0.0)
        s2 = 0.5 * ((q1 - q2) - (q1 - q2).transpose(1, 0, 2, 3))
        s2 = np.where(m2, 0.5 * (s2 - s2.transpose(0, 1, 3, 2)), 0.0)
        return np.concatenate([s1.ravel(), s2.ravel() / (2 * eps)])

    # project guesses into the antisymmetric sector so Davidson never
    # sees the (null) symmetric complement
    x0 = []
    for v in _guesses(diag, n1, nroots + 2):
        r1, r2 = proj(v)
        w = np.concatenate([r1.ravel(), r2.ravel()])
        nrm = np.linalg.norm(w)
        if nrm > 1e-8:
            x0.append(w / nrm)
    return _davidson_sorted(matvec, x0, diag, nroots, tol=tol,
                            max_cycle=max_cycle, verbose=verbose)


def _davidson_sorted(matvec, x0, diag, nroots, **kw):
    """Root-following Davidson over len(x0) >= nroots guesses, returning
    the lowest ``nroots`` eigenpairs by value.  Spin-orbital spaces carry
    exact alpha/beta degeneracies that can make overlap-tracking land a
    single requested root on the wrong member — solving for a margin of
    extra roots and sorting is the robust fix."""
    conv, e, vecs = davidson(matvec, x0, diag, nroots=len(x0),
                             pick="follow", **kw)
    order = np.argsort(np.asarray(e).real)[:nroots]
    return ([conv[i] for i in order], np.asarray(e)[order],
            [vecs[i] for i in order])


# ---------------------------------------------------------------------------
# G-spin IP / EA (reference eom_gccsd.EOMIP/EOMEA role): the same
# zero-interaction-orbital embedding as the restricted solvers, in the
# spin-orbital space, with the finite-difference GCCSD Jacobian.
# ---------------------------------------------------------------------------

def _augment_so(t1, t2, eris_so, which):
    """SpinOrbERIs (+amplitudes) with one zero-interaction spin orbital
    appended at the end of the virtual ('v') or occupied ('o') range."""
    from pyscf_mpcc_tpu_torch.cc.gccsd_slow import SpinOrbERIs
    nocc = eris_so.nocc
    nso = eris_so.nso
    ints = np.zeros((nso + 1,) * 4)
    fock = np.zeros((nso + 1, nso + 1))
    if which == "v":
        old = list(range(nso))
    else:
        old = list(range(nocc)) + list(range(nocc + 1, nso + 1))
    ix = np.asarray(old)
    ints[np.ix_(ix, ix, ix, ix)] = eris_so.ints
    fock[np.ix_(ix, ix)] = eris_so.fock
    spins = np.insert(np.asarray(eris_so.spins), nocc if which == "o"
                      else nso, 0)
    er = SpinOrbERIs(ints, fock, nocc + (1 if which == "o" else 0),
                     spins=spins)
    if which == "v":
        t1p = np.pad(np.asarray(t1), [(0, 0), (0, 1)])
        t2p = np.pad(np.asarray(t2), [(0, 0), (0, 0), (0, 1), (0, 1)])
    else:
        t1p = np.pad(np.asarray(t1), [(0, 1), (0, 0)])
        t2p = np.pad(np.asarray(t2), [(0, 1), (0, 1), (0, 0), (0, 0)])
    return t1p, t2p, er


def kernel_ip_g(t1, t2, eris_so, nroots=2, tol=1e-6, max_cycle=100,
                verbose=0, eps=1e-5):
    """IP-EOM-GCCSD: r1[i] + r2[i,j,a] ((ij)-antisymmetric 2h1p), all spin
    sectors together.  Returns (conv, e_ip (positive), vectors)."""
    nocc, nvir = t1.shape
    t1p, t2p, erp = _augment_so(t1, t2, eris_so, "v")
    X = nvir
    eo = np.diag(np.asarray(eris_so.fock))[:nocc]
    ev = np.diag(np.asarray(eris_so.fock))[nocc:]
    diag = np.concatenate([
        -eo, (-eo[:, None, None] - eo[None, :, None]
              + ev[None, None, :]).ravel()])
    n1 = nocc

    def proj(x):
        r1 = x[:n1]
        r2 = x[n1:].reshape(nocc, nocc, nvir)
        return r1, 0.5 * (r2 - r2.transpose(1, 0, 2))

    def embed(r1, r2):
        z1 = np.zeros_like(t1p)
        z1[:, X] = r1
        z2 = np.zeros_like(t2p)
        z2[:, :, :nvir, X] = r2
        z2 = z2 - z2.transpose(0, 1, 3, 2)
        return z1, z2

    def matvec(x):
        r1, r2 = proj(x)
        z1, z2 = embed(r1, r2)
        p1, q1 = _gccsd_residual(t1p + eps * z1, t2p + eps * z2, erp)
        p2, q2 = _gccsd_residual(t1p - eps * z1, t2p - eps * z2, erp)
        s1 = (p1 - p2)[:, X] / (2 * eps)
        s2 = (q1 - q2)[:, :, :nvir, X] / (2 * eps)
        s2 = 0.5 * (s2 - s2.transpose(1, 0, 2))
        return np.concatenate([s1.ravel(), s2.ravel()])

    x0 = _guesses(diag, n1, nroots + 2)
    return _davidson_sorted(matvec, x0, diag, nroots, tol=tol,
                            max_cycle=max_cycle, verbose=verbose)


def kernel_ea_g(t1, t2, eris_so, nroots=2, tol=1e-6, max_cycle=100,
                verbose=0, eps=1e-5):
    """EA-EOM-GCCSD: r1[a] + r2[j,a,b] ((ab)-antisymmetric 2p1h)."""
    nocc, nvir = t1.shape
    t1p, t2p, erp = _augment_so(t1, t2, eris_so, "o")
    Y = nocc
    eo = np.diag(np.asarray(eris_so.fock))[:nocc]
    ev = np.diag(np.asarray(eris_so.fock))[nocc:]
    diag = np.concatenate([
        ev, (-eo[:, None, None] + ev[None, :, None]
             + ev[None, None, :]).ravel()])
    n1 = nvir

    def proj(x):
        r1 = x[:n1]
        r2 = x[n1:].reshape(nocc, nvir, nvir)
        return r1, 0.5 * (r2 - r2.transpose(0, 2, 1))

    def embed(r1, r2):
        z1 = np.zeros_like(t1p)
        z1[Y, :] = r1
        z2 = np.zeros_like(t2p)
        z2[Y, :nocc, :, :] = r2
        z2 = z2 - z2.transpose(1, 0, 2, 3)
        return z1, z2

    def matvec(x):
        r1, r2 = proj(x)
        z1, z2 = embed(r1, r2)
        p1, q1 = _gccsd_residual(t1p + eps * z1, t2p + eps * z2, erp)
        p2, q2 = _gccsd_residual(t1p - eps * z1, t2p - eps * z2, erp)
        s1 = (p1 - p2)[Y, :] / (2 * eps)
        s2 = (q1 - q2)[Y, :nocc, :, :] / (2 * eps)
        s2 = 0.5 * (s2 - s2.transpose(0, 2, 1))
        return np.concatenate([s1.ravel(), s2.ravel()])

    x0 = _guesses(diag, n1, nroots + 2)
    return _davidson_sorted(matvec, x0, diag, nroots, tol=tol,
                            max_cycle=max_cycle, verbose=verbose)
