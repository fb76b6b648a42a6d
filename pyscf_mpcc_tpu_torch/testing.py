"""Test and smoke-run inputs: molecules, synthetic DF integrals, random
(T) problems.

``mol_of`` builds the H2O geometries of the JAX package's tests with the
port's own ``gto``.  ``synthetic_eris`` is the counterpart of
``__graft_entry__._synthetic_eris``: the same recipe
(uniform 3-center factors scaled by 0.05, symmetrized Loo/Lvv, a diagonal
Fock of sorted orbital energies with the occupied block shifted down),
built on the target device from a seeded ``torch.Generator``.  The two
generators give different numbers from the same seed; parity tests make
their inputs with numpy instead.  ``synthetic_ueris`` is the same recipe
per spin for the unrestricted container, and ``synthetic_ufactors`` the
full-MO factors and one-electron integrals of the same numbers (the
inputs of the DF T3 engine).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.cc.eris import RERIs, _pair as pair
from pyscf_mpcc_tpu_torch.cc.uccsd import UERIs
from pyscf_mpcc_tpu_torch.lib import device as _dev

# H2O geometries (Angstrom) of the reference's tests: 'sym' is
# pyscf/cc/test/test_h2o.py, 'tilt' the distorted geometry of the pinned
# (T) value (pyscf/cc/ccsd_t.py:241)
GEOMS = {
    "sym": [[8, (0., 0., 0.)], [1, (0., -0.757, 0.587)],
            [1, (0., 0.757, 0.587)]],
    "tilt": [[8, (0., 0., 0.)], [1, (0., -0.957, 0.587)],
             [1, (0.2, 0.757, 0.487)]],
}

# (H2O)4: the first four waters (12 atoms, O H H each, Angstrom) of the
# (H2O)8 cube of examples/w8_ccsd_pipeline.py (_w8_cube: O-O edge 2.8,
# r(OH) 0.9572).  nocc 20, nmo 96 in cc-pVDZ.
W4_GEOM = [
    ["O", (0.0, 0.0, 0.0)], ["H", (0.9572, 0.0, 0.0)],
    ["H", (0.0, 0.9572, 0.0)],
    ["O", (0.0, 0.0, 2.8)], ["H", (0.0, 0.0, 1.8427999999999998)],
    ["H", (0.9572, 0.0, 2.8)],
    ["O", (0.0, 2.8, 0.0)], ["H", (0.9572, 2.8, 0.0)],
    ["H", (0.0, 2.8, 0.9572)],
    ["O", (0.0, 2.8, 2.8)], ["H", (0.0, 1.8427999999999998, 2.8)],
    ["H", (0.9572, 2.8, 2.8)],
]


def mol_of(geom="sym", basis="cc-pvdz"):
    """The port's Mole of an H2O geometry of GEOMS."""
    return gto.M(atom=GEOMS[geom], basis=basis)


def synthetic_eris(nocc=4, nvir=16, naux=32, device=None, dtype=None,
                   generator=None, build_ovvv=True):
    """RERIs with DF factors; build_ovvv=False leaves (ia|bc) implicit
    (the production layout at the (H2O)8 shape, where it would be
    9.7 GB in fp32)."""
    device, dtype = _dev.resolve(device, dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device,
                          dtype=dtype)

    Loo = uniform(naux, nocc, nocc) * 0.05
    Loo = 0.5 * (Loo + Loo.transpose(1, 2))
    Lov = uniform(naux, nocc, nvir) * 0.05
    Lvv = uniform(naux, nvir, nvir) * 0.05
    Lvv = 0.5 * (Lvv + Lvv.transpose(1, 2))
    mo_e = torch.sort(uniform(nocc + nvir)).values * 2.0
    mo_e[:nocc] -= 1.5
    fock = torch.diag(mo_e)

    ovov = pair(Lov, Lov)
    return RERIs(
        fock=fock, mo_energy=mo_e,
        oooo=pair(Loo, Loo),
        ovoo=pair(Lov, Loo),
        ovov=ovov,
        oovv=pair(Loo, Lvv),
        ovvo=ovov.permute(0, 1, 3, 2).contiguous(),
        ovvv=pair(Lov, Lvv) if build_ovvv else None,
        vvvv=None,
        Lvv=Lvv, Lov=Lov, Loo=Loo,
    )


def _synthetic_uspins(nocca, noccb, nvira, nvirb, naux, device, dtype,
                      seed):
    """Per spin (Loo, Lov, Lvv, fock) of the synthetic_eris recipe, drawn
    from one torch.Generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device, dtype=dtype)

    def spin(nocc, nvir):
        Loo = uniform(naux, nocc, nocc) * 0.05
        Lov = uniform(naux, nocc, nvir) * 0.05
        Lvv = uniform(naux, nvir, nvir) * 0.05
        mo_e = torch.sort(uniform(nocc + nvir)).values * 2.0
        mo_e[:nocc] -= 1.5
        return (0.5 * (Loo + Loo.transpose(1, 2)), Lov,
                0.5 * (Lvv + Lvv.transpose(1, 2)), torch.diag(mo_e))

    return spin(nocca, nvira), spin(noccb, nvirb)


def synthetic_ueris(nocca=4, noccb=3, nvira=12, nvirb=13, naux=32,
                    device=None, dtype=None, seed=0, materialize=False):
    """UERIs from random per-spin DF factors (the synthetic_eris recipe
    for each spin), on ``device`` from a torch.Generator seeded with
    ``seed``.  The o^2 v^2-class blocks are products of the same factors,
    so materialize=True (the three-virtual blocks as tensors instead of
    the factors; small shapes only) gives the same equations as the DF
    container."""
    device, dtype = _dev.resolve(device, dtype)
    (Loo_a, Lov_a, Lvv_a, fa), (Loo_b, Lov_b, Lvv_b, fb) = \
        _synthetic_uspins(nocca, noccb, nvira, nvirb, naux, device, dtype,
                          seed)

    def ex(a, b):      # (xy|wz) stored [x,y,z,w]
        return pair(a, b).permute(0, 1, 3, 2).contiguous()

    blocks = dict(
        focka=fa, fockb=fb, nocca=nocca, noccb=noccb,
        oooo=pair(Loo_a, Loo_a), ovoo=pair(Lov_a, Loo_a),
        ovov=pair(Lov_a, Lov_a), oovv=pair(Loo_a, Lvv_a),
        ovvo=ex(Lov_a, Lov_a),
        OOOO=pair(Loo_b, Loo_b), OVOO=pair(Lov_b, Loo_b),
        OVOV=pair(Lov_b, Lov_b), OOVV=pair(Loo_b, Lvv_b),
        OVVO=ex(Lov_b, Lov_b),
        ooOO=pair(Loo_a, Loo_b), ovOO=pair(Lov_a, Loo_b),
        OVoo=pair(Lov_b, Loo_a), ovOV=pair(Lov_a, Lov_b),
        ooVV=pair(Loo_a, Lvv_b), OOvv=pair(Loo_b, Lvv_a),
        ovVO=ex(Lov_a, Lov_b), OVvo=ex(Lov_b, Lov_a))
    if materialize:
        blocks.update(
            ovvv=pair(Lov_a, Lvv_a), OVVV=pair(Lov_b, Lvv_b),
            ovVV=pair(Lov_a, Lvv_b), OVvv=pair(Lov_b, Lvv_a),
            vvvv=pair(Lvv_a, Lvv_a), VVVV=pair(Lvv_b, Lvv_b),
            vvVV=pair(Lvv_a, Lvv_b))
    else:
        blocks.update(Lov_a=Lov_a, Lvv_a=Lvv_a, Lov_b=Lov_b, Lvv_b=Lvv_b)
    return UERIs(**blocks)


def synthetic_ufactors(nocca=4, noccb=3, nvira=12, nvirb=13, naux=32,
                       device=None, dtype=None, seed=0):
    """(B, h) consistent with ``synthetic_ueris`` of the same arguments:
    per-spin full-MO 3-center factors B[s] (naux, nmo, nmo), symmetric in
    the orbital pair, whose blocks are that container's factors, and
    one-electron integrals h[s] = fock_s - J + K_s, so that the dressed
    Fock of cc.ccsdt_act.dress_df at t1 = 0 is the container's Fock (what
    umpccsd.kernel_pert_df consumes beside the container)."""
    device, dtype = _dev.resolve(device, dtype)
    spins = _synthetic_uspins(nocca, noccb, nvira, nvirb, naux, device,
                              dtype, seed)
    B = []
    for (Loo, Lov, Lvv, _), no in zip(spins, (nocca, noccb)):
        B.append(torch.cat([torch.cat([Loo, Lov], dim=2),
                            torch.cat([Lov.transpose(1, 2), Lvv], dim=2)],
                           dim=1))
    jtot = sum(torch.diagonal(b[:, :no, :no], dim1=1, dim2=2).sum(-1)
               for b, no in zip(B, (nocca, noccb)))
    h = []
    for b, (*_, fock), no in zip(B, spins, (nocca, noccb)):
        j = torch.einsum("Lpq,L->pq", b, jtot)
        k = torch.einsum("Lpj,Ljq->pq", b[:, :, :no], b[:, :no, :])
        h.append(fock - j + k)
    return tuple(B), tuple(h)


def random_triples_problem(nocc=3, nvir=7, seed=7, naux=None):
    """numpy (t1, t2, fields) of a random (T) problem: the recipe of the
    JAX package's engine tests (tests/test_triples_fused.py _rand_problem,
    and _df_problem when naux is given: DF factors replace ovvv).  fields
    holds fock, mo_energy, ovoo, ovov, ovvv, Lov, Lvv."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape) * 0.05

    t1 = r(nocc, nvir)
    t2 = r(nocc, nocc, nvir, nvir)
    t2 = t2 + t2.transpose(1, 0, 3, 2)
    ovov = r(nocc, nvir, nocc, nvir)
    ovov = ovov + ovov.transpose(2, 3, 0, 1)
    ovvv = r(nocc, nvir, nvir, nvir)
    ovvv = ovvv + ovvv.transpose(0, 1, 3, 2)
    ovoo = r(nocc, nvir, nocc, nocc)
    ovoo = ovoo + ovoo.transpose(0, 1, 3, 2)
    mo_energy = np.concatenate([-np.sort(rng.random(nocc))[::-1] - 1.0,
                                np.sort(rng.random(nvir)) + 0.5])
    fock = np.diag(mo_energy)
    fock += 0.01 * (r(nocc + nvir, nocc + nvir)
                    + r(nocc + nvir, nocc + nvir).T)
    fields = dict(fock=fock, mo_energy=mo_energy, ovoo=ovoo, ovov=ovov,
                  ovvv=ovvv, Lov=None, Lvv=None)
    if naux:
        rng = np.random.default_rng(seed)
        fields["ovvv"] = None
        fields["Lov"] = rng.standard_normal((naux, nocc, nvir)) * 0.1
        Lvv = rng.standard_normal((naux, nvir, nvir)) * 0.1
        fields["Lvv"] = 0.5 * (Lvv + Lvv.transpose(0, 2, 1))
    return t1, t2, fields


def triples_tensors(t1, t2, fields, device, dtype):
    """(t1, t2, eris namespace) tensors of random_triples_problem."""
    def t(x):
        return None if x is None else torch.tensor(x, device=device,
                                                   dtype=dtype)
    return t(t1), t(t2), SimpleNamespace(**{k: t(v)
                                            for k, v in fields.items()})
