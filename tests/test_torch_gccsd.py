"""The port's spin-orbital CCSD (cc/gccsd: GERIs, make_eris_ghf, _update
in its 'ccsd' and 'qcisd' variants, energy, kernel, the GCCSD facade)
against the JAX package, in fp64 on the CPU.

Inputs: OH/sto-3g GHF (the JAX package's test_gccsd_t_rdm.py system) with
the JAX GHF's orbitals handed to both packages, seeded antisymmetric
amplitudes for one update, and H2O/sto-3g RHF for the facade
(convert_to_ghf) against the restricted CCSD and the host oracle
cc/gccsd_slow.  Tolerances: the nine blocks and one update 1e-12 (the
same fp64 algebra); converged energies 1e-9 Ha and amplitudes 1e-8.
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu.cc import gccsd as jg
from pyscf_mpcc_tpu_torch import convert, gto, scf
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.cc import gccsd, gccsd_slow, rccsd

torch.set_num_threads(1)

CPU = torch.device("cpu")
OH = "O 0 0 0; H 0 0 0.97"
H2O = [[8, (0, 0, 0)], [1, (0, -0.757, 0.587)], [1, (0, 0.757, 0.587)]]


def _ghf(pkg_gto, pkg_scf):
    mf = pkg_scf.GHF(pkg_gto.M(atom=OH, basis="sto-3g", spin=1))
    mf.conv_tol = 1e-12
    mf.kernel()
    assert mf.converged
    return mf


def _antisym(x):
    x = x - x.transpose(1, 0, 2, 3)
    return x - x.transpose(0, 1, 3, 2)


@pytest.fixture(scope="module")
def ref():
    jmf = _ghf(jgto, jscf)
    er = jg.make_eris_ghf(jmf)
    e, t1, t2, c = jg.kernel(er, conv_tol=1e-11, conv_tol_normt=1e-9)
    assert c
    rng = np.random.default_rng(11)
    no, nv = np.asarray(t1).shape
    s1 = 0.05 * rng.standard_normal((no, nv))
    s2 = 0.05 * _antisym(rng.standard_normal((no, no, nv, nv)))
    out = dict(jmf=jmf, blocks={k: np.asarray(v) for k, v in er.b.items()},
               fock=np.asarray(er.fock), nocc=er.nocc, e=e,
               t1=np.asarray(t1), t2=np.asarray(t2), s1=s1, s2=s2)
    for variant in ("ccsd", "qcisd"):
        u1, u2 = jg._update(s1, s2, er.b, er.fock, er.nocc, variant=variant)
        out["upd", variant] = (np.asarray(u1), np.asarray(u2))
        out["e", variant] = jg.energy(s1, s2, er, variant=variant)
    return out


def _geris(ref):
    return convert.geris_from_numpy(ref["blocks"], ref["fock"], ref["nocc"],
                                    CPU)


def test_make_eris_ghf_blocks_match_jax(ref):
    mf = _ghf(gto, scf)
    jmf = ref["jmf"]
    assert abs(mf.e_tot - jmf.e_tot) < 1e-10
    # the JAX GHF's spinors in the port's mean field, so both packages
    # transform the same orbitals
    mf.mo_coeff, mf.mo_occ = np.asarray(jmf.mo_coeff), np.asarray(jmf.mo_occ)
    er = gccsd.make_eris_ghf(mf, device=CPU)
    assert er.nocc == ref["nocc"] and er.nso == ref["fock"].shape[0]
    for k in gccsd.GERIs.BLOCKS:
        assert er.b[k].dtype == torch.float64
        np.testing.assert_allclose(er.b[k].numpy(), ref["blocks"][k],
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(er.fock.numpy(), ref["fock"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(er.block("oovv"), ref["blocks"]["oovv"],
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("variant", ["ccsd", "qcisd"])
def test_update_and_energy_match_jax(ref, variant):
    er = _geris(ref)
    s1, s2 = convert.amps_from_numpy(ref["s1"], ref["s2"], CPU)
    u1, u2 = gccsd._update(s1, s2, er.b, er.fock, er.nocc, variant=variant)
    w1, w2 = ref["upd", variant]
    np.testing.assert_allclose(u1.numpy(), w1, rtol=0, atol=1e-12)
    np.testing.assert_allclose(u2.numpy(), w2, rtol=0, atol=1e-12)
    assert abs(gccsd.energy(s1, s2, er, variant=variant)
               - ref["e", variant]) < 1e-12


def test_kernel_matches_jax_and_oracle(ref):
    er = _geris(ref)
    e, t1, t2, c = gccsd.kernel(er, conv_tol=1e-11, conv_tol_normt=1e-9)
    assert c and t2.dtype == torch.float64
    assert abs(e - ref["e"]) < 1e-9
    np.testing.assert_allclose(t1.numpy(), ref["t1"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(t2.numpy(), ref["t2"], rtol=0, atol=1e-8)
    # the host oracle on the same blocks (it reads them through .block)
    so = gccsd_slow.SpinOrbERIs(None, ref["fock"], ref["nocc"])
    so.block = er.block
    e_o = gccsd_slow.kernel(so, conv_tol=1e-11, conv_tol_normt=1e-9)[0]
    assert abs(e - e_o) < 1e-9


def test_gccsd_facade_on_rhf_matches_rccsd():
    mol = gto.M(atom=H2O, basis="sto-3g")
    mf = scf.RHF(mol)
    mf.conv_tol = 1e-12
    mf.kernel()
    cc = gccsd.GCCSD(mf, device=CPU).run(conv_tol=1e-11, conv_tol_normt=1e-9)
    assert cc.converged and cc.t2.device == CPU
    er = eris_mod.make_eris_incore(gto.intor_eri(mol), mf.mo_coeff,
                                   mf.get_fock(mf.make_rdm1()), 5,
                                   device=CPU)
    c, e_r, _, _ = rccsd.kernel(er, conv_tol=1e-11, conv_tol_normt=1e-9)
    assert c
    assert abs(cc.e_corr - float(e_r)) < 1e-8
    assert abs(cc.e_tot - (mf.e_tot + cc.e_corr)) < 1e-12
