"""The port's restricted EOM-CCSD (cc/eom: ee_sigma, kernel_ee, kernel_ip,
kernel_ea and the RCCSDDriver methods) against the JAX package, in fp64
on the CPU.

Inputs: H2O/sto-3g (the JAX package's test_eom_ip_ea.py geometry) with
the JAX RHF's orbitals, AO integrals and Fock, and the JAX CCSD
amplitudes handed to both packages as numpy arrays (the JAX reference is
computed once, a module fixture); H2/6-31g through the port alone against
its exact two-electron spectrum (tests/test_eom.py); H2O/cc-pVDZ through
the port's own RHF and CCSD driver against the reference's pins
(tests/test_eom_ip_ea.py, docs/reference_pins.json h2o_ccpvdz).

Tolerances: the sigma 1e-10 of its scale (the same contractions, forward
mode in both); roots 1e-10 Ha (the same Davidson on the same guesses);
the two-electron spectrum 1e-6 Ha (EE) and 1e-8 Ha (IP), the JAX tests'
bounds; the pins 1e-7 Ha (IP/EA) and 5e-7 Ha (EE), the JAX test's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.cc import eom as jeom
from pyscf_mpcc_tpu.cc import eris as jeris_mod
from pyscf_mpcc_tpu.cc import rccsd as jrccsd
from pyscf_mpcc_tpu.scf import RHF as JRHF
from pyscf_mpcc_tpu_torch import ao2mo, convert, gto
from pyscf_mpcc_tpu_torch.cc import eom, rccsd
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.cc.driver import CCSD
from pyscf_mpcc_tpu_torch.scf import RHF

torch.set_num_threads(1)

CPU = torch.device("cpu")
H2O = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
KERNELS = ("kernel_ee", "kernel_ip", "kernel_ea")
# the reference fork's eom_rccsd at H2O/cc-pVDZ (tests/test_eom_ip_ea.py)
REF_E_CORR = -0.2133274273544366
REF_IP = [0.433564372260947, 0.5186599930972678, 0.6784704515875678]
REF_EA = [0.16741950216613447, 0.24029462761583625, 0.5101075032617646]
REF_EE = [0.3006258759956825, 0.37594403988325975, 0.397748269999603]


@pytest.fixture(scope="module")
def ref():
    """JAX H2O/sto-3g: integrals, amplitudes, a sigma and the roots."""
    mol = jgto.M(atom=H2O, basis="sto-3g", unit="angstrom")
    mf = JRHF(mol)
    mf.conv_tol = 1e-12
    mf.kernel()
    args = (np.asarray(jgto.intor_eri(mol)), np.asarray(mf.mo_coeff),
            np.asarray(mf.get_fock(mf.make_rdm1())), 5)
    er = jeris_mod.make_eris_incore(*args)
    conv, _, t1, t2 = jrccsd.kernel(er, conv_tol=1e-11, conv_tol_normt=1e-9)
    assert conv
    rng = np.random.default_rng(0)
    r1 = rng.standard_normal(t1.shape)
    r2 = rng.standard_normal(t2.shape)
    r2 = 0.5 * (r2 + r2.transpose(1, 0, 3, 2))
    s1, s2 = jeom.ee_sigma(t1, t2, er, jnp.asarray(r1), jnp.asarray(r2))
    out = dict(args=args, t1=np.asarray(t1), t2=np.asarray(t2), r1=r1,
               r2=r2, s1=np.asarray(s1), s2=np.asarray(s2))
    for name in KERNELS:
        conv, e, _ = getattr(jeom, name)(t1, t2, er, nroots=3, tol=1e-9)
        assert all(conv)
        out[name] = np.asarray(e)
    return out


def _port(ref):
    er = eris_mod.make_eris_incore(*ref["args"], device=CPU)
    return (*convert.amps_from_numpy(ref["t1"], ref["t2"], CPU), er)


def test_ee_sigma_matches_jax(ref):
    t1, t2, er = _port(ref)
    r1, r2 = convert.amps_from_numpy(ref["r1"], ref["r2"], CPU)
    s1, s2 = eom.ee_sigma(t1, t2, er, r1, r2)
    for a, b in ((s1, ref["s1"]), (s2, ref["s2"])):
        a = convert.to_numpy(a)
        assert np.abs(a - b).max() < 1e-10 * np.abs(b).max()


@pytest.mark.parametrize("name", KERNELS)
def test_roots_match_jax(ref, name):
    t1, t2, er = _port(ref)
    conv, e, vecs = getattr(eom, name)(t1, t2, er, nroots=3, tol=1e-9)
    assert all(conv) and len(vecs) == 3
    np.testing.assert_allclose(e, ref[name], rtol=0, atol=1e-10)


def _h2():
    mol = gto.M(atom="H 0 0 0; H 0 0 0.74", basis="6-31g")
    mf = RHF(mol)
    mf.conv_tol = 1e-13
    mf.conv_tol_grad = 1e-10
    mf.kernel()
    er = eris_mod.make_eris_incore(gto.intor_eri(mol), mf.mo_coeff,
                                   mf.get_fock(mf.make_rdm1()), 1,
                                   device=CPU)
    conv, e_corr, t1, t2 = rccsd.kernel(er, conv_tol=1e-12,
                                        conv_tol_normt=1e-11, max_cycle=100)
    assert conv
    return mol, mf, er, e_corr, t1, t2


def _fci_singlets(mol, mf):
    """Exact singlet spectrum of the 2-electron Hamiltonian (MO basis)."""
    mo = np.asarray(mf.mo_coeff)
    nmo = mo.shape[1]
    h = mo.T @ mf.get_hcore() @ mo
    g = convert.to_numpy(ao2mo.full(torch.tensor(gto.intor_eri(mol)),
                                    torch.tensor(mo)))
    pairs = [(p, q) for p in range(nmo) for q in range(p, nmo)]

    def me(p, q, r, s):
        return (h[p, r] * (q == s) + h[q, s] * (p == r) + g[p, r, q, s])

    H = np.zeros((len(pairs), len(pairs)))
    for i, (p, q) in enumerate(pairs):
        for j, (r, s) in enumerate(pairs):
            val = 0.5 * (me(p, q, r, s) + me(p, q, s, r) + me(q, p, r, s)
                         + me(q, p, s, r))
            H[i, j] = val / ((np.sqrt(2.0) if p == q else 1.0)
                             * (np.sqrt(2.0) if r == s else 1.0))
    return np.linalg.eigvalsh(H) + mol.energy_nuc(), h


def test_two_electron_spectrum_is_exact():
    """For two electrons CCSD is FCI: the EE roots are the exact singlet
    gaps and the IP roots the exact cation energies less the ground
    state's (the {1h, 2h1p} space spans the one-electron space)."""
    mol, mf, er, e_corr, t1, t2 = _h2()
    fci, h = _fci_singlets(mol, mf)
    e0 = mf.e_tot + e_corr
    assert abs(e0 - fci[0]) < 1e-8
    conv, e_ee, _ = eom.kernel_ee(t1, t2, er, nroots=2, tol=1e-7)
    assert all(conv)
    np.testing.assert_allclose(e_ee, fci[1:3] - fci[0], rtol=0, atol=1e-6)
    conv, e_ip, _ = eom.kernel_ip(t1, t2, er, nroots=2, tol=1e-9)
    assert all(conv)
    cation = np.linalg.eigvalsh(h)[:2] - (e0 - mol.energy_nuc())
    np.testing.assert_allclose(e_ip, cation, rtol=0, atol=1e-8)


def test_driver_methods_reference_pins_h2o_ccpvdz():
    mf = RHF(gto.M(atom=H2O, basis="cc-pvdz", unit="angstrom"))
    mf.conv_tol = 1e-13
    mf.kernel()
    cc = CCSD(mf, device=CPU).set(conv_tol=1e-11, conv_tol_normt=1e-9)
    cc.run()
    assert cc.converged and abs(cc.e_corr - REF_E_CORR) < 1e-8
    np.testing.assert_allclose(cc.ipccsd(nroots=3, tol=1e-9), REF_IP,
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(cc.eaccsd(nroots=3, tol=1e-9), REF_EA,
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(cc.eeccsd(nroots=3, tol=1e-9), REF_EE,
                               rtol=0, atol=5e-7)
