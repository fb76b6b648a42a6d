"""The port's fragmented MP-CC workflow and the MPCC(mf) facade against
the JAX package.

- fragmented_mpcc on H2O/cc-pVDZ (the JAX package's cached RHF solution,
  handed to a port RHF of the same molecule, and the same AO integrals):
  the oxygen fragment with all but the all-active doubles block frozen
  gives the same localized spaces as JAX's run and its energy within
  1e-9 Ha (both solves converge to 1e-9); one fragment over all atoms
  with nothing frozen gives CCSD (the pin, 1e-7).
- MPCC(mf) on H2O/sto-3g with an even-tempered DF basis, end to end
  (tests/test_mpcc_facade.py's run): the low-level energy and the
  high-level kernel's energy against JAX's facade, 1e-8 Ha.
- fragmented_mpcc_unrestricted on O2 triplet/sto-3g (the JAX package's
  UHF of tests/_torch_uinputs handed to a port UHF): the first oxygen as
  the fragment, all but the all-active doubles frozen, with and without
  the OO-MP2 bath relaxation (tests/test_workflow.py's runs): the same
  per-spin localized orbitals (1e-8) and spaces as JAX's run and its
  energy within 1e-9 Ha; one fragment over both atoms with nothing frozen
  gives UCCSD (1e-7, the JAX test's bound).
- Without a device argument the entry points run on CUDA and raise where
  there is no card.
"""

import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.mpcc import MPCC as JMPCC
from pyscf_mpcc_tpu.mpcc import workflow as jworkflow
from pyscf_mpcc_tpu.scf import RHF as JRHF
from pyscf_mpcc_tpu.testutil import h2o_ccpvdz
from pyscf_mpcc_tpu.testutil import mol_of as jmol_of
from pyscf_mpcc_tpu_torch import gto, testing
from pyscf_mpcc_tpu_torch.cc import uccsd
from pyscf_mpcc_tpu_torch.mp import DFRMP2
from pyscf_mpcc_tpu_torch.mpcc import MPCC, workflow
from pyscf_mpcc_tpu_torch.scf import RHF, UHF

from _torch_uinputs import O2, mean_field

torch.set_num_threads(1)

CPU = torch.device("cpu")
E_MP2 = -0.2040199672883385
E_CCSD = -0.2133432312951
FRAG = dict(fragments=[[0]], idx_s=[], idx_d=list(range(15)),
            pop_threshold=0.3, cc_conv=1e-9)
STO3G = [[8, (0, 0, 0)], [1, (0, -0.757, 0.587)], [1, (0, 0.757, 0.587)]]
UFRAG = dict(fragments=[[0]], idx_s=[], idx_d=list(range(15)),
             pop_threshold=0.3, cc_conv=1e-10)
ACT = dict(act_hole=[2, 3, 4], act_particle=[0, 1], idx_s=[],
           idx_d=list(range(15)), conv_tol=1e-9, conv_tol_normt=1e-7,
           max_cycle=100)


def _solved(mf, d):
    mf.mo_coeff = d["mo_coeff"]
    mf.mo_energy = d["mo_energy"]
    mf.mo_occ = d["mo_occ"]
    mf.converged = True
    mf.e_tot = float(d["e_tot"])
    return mf


@pytest.fixture(scope="module")
def h2o():
    d = h2o_ccpvdz()
    jmol = jmol_of()
    jmf = _solved(JRHF(jmol), d)
    e, _, _, c_loc, spaces = jworkflow.fragmented_mpcc(
        jmol, jmf, eri_ao=d["eri_ao"], **FRAG)
    mol = testing.mol_of("sym")
    return d, mol, _solved(RHF(mol), d), (e, c_loc, spaces)


def test_fragmented_mpcc_matches_jax(h2o):
    d, mol, mf, (e_j, c_loc_j, spaces_j) = h2o
    e, t1, t2, c_loc, spaces = workflow.fragmented_mpcc(
        mol, mf, eri_ao=d["eri_ao"], device=CPU, **FRAG)
    assert t2.dtype == torch.float64 and t2.device.type == "cpu"
    assert len(spaces) == len(spaces_j) == 1
    for (h, p), (hj, pj) in zip(spaces, spaces_j):
        np.testing.assert_array_equal(h, hj)
        np.testing.assert_array_equal(p, pj)
    assert len(spaces[0][0]) >= 1
    np.testing.assert_allclose(c_loc, c_loc_j, rtol=0, atol=1e-8)
    assert abs(e - e_j) < 1e-9
    assert E_CCSD - 1e-7 <= e <= E_MP2 + 1e-7


def test_single_fragment_no_freeze_is_ccsd(h2o):
    d, mol, mf, _ = h2o
    e, *_ = workflow.fragmented_mpcc(
        mol, mf, fragments=[[0, 1, 2]], idx_s=[], idx_d=[],
        eri_ao=d["eri_ao"], pop_threshold=-1.0, cc_conv=1e-9, device=CPU)
    assert abs(e - E_CCSD) < 1e-7


def test_mpcc_facade_matches_jax():
    jmf = JRHF(jgto.M(atom=STO3G, basis="sto-3g")).density_fit("etb")
    jmf.conv_tol = 1e-11
    jmf.kernel()
    jm = JMPCC(jmf)
    je = jm.kernel(**ACT)
    mf = RHF(gto.M(atom=STO3G, basis="sto-3g")).density_fit("etb")
    mf.with_df._B = np.asarray(jmf.with_df.B_ao())
    _solved(mf, dict(mo_coeff=np.asarray(jmf.mo_coeff),
                     mo_energy=np.asarray(jmf.mo_energy),
                     mo_occ=np.asarray(jmf.mo_occ), e_tot=jmf.e_tot))
    m = MPCC(mf, device=CPU)
    assert m.t1_ll.dtype == torch.float64
    assert abs(m.e_lowlevel - jm.e_lowlevel) < 1e-8
    assert -0.2 < m.e_lowlevel < -0.01
    e = m.kernel(**ACT)
    assert m.converged and jm.converged
    assert abs(e - je) < 1e-8 and -0.08 < e < -0.03


@pytest.fixture(scope="module")
def o2():
    jmf = mean_field("o2")
    eri = np.asarray(jgto.intor_eri(jmf.mol))
    runs = {relax: jworkflow.fragmented_mpcc_unrestricted(
        jmf.mol, jmf, eri_ao=eri, oo_mp2_relax=relax, **UFRAG)
        for relax in (False, True)}
    mol = gto.M(atom=O2, basis="sto-3g", spin=2)
    mf = UHF(mol)
    mf.mo_coeff = np.asarray(jmf.mo_coeff)
    mf.mo_energy = np.asarray(jmf.mo_energy)
    mf.mo_occ = np.asarray(jmf.mo_occ)
    mf.converged, mf.e_tot = True, float(jmf.e_tot)
    return mol, mf, eri, runs


@pytest.mark.parametrize("relax", [False, True])
def test_fragmented_mpcc_unrestricted_matches_jax(o2, relax):
    mol, mf, eri, runs = o2
    e_j, _, _, c_loc_j, spaces_j = runs[relax]
    e, t1, t2, c_loc, spaces = workflow.fragmented_mpcc_unrestricted(
        mol, mf, eri_ao=eri, oo_mp2_relax=relax, device=CPU, **UFRAG)
    assert t2[1].dtype == torch.float64 and t2[1].device.type == "cpu"
    for c, cj in zip(c_loc, c_loc_j):
        np.testing.assert_allclose(c, cj, rtol=0, atol=1e-8)
    assert len(spaces) == len(spaces_j) == 1
    for got, want in zip(spaces[0], spaces_j[0]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert sum(len(h) for h in spaces[0][0]) >= 1
    assert abs(e - e_j) < 1e-9


def test_single_fragment_no_freeze_is_uccsd(o2):
    mol, mf, eri, _ = o2
    e, _, _, _, spaces = workflow.fragmented_mpcc_unrestricted(
        mol, mf, fragments=[[0, 1]], idx_s=[], idx_d=[], eri_ao=eri,
        pop_threshold=-1.0, cc_conv=1e-10, device=CPU)
    _, e_ref, _, _ = uccsd.kernel(uccsd.eris_from_scf(mf, device=CPU),
                                  conv_tol=1e-10, conv_tol_normt=1e-8)
    assert abs(e - e_ref) < 1e-7
    (aha, ahb), _ = spaces[0]
    assert (len(aha), len(ahb)) == mol.nelec


def test_mpcc_rejects_unrestricted_reference():
    mf = RHF(testing.mol_of("sym", basis="sto-3g"))
    mf.mo_coeff = np.zeros((2, 7, 7))
    with pytest.raises(NotImplementedError, match="requires an RHF"):
        MPCC(mf, device=CPU)


@pytest.mark.parametrize("entry", ["MPCC", "DFRMP2", "fragmented_mpcc",
                                   "fragmented_mpcc_unrestricted"])
def test_entry_points_default_to_cuda(entry):
    mol = testing.mol_of("sym", basis="sto-3g")
    mf = RHF(mol).density_fit()
    mf.mo_coeff = np.eye(mol.nao)
    calls = {"MPCC": lambda: MPCC(mf, run_lowlevel=False),
             "DFRMP2": lambda: DFRMP2(mf),
             "fragmented_mpcc": lambda: workflow.fragmented_mpcc(
                 mol, mf, [[0]], [], []),
             "fragmented_mpcc_unrestricted":
                 lambda: workflow.fragmented_mpcc_unrestricted(
                     mol, mf, [[0]], [], [])}
    if torch.cuda.is_available():
        if entry.startswith("fragmented"):
            pytest.skip("a card is present: the workflow would run on it")
        assert calls[entry]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry]()
