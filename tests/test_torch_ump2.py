"""The port's unrestricted MP2 (mp/ump2) and DF-UMP2 with relaxed
densities (mp/dfump2.DFUMP2) against the JAX package, in fp64 on the CPU.

Inputs: O2 triplet/sto-3g UHF and ROHF (the ROHF orbitals are not
canonical for the UHF Fock, so they drive the non-canonical solver) with
their incore UERIs, and the DF-UHF of tests/test_dfump2.py; H2O/sto-3g
RHF for the closed-shell limit.  The same numpy arrays go to both
packages; the JAX references are computed once (module fixture).
Tolerances: energies and densities 1e-10 (the relaxed density through
a CG stopped at 1e-10 of its right-hand side), the rest 1e-12; the
converged iterative energy 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_uinputs import mean_field, np_tuple, uhf_arrays
from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.cc import uccsd as ju
from pyscf_mpcc_tpu.mp import dfump2 as jdf
from pyscf_mpcc_tpu.mp import ump2 as jump2
from pyscf_mpcc_tpu_torch import mp
from pyscf_mpcc_tpu_torch.cc import uccsd
from pyscf_mpcc_tpu_torch.mp import DFRMP2, DFUMP2, dfump2, ump2

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL, TOL_E = 1e-12, 1e-10


def _g(er, m):
    """(gaa, gab, gbb) of a UERIs, by either package's layout rules."""
    if m is jnp:
        return (er.ovov.transpose(0, 2, 1, 3) - er.ovov.transpose(0, 2, 3, 1),
                er.ovOV.transpose(0, 2, 1, 3),
                er.OVOV.transpose(0, 2, 1, 3) - er.OVOV.transpose(0, 2, 3, 1))
    return ump2._g_blocks(er)


@pytest.fixture(scope="module")
def ref():
    out = {}
    for name in ("o2", "o2_rohf"):
        mf = mean_field(name)
        er = ju.make_eris_incore(jgto.intor_eri(mf.mol), *uhf_arrays(mf))
        out[name] = dict(mf=mf, er=er)
    er = out["o2_rohf"]["er"]
    rng = np.random.default_rng(8)
    g = _g(er, jnp)
    t2 = tuple(0.05 * rng.standard_normal(x.shape) for x in g)
    na, nb = 9, 7
    focks = (er.focka[:na, :na], er.fockb[:nb, :nb], er.focka[na:, na:],
             er.fockb[nb:, nb:])
    new, res = jump2.update_amps(tuple(map(jnp.asarray, t2)), g, *focks)
    out.update(t2=t2, update=np_tuple((*new, *res)),
               energy=jump2.energy(tuple(map(jnp.asarray, t2)), g))
    for name in ("o2", "o2_rohf"):
        e = out[name]["er"]
        out[name]["kfu"] = jump2.kernel_from_ueris(e)[0]
        out[name]["scs"] = jump2.scs_energy(e)
        e_it, _, c = jump2.iterative_kernel(e, conv_tol=1e-12)
        assert c
        out[name]["iter"] = e_it
    mf = mean_field("o2_df")
    out["df"] = dict(mf=mf, dfk=[jump2.df_kernel_from_scf(mf, frozen=f)
                                 for f in (0, 1)])
    pt = jdf.DFUMP2(mf).run()
    out["df"]["pt"] = (pt.e_corr, pt.make_rdm1(), pt.make_rdm1(relaxed=True),
                       pt.make_natorbs(relaxed=True)[0])
    return out


def _port_eris(ref, name):
    mf = ref[name]["mf"]
    from pyscf_mpcc_tpu_torch import gto
    eri = gto.intor_eri(gto.M(atom=mf.mol.atom, basis=mf.mol.basis,
                              spin=mf.mol.spin))
    return uccsd.make_eris_incore(eri, *uhf_arrays(mf), device=CPU)


def test_update_amps_and_energy_match_jax(ref):
    er = _port_eris(ref, "o2_rohf")
    g = _g(er, torch)
    t2 = tuple(torch.tensor(x) for x in ref["t2"])
    na, nb = 9, 7
    new, res = ump2.update_amps(t2, g, er.focka[:na, :na],
                                er.fockb[:nb, :nb], er.focka[na:, na:],
                                er.fockb[nb:, nb:])
    for a, b in zip((*new, *res), ref["update"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TOL)
    assert abs(ump2.energy(t2, g) - ref["energy"]) < TOL


@pytest.mark.parametrize("name", ["o2", "o2_rohf"])
def test_energies_match_jax(ref, name):
    er = _port_eris(ref, name)
    r = ref[name]
    e, t2 = ump2.kernel_from_ueris(er)
    assert abs(e - r["kfu"]) < TOL and len(t2) == 3
    np.testing.assert_allclose(ump2.scs_energy(er), r["scs"], rtol=0,
                               atol=TOL)
    e_it, t2_it, c = ump2.iterative_kernel(er, conv_tol=1e-12)
    assert c and abs(e_it - r["iter"]) < TOL_E
    if name == "o2":     # canonical orbitals: the iteration is MP2
        assert abs(e_it - e) < TOL_E


def _port_df_mf(ref):
    from pyscf_mpcc_tpu_torch import gto, scf
    jmf = ref["df"]["mf"]
    mf = scf.UHF(gto.M(atom=jmf.mol.atom, basis=jmf.mol.basis,
                       spin=jmf.mol.spin)).density_fit()
    mf.conv_tol, mf.conv_tol_grad = 1e-12, 1e-9
    return mf.run()


@pytest.mark.parametrize("frozen", [0, 1])
def test_df_kernel_from_scf_matches_jax(ref, frozen):
    e, parts = ump2.df_kernel_from_scf(ref["df"]["mf"], frozen=frozen,
                                       device=CPU)
    je, jparts = ref["df"]["dfk"][frozen]
    assert abs(e - je) < TOL
    np.testing.assert_allclose(parts, jparts, rtol=0, atol=TOL)


def test_dfump2_matches_jax(ref):
    pt = DFUMP2(_port_df_mf(ref), device=CPU).run()
    je, jdm, jrel, jocc = ref["df"]["pt"]
    assert pt.t2[1].dtype == torch.float64
    assert abs(pt.e_corr - je) < TOL_E
    assert abs(pt.e_corr - ump2.df_kernel_from_scf(pt._scf,
                                                   device=CPU)[0]) < TOL
    dm, rel = pt.make_rdm1(), pt.make_rdm1(relaxed=True)
    np.testing.assert_allclose(dm.numpy(), jdm, rtol=0, atol=TOL_E)
    np.testing.assert_allclose(rel.numpy(), jrel, rtol=0, atol=TOL_E)
    S = torch.tensor(pt._scf.get_ovlp())
    assert abs(float(torch.trace(rel @ S)) - pt.mol.nelectron) < 1e-8
    occ, orbs = pt.make_natorbs(relaxed=True)
    np.testing.assert_allclose(occ.numpy(), jocc, rtol=0, atol=TOL_E)
    assert orbs.shape == (pt.mol.nao, pt.mol.nao)


def test_dfump2_closed_shell_is_dfrmp2():
    from pyscf_mpcc_tpu_torch import gto, scf
    from _torch_uinputs import H2O
    mf = scf.RHF(gto.M(atom=H2O, basis="sto-3g")).density_fit()
    mf.conv_tol = 1e-12
    mf.run()
    u = DFUMP2(mf, device=CPU).run()
    r = DFRMP2(mf, device=CPU).run()
    assert abs(u.e_corr - r.e_corr) < TOL
    np.testing.assert_allclose(u.make_rdm1(relaxed=True).numpy(),
                               r.make_rdm1(relaxed=True, ao_repr=True).numpy(),
                               rtol=0, atol=1e-9)


def test_module_surface():
    assert mp.ump2 is ump2 and mp.dfump2 is dfump2 and mp.DFUMP2 is DFUMP2
