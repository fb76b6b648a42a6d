"""The port's UCCSD (cc/spinsum, cc/uccsd, the UCCSDDriver) against the JAX
package, in fp64 on the CPU.

Inputs: the JAX package's O2 triplet/sto-3g UHF, H2O/sto-3g RHF (closed
shell through the unrestricted code) and their AO integrals, exact
Cholesky factors and a DF factor, the same numpy arrays for both
packages.  The JAX references are computed once (module fixture).
Tolerances: one or two Jacobi sweeps 1e-12 (the same fp64 contractions
in another order), converged energies and amplitudes 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_uinputs import cholesky, fields, mean_field, np_tuple, uhf_arrays
from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.cc import spinsum as jss
from pyscf_mpcc_tpu.cc import uccsd as ju
from pyscf_mpcc_tpu.cc.driver import UCCSDDriver as JUCCSD
from pyscf_mpcc_tpu.df import DF as JDF
from pyscf_mpcc_tpu_torch import convert, gto, scf, testing
from pyscf_mpcc_tpu_torch.cc import rccsd, spinsum, uccsd
from pyscf_mpcc_tpu_torch.cc.driver import CCSD, UCCSDDriver
from pyscf_mpcc_tpu_torch.cc.eris import make_eris_incore

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL_SWEEP, TOL_CONV = 1e-12, 1e-10
KCONV = dict(conv_tol=1e-11, conv_tol_normt=1e-9, max_cycle=200)


def _jeris(mf, kind):
    a = uhf_arrays(mf)
    eri = jgto.intor_eri(mf.mol)
    if kind == "incore":
        return ju.make_eris_incore(eri, *a)
    B = cholesky(eri) if kind == "chol" else JDF(mf.mol).B_ao()
    return ju.make_eris_df(B, *a)


def _eris(mf, kind):
    a = uhf_arrays(mf)
    eri = gto.intor_eri(gto.M(atom=mf.mol.atom, basis=mf.mol.basis,
                              spin=mf.mol.spin))
    if kind == "incore":
        return uccsd.make_eris_incore(eri, *a, device=CPU)
    B = cholesky(eri) if kind == "chol" else JDF(mf.mol).B_ao()
    return uccsd.make_eris_df(B, *a, device=CPU)


def _t(xs):
    return tuple(torch.tensor(np.asarray(x)) for x in xs)


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def ref():
    out = {}
    for m in ("o2", "h2o"):
        mf = mean_field(m)
        for kind in ("incore", "chol", "df"):
            er = _jeris(mf, kind)
            _, t1, t2 = ju.init_amps(er)
            sweeps = []
            for _ in range(2):
                t1, t2 = ju.update_amps(t1, t2, er, ntile=2)
                sweeps.append(np_tuple((*t1, *t2)))
            out[m, kind] = dict(mf=mf, er=er, sweeps=sweeps,
                                init=np_tuple((*t1, *t2)))
    er = out["o2", "incore"]["er"]
    for ring in ("host", "device"):
        c, e, t1, t2 = ju.kernel(er, diis_backend=ring, **KCONV)
        assert c
        out["kernel", ring] = (e, np_tuple((*t1, *t2)))
    out["o2_df"] = mf = mean_field("o2_df")
    jd = JUCCSD(mf, frozen=1)
    jd.conv_tol, jd.conv_tol_normt = 1e-11, 1e-9
    jd.run()
    out["driver_frozen"] = (jd.e_corr, jd.e_tot, jd.ccsd_t(tile=2),
                            float(ju.init_amps(jd.eris)[0]))
    # the IP-EOM-UCCSD roots at the driver's defaults, and the state they
    # were computed on (handed to the port's driver below)
    out["driver_ip"] = (np.asarray(jd.ipccsd()), np_tuple(jd.t1),
                        np_tuple(jd.t2), fields(jd.eris))
    return out


@pytest.mark.parametrize("mol", ["o2", "h2o"])
@pytest.mark.parametrize("kind", ["incore", "chol", "df"])
def test_update_amps_matches_jax(ref, mol, kind):
    r = ref[mol, kind]
    er = _eris(r["mf"], kind)
    assert (er.Lvv_a is None) == (kind == "incore")
    _, t1, t2 = uccsd.init_amps(er)
    for want in r["sweeps"]:
        t1, t2 = uccsd.update_amps(t1, t2, er, ntile=2)
        _close((*t1, *t2), want, TOL_SWEEP)


@pytest.mark.parametrize("mol", ["o2", "h2o"])
def test_df_update_matches_materialized(ref, mol):
    """Exact Cholesky factors reproduce the materialized update: the
    t1-dressed tiled ladders with quadratic compensation and the
    factorized ovvv/vvvo terms, for every tiling."""
    mf = ref[mol, "incore"]["mf"]
    ue, ud = _eris(mf, "incore"), _eris(mf, "chol")
    _, t1, t2 = uccsd.init_amps(ue)
    a1, a2 = uccsd.update_amps(t1, t2, ue)
    for ntile in (1, 2, 3):
        b1, b2 = uccsd.update_amps(t1, t2, ud, ntile=ntile)
        _close((*b1, *b2), (*a1, *a2), TOL_SWEEP)


def test_ladder_tiled_any_ntile():
    rng = np.random.default_rng(3)
    naux, nv1, nv2, no = 9, 7, 5, 3
    L1 = torch.from_numpy(rng.standard_normal((naux, nv1, nv1)))
    L2 = torch.from_numpy(rng.standard_normal((naux, nv2, nv1)))
    tau = torch.from_numpy(rng.standard_normal((no, no, nv1, nv1)))
    want = np.einsum("Lae,Lbf,ijef->ijab", L1, L2, tau, optimize=True)
    for ntile in (1, 2, 3, 4, 7, 11):
        got = uccsd._ladder_tiled(tau, L1, L2, ntile)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("ring", ["host", "device"])
def test_kernel_matches_jax(ref, ring):
    er = _eris(ref["o2", "incore"]["mf"], "incore")
    c, e, t1, t2 = uccsd.kernel(er, diis_backend=ring, **KCONV)
    je, jamps = ref["kernel", ring]
    assert c and abs(e - je) < TOL_CONV
    _close((*t1, *t2), jamps, TOL_CONV)
    assert abs(e - ref["kernel", "host"][0]) < 1e-8


def test_closed_shell_uccsd_equals_rccsd(ref):
    mf = ref["h2o", "incore"]["mf"]
    c, e, t1, t2 = uccsd.kernel(_eris(mf, "incore"), **KCONV)
    rer = make_eris_incore(jgto.intor_eri(mf.mol), mf.mo_coeff,
                           mf.get_fock(mf.make_rdm1()), 5, device=CPU)
    cr, er_, r1, r2 = rccsd.kernel(rer, **KCONV)
    assert c and cr and abs(e - er_) < TOL_CONV
    np.testing.assert_allclose(t2[1].numpy(), r2.numpy(), atol=1e-8)
    np.testing.assert_allclose(
        t2[0].numpy(), (r2 - r2.permute(0, 1, 3, 2)).numpy(), atol=1e-8)


def test_spinsum_matches_jax():
    rng = np.random.default_rng(9)
    na, nb, va, vb = 3, 2, 4, 5
    dims = {"a": {"o": na, "v": va}, "b": {"o": nb, "v": vb}}

    def blocks(slots, keys):
        return {k: rng.standard_normal([dims[s][c] for s, c in
                                        zip(k, slots)]) for k in keys}

    g = blocks("oovv", ["aaaa", "bbbb", "abab", "baba", "abba", "baab"])
    t = blocks("oovv", ["aaaa", "bbbb", "abab"])
    t1 = blocks("ov", ["aa", "bb"])
    G = spinsum.ST({k: torch.from_numpy(v) for k, v in g.items()})
    JG = jss.ST({k: jnp.asarray(v) for k, v in g.items()})
    T2 = spinsum.t2_st([torch.from_numpy(t[k]) for k in
                        ("aaaa", "abab", "bbbb")])
    JT2 = jss.t2_st([jnp.asarray(t[k]) for k in ("aaaa", "abab", "bbbb")])
    T1 = spinsum.t1_st([torch.from_numpy(t1[k]) for k in ("aa", "bb")])
    JT1 = jss.t1_st([jnp.asarray(t1[k]) for k in ("aa", "bb")])
    pairs = [
        (spinsum.seinsum("mnef,jnfb->mbej", G, T2),
         jss.seinsum("mnef,jnfb->mbej", JG, JT2)),
        (spinsum.seinsum("ie,ma,mbej->ijab", T1, T1,
                         G.transpose((0, 2, 3, 1))),
         jss.seinsum("ie,ma,mbej->ijab", JT1, JT1,
                     JG.transpose((0, 2, 3, 1)))),
        (spinsum.asym(spinsum.asym(T2, 0, 1), 2, 3) - 0.5 * T2,
         jss.asym(jss.asym(JT2, 0, 1), 2, 3) - 0.5 * JT2),
        (spinsum.anti4(*(torch.from_numpy(g[k]) for k in
                         ("aaaa", "bbbb", "abab"))),
         jss.anti4(*(jnp.asarray(g[k]) for k in ("aaaa", "bbbb", "abab")))),
    ]
    for got, want in pairs:
        assert set(got.keys()) == set(want.keys())
        for k in want.keys():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-12)


def test_to_spin_orbital_and_vectors_match_jax(ref):
    r = ref["o2", "incore"]
    t = _t(r["sweeps"][0])
    t1, t2 = t[:2], t[2:]
    T1, T2 = uccsd.to_spin_orbital(t1, t2, (9, 7))
    jT1, jT2 = ju.to_spin_orbital(r["sweeps"][0][:2], r["sweeps"][0][2:],
                                  (9, 7))
    np.testing.assert_array_equal(T1.numpy(), jT1)
    np.testing.assert_array_equal(T2.numpy(), jT2)
    vec = uccsd.amplitudes_to_vector(t1, t2)
    np.testing.assert_array_equal(
        vec.numpy(), np.asarray(ju.amplitudes_to_vector(*map(
            lambda x: tuple(map(jnp.asarray, x)), (r["sweeps"][0][:2],
                                                   r["sweeps"][0][2:])))))
    b1, b2 = uccsd.vector_to_amplitudes(vec, [x.shape for x in t])
    for a, b in zip((*b1, *b2), t):
        assert torch.equal(a, b)


def test_ueris_from_numpy(ref):
    jer = ref["o2", "df"]["er"]
    er = convert.ueris_from_numpy(fields(jer), CPU)
    assert er.nocca == 9 and er.noccb == 7 and er.vvvv is None
    for k, v in fields(jer).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(getattr(er, k).numpy(), v)
    with pytest.raises(ValueError, match="unknown UERIs fields"):
        convert.ueris_from_numpy({**fields(jer), "Lvv": None}, CPU)


def test_synthetic_ueris_df_matches_materialized():
    d = testing.synthetic_ueris(4, 3, 9, 10, 20, device=CPU, seed=2)
    m = testing.synthetic_ueris(4, 3, 9, 10, 20, device=CPU, seed=2,
                                materialize=True)
    assert d.Lvv_a is not None and m.vvvv is not None
    _, t1, t2 = uccsd.init_amps(d)
    a1, a2 = uccsd.update_amps(t1, t2, d, ntile=3)
    b1, b2 = uccsd.update_amps(t1, t2, m)
    _close((*a1, *a2), (*b1, *b2), TOL_SWEEP)


def _port_mf(jmf, cls="UHF", df=False):
    mol = gto.M(atom=jmf.mol.atom, basis=jmf.mol.basis, spin=jmf.mol.spin)
    mf = getattr(scf, cls)(mol)
    if df:
        mf.density_fit()
    mf.conv_tol, mf.conv_tol_grad = 1e-12, 1e-9
    return mf.run()


def test_driver_dispatch_and_frozen_df(ref):
    mf = _port_mf(ref["o2_df"], df=True)
    cc = CCSD(mf, frozen=1, device=CPU)
    assert isinstance(cc, UCCSDDriver) and cc.nocc == (8, 6)
    cc.conv_tol, cc.conv_tol_normt = 1e-11, 1e-9
    cc.run()
    je, jtot, jet, jmp2 = ref["driver_frozen"]
    assert cc.converged and cc.t2[1].dtype == torch.float64
    assert abs(cc.e_corr - je) < TOL_CONV and abs(cc.e_tot - jtot) < TOL_CONV
    assert abs(cc.ccsd_t(tile=2) - jet) < TOL_CONV
    assert abs(float(uccsd.init_amps(cc.eris)[0]) - jmp2) < TOL_SWEEP
    # IP-EOM: on the port's own amplitudes, and on the JAX driver's
    jip, jt1, jt2, jfields = ref["driver_ip"]
    np.testing.assert_allclose(cc.ipccsd(), jip, rtol=0, atol=1e-8)
    cc.t1, cc.t2 = convert.uamps_from_numpy(jt1, jt2, CPU)
    cc.eris = convert.ueris_from_numpy(jfields, CPU)
    np.testing.assert_allclose(cc.ipccsd(), jip, rtol=0, atol=TOL_CONV)
    ro = _port_mf(ref["o2", "incore"]["mf"], cls="ROHF")
    assert isinstance(CCSD(ro, device=CPU), UCCSDDriver)
    rh = _port_mf(ref["h2o", "incore"]["mf"], cls="RHF")
    assert not isinstance(CCSD(rh, device=CPU), UCCSDDriver)
    assert isinstance(CCSD(scf.convert_to_uhf(rh), device=CPU), UCCSDDriver)


def test_uccsd_scanner_matches_cold(ref):
    mf = _port_mf(ref["o2", "incore"]["mf"])
    cc = CCSD(mf, device=CPU).set(conv_tol=1e-10, conv_tol_normt=1e-8)
    cc.run()
    scan = cc.as_scanner()
    e = scan("O 0 0 0; O 0 0 1.25")
    cold_mf = scf.UHF(gto.M(atom="O 0 0 0; O 0 0 1.25", basis="sto-3g",
                            spin=2)).set(conv_tol=1e-11).run()
    cold = CCSD(cold_mf, device=CPU).set(conv_tol=1e-10,
                                          conv_tol_normt=1e-8).run()
    assert scan.converged and isinstance(scan.cc, UCCSDDriver)
    assert abs(e - cold.e_tot) < 1e-8


def test_open_shell_entry_points_default_to_cuda(ref):
    """Without a device argument CCSD(uhf), DF-UMP2 and DFUMP2 run on
    CUDA, and raise where there is no card."""
    from pyscf_mpcc_tpu_torch.mp import DFUMP2, ump2
    mf = _port_mf(ref["o2_df"], df=True)
    calls = (lambda: CCSD(mf), lambda: DFUMP2(mf),
             lambda: ump2.df_kernel_from_scf(mf))
    if torch.cuda.is_available():
        assert CCSD(mf).device.type == "cuda"
        assert DFUMP2(mf).device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
