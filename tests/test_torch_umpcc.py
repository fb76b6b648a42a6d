"""The port's unrestricted MP-CC solver (pyscf_mpcc_tpu_torch.mpcc.umpccsd)
against the JAX package, in fp64 on the CPU.

Inputs: the O2 triplet/sto-3g UHF of tests/_torch_uinputs (nelec (9, 7),
nmo 10), its incore UERIs (the JAX package's make_eris_incore, handed to
the port as numpy), seeded random amplitudes, and the active space of the
JAX package's examples/umpcc_o2.py: holes ([7, 8], [5, 6]), particles
([0], [0, 1]), doubles frozen unless all four indices are active.  The
JAX references are computed once (module fixture).

Tolerances: one masked update 1e-12 (the same fp64 algebra in another
order); converged energies, amplitudes and multipliers 1e-10; the limits
at the JAX package's bounds (tests/test_uccsd.py: all frozen within 1e-8
of UMP2, nothing frozen within 1e-9 of UCCSD); the frozen blocks equal to
the bath bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_uinputs import fields, mean_field, np_tuple, uhf_arrays
from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.cc import uccsd as ju
from pyscf_mpcc_tpu.mpcc import umpccsd as jum
from pyscf_mpcc_tpu_torch import convert, mpcc
from pyscf_mpcc_tpu_torch.cc import uccsd
from pyscf_mpcc_tpu_torch.mpcc import umpccsd

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL_SWEEP, TOL = 1e-12, 1e-10
AH, AP = ([7, 8], [5, 6]), ([0], [0, 1])
IDX_S, IDX_D = [], list(range(15))
TIGHT = dict(conv_tol=1e-12, conv_tol_normt=1e-12, max_cycle=100)


def _t(xs):
    return tuple(torch.tensor(np.asarray(x)) for x in xs)


def _j(xs):
    return tuple(jnp.asarray(np.asarray(x)) for x in xs)


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(convert.to_numpy(g), np.asarray(w),
                                   rtol=0, atol=tol)


@pytest.fixture(scope="module")
def ref():
    mf = mean_field("o2")
    mo_a, mo_b, fa, fb, na, nb = uhf_arrays(mf)
    jer = ju.make_eris_incore(jgto.intor_eri(mf.mol), mo_a, mo_b, fa, fb,
                              na, nb)
    nocc = (na, nb)
    nvir = (mo_a.shape[1] - na, mo_b.shape[1] - nb)
    rng = np.random.default_rng(3)
    t1 = tuple(0.02 * rng.standard_normal((o, v))
               for o, v in zip(nocc, nvir))
    _, _, t2 = ju.init_amps(jer)
    t2 = tuple(np.asarray(x) + 0.01 * rng.standard_normal(x.shape)
               for x in t2)
    # one channel's idx_s per spin, the doubles channels apart
    idx_s = ([0, 3], [1, 2])
    idx_d = ([1, 6, 15], list(range(15)), [0, 2, 8])
    masks = jum.frozen_masks_u(AH, AP, nocc, nvir, idx_s, idx_d)
    upd = jum.update_amps_masked(_j(t1), _j(t2), jer, masks)
    conv, e, jt1, jt2 = jum.kernel(jer, AH, AP, IDX_S, IDX_D, **TIGHT)
    assert conv
    # Lambda on the converged partial freeze
    lconv, l1, l2 = jum.lambda_kernel(jer, jt1, jt2, AH, AP, IDX_S, IDX_D,
                                      conv_tol=1e-11, max_cycle=100)
    assert lconv
    so = jum._masks_to_spin_orbital(masks, nocc, nvir)
    emp2, _, _ = ju.init_amps(jer)
    return dict(fields=fields(jer), nocc=nocc, nvir=nvir, t=(t1, t2),
                idx=(idx_s, idx_d), masks=np_tuple(masks),
                upd=(np_tuple(upd[0]), np_tuple(upd[1])),
                solve=(e, np_tuple(jt1), np_tuple(jt2)),
                lam=(np_tuple(l1), np_tuple(l2)), so=np_tuple(so),
                emp2=float(emp2))


@pytest.fixture(scope="module")
def eris(ref):
    return convert.ueris_from_numpy(ref["fields"], CPU)


def _masks(ref, idx_s, idx_d):
    return umpccsd.frozen_masks_u(AH, AP, ref["nocc"], ref["nvir"], idx_s,
                                  idx_d, device=CPU)


def test_frozen_masks_match_jax(ref):
    got = _masks(ref, *ref["idx"])
    assert len(got) == 5
    for g, w in zip(got, ref["masks"]):
        assert g.dtype == torch.bool and g.device.type == "cpu"
        np.testing.assert_array_equal(convert.to_numpy(g), w)


def test_masks_to_spin_orbital_match_jax(ref):
    got = umpccsd._masks_to_spin_orbital(_masks(ref, *ref["idx"]),
                                         ref["nocc"], ref["nvir"])
    for g, w in zip(got, ref["so"]):
        np.testing.assert_array_equal(convert.to_numpy(g), w)


@pytest.mark.parametrize("plain,per_spin", [
    (([0, 3], list(range(15))),
     (([0, 3], [0, 3]), (list(range(15)),) * 3)),
    (([], []), (([], []), ([], [], []))),
    ((None, None), (([], []), ([], [], [])))])
def test_index_broadcasting(ref, plain, per_spin):
    """Plain lists apply to every spin channel, empty (or None) freezes
    nothing (umpccsd.py:85-92)."""
    assert umpccsd._index_lists(*plain) == per_spin
    got = _masks(ref, *umpccsd._index_lists(*plain))
    want = jum.frozen_masks_u(AH, AP, ref["nocc"], ref["nvir"], *per_spin)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(convert.to_numpy(g), np.asarray(w))


def test_update_amps_masked_matches_jax(ref, eris):
    t1, t2 = _t(ref["t"][0]), _t(ref["t"][1])
    masks = _masks(ref, *ref["idx"])
    u1, u2 = umpccsd.update_amps_masked(t1, t2, eris, masks)
    _close((*u1, *u2), (*ref["upd"][0], *ref["upd"][1]), TOL_SWEEP)
    # the frozen blocks are the incoming amplitudes exactly
    for u, t, m in zip((*u1, *u2), (*t1, *t2), masks):
        assert torch.equal(u[m], t[m])


@pytest.mark.parametrize("ring", ["host", "device"])
def test_kernel_limits(ref, eris, ring):
    """Every block frozen: the bath's UMP2 energy; nothing frozen: UCCSD."""
    conv, e, *_ = umpccsd.kernel(eris, ([0], [0]), ([0], [0]),
                                 list(range(4)), list(range(16)),
                                 diis_backend=ring, **TIGHT)
    assert conv and abs(e - ref["emp2"]) < 1e-8
    conv, e, *_ = umpccsd.kernel(eris, ([0], [0]), ([0], [0]), [], [],
                                 diis_backend=ring, **TIGHT)
    conv2, e2, *_ = uccsd.kernel(eris, **TIGHT)
    assert conv and conv2 and abs(e - e2) < 1e-9


@pytest.mark.parametrize("ring", ["host", "device"])
def test_partial_freeze_matches_jax(ref, eris, ring):
    e_j, t1_j, t2_j = ref["solve"]
    conv, e, t1, t2 = umpccsd.kernel(eris, AH, AP, IDX_S, IDX_D,
                                     diis_backend=ring, **TIGHT)
    assert conv and abs(e - e_j) < TOL
    _close((*t1, *t2), (*t1_j, *t2_j), TOL)
    _, _, bath = uccsd.init_amps(eris)
    masks = _masks(ref, *umpccsd._index_lists(IDX_S, IDX_D))
    moved = 0.0
    for t, b, m in zip(t2, bath, masks[2:]):
        assert m.any() and torch.equal(t[m], b[m])
        moved = max(moved, float((t[~m] - b[~m]).abs().max()))
    # the relaxed all-active doubles moved off the bath
    assert moved > 1e-6


def test_kernel_rejects_unknown_ring(eris):
    with pytest.raises(ValueError, match="diis_backend"):
        umpccsd.kernel(eris, AH, AP, IDX_S, IDX_D, diis_backend="gpu")


def test_lambda_kernel_matches_jax(ref, eris):
    _, t1, t2 = ref["solve"]
    conv, l1, l2 = umpccsd.lambda_kernel(eris, _t(t1), _t(t2), AH, AP,
                                         IDX_S, IDX_D, conv_tol=1e-11,
                                         max_cycle=100)
    assert conv
    _close((*l1, *l2), (*ref["lam"][0], *ref["lam"][1]), TOL)


def test_kernel_pert_triples_names_a15c():
    """kernel_pert_triples (ROADMAP A15c) was a stub that raised; it runs
    now (tests/test_torch_pert_triples.py holds it to the JAX package).
    Here its empty-triples, nothing-frozen limit on O2 triplet/sto-3g is
    the host spin-orbital CCSD, 1e-9 Ha."""
    from pyscf_mpcc_tpu_torch import gto, scf
    from pyscf_mpcc_tpu_torch.cc import gccsd_slow
    mf = scf.UHF(gto.M(atom="O 0 0 0; O 0 0 1.21", basis="sto-3g", spin=2))
    mf.conv_tol = 1e-12
    mf.kernel()
    e, *_, conv = umpccsd.kernel_pert_triples(
        mf, ([], []), ([], []), [], [], model="ccsdt", conv_tol=1e-11,
        conv_tol_normt=1e-9)
    e_cc = gccsd_slow.kernel(gccsd_slow.eris_from_scf(mf), conv_tol=1e-11,
                             conv_tol_normt=1e-9)[0]
    assert conv and abs(e - e_cc) < 1e-9


def test_package_exports_open_shell_modules():
    assert mpcc.umpccsd is umpccsd
    assert callable(mpcc.oomp2.update_amps_oomp2)
