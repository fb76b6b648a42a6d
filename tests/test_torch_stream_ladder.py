"""The port's out-of-core DF ladder (lib/hoststore, cc/stream_ladder,
eris.make_eris_df(stream_vv=True)) against the resident path and the JAX
package's streamed functions, in fp64 on the CPU.

Inputs: H2O/cc-pVDZ with the JAX RHF's orbitals, Fock and DF factors
(tests/test_stream_ladder.py's system), handed to both packages as numpy
arrays; the JAX references are computed once (a module fixture).  The
capacity model and one update at tests/test_capacity.py's shape and
budget (NOCC, NVIR, NAUX = 8, 48, 3072, 32 MiB, ntile 16).

Tolerances: the store, oovv and the five StreamedOvvv methods 1e-13 of
their scale against the resident path (the same products in other GEMM
blockings) and 1e-10 against JAX; the ladder and its vjp (ntile 1 and 3)
1e-12 against resident (autograd here against JAX's hand-derived
custom_vjp: 1e-9, JAX's own bound); a CCSD solve and Lambda 1e-13
relative against resident, as tests/test_capacity.py holds one update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.cc import eris as jeris_mod
from pyscf_mpcc_tpu.cc import rccsd as jrccsd
from pyscf_mpcc_tpu.cc import stream_ladder as jsl
from pyscf_mpcc_tpu.df import df as jdf
from pyscf_mpcc_tpu.lib import hoststore as jhs
from pyscf_mpcc_tpu.lib import memory as jmem
from pyscf_mpcc_tpu.scf import RHF as JRHF
from pyscf_mpcc_tpu_torch import convert, testing
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.cc import lambda_ad, rccsd, stream_ladder
from pyscf_mpcc_tpu_torch.lib import memory
from pyscf_mpcc_tpu_torch.lib.hoststore import HostStore

torch.set_num_threads(1)

CPU = torch.device("cpu")
H2O = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
OPS = ("t1_t2_terms", "lvv_t1", "wvoov_t1", "wvovo_t1", "t2_vvov_t1")
# tests/test_capacity.py
NOCC, NVIR, NAUX, BUDGET, STREAM_NTILE = 8, 48, 3072, 32 * 1024 ** 2, 16


def _rel(a, b):
    a = convert.to_numpy(a) if torch.is_tensor(a) else np.asarray(a)
    b = convert.to_numpy(b) if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def ref():
    mol = jgto.M(atom=H2O, basis="cc-pvdz", unit="angstrom")
    mf = JRHF(mol)
    mf.conv_tol = 1e-12
    mf.kernel()
    args = (np.asarray(jdf.DF(mol).B_ao()), np.asarray(mf.mo_coeff),
            np.asarray(mf.get_fock(mf.make_rdm1())), 5)
    er = jeris_mod.make_eris_df(*args, stream_vv=True)
    nocc, nvir = er.nocc, er.nvir
    rng = np.random.default_rng(3)
    tau = rng.standard_normal((nocc, nocc, nvir, nvir))
    tau = 0.5 * (tau + tau.transpose(1, 0, 3, 2))
    t1 = 0.1 * rng.standard_normal((nocc, nvir))
    t2 = 0.1 * rng.standard_normal((nocc, nocc, nvir, nvir))
    w = rng.standard_normal(tau.shape)
    fields = {k: None if v is None else np.asarray(v)
              for k, v in er._asdict().items()}
    fields["Lvv_stream"] = jhs.get(int(er.Lvv_stream))
    out = dict(args=args, fields=fields, tau=tau, t1=t1, t2=t2, w=w)
    for ntile in (1, 3):
        lad = jsl.make_streamed_ladder(nocc, nvir, er.Lov.shape[0], ntile,
                                       er.Lov.dtype)

        def f(tau, t1):
            return jnp.vdot(jnp.asarray(w),
                            lad(tau, t1, er.Lov, er.Lvv_stream))

        v, g = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(tau),
                                                     jnp.asarray(t1))
        out["ladder", ntile] = (float(v), np.asarray(g[0]),
                                np.asarray(g[1]))
    ops = jrccsd._OvvvOps(er, ntile=3)
    for name in OPS:
        arg = t2 if name == "t1_t2_terms" else t1
        out[name] = np.asarray(getattr(ops, name)(jnp.asarray(arg)))
    return out


@pytest.fixture(scope="module")
def both(ref):
    """(resident, streamed) port containers from the same numpy inputs."""
    res = eris_mod.make_eris_df(*ref["args"], keep_ovvv=False, device=CPU)
    return res, eris_mod.make_eris_df(*ref["args"], stream_vv=True,
                                      device=CPU)


def test_streamed_eris_layout(ref, both):
    res, st = both
    # Lvv is not on the device: the container holds only its host store
    assert st.Lvv is None and st.ovvv is None
    assert isinstance(st.Lvv_stream, HostStore)
    assert st.Lvv_stream.nbytes >= res.Lvv.numel() * 8
    assert _rel(st.Lvv_stream.to_dense(), res.Lvv) < 1e-13
    assert _rel(st.Lvv_stream.to_dense(), ref["fields"]["Lvv_stream"]) \
        < 1e-10
    assert _rel(st.oovv, res.oovv) < 1e-13
    assert _rel(st.oovv, ref["fields"]["oovv"]) < 1e-10
    for k in ("fock", "oooo", "ovoo", "ovov", "Lov", "Loo"):
        assert torch.equal(getattr(st, k), getattr(res, k)), k
    # the JAX container's fields, the store included, hand over
    conv = convert.eris_from_numpy(ref["fields"], CPU)
    assert conv.Lvv is None
    assert _rel(conv.Lvv_stream.to_dense(), res.Lvv) < 1e-10
    # retiling keeps the factor
    st.Lvv_stream.retile(5)
    assert st.Lvv_stream.tiles.shape[:3] == (5, res.Lvv.shape[0], 4)
    assert _rel(st.Lvv_stream.to_dense(), res.Lvv) < 1e-13


@pytest.mark.parametrize("ntile", [1, 3])
def test_streamed_ladder_forward_and_vjp(ref, both, ntile):
    """Streamed pair ladder == resident pair_ladder_sym (value and the
    cotangents of tau and t1), and == JAX's streamed custom_vjp ladder."""
    res, st = both
    w = torch.tensor(ref["w"])

    def run(streamed):
        tau, t1 = (torch.tensor(ref[k], requires_grad=True)
                   for k in ("tau", "t1"))
        if streamed:
            out = stream_ladder.pair_ladder_sym(tau, t1, st.Lov,
                                                st.Lvv_stream, ntile)
        else:
            ld = res.Lvv - torch.einsum("ka,Lkc->Lac", t1, res.Lov)
            out = rccsd.pair_ladder_sym(tau, ld, ntile)
        v = torch.vdot(w.reshape(-1), out.reshape(-1))
        return (v, *torch.autograd.grad(v, (tau, t1)))

    got, want = run(True), run(False)
    for a, b in zip(got, want):
        assert _rel(a.detach(), b.detach()) < 1e-12
    jv, jg_tau, jg_t1 = ref["ladder", ntile]
    np.testing.assert_allclose(float(got[0].detach()), jv, rtol=1e-10)
    np.testing.assert_allclose(convert.to_numpy(got[1]), jg_tau, rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(convert.to_numpy(got[2]), jg_t1, rtol=1e-9,
                               atol=1e-10)


@pytest.mark.parametrize("name", OPS)
def test_streamed_ovvv_ops_match(ref, both, name):
    res, st = both
    arg = torch.tensor(ref["t2" if name == "t1_t2_terms" else "t1"])
    a = getattr(rccsd._OvvvOps(st, ntile=3), name)(arg)
    b = getattr(rccsd._OvvvOps(res), name)(arg)
    assert _rel(a, b) < 1e-13
    assert _rel(a, ref[name]) < 1e-10


def test_streamed_ccsd_and_lambda_match_resident(both):
    """A CCSD solve and the Lambda solve at its amplitudes, streamed
    against resident (the same equations on the same factors)."""
    res, st = both
    kw = dict(conv_tol=1e-10, conv_tol_normt=1e-8, max_cycle=80, ntile=2)
    cr, er_, t1r, t2r = rccsd.kernel(res, **kw)
    cs, es_, t1s, t2s = rccsd.kernel(st, **kw)
    assert cr and cs and abs(er_ - es_) < 1e-13 * abs(er_)
    assert _rel(t2s, t2r) < 1e-13 and _rel(t1s, t1r) < 1e-13
    lr = lambda_ad.kernel(t1r, t2r, res, conv_tol=1e-8, ntile=2)
    ls = lambda_ad.kernel(t1s, t2s, st, conv_tol=1e-8, ntile=2)
    assert lr[0] and ls[0]
    assert _rel(ls[1], lr[1]) < 1e-13 and _rel(ls[2], lr[2]) < 1e-13


def test_capacity_model_matches_jax_and_shows_the_gap():
    kw = dict(ntile=STREAM_NTILE, dtype="float64", ndev=1)
    full = memory.ccsd_working_set_bytes(NOCC, NVIR, NAUX, **kw)
    streamed = memory.ccsd_working_set_bytes(NOCC, NVIR, NAUX,
                                             stream_vv=True, **kw)
    assert full > BUDGET and NAUX * NVIR * NVIR * 8 > BUDGET
    assert streamed < BUDGET
    for shape in ((NOCC, NVIR, NAUX), (32, 424, 1216)):
        for k in (dict(ntile=8), dict(ntile=3, ndev=4),
                  dict(ntile=16, stream_vv=True, dtype="float32")):
            assert memory.ccsd_working_set_bytes(*shape, **k) \
                == jmem.ccsd_working_set_bytes(*shape, **k)


def test_streamed_update_matches_resident_beyond_budget():
    """tests/test_capacity.py's update at its shape: streamed against
    resident, 1e-13 relative."""
    er = testing.synthetic_eris(NOCC, NVIR, NAUX, device=CPU,
                                dtype=torch.float64, build_ovvv=False)
    _, t1, t2 = rccsd.init_amps(er)
    ref1, ref2 = rccsd.update_amps(t1, t2, er, ntile=STREAM_NTILE)
    store = HostStore.from_tensor(er.Lvv, CPU)
    st = er._replace(Lvv=None, Lvv_stream=store)
    out1, out2 = rccsd.update_amps(t1, t2, st, ntile=STREAM_NTILE)
    assert st.Lvv is None and store.ntile == STREAM_NTILE
    assert store.to_dense().numel() * 8 == NAUX * NVIR * NVIR * 8
    assert _rel(out1, ref1) < 1e-13 and _rel(out2, ref2) < 1e-13
    # every tile crossed at least once, the ladder's pairs more
    assert store.bytes_moved >= store.nbytes
