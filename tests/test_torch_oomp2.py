"""The port's OO-MP2 bath updates (pyscf_mpcc_tpu_torch.mpcc.oomp2) and the
OO-MP2 relaxation of umpccsd.kernel against the JAX package, in fp64 on
the CPU.

Inputs: the O2 triplet/sto-3g UHF of tests/_torch_uinputs, its incore
UERIs and exact-Cholesky DF UERIs (the JAX package's containers, handed
to the port as numpy), the MP2 guess with seeded random t1, and the
active masks of tests/test_oomp2.py (one active hole and particle a
spin; doubles block 15).  The JAX references (the materialized path) are
computed once (module fixture).

Tolerances: one sweep 1e-12 on either path of the port against JAX's
materialized sweep (exact factors: tests/test_oomp2.py holds JAX's own two
paths to 1e-12); the converged relaxation 1e-10 with the frozen all-active
blocks equal to the incoming amplitudes bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_uinputs import cholesky, fields, mean_field, np_tuple, uhf_arrays
from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.cc import uccsd as ju
from pyscf_mpcc_tpu.mpcc import umpccsd as jum
from pyscf_mpcc_tpu.mpcc.masks import doubles_blocks
from pyscf_mpcc_tpu.mpcc.oomp2 import update_amps_oomp2 as jupdate
from pyscf_mpcc_tpu_torch import convert
from pyscf_mpcc_tpu_torch.mpcc import oomp2, umpccsd

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL_SWEEP, TOL = 1e-12, 1e-10
VARIANTS = ("standard", "t2_fock", "t2_all", "t2act")
# the fragment's active blocks frozen, the bath relaxed (workflow.py)
RELAX = dict(idx_s=[3], idx_d=[15], conv_tol=1e-11, conv_tol_normt=1e-9,
             max_cycle=100)


@pytest.fixture(scope="module")
def ref():
    mf = mean_field("o2")
    mo_a, mo_b, fa, fb, na, nb = uhf_arrays(mf)
    eri = jgto.intor_eri(mf.mol)
    jer = ju.make_eris_incore(eri, mo_a, mo_b, fa, fb, na, nb)
    jdf = ju.make_eris_df(cholesky(eri), mo_a, mo_b, fa, fb, na, nb)
    _, t1, t2 = ju.init_amps(jer)
    rng = np.random.default_rng(9)
    t1 = tuple(np.asarray(x) + 0.02 * rng.standard_normal(x.shape)
               for x in t1)
    t2 = np_tuple(t2)
    nva, nvb = t1[0].shape[1], t1[1].shape[1]
    ah, ap = ([na - 1], [nb - 1]), ([0], [0])
    act = (doubles_blocks(ah[0], ap[0], na, nva)[15],
           doubles_blocks(ah[0], ap[0], na, nva, ah[1], ap[1], nb, nvb)[15],
           doubles_blocks(ah[1], ap[1], nb, nvb)[15])
    sweep, relax = {}, {}
    # a larger fragment space for the relaxation (umpcc_o2.py's)
    space = (([7, 8], [5, 6]), ([0], [0, 1]))
    for v in VARIANTS:
        a1, a2 = jupdate(tuple(jnp.asarray(x) for x in t1),
                         tuple(jnp.asarray(x) for x in t2), jer, variant=v,
                         act_masks=tuple(jnp.asarray(m) for m in act))
        sweep[v] = (np_tuple(a1), np_tuple(a2))
        conv, e, r1, r2 = jum.kernel(jer, *space, t1=t1, t2=t2, oo_mp2=True,
                                     oomp2_variant=v, **RELAX)
        assert conv
        relax[v] = (e, np_tuple(r1), np_tuple(r2))
    return dict(fields=fields(jer), fields_df=fields(jdf), t=(t1, t2),
                act=act, space=space, sweep=sweep, relax=relax)


@pytest.fixture(scope="module")
def eris(ref):
    return {"incore": convert.ueris_from_numpy(ref["fields"], CPU),
            "df": convert.ueris_from_numpy(ref["fields_df"], CPU)}


def _amps(ref):
    t1, t2 = ref["t"]
    return (convert.tensors_from_numpy(*t1, device=CPU),
            convert.tensors_from_numpy(*t2, device=CPU))


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(convert.to_numpy(g), np.asarray(w),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("path", ["incore", "df"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_sweep_matches_jax(ref, eris, variant, path):
    t1, t2 = _amps(ref)
    act = convert.tensors_from_numpy(*ref["act"], device=CPU)
    u1, u2 = oomp2.update_amps_oomp2(t1, t2, eris[path], variant=variant,
                                     act_masks=act, ntile=2)
    w1, w2 = ref["sweep"][variant]
    _close((*u1, *u2), (*w1, *w2), TOL_SWEEP)


def test_t2act_without_active_blocks_is_standard(ref, eris):
    t1, t2 = _amps(ref)
    none = tuple(torch.zeros_like(x, dtype=torch.bool) for x in t2)
    a = oomp2.update_amps_oomp2(t1, t2, eris["df"], variant="t2act",
                                act_masks=none)
    b = oomp2.update_amps_oomp2(t1, t2, eris["df"], variant="standard")
    _close((*a[0], *a[1]), (*b[0], *b[1]), 1e-14)


def test_unknown_variant_raises(ref, eris):
    t1, t2 = _amps(ref)
    with pytest.raises(ValueError, match="oomp2 variant"):
        oomp2.update_amps_oomp2(t1, t2, eris["incore"], variant="t2_ring")


@pytest.mark.parametrize("variant", VARIANTS)
def test_relaxation_matches_jax(ref, eris, variant):
    t1, t2 = _amps(ref)
    conv, e, r1, r2 = umpccsd.kernel(eris["incore"], *ref["space"], t1=t1,
                                     t2=t2, oo_mp2=True,
                                     oomp2_variant=variant, **RELAX)
    e_j, w1, w2 = ref["relax"][variant]
    assert conv and abs(e - e_j) < TOL
    _close((*r1, *r2), (*w1, *w2), TOL)
    masks = umpccsd.frozen_masks_u(
        *ref["space"], (t1[0].shape[0], t1[1].shape[0]),
        (t1[0].shape[1], t1[1].shape[1]), *umpccsd._index_lists(
            RELAX["idx_s"], RELAX["idx_d"]), device=CPU)
    for x, b, m in zip((*r1, *r2), (*t1, *t2), masks):
        assert m.any() and torch.equal(x[m], b[m])
