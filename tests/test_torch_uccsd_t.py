"""The port's UCCSD(T) (cc/uccsd_t: the tiled spin-orbital kernel, its
device-side assembly, DF and materialized paths, the active partition)
against the JAX package, in fp64 on the CPU.

Inputs: O2 triplet/sto-3g UHF solved to 1e-11 by the JAX package (the
same numpy amplitudes and mean field for both packages), its incore
UERIs and a DF container on the even-tempered aux basis of the JAX
test (tests/test_uccsd_t_fast.py); H2O/cc-pVDZ at the distorted
geometry of the pinned closed-shell E(T).  The JAX references are
computed once (module fixture).  Tolerance 1e-12 against the JAX kernel
(the same fp64 products in another order); 1e-10 between the
unrestricted and restricted kernels on a closed shell.
"""

import numpy as np
import pytest
import torch

from _torch_uinputs import mean_field, np_tuple, uhf_arrays
from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.cc import uccsd as ju
from pyscf_mpcc_tpu.cc import uccsd_t as jut
from pyscf_mpcc_tpu.df.addons import aug_etb
from pyscf_mpcc_tpu.df.df import DF
from pyscf_mpcc_tpu.testutil import h2o_ccpvdz
from pyscf_mpcc_tpu_torch.cc import ccsd_t, rccsd, uccsd, uccsd_t
from pyscf_mpcc_tpu_torch.cc.eris import make_eris_incore

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-12
ACT = dict(act_hole=([5, 6, 7, 8], [5, 6]), act_particle=([0], [0, 1]))
# the closed-shell pin at the tilted H2O/cc-pVDZ (chip_smoke.E_T_TILT)
E_T_TILT = -0.0033300722704016289


@pytest.fixture(scope="module")
def ref():
    mf = mean_field("o2")
    a = uhf_arrays(mf)
    eri = jgto.intor_eri(mf.mol)
    ue = ju.make_eris_incore(eri, *a)
    B = DF(mf.mol, auxbasis=aug_etb(mf.mol)).B_ao()
    ud = ju.make_eris_df(B, *a)
    conv, _, t1, t2 = ju.kernel(ue, conv_tol=1e-11, conv_tol_normt=1e-9,
                                max_cycle=200)
    assert conv
    out = dict(a=a, eri=eri, B=B, t1=np_tuple(t1), t2=np_tuple(t2))
    out["incore", 2] = jut.kernel(t1, t2, ue, tile=2)
    out["incore", 8] = jut.kernel(t1, t2, ue, tile=8)
    out["df", 2] = jut.kernel(t1, t2, ud, tile=2)
    for mode in ("exclude_active", "only_active"):
        out[mode] = jut.kernel(t1, t2, ue, tile=2, mode=mode, **ACT)
    return out


@pytest.fixture(scope="module")
def port(ref):
    a = ref["a"]
    ue = uccsd.make_eris_incore(ref["eri"], *a, device=CPU)
    ud = uccsd.make_eris_df(ref["B"], *a, device=CPU)
    t1 = tuple(torch.tensor(x) for x in ref["t1"])
    t2 = tuple(torch.tensor(x) for x in ref["t2"])
    return ue, ud, t1, t2


@pytest.mark.parametrize("kind,tile", [("incore", 2), ("incore", 8),
                                       ("df", 2)])
def test_energy_matches_jax(ref, port, kind, tile):
    ue, ud, t1, t2 = port
    et = uccsd_t.kernel(t1, t2, ue if kind == "incore" else ud, tile=tile)
    assert abs(et - ref[kind, tile]) < TOL
    assert abs(et) > 1e-6      # O2 triplet has a real (T) contribution


def test_active_partition_matches_jax_and_adds_up(ref, port):
    ue, _, t1, t2 = port
    e = {mode: uccsd_t.kernel(t1, t2, ue, tile=2, mode=mode, **ACT)
         for mode in ("exclude_active", "only_active")}
    for mode, v in e.items():
        assert abs(v - ref[mode]) < TOL
    assert abs(e["exclude_active"] + e["only_active"]
               - ref["incore", 2]) < TOL


def test_closed_shell_matches_restricted_kernel():
    d = h2o_ccpvdz(geom="tilt")
    er = make_eris_incore(d["eri_ao"], d["mo_coeff"], d["fock_ao"], 5,
                          device=CPU)
    conv, _, t1, t2 = rccsd.kernel(er, conv_tol=1e-12, conv_tol_normt=1e-10,
                                   max_cycle=200)
    assert conv
    et_r = ccsd_t.kernel(t1, t2, er, tile=8)
    ue = uccsd.make_eris_incore(d["eri_ao"], d["mo_coeff"], d["mo_coeff"],
                                d["fock_ao"], d["fock_ao"], 5, 5, device=CPU)
    taa = t2 - t2.permute(0, 1, 3, 2)
    et_u = uccsd_t.kernel((t1, t1), (taa, t2, taa), ue, tile=8)
    assert abs(et_u - et_r) < 1e-10
    assert abs(et_u - E_T_TILT) < 1e-9


def test_prepare_assembles_spin_orbital_blocks(port):
    """The device-side assembly: block-diagonal DF factors, the padded
    virtual energies and <jk||yz> antisymmetry."""
    _, ud, t1, t2 = port
    big = uccsd_t._prepare(t1, t2, ud, 4, torch.float64, None, None)
    na, nb, va, vb = 9, 7, 1, 3
    assert big["O"] == na + nb and big["nvp"] == 4
    assert torch.equal(big["Lov"][:, :na, va:], torch.zeros_like(
        big["Lov"][:, :na, va:]))
    g = big["aoovv_r"]
    torch.testing.assert_close(g, -g.permute(1, 0, 2, 3), rtol=0, atol=1e-15)
    torch.testing.assert_close(g, -g.permute(0, 1, 3, 2), rtol=0, atol=1e-15)


def test_mesh_raises(port):
    """The mesh (T) takes the replicated integrals (the mesh path itself
    is held to JAX in tests/test_torch_parallel.py): a container sharded
    over a mesh is refused before any tile runs."""
    ue, _, t1, t2 = port
    with pytest.raises(ValueError, match="replicated"):
        uccsd_t.kernel(t1, t2, ue._replace(mesh=object()), mesh=object())
