"""The port's tiled RCCSD update (pyscf_mpcc_tpu_torch/parallel/ccsd_shard)
against the JAX package, on gloo ranks on the CPU.

The tiled update re-derives every contraction on occupied-row shards
(rings, all_reduces, all_to_all exchanges); these tests hold it, and its
host-DIIS iteration, to the unsharded JAX rccsd.update_amps and
rccsd.kernel in fp64, where any mis-localized index shows far above the
1e-11 gate.  The ranks run as in tests/test_torch_parallel.py: 2 and 4
processes (a module fixture each, with a timeout), the JAX references
computed once here.  The exchange is exact; the energy of the tiled
iteration 1e-9 (as the JAX test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from pyscf_mpcc_tpu.cc import rccsd as jrccsd
from pyscf_mpcc_tpu.cc.eris import RERIs as JRERIs

torch.set_num_threads(1)

TILED_TOL, ENERGY_TOL = 1e-11, 1e-9
# the unsharded reference's ladder tiling (the JAX tests')
REF_NTILE = {"tiled": 2, "tiled_asym": 3, "submesh": 1}


def _jeris(fields):
    return JRERIs(**{k: None if v is None else jnp.asarray(v)
                     for k, v in fields.items()}, Lvv_stream=None)


@pytest.fixture(scope="module")
def jax_ref():
    inp = W.inputs("ccsd_shard")
    ref = {}
    for case, ntile in REF_NTILE.items():
        d = inp[case]
        u1, u2 = jrccsd.update_amps(jnp.asarray(d["t1"]),
                                    jnp.asarray(d["t2"]),
                                    _jeris(d["fields"]), ntile=ntile)
        ref[case] = (np.asarray(u1), np.asarray(u2))
    conv, e, _, _ = jrccsd.kernel(_jeris(inp["kernel_tiled"]["fields"]),
                                  conv_tol=1e-10, conv_tol_normt=1e-8)
    assert conv
    ref["kernel_tiled"] = float(e)
    ref["t_exchange"] = inp["t_exchange"]["x"].transpose(1, 0, 3, 2)
    return ref


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def ranks(request, tmp_path_factory):
    world = request.param
    out, logs = W.run_ranks("ccsd_shard", world,
                            str(tmp_path_factory.mktemp(f"shard{world}")))
    return world, out, logs


def _res(ranks, case):
    return W.result(ranks[1], ranks[2], case)


def test_t_exchange_roundtrip(ranks, jax_ref):
    r = _res(ranks, "t_exchange")
    assert np.abs(r["y"] - jax_ref["t_exchange"]).max() == 0.0


@pytest.mark.parametrize("case", ["tiled", "tiled_asym"])
def test_tiled_update_matches_unsharded(ranks, jax_ref, case):
    """(8, 16, 24) at ntile 4 / nchunk 2, and the asymmetric (8, 14, 27):
    nvir not a multiple of the ladder tiling, naux of the mesh (padded),
    ntile 3 / nchunk 3.  The unpadded aux axis and nocc % N raise
    ValueError, as in the JAX package."""
    n = ranks[0]
    r = _res(ranks, case)
    ref1, ref2 = jax_ref[case]
    assert np.abs(r["t1"] - ref1).max() < TILED_TOL
    assert np.abs(r["t2"] - ref2).max() < TILED_TOL
    naux = W.TILED_SHAPES[case][2]
    assert int(r["lvv_rows"]) == -(-naux // n)
    errs = r["errors"].tolist()
    assert len(errs) == 2
    assert "must divide the mesh size" in errs[0]
    assert "aux axis not padded" in errs[1]


def test_tiled_kernel_converges_to_unsharded_energy(ranks, jax_ref):
    r = _res(ranks, "kernel_tiled")
    assert bool(r["conv"])
    assert abs(float(r["e"]) - jax_ref["kernel_tiled"]) < ENERGY_TOL


def test_tiled_update_on_submesh(ranks, jax_ref):
    """The first half of the ranks (make_mesh(n // 2), a new group: 2 of
    4, and a one-rank mesh of 2); rank 0 reports."""
    r = _res(ranks, "submesh")
    assert bool(r["member"]) and int(r["size"]) == ranks[0] // 2
    ref1, ref2 = jax_ref["submesh"]
    assert np.abs(r["t1"] - ref1).max() < TILED_TOL
    assert np.abs(r["t2"] - ref2).max() < TILED_TOL
