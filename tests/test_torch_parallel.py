"""The port's multi-device layer (pyscf_mpcc_tpu_torch/parallel: mesh,
ladder_shard, distributed; the mesh (T) of cc/ccsd_t and cc/uccsd_t; the
sharded device DIIS) against the JAX package, on gloo ranks on the CPU.

The numpy inputs come from seeds (tests/_torch_parallel_worker.inputs);
the JAX references are the unsharded JAX functions on the same arrays,
computed once in this process.  The port runs in 2 and in 4 processes
(one set of ranks per world size, a module fixture), each rank a gloo
rank of parallel.distributed.initialize reading torchrun's RANK and
WORLD_SIZE; the ranks run every case and rank 0 writes the results, the
shards gathered, for the tests here to compare one case each.  Every set
of ranks has a timeout.  Tolerances (fp64): the sharded updates 1e-12
(the same products, partial sums added in another order), the ladder
1e-10 (as the JAX test), the mesh (T) 1e-12, the DIIS 1e-10; the
collectives are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from pyscf_mpcc_tpu.cc import ccsd_t as jccsd_t
from pyscf_mpcc_tpu.cc import rccsd as jrccsd
from pyscf_mpcc_tpu.cc import uccsd as juccsd
from pyscf_mpcc_tpu.cc import uccsd_t as juccsd_t
from pyscf_mpcc_tpu.cc.eris import RERIs as JRERIs
from pyscf_mpcc_tpu.lib import device_diis as jdiis
from pyscf_mpcc_tpu_torch.parallel import distributed

torch.set_num_threads(1)

UPDATE_TOL, LADDER_TOL, TRIPLES_TOL, DIIS_TOL = 1e-12, 1e-10, 1e-12, 1e-10


def _j(x):
    return None if x is None else jnp.asarray(x)


def _jeris(fields):
    return JRERIs(**{k: _j(v) for k, v in fields.items()}, Lvv_stream=None)


def _jueris(fields):
    return juccsd.UERIs(**{k: v if k in ("nocca", "noccb") else _j(v)
                           for k, v in fields.items()})


@pytest.fixture(scope="module")
def jax_ref():
    inp = W.inputs("parallel")
    ref = {}
    for case in W.UPDATE_SHAPES:
        d = inp[case]
        u1, u2 = jrccsd.update_amps(_j(d["t1"]), _j(d["t2"]),
                                    _jeris(d["fields"]), ntile=2)
        ref[case] = (np.asarray(u1), np.asarray(u2))
    d = inp["ladder"]
    ref["ladder"] = np.einsum("Lac,Lbd,ijcd->ijab", d["ld"], d["ld"],
                              d["tau"])
    d = inp["ccsd_t"]
    from types import SimpleNamespace
    er = SimpleNamespace(**{k: _j(v) for k, v in d["fields"].items()})
    ref["ccsd_t"] = jccsd_t.kernel(_j(d["t1"]), _j(d["t2"]), er,
                                   tile=W.TRIPLES["tile"], engine="xla")
    d = inp["uccsd_t"]
    ref["uccsd_t"] = juccsd_t.kernel(
        tuple(map(_j, d["t1"])), tuple(map(_j, d["t2"])),
        _jueris(d["fields"]), tile=W.UCCSD_T["tile"])
    for case in ("uccsd_update", "uccsd_update_mat"):
        d = inp[case]
        o1, o2 = juccsd.update_amps(tuple(map(_j, d["t1"])),
                                    tuple(map(_j, d["t2"])),
                                    _jueris(d["fields"]), ntile=2)
        ref[case] = [np.asarray(x) for x in (*o1, *o2)]
    d = inp["diis"]
    st = jdiis.init(W.DIIS_N, W.DIIS_SPACE, dtype=jnp.float64)
    outs = []
    for x, e in zip(d["x"], d["e"]):
        st, o = jdiis.update_hostsolve(st, _j(x), _j(e))
        outs.append(np.asarray(o))
    ref["diis"] = np.stack(outs)
    return ref


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def ranks(request, tmp_path_factory):
    """(world size, out dir, logs) of one run of the suite's ranks."""
    world = request.param
    out, logs = W.run_ranks("parallel", world,
                            str(tmp_path_factory.mktemp(f"ranks{world}")))
    return world, out, logs


def _res(ranks, case):
    return W.result(ranks[1], ranks[2], case)


def test_collectives_over_gloo(ranks):
    """The Mesh collectives, exactly: psum, the packed psum, all_gather on
    both axes, all_to_all, the ring shift and broadcast, gathered from
    every rank; the group's size came from WORLD_SIZE."""
    n = ranks[0]
    r = _res(ranks, "collectives")
    assert r["world"].tolist() == [n, n, 1]
    assert r["rank"].tolist() == list(range(n))
    x = [np.arange(4.0 * n).reshape(n, 4) + 100 * k for k in range(n)]
    np.testing.assert_array_equal(r["psum"], sum(x))
    np.testing.assert_array_equal(r["psum_many"], sum(x))
    for k in range(n):
        np.testing.assert_array_equal(r["gather0"][k], np.concatenate(x))
        np.testing.assert_array_equal(r["gather1"][k],
                                      np.concatenate(x, axis=1))
        np.testing.assert_array_equal(r["a2a"][k],
                                      np.stack([xe[k] for xe in x]))
        np.testing.assert_array_equal(r["ring"][k], x[(k - 1) % n])
        np.testing.assert_array_equal(r["bcast"][k], x[0])


@pytest.mark.parametrize("case", list(W.UPDATE_SHAPES))
def test_sharded_update_matches_jax(ranks, jax_ref, case):
    """sharded_update_amps (t2 row shards in and out, Lvv/Lov/Loo aux
    shards, ovvv occupied rows) against the JAX rccsd.update_amps, for the
    DF ('update_df', the JAX test's shape), DF + ovvv (the dry run's
    stage 1, naux not a mesh multiple) and materialized vvvv containers."""
    n = ranks[0]
    r = _res(ranks, case)
    ref1, ref2 = jax_ref[case]
    assert np.abs(r["t1"] - ref1).max() < UPDATE_TOL
    assert np.abs(r["t2"] - ref2).max() < UPDATE_TOL
    nocc, _, naux, form = W.UPDATE_SHAPES[case]
    lvv = -(-naux // n) if form != "vvvv" else -1
    ovvv = nocc // n if form != "df_direct" else -1
    assert r["shards"].tolist() == [[lvv, ovvv, nocc // n]] * n


def test_ladder_sharded_matches_einsum(ranks, jax_ref):
    r = _res(ranks, "ladder")
    assert np.abs(r["out"] - jax_ref["ladder"]).max() < LADDER_TOL


@pytest.mark.parametrize("engine", ["xla", "fused", "resident"])
def test_mesh_ccsd_t_matches_jax(ranks, jax_ref, engine):
    """The mesh (T) through each engine (their plain versions on the CPU)
    against the JAX package's unsharded kernel; 35 tiles, so the last
    rank's block is short (the JAX pad tiles are left out)."""
    n = ranks[0]
    r = _res(ranks, "ccsd_t")
    assert abs(float(r[engine]) - jax_ref["ccsd_t"]) < TRIPLES_TOL
    per = -(-35 // n)
    assert r["tiles"].tolist() == [min(per, 35 - k * per) for k in range(n)]
    assert r["tiles"].sum() == 35 and 35 % n


def test_mesh_uccsd_t_matches_jax(ranks, jax_ref):
    r = _res(ranks, "uccsd_t")
    assert abs(float(r["e"]) - jax_ref["uccsd_t"]) < TRIPLES_TOL
    assert abs(jax_ref["uccsd_t"]) > 1e-8


@pytest.mark.parametrize("case", ["uccsd_update", "uccsd_update_mat"])
def test_sharded_uccsd_update_matches_jax(ranks, jax_ref, case):
    """sharded_uccsd_update on per-spin aux shards (naux 22, padded at 4
    ranks) and on materialized three-virtual blocks in row shards."""
    r = _res(ranks, case)
    got = [r[f"t1_{i}"] for i in range(2)] + [r[f"t2_{i}"] for i in range(3)]
    for a, b in zip(got, jax_ref[case]):
        assert np.abs(a - b).max() < UPDATE_TOL


def test_sharded_device_diis_matches_replicated(ranks, jax_ref):
    """update_hostsolve on a history sharded along the vector (the Gram
    dots summed over the ranks) against the replicated ring and the JAX
    package's; the history stays a shard on each rank."""
    n = ranks[0]
    r = _res(ranks, "diis")
    assert np.abs(r["sharded"] - r["replicated"]).max() < DIIS_TOL
    assert np.abs(r["replicated"] - jax_ref["diis"]).max() < DIIS_TOL
    assert r["history"].tolist() == [W.DIIS_SPACE, W.DIIS_N // n]


def test_initialize_single_process_is_a_no_op(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device=torch.device("cpu")) is False
    assert not torch.distributed.is_initialized()


def test_launch_env_reads_torchrun_variables(monkeypatch):
    for k, v in dict(RANK="3", WORLD_SIZE="4", LOCAL_RANK="1",
                     MASTER_ADDR="localhost", MASTER_PORT="29511").items():
        monkeypatch.setenv(k, v)
    assert distributed.launch_env() == ("tcp://localhost:29511", 4, 3, 1)
    assert distributed.launch_env("file:///x", 2, 0) == ("file:///x", 2, 0,
                                                          1)
