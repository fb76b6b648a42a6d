"""The multi-device layer on the card (parallel/, the mesh (T)).

Needs a CUDA device; skipped elsewhere.  Run on the card with
``python -m pytest tests/test_torch_parallel_gpu.py -o addopts='' --noconftest``
(tests/conftest.py imports jax, which the card's machine may not have).

- NCCL at world size 1 (a file:// rendezvous in this process): the mesh
  (T) through the combine kernel ('fused') and the resident kernel, the
  sharded update and the tiled update, in fp64, against the single-card
  paths on the same card: the (T) 1e-12, the updates 1e-12 and 1e-11
  (tests/test_torch_parallel.py's bounds).  Every collective runs
  through the group even though it has one rank.
- Two ranks sharing the card over gloo (tests/_torch_parallel_worker.py,
  suite 'gpu_shared', tensors crossing through host memory): the same
  cases against the same single-card paths, at the same bounds.
"""

import os

import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from pyscf_mpcc_tpu_torch import convert, testing
from pyscf_mpcc_tpu_torch.cc import ccsd_t, rccsd

pytestmark = pytest.mark.cuda

F64 = torch.float64
TRIPLES_TOL, UPDATE_TOL, TILED_TOL = 1e-12, 1e-12, 1e-11


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyscf_mpcc_tpu_torch.lib import device
    device.set_fp32_precision()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def single(cuda):
    """The single-card results of the cases, on the card, fp64."""
    inp = W.inputs("gpu_shared")
    d = inp["ccsd_t"]
    fields = {k: d["fields"].get(k) for k in (
        "fock", "mo_energy", "ovoo", "ovov", "ovvv", "Lov", "Lvv")}
    t1, t2, er = testing.triples_tensors(d["t1"], d["t2"], fields, cuda, F64)
    out = {eng: ccsd_t.kernel(t1, t2, er, tile=W.TRIPLES["tile"],
                              engine=eng)
           for eng in ("xla", "fused", "resident")}
    for case, ntile in (("update_df", 2), ("update_ovvv", 2), ("tiled", 2)):
        d = inp[case]
        er = convert.eris_from_numpy(d["fields"], cuda, F64)
        u1, u2 = rccsd.update_amps(
            *(torch.tensor(x, dtype=F64, device=cuda) for x in
              (d["t1"], d["t2"])), er, ntile=ntile)
        out[case] = (u1.cpu().numpy(), u2.cpu().numpy())
    return inp, out


@pytest.fixture(scope="module")
def nccl1(cuda, tmp_path_factory):
    """A one-rank NCCL mesh in this process."""
    import torch.distributed as dist
    from pyscf_mpcc_tpu_torch.parallel import distributed, make_mesh
    store = tmp_path_factory.mktemp("nccl") / "store"
    assert distributed.initialize(init_method=f"file://{store}",
                                  world_size=1, rank=0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def _check(res, single, tol):
    for a, b in zip(res, single):
        assert np.abs(np.asarray(a) - b).max() < tol


def test_nccl_one_rank_matches_single_card(nccl1, single):
    from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
    from pyscf_mpcc_tpu_torch.ops import triples_resident as tr
    assert nccl1.backend == "nccl" and nccl1.size == 1
    inp, ref = single
    cases = W.suite_cases(torch, "gpu_shared", nccl1)
    n_comb, n_res = tc.launch_count, tr.launch_count
    got = cases["ccsd_t"](inp["ccsd_t"])
    assert tc.launch_count > n_comb and tr.launch_count > n_res
    for eng in ("xla", "fused", "resident"):
        assert abs(float(got[eng]) - ref[eng]) < TRIPLES_TOL, eng
    for case, tol in (("update_df", UPDATE_TOL), ("update_ovvv", UPDATE_TOL),
                      ("tiled", TILED_TOL)):
        r = cases[case](inp[case])
        _check((r["t1"].cpu(), r["t2"].cpu()), ref[case], tol)


def test_two_ranks_share_the_card_over_gloo(single, tmp_path):
    inp, ref = single
    out, logs = W.run_ranks("gpu_shared", 2, str(tmp_path),
                            env=dict(os.environ))
    got = W.result(out, logs, "ccsd_t")
    assert got["tiles"].tolist() == [18, 17]
    for eng in ("xla", "fused", "resident"):
        assert abs(float(got[eng]) - ref[eng]) < TRIPLES_TOL, eng
    for case, tol in (("update_df", UPDATE_TOL), ("update_ovvv", UPDATE_TOL),
                      ("tiled", TILED_TOL)):
        r = W.result(out, logs, case)
        _check((r["t1"], r["t2"]), ref[case], tol)
