"""The port's streamed and certified (H2O)8/aug-cc-pVTZ campaign script
(pyscf_mpcc_tpu_torch/examples/w8aug_stream_certify.py) on the CPU at a
small size, against the JAX package where it has a counterpart.

- H2O/aug-cc-pVDZ with aug-cc-pVDZ-JKFIT fitting and one frozen core
  orbital, the campaign's basis family with its diffuse functions: on the
  same B, mo and fock (fp64 numpy from the script's SCF stage),
  stage_fp32 at fp64 (streamed integrals, device DIIS rings of 3 and 2
  slots with bf16 errors, ladder tiles 3 through W8AUG_NTILE) and the
  certification against JAX's make_eris_df(stream_vv=True),
  rccsd.kernel, lambda_ad.kernel and lambda_ad.lagrangian_energy on the
  same settings: energies and amplitudes within 1e-10.  The JAX
  reference is computed once (module fixture).
- The port's streamed chain against its resident chain within 1e-12.
- The stage in fp32, certified in fp64, within 1e-8 of the fp64 CCSD
  energy converged to 1e-10.
- run() writes scf.npz, amps_t.npz and amps.npz in the stated format, and
  a rerun that resumes after CCSD from amps_t.npz certifies bit for bit.
- The capacity record's model equals the JAX package's
  lib/memory.ccsd_working_set_bytes and the JAX script's record.
- campaign.make_eris builds a streamed container; W8_STAGE64_BACKEND=ozaki
  raises.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu.cc import eris as jeris_mod
from pyscf_mpcc_tpu.cc import lambda_ad as jlam
from pyscf_mpcc_tpu.cc import rccsd as jrccsd
from pyscf_mpcc_tpu.lib import memory as jmem
from pyscf_mpcc_tpu_torch.cc import rccsd
from pyscf_mpcc_tpu_torch.examples import campaign as cp
from pyscf_mpcc_tpu_torch.examples import w8aug_stream_certify as w8aug

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
F64 = torch.float64
H2O = [["O", (0.0, 0.0, 0.0)], ["H", (0.0, -0.757, 0.587)],
       ["H", (0.0, 0.757, 0.587)]]
SMALL = dict(geom=H2O, basis="aug-cc-pvdz", auxbasis="aug-cc-pvdz-jkfit",
             frozen=1)
FROZEN, NTILE = 1, 3


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def h2o():
    """The script's DF-RHF of H2O/aug-cc-pVDZ (host J/K, no checkpoint):
    the scf.npz dict."""
    scf, r = w8aug.scf_stage(CPU, None, H2O, SMALL["basis"],
                             SMALL["auxbasis"])
    assert not r["scf_reused"] and r["scf_converged"]
    assert r["s_min"] > 0 and (r["nao"], r["naux"]) == (41, 150)
    return scf


@pytest.fixture(scope="module")
def jax_ref(h2o):
    """JAX's streamed CCSD, Lambda and Lagrangian energy on the same B, mo
    and fock, at the JAX script's rings and tolerances."""
    nocc = int(h2o["nelectron"]) // 2 - FROZEN
    er = jeris_mod.make_eris_df(h2o["B"], h2o["mo_full"][:, FROZEN:],
                                h2o["fock_ao"], nocc, keep_ovvv=False,
                                stream_vv=True)
    assert er.Lvv is None
    ring = dict(diis_backend="device", diis_err_dtype=jnp.bfloat16)
    conv, e, t1, t2 = jrccsd.kernel(er, ntile=NTILE, diis_space=3, **ring,
                                    **w8aug.CCSD_TOL)
    cl, l1, l2 = jlam.kernel(t1, t2, er, ntile=NTILE, diis_space=2, **ring,
                             **w8aug.LAMBDA_TOL)
    el = float(jlam.lagrangian_energy(t1, t2, l1, l2, er, ntile=NTILE))
    assert conv and cl
    return dict(e32=float(e), e_lagr=el,
                **{k: np.asarray(v) for k, v in
                   (("t1", t1), ("t2", t2), ("l1", l1), ("l2", l2))})


@pytest.fixture
def ntile3(monkeypatch):
    monkeypatch.setenv("W8AUG_NTILE", str(NTILE))


def test_stage_and_certify_match_jax(h2o, jax_ref, ntile3):
    amps, r = w8aug.stage_fp32(h2o, FROZEN, CPU, F64)
    assert r["ccsd_converged"] and r["lambda_converged"]
    assert r["ccsd_diis"] == dict(backend="device", space=3,
                                  err_dtype="torch.bfloat16", ntile=NTILE,
                                  resumed=False)
    assert r["lambda_diis"]["space"] == 2
    assert r["lambda_diis"]["ntile"] == NTILE
    # every sweep pulls Lvv's row tiles from the store
    assert r["ccsd_h2d_gb"] > 0 and r["lambda_h2d_gb"] > 0
    assert abs(r["e32"] - jax_ref["e32"]) < 1e-10
    for k in ("t1", "t2", "l1", "l2"):
        assert amps[k].dtype == np.float64
        assert np.abs(amps[k] - jax_ref[k]).max() < 1e-10, k
    e_lagr, rc = w8aug.stage_fp64(h2o, amps, FROZEN, CPU)
    assert abs(e_lagr - jax_ref["e_lagr"]) < 1e-10
    assert rc["e_lagr"] == e_lagr and rc["stage64_backend"] == "device"
    assert rc["stream_vv64"]
    assert rc["raw_gap"] == abs(r["e32"] - e_lagr)


def test_streamed_chain_matches_resident(h2o, jax_ref, ntile3):
    """The same solves on the resident integrals of the same store."""
    er, _ = cp.make_eris(h2o, FROZEN, F64, CPU)
    nocc, nvir = jax_ref["t1"].shape
    n = nocc * nvir + (nocc * nvir) ** 2
    t1, t2, r = cp.solve_ccsd(er, w8aug._solver(n, nocc, nvir, 0, F64, None),
                              **w8aug.CCSD_TOL)
    l1, l2, rl = cp.solve_lambda(
        t1, t2, er, w8aug._solver(n, nocc, nvir, 0, F64, None, lam=True),
        **w8aug.LAMBDA_TOL)
    assert r["ccsd_converged"] and rl["lambda_converged"]
    amps, _ = w8aug.stage_fp32(h2o, FROZEN, CPU, F64)
    for k, v in (("t1", t1), ("t2", t2), ("l1", l1), ("l2", l2)):
        assert _rel(amps[k], v.numpy()) < 1e-12, k


def test_fp32_stage_certified_in_fp64(h2o):
    nocc = int(h2o["nelectron"]) // 2 - FROZEN
    er, _ = cp.make_eris(h2o, FROZEN, F64, CPU)
    conv, e64, _, _ = rccsd.kernel(er, conv_tol=1e-10, conv_tol_normt=1e-8,
                                   max_cycle=100)
    assert conv
    amps, r = w8aug.stage_fp32(h2o, FROZEN, CPU, torch.float32)
    assert amps["t2"].dtype == np.float32 and r["lambda_converged"]
    assert amps["t1"].shape[0] == nocc
    e_lagr, _ = w8aug.stage_fp64(h2o, amps, FROZEN, CPU)
    assert abs(e_lagr - e64) < 1e-8
    # the certification is what brings the fp32 solve there
    assert abs(e_lagr - e64) < abs(r["e32"] - e64)


def test_checkpoint_files_and_resume(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("W8AUG_NTILE", str(NTILE))
    first = w8aug.run(CPU, scratch=str(tmp_path), **SMALL)
    with np.load(tmp_path / "scf.npz") as z:
        assert sorted(z.files) == ["B", "e_scf", "fock_ao", "mo_full",
                                   "nelectron"]
        assert float(z["e_scf"]) == first["e_scf"]
    with np.load(tmp_path / "amps_t.npz") as z:
        assert sorted(z.files) == ["e32", "t1", "t2"]
        assert float(z["e32"]) == first["e32"]
    with np.load(tmp_path / "amps.npz") as z:
        assert sorted(z.files) == ["e32", "l1", "l2", "t1", "t2"]
    assert not first["scf_reused"] and not first["ccsd_reused"]
    lines = [ln.split(" ", 1)[1] for ln in capsys.readouterr().out
             .splitlines() if ln.startswith("W8AUG ")]
    assert lines[0].startswith("capacity {") and len(lines) == 3
    stages = [json.loads(ln) for ln in lines[1:]]
    assert [d["stage"] for d in stages] == ["fp32_streamed", "fp64"]
    assert stages[0]["conv"] and stages[1]["e_lagr"] == first["e_lagr"]
    # a rerun after CCSD: the SCF and the CCSD amplitudes from the files
    os.remove(tmp_path / "amps.npz")
    again = w8aug.run(CPU, scratch=str(tmp_path), **SMALL)
    assert again["scf_reused"] and again["ccsd_reused"]
    assert again["e_lagr"] == first["e_lagr"]
    # the certification alone, from the files
    alone = w8aug.run(CPU, scratch=str(tmp_path), stage32=False, **SMALL)
    assert alone["e_lagr"] == first["e_lagr"]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "w8aug_stream_certify",
        os.path.join(ROOT, "examples", "w8aug_stream_certify.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_capacity_record_matches_jax(capsys):
    shape = (32, 696, 1568)
    rec = w8aug.capacity_record(*shape, 16, budget=60 * 2**30,
                                peaks={"ccsd": 1.0})
    gib = 2.0 ** 30
    assert rec["resident_model_gib"] * gib == jmem.ccsd_working_set_bytes(
        *shape, ntile=16)
    assert rec["streamed_model_gib"] * gib - rec["ring_gib"] * gib == \
        jmem.ccsd_working_set_bytes(*shape, ntile=16, stream_vv=True)
    jrec = _jax_script()._capacity_record(*shape, 16)
    for k in ("resident_model_gib", "ring_gib", "resident_total_gib",
              "streamed_model_gib"):
        assert round(rec[k], 2) == jrec[k], k
    assert rec["resident_fits"] and rec["peak_gib"] == {"ccsd": 1.0}
    assert "W8AUG capacity " in capsys.readouterr().out


def test_make_eris_streamed(h2o):
    st, rs = cp.make_eris(h2o, FROZEN, F64, CPU, stream_vv=True)
    res, rr = cp.make_eris(h2o, FROZEN, F64, CPU)
    assert st.Lvv is None and st.Lvv_stream is not None
    assert {k: rs[k] for k in ("nocc", "nvir", "naux")} == \
        {k: rr[k] for k in ("nocc", "nvir", "naux")} == \
        dict(nocc=4, nvir=36, naux=150)
    assert _rel(st.Lvv_stream.to_dense(), res.Lvv) < 1e-14
    assert _rel(st.oovv, res.oovv) < 1e-14


def test_ozaki_certification_is_not_ported(h2o, monkeypatch):
    monkeypatch.setenv("W8_STAGE64_BACKEND", "ozaki")
    with pytest.raises(NotImplementedError, match="rule 3"):
        w8aug.stage_fp64(h2o, {}, FROZEN, CPU)
