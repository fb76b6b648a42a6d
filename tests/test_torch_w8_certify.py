"""The port's certified (H2O)8 campaign script
(pyscf_mpcc_tpu_torch/examples/w8_parity_certify.py) on the CPU at small
sizes, against the JAX package where it has a counterpart.

- The cube-cluster geometries the script copies equal those of the JAX
  package's examples/w8_ccsd_pipeline.py exactly.
- H2O/cc-pVDZ with DF (weigend) and one frozen core orbital, the
  smallest molecule of tests/test_torch_lambda.py's fixtures: on the same
  B, mo and fock (fp64 numpy from the script's build_mf), stage_fp32 at
  fp64 (device DIIS rings of six slots, ladder tiles 3 through the
  W8_NTILE knobs) and certify against JAX's rccsd.kernel,
  lambda_ad.kernel and lambda_ad.lagrangian_energy on the same settings:
  energies and amplitudes within 1e-10.  The JAX reference is computed
  once (module fixture).
- The stage in fp32, certified in fp64, within 1e-8 of the fp64 CCSD
  energy converged to 1e-10.
- run(small=True) writes scf.npz and amps.npz in the stated format, and
  --reuse-scf from them gives the same certified energy bit for bit.
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
from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
from pyscf_mpcc_tpu_torch.cc import rccsd
from pyscf_mpcc_tpu_torch.examples import w8_parity_certify as w8

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
H2O = [["O", (0.0, 0.0, 0.0)], ["H", (0.0, -0.757, 0.587)],
       ["H", (0.0, 0.757, 0.587)]]
FROZEN, NTILE = 1, 3
# the campaign's tolerances (the script's defaults)
CCSD_TOL = dict(conv_tol=1e-6, conv_tol_normt=1.5e-4, max_cycle=80)
LAMBDA_TOL = dict(conv_tol=1e-4, max_cycle=80)


def _pipeline():
    spec = importlib.util.spec_from_file_location(
        "w8_ccsd_pipeline", os.path.join(ROOT, "examples",
                                         "w8_ccsd_pipeline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_geometries_equal_the_jax_example():
    ref = _pipeline()
    assert w8.W8_GEOM == ref.W8_GEOM
    assert w8.W2_GEOM == ref.W2_GEOM
    assert len(w8.W8_GEOM) == 24


@pytest.fixture(scope="module")
def h2o():
    """The script's DF-RHF of H2O/cc-pVDZ (host J/K): the scf.npz dict."""
    scf, r = w8.build_mf(H2O, "cc-pvdz", "weigend")
    assert r["scf_converged"] and r["scf_cycles"] > 0
    return scf


@pytest.fixture(scope="module")
def jax_ref(h2o):
    """JAX's CCSD, Lambda and Lagrangian energy on the same B, mo and
    fock, the device rings and tiles of the port's stage."""
    nocc = int(h2o["nelectron"]) // 2 - FROZEN
    er = jeris_mod.make_eris_df(h2o["B"], h2o["mo_full"][:, FROZEN:],
                                h2o["fock_ao"], nocc, keep_ovvv=False)
    conv, e, t1, t2 = jrccsd.kernel(er, ntile=NTILE, diis_backend="device",
                                    diis_space=6, **CCSD_TOL)
    cl, l1, l2 = jlam.kernel(t1, t2, er, ntile=NTILE, diis_backend="device",
                             diis_space=6, **LAMBDA_TOL)
    el = float(jlam.lagrangian_energy(t1, t2, l1, l2, er, ntile=NTILE))
    assert conv and cl
    return dict(e32=float(e), e_lagr=el,
                **{k: np.asarray(v) for k, v in
                   (("t1", t1), ("t2", t2), ("l1", l1), ("l2", l2))})


def test_stage_and_certify_match_jax(h2o, jax_ref, monkeypatch):
    monkeypatch.setenv("W8_NTILE", str(NTILE))
    monkeypatch.setenv("W8_LAMBDA_NTILE", str(NTILE))
    amps, r = w8.stage_fp32(h2o, FROZEN, CPU, torch.float64)
    assert r["ccsd_converged"] and r["lambda_converged"]
    assert r["ccsd_diis"] == dict(backend="device", space=6, err_dtype="None",
                                  ntile=NTILE, resumed=False)
    assert r["lambda_diis"]["ntile"] == NTILE
    assert abs(r["e32"] - jax_ref["e32"]) < 1e-10
    for k in ("t1", "t2", "l1", "l2"):
        assert amps[k].dtype == np.float64
        assert np.abs(amps[k] - jax_ref[k]).max() < 1e-10, k
    e_lagr, rc = w8.certify(h2o, amps, FROZEN, CPU)
    assert abs(e_lagr - jax_ref["e_lagr"]) < 1e-10
    assert rc["e_lagr"] == e_lagr


def test_fp32_stage_certified_in_fp64(h2o):
    nocc = int(h2o["nelectron"]) // 2 - FROZEN
    er = eris_mod.make_eris_df(h2o["B"], h2o["mo_full"][:, FROZEN:],
                               h2o["fock_ao"], nocc, keep_ovvv=False,
                               device=CPU)
    conv, e64, _, _ = rccsd.kernel(er, conv_tol=1e-10, conv_tol_normt=1e-8,
                                   max_cycle=100)
    assert conv
    amps, r = w8.stage_fp32(h2o, FROZEN, CPU, torch.float32)
    assert amps["t2"].dtype == np.float32 and r["lambda_converged"]
    e_lagr, _ = w8.certify(h2o, amps, FROZEN, CPU)
    assert abs(e_lagr - e64) < 1e-8
    # the certification is what brings the fp32 solve there
    assert abs(e_lagr - e64) < abs(r["e32"] - e64)


def test_reuse_scf_gives_the_same_energy(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("W8_SCRATCH", str(tmp_path))
    first = w8.run(CPU, small=True)
    d = tmp_path / "small"
    with np.load(d / "scf.npz") as z:
        assert sorted(z.files) == ["B", "e_scf", "fock_ao", "mo_full",
                                   "nelectron"]
        assert float(z["e_scf"]) == first["e_scf"]
    with np.load(d / "amps.npz") as z:
        assert sorted(z.files) == ["e32", "l1", "l2", "t1", "t2"]
        assert float(z["e32"]) == first["e32"]
    assert (first["nocc"], first["nvir"]) == (8, 38)
    assert first["ccsd_converged"] and first["lambda_converged"]
    capsys.readouterr()
    again = w8.main(["--small", "--device", "cpu", "--reuse-scf"])
    assert json.loads(capsys.readouterr().out) == again
    assert again["scf_reused"] and again["amps_reused"]
    assert again["e_lagr"] == first["e_lagr"]
