"""The port's benzene campaign script (pyscf_mpcc_tpu_torch/examples/
benzene.py) on the CPU in fp64 at benzene/6-31g (nao 66; nocc 21, nvir 45,
naux 360; 56 (T) tiles of edge 8), against the JAX package.

- The geometry and the reference rows equal examples/benzene_chip.py's.
- run(cpu, '6-31g') with the (T) on the fused engine (its plain versions
  on the CPU; ccsd_t.auto_engine answers as on the card) against the JAX
  package's functions on the same SCF arrays (the port's checkpoint):
  E_SCF within 1e-9 of JAX's own DF-RHF; DF-MP2, E_corr(CCSD), E(T)
  (JAX's engine='xla') and the certified E_L each within rtol 1e-10.  The
  JAX references are computed once (module fixture).
- The BENZENE line holds every key of the JAX script's line; 6-31g has no
  reference row, so speedup_vs_reference is null with the JAX script's
  warning.
- A second run reuses the SCF file and gives the same E_L bit for bit;
  --stage64 certifies from the checkpoint alone; --scf-only gives the
  same E_SCF.
- run() and main() with no device raise on a machine without a card:
  tests/test_torch_slice.py's test_campaign_entry_points_default_to_cuda.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.cc import ccsd_t as jccsd_t
from pyscf_mpcc_tpu.cc import eris as jeris_mod
from pyscf_mpcc_tpu.cc import lambda_ad as jlam
from pyscf_mpcc_tpu.cc import rccsd as jrccsd
from pyscf_mpcc_tpu.mp import mp2 as jmp2
from pyscf_mpcc_tpu.scf import RHF as JRHF
from pyscf_mpcc_tpu_torch.cc import ccsd_t
from pyscf_mpcc_tpu_torch.examples import benzene as bz

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, "examples", "benzene_chip.py")
CPU = torch.device("cpu")
BASIS = "6-31g"
RTOL = 1e-10


def _jax_script():
    spec = importlib.util.spec_from_file_location("benzene_chip", JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_line_keys():
    """The keys of the JAX script's BENZENE line: the keywords of its
    ``out = dict(...)`` and every ``out["key"] = ...``."""
    keys = set()
    for node in ast.walk(ast.parse(open(JAX_SCRIPT).read())):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "id", None) == "dict"
                and getattr(node.targets[0], "id", None) == "out"):
            keys |= {kw.arg for kw in node.value.keywords}
        if (isinstance(node, ast.Subscript)
                and getattr(node.value, "id", None) == "out"
                and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return keys


def _run_main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = bz.main(argv)
    return ret, buf.getvalue()


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's run at 6-31g with the (T) through the fused engine, its
    stdout, and its checkpoint directory."""
    scratch = str(tmp_path_factory.mktemp("benzene"))
    orig = ccsd_t.auto_engine
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ccsd_t, "auto_engine",
                   lambda dt, *a, **k: orig("cuda", *a, **k))
        with contextlib.redirect_stdout(buf):
            r = bz.run(CPU, BASIS, certify=True, triples=True,
                       scratch=scratch)
    return dict(r=r, stdout=buf.getvalue(), scratch=scratch)


@pytest.fixture(scope="module")
def jax_ref(port):
    """The JAX package's DF-RHF of the same molecule, and its DF-MP2,
    CCSD, (T) (engine='xla'), Lambda and Lagrangian energy on the port's
    SCF arrays, at the script's tolerances on the device ring."""
    mol = jgto.M(atom=bz.BENZENE, basis=BASIS, unit="angstrom")
    mf = JRHF(mol).density_fit()
    mf.conv_tol = 1e-10
    mf.kernel()
    assert mf.converged
    scf = bz.load_scf(bz._paths(port["scratch"], BASIS)[0])
    nocc = int(scf["nelectron"]) // 2
    er = jeris_mod.make_eris_df(scf["B"], scf["mo_full"], scf["fock_ao"],
                                nocc, keep_ovvv=False)
    e_mp2, _ = jmp2.df_kernel(er.mo_energy[:nocc], er.mo_energy[nocc:],
                              er.Lov)
    conv, e_cc, t1, t2 = jrccsd.kernel(er, ntile=1, diis_backend="device",
                                       diis_space=6, **bz.CCSD_TOL)
    assert conv
    e_t = jccsd_t.kernel(t1, t2, er, tile=8, engine="xla")
    cl, l1, l2 = jlam.kernel(t1, t2, er, ntile=1, diis_backend="device",
                             diis_space=6, **bz.LAMBDA_TOL)
    assert cl
    e_l = jlam.lagrangian_energy(t1, t2, l1, l2, er)
    return dict(e_scf=float(mf.e_tot), e_corr_mp2_fp32=float(e_mp2),
                e_corr_fp32=float(e_cc), e_t_fp32=float(e_t),
                e_corr_fp64_lagrangian=float(jnp.asarray(e_l)))


def test_geometry_and_reference_rows_equal_the_jax_script():
    ref = _jax_script()
    assert bz.BENZENE == ref.BENZENE
    assert bz._REFERENCE_ROWS == ref._REFERENCE_ROWS


def test_scf_matches_jax(port, jax_ref):
    r = port["r"]
    assert r["scf_converged"] and not r["scf_reused"]
    assert (r["nao"], r["nocc"], r["nvir"], r["naux"]) == (66, 21, 45, 360)
    assert abs(r["e_scf"] - jax_ref["e_scf"]) < 1e-9


@pytest.mark.parametrize("key", ["e_corr_mp2_fp32", "e_corr_fp32",
                                 "e_t_fp32", "e_corr_fp64_lagrangian"])
def test_energies_match_jax(port, jax_ref, key):
    r = port["r"]
    assert r["converged"] and r["lambda_converged"]
    assert r["dtype"] == "torch.float64"
    assert abs(r[key] - jax_ref[key]) <= RTOL * abs(jax_ref[key]), key


def test_triples_ran_on_the_fused_engine(port):
    r = port["r"]
    assert (r["triples_engine"], r["triples_tile"],
            r["triples_tiles"]) == ("fused", 8, 56)
    # the CPU runs the plain versions, which count no launch
    assert r["triples_launches"] == 0


def test_line_holds_every_jax_key(port):
    lines = [ln for ln in port["stdout"].splitlines()
             if ln.startswith("BENZENE ")]
    assert len(lines) == 1
    line = json.loads(lines[0][len("BENZENE "):])
    keys = _jax_line_keys()
    assert {"e_t_fp32", "e_corr_fp64_lagrangian", "speedup_vs_reference",
            "total_wall_sec"} <= keys
    assert keys <= set(line)
    assert line == json.loads(json.dumps(port["r"]))
    for k in ("ccsd_cycles", "lambda_cycles", "stage_s", "peak_gib",
              "triples_ms_per_tile", "ccsd_normt", "lambda_dl"):
        assert k in line


def test_unknown_basis_has_no_speedup(port):
    r = port["r"]
    assert r["reference_ccsd_sec"] is None
    assert r["speedup_vs_reference"] is None
    assert ("WARNING: no reference benchmark row for basis '6-31g' -- "
            "speedup columns will be null") in port["stdout"]
    assert "d_scf_vs_pin" not in r


def test_checkpoint_files(port):
    scf_path, amps_path = bz._paths(port["scratch"], BASIS)
    with np.load(scf_path) as z:
        assert sorted(z.files) == ["B", "e_scf", "fock", "mo", "nelectron"]
        assert float(z["e_scf"]) == port["r"]["e_scf"]
    with np.load(amps_path) as z:
        assert sorted(z.files) == ["e32", "l1", "l2", "t1", "t2"]
        assert float(z["e32"]) == port["r"]["e_corr_fp32"]
        assert z["t2"].shape == (21, 21, 45, 45)


def test_second_run_reuses_the_scf(port):
    r2, out = _run_main(["--basis", BASIS, "--device", "cpu", "--certify",
                         "--scratch", port["scratch"]])
    assert r2["scf_reused"] and "e_t_fp32" not in r2
    assert r2["e_scf"] == port["r"]["e_scf"]
    assert (r2["e_corr_fp64_lagrangian"]
            == port["r"]["e_corr_fp64_lagrangian"])
    assert out.splitlines()[-1].startswith("BENZENE ")


def test_stage64_certifies_from_the_checkpoint(port):
    e_l, out = _run_main(["--stage64", "--basis", BASIS, "--device", "cpu",
                          "--scratch", port["scratch"]])
    assert e_l == port["r"]["e_corr_fp64_lagrangian"]
    assert out.strip() == f"E_LAGR64 {e_l:.12f}"


def test_scf_only_gives_the_same_energy(port, tmp_path):
    e, out = _run_main(["--scf-only", "--basis", BASIS, "--device", "cpu",
                        "--scratch", str(tmp_path)])
    assert out.strip() == "E(DF-RHF) = %.10f" % e
    assert os.path.exists(bz._paths(str(tmp_path), BASIS)[0])
    assert abs(e - port["r"]["e_scf"]) < 1e-12
