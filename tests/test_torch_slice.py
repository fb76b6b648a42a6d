"""The DF-CCSD(T) slice of the port end to end, and its standalone imports.

- The user entry points, RHF(mol).density_fit().run() -> CCSD(mf,
  device=cpu).run() -> .ccsd_t(), against the JAX package's RCCSDDriver
  on H2O/cc-pVDZ: E_corr to 1e-9 and E(T) to 1e-10.
- No module of the port (nor chip_smoke.py) imports jax or anything of
  the JAX package; a fresh interpreter runs a small synthetic CCSD(T)
  through the fused and resident engines, and Lambda and the Lagrangian
  energy with the device DIIS ring, with neither ever loaded.
- Without a device argument the entry points run on CUDA, and raise
  where there is no card.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import clean_child_env
from pyscf_mpcc_tpu import config as jconfig
from pyscf_mpcc_tpu import scf as jscf
from pyscf_mpcc_tpu.cc.driver import RCCSDDriver
from pyscf_mpcc_tpu.testutil import mol_of
from pyscf_mpcc_tpu_torch import config, testing
from pyscf_mpcc_tpu_torch.cc.driver import CCSD
from pyscf_mpcc_tpu_torch.lib.device import resolve
from pyscf_mpcc_tpu_torch.scf import RHF

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pyscf_mpcc_tpu_torch")
# modules of the JAX package the port may import: none (its host layers
# are copies inside the port)
ALLOWED = ()
# the modules of the Lambda, open-shell and spin-orbital slices: both
# import checks must reach them
LAMBDA_SLICE = ("cc.lambda_ad", "lib.device_diis", "lib.chkfile",
                "cc.spinsum", "cc.uccsd", "cc.uccsd_t", "mp.ump2",
                "mp.dfump2", "scf.diis", "cc.ccsd_t_rdm", "cc.uccsd_t_rdm",
                "cc.gccsd", "cc.qcisd", "cc.bccd", "cc.gccsd_t_rdm",
                "cc.addons", "scf.ghf", "cc.gccsd_slow", "ci.fci_slow",
                "cc.eom_slow", "cc.gccsdt1_slow", "cc.gccsdt_slow",
                "mp.mp2f12", "mp.gmp2", "mp.dfgmp2", "utils.profiling",
                "lib.linalg", "cc.eom", "cc.momgfccsd", "lib.hoststore",
                "cc.stream_ladder", "parallel.mesh", "parallel.distributed",
                "parallel.ladder_shard", "parallel.ccsd_shard",
                "examples.w8_parity_certify", "examples.w8_triples",
                "examples.w8_ccsd_pipeline", "examples.benzene",
                "examples.campaign", "lib.device_davidson",
                "examples.w8aug_stream_certify",
                "examples.properties_showcase", "examples.umpcc_o2",
                "tools.w8aug_fp64_ccsd")
# the JAX package's example scripts (the repo's examples/): the port's
# twins carry their own copies of what they take from them
ROOT_EXAMPLES = {"examples"} | {
    f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
    if f.endswith(".py")}


def test_df_slice_matches_jax_driver(monkeypatch):
    # the JAX memory planner falls back to 12 GiB on the CPU backend; give
    # both packages (each reads its own config) that budget so they plan
    # the same tiles
    monkeypatch.setattr(jconfig, "MAX_MEMORY", 12 * 1024)
    monkeypatch.setattr(config, "MAX_MEMORY", 12 * 1024)
    jmf = jscf.RHF(mol_of("sym")).density_fit().run()
    jcc = RCCSDDriver(jmf).run()
    jet = jcc.ccsd_t()
    mf = RHF(testing.mol_of("sym")).density_fit().run()
    assert abs(mf.e_tot - jmf.e_tot) < 1e-10
    cc = CCSD(mf, device=torch.device("cpu")).run()
    assert cc.converged and cc.t2.dtype == torch.float64
    et = cc.ccsd_t()
    assert abs(cc.e_corr - jcc.e_corr) < 1e-9
    assert abs(et - jet) < 1e-10
    assert abs(cc.e_tot - jcc.e_tot) < 1e-9


def _imports(path):
    """Fully qualified names imported by one source file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                yield f"{node.module}.{a.name}"


def _sources():
    yield os.path.join(ROOT, "chip_smoke.py")
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_port_imports_no_jax_statically():
    walked = set(_sources())
    for m in LAMBDA_SLICE:
        assert os.path.join(PKG, *m.split(".")) + ".py" in walked, m
    bad = []
    for path in _sources():
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib"):
                bad.append((path, name))
            elif top == "pyscf_mpcc_tpu" and not any(
                    name == a or name.startswith(a + ".") for a in ALLOWED):
                bad.append((path, name))
            elif top in ROOT_EXAMPLES:
                bad.append((path, name))
    assert not bad, bad


CHILD = f"LAMBDA_SLICE = {LAMBDA_SLICE!r}\n" + r"""
import sys
if "jax" in sys.modules:
    print("JAX_PRELOADED")
    raise SystemExit(0)
import importlib, pkgutil, torch
import pyscf_mpcc_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
for m in LAMBDA_SLICE:
    assert "pyscf_mpcc_tpu_torch." + m in sys.modules, m
from pyscf_mpcc_tpu_torch import testing
from pyscf_mpcc_tpu_torch.cc import ccsd_t, lambda_ad, rccsd
er = testing.synthetic_eris(4, 11, 30, device="cpu", build_ovvv=False)
conv, e, t1, t2 = rccsd.kernel(er, ntile=2, conv_tol=1e-10,
                               diis_backend="device")
et = ccsd_t.kernel(t1, t2, er, tile=4, engine="fused")
er_ = ccsd_t.kernel(t1, t2, er, tile=4, engine="resident")
assert conv and e < 0 and et < 0 and abs(er_ - et) < 1e-10, (conv, e, et)
cl, l1, l2 = lambda_ad.kernel(t1, t2, er, ntile=2, conv_tol=1e-8,
                              diis_backend="device")
el = float(lambda_ad.lagrangian_energy(t1, t2, l1, l2, er, ntile=2))
assert cl and abs(el - e) < 1e-9, (cl, el, e)
mol = pkg.M(atom="O 0 0 0; H 0 0.757 0.587; H 0 -0.757 0.587",
            basis="cc-pvdz")
from pyscf_mpcc_tpu_torch.scf import RHF
assert RHF(mol).density_fit().run().converged
from pyscf_mpcc_tpu_torch.cc import uccsd_t
from pyscf_mpcc_tpu_torch.cc.driver import CCSD
from pyscf_mpcc_tpu_torch.scf import UHF
umf = UHF(pkg.M(atom="O 0 0 0; O 0 0 1.21", basis="sto-3g", spin=2)).run()
ucc = CCSD(umf, device="cpu").run()
ul = lambda_ad.kernel_u(ucc.t1, ucc.t2, ucc.eris, diis_backend="device")
assert ucc.converged and ul[0] and ucc.ccsd_t(tile=2) < 0
assert "jax" not in sys.modules
assert not any(m == "pyscf_mpcc_tpu" or m.startswith("pyscf_mpcc_tpu.")
               for m in sys.modules), sorted(sys.modules)
print("NOJAX_OK", e, et)
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT,
                          env=clean_child_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    if "JAX_PRELOADED" in proc.stdout:
        pytest.skip("jax is loaded at interpreter start here")
    assert "NOJAX_OK" in proc.stdout


def test_entry_points_default_to_cuda():
    mf = RHF(testing.mol_of("sym"))
    mf.mo_coeff = np.eye(mf.mol.nao)
    if torch.cuda.is_available():
        assert CCSD(mf).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CCSD(mf)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve(None)
    assert resolve(torch.device("cpu")) == (torch.device("cpu"),
                                            torch.float64)


@pytest.mark.parametrize("entry", ["initialize", "make_mesh",
                                   "global_mesh"])
def test_parallel_entry_points_default_to_cuda(entry):
    """The multi-device layer's start-up resolves a missing device to the
    card, and raises where there is none, before it looks for a process
    group or a launcher's environment."""
    from pyscf_mpcc_tpu_torch.parallel import distributed, mesh
    fn = {"initialize": distributed.initialize, "make_mesh": mesh.make_mesh,
          "global_mesh": distributed.global_mesh}[entry]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would start a job")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


def _spinorb_entry_points():
    from pyscf_mpcc_tpu_torch import gto
    from pyscf_mpcc_tpu_torch.cc import bccd, gccsd, qcisd
    from pyscf_mpcc_tpu_torch.mp import dfgmp2, gmp2
    from pyscf_mpcc_tpu_torch.scf import convert_to_ghf
    from pyscf_mpcc_tpu_torch.scf.hf import _JKDF
    mf = RHF(gto.M(atom="H 0 0 0; H 0 0 0.74", basis="sto-3g")).run()
    blocks = {k: np.zeros((1, 1, 1, 1)) for k in gccsd.GERIs.BLOCKS}
    return {
        "GERIs": lambda: gccsd.GERIs(blocks, np.eye(2), 1),
        "GCCSD": lambda: gccsd.GCCSD(mf),
        "make_eris_ghf": lambda: gccsd.make_eris_ghf(convert_to_ghf(mf)),
        "QCISD": lambda: qcisd.QCISD(mf),
        "make_geris_rhf": lambda: qcisd.make_geris_rhf(mf),
        "bccd": lambda: bccd.kernel(mf, np.zeros((2,) * 4)),
        "GMP2": lambda: gmp2.GMP2(mf),
        "DFGMP2": lambda: dfgmp2.DFGMP2(mf),
        "spinorb_Lov": lambda: dfgmp2.spinorb_Lov(
            np.zeros((3, 2, 2)), np.eye(2), np.eye(2), (1, 1)),
        "JKDF": lambda: _JKDF(np.zeros((3, 2, 2)), device=True),
    }


@pytest.mark.parametrize("name", list(_spinorb_entry_points()))
def test_spinorb_entry_points_default_to_cuda(name):
    """The spin-orbital and (T)-response slice's device entry points
    resolve a missing device to the card (lib/device.resolve) and raise
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("the card is present; chip_smoke.py phase 11 runs these")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _spinorb_entry_points()[name]()


def _eom_stream_entry_points():
    from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
    from pyscf_mpcc_tpu_torch.lib.hoststore import HostStore
    from pyscf_mpcc_tpu_torch.examples import eom_benzene
    b = np.zeros((3, 2, 2))
    return {
        "make_eris_df_stream": lambda: eris_mod.make_eris_df(
            b, np.eye(2), np.eye(2), 1, stream_vv=True, device=None),
        "HostStore": lambda: HostStore.from_tensor(np.zeros((3, 2, 2)),
                                                   None),
        "eom_benzene": lambda: eom_benzene.main(["--device", "cuda"]),
    }


@pytest.mark.parametrize("name", list(_eom_stream_entry_points()))
def test_eom_stream_entry_points_default_to_cuda(name):
    """The EOM and out-of-core slice's device entry points resolve a
    missing device to the card (lib/device.resolve) and raise where there
    is none."""
    if torch.cuda.is_available():
        pytest.skip("the card is present; chip_smoke.py phase 12 runs these")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _eom_stream_entry_points()[name]()


def _campaign_entry_points():
    from pyscf_mpcc_tpu_torch.examples import benzene as bz
    from pyscf_mpcc_tpu_torch.examples import properties_showcase as ps
    from pyscf_mpcc_tpu_torch.examples import umpcc_o2
    from pyscf_mpcc_tpu_torch.examples import w8_ccsd_pipeline as pipe
    from pyscf_mpcc_tpu_torch.examples import w8_parity_certify as w8
    from pyscf_mpcc_tpu_torch.examples import w8_triples as w8t
    from pyscf_mpcc_tpu_torch.examples import w8aug_stream_certify as w8aug
    from pyscf_mpcc_tpu_torch.tools import w8aug_fp64_ccsd
    scf = {"nelectron": 2}
    return {
        "w8_run": lambda: w8.run(),
        "w8_main": lambda: w8.main([]),
        "w8_stage_fp32": lambda: w8.stage_fp32(scf, 0),
        "w8_certify": lambda: w8.certify(scf, {}, 0),
        "w8_triples_run": lambda: w8t.run(),
        "w8_triples_main": lambda: w8t.main([]),
        "w8_pipeline_run": lambda: pipe.run(),
        "w8_pipeline_main": lambda: pipe.main(["--full"]),
        "benzene_run": lambda: bz.run(),
        "benzene_main": lambda: bz.main(["--certify", "--triples"]),
        "benzene_stage64": lambda: bz.main(["--stage64"]),
        "benzene_scf_only": lambda: bz.main(["--scf-only"]),
        "w8aug_run": lambda: w8aug.run(),
        "w8aug_main": lambda: w8aug.main([]),
        "w8aug_stage32": lambda: w8aug.main(["--stage32"]),
        "w8aug_stage64": lambda: w8aug.main(["--stage64"]),
        "w8aug_scf_stage": lambda: w8aug.scf_stage(),
        "w8aug_stage_fp32": lambda: w8aug.stage_fp32(scf, 0),
        "w8aug_stage_fp64": lambda: w8aug.stage_fp64(scf, {}, 0),
        "w8aug_fp64_ccsd": lambda: w8aug_fp64_ccsd.main([]),
        "properties_run": lambda: ps.run(),
        "properties_main": lambda: ps.main([]),
        "properties_dfmp2_stage": lambda: ps.dfmp2_stage(),
        "properties_ccsd_stage": lambda: ps.ccsd_stage(),
        "umpcc_o2_run": lambda: umpcc_o2.run(),
        "umpcc_o2_main": lambda: umpcc_o2.main([]),
    }


@pytest.mark.parametrize("name", list(_campaign_entry_points()))
def test_campaign_entry_points_default_to_cuda(name):
    """The campaigns' entry points ((H2O)8: the certified CCSD, the full
    (T), the CCSD(T) pipeline; benzene end to end; (H2O)8/aug-cc-pVTZ
    streamed and certified; the property showcase and triplet-O2 UMPCC)
    resolve a missing device to the card (lib/device.resolve) and raise
    where there is none, before any SCF or checkpoint work."""
    if torch.cuda.is_available():
        pytest.skip("the card is present; chip_smoke.py phases 15-19 run "
                    "these")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _campaign_entry_points()[name]()
