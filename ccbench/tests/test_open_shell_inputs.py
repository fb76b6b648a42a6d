"""CPU tests of the input maker's spin dispatch (``scf.make_inputs`` and
``uscf``): closed-shell inputs pinned to their values from before the
open-shell path existed, the DF-UHF against the port's on OH/cc-pVDZ, its
invariance under the seeded rigid motion, the UHF at spin 0 against the
RHF, and an open-shell cell added by files and entries alone.

Run from the checkout's root:  python -m pytest ccbench/tests -q
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from ccbench.harness import cell as cell_mod
from ccbench.harness import main
from ccbench.inputmaker import scf, uscf
from ccbench.inputmaker.mole import M

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "ccbench")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
DATA = os.path.join(BENCH_DIR, "tests", "data")
H2O_PATH = os.path.join(DATA, "h2o_vdz.json")
OH_PATH = os.path.join(DATA, "oh_vdz.json")
OH = json.load(open(OH_PATH))
CPU = torch.device("cpu")


# ------------------------------------------ (a) the closed shell is pinned

# H2O/cc-pVDZ at seed 7, made by make_inputs before it read a spin: the SCF
# energy and cycles, and the exact (fsum) sum and sum of squares of B, mo
# and fock_ao.  They are exact only where the arithmetic is fixed: the
# DF-RHF's DIIS solve, torch.linalg.lstsq's default CPU driver (gelsy),
# differs from run to run in its last bits, and MKL's and ATen's kernels
# differ between thread counts and instruction sets.  So the inputs are made
# in a fresh process with one thread, MKL's compatible mode, ATen's default
# kernels and the SVD driver (gelsd), which is reproducible.  The energy,
# orbitals and Fock matrix still take their last bits from the PyTorch
# build, so their pins are kept per build; B, from the benchmark's own
# integral library, and the cycle count read the same on every build here.
PINNED = {"scf_cycles": 13, "B": [206.9569090769, 55.07510631510804]}
PINNED_BY_BUILD = {
    "2.13.0+cpu": {"e_scf": -76.02676889763067,
                   "mo": [-3.231138897184465, 79.69683205998693],
                   "fock_ao": [-37.3173301284718, 610.170677515287]},
    "2.11.0+cu128": {"e_scf": -76.02676889763065,
                     "mo": [-7.263948306591625, 79.69683205998687],
                     "fock_ao": [-37.31733012846891, 610.1706775152521]},
}

PIN_CHILD = """
import json, math, sys, torch
sys.path.insert(0, {root!r})
lstsq = torch.linalg.lstsq
torch.linalg.lstsq = lambda a, b, **k: lstsq(a, b, driver="gelsd")
from ccbench.inputmaker import scf
inp = scf.make_inputs(json.load(open({cfg!r})), 7, torch.device("cpu"))
out = dict(e_scf=float(inp["e_scf"]), scf_cycles=inp["scf_cycles"])
for k in ("B", "mo", "fock_ao"):
    x = inp[k].flatten().tolist()
    out[k] = [math.fsum(x), math.fsum(v * v for v in x)]
print(json.dumps(out))
"""


def test_closed_shell_inputs_are_pinned():
    env = dict(os.environ, MKL_CBWR="COMPATIBLE",
               ATEN_CPU_CAPABILITY="default", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", PIN_CHILD.format(root=ROOT, cfg=H2O_PATH)],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True)
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {k: got[k] for k in PINNED} == PINNED
    pins = PINNED_BY_BUILD.get(torch.__version__, {})
    assert {k: got[k] for k in pins} == pins


# --------------------------------------------------- (b)-(d) the DF-UHF

def _port_uhf(cfg, seed):
    """The port's DF-UHF of ``cfg`` at the geometry of ``seed``: its
    energy and <S^2>."""
    from pyscf_mpcc_tpu_torch import gto
    from pyscf_mpcc_tpu_torch.scf import UHF
    atoms = scf.geometry(cfg["atoms"], seed, cfg["translation_angstrom"])
    mol = gto.M(atom=atoms, basis=cfg["basis"], spin=cfg["spin"])
    mf = UHF(mol).density_fit(cfg["auxbasis"]).run()
    assert mf.converged
    na, nb = mol.nelec
    ovlp = mf.mo_coeff[0][:, :na].T @ mf.S @ mf.mo_coeff[1][:, :nb]
    sz = 0.5 * (na - nb)
    return mf.e_tot, sz * (sz + 1) + nb - float(np.sum(ovlp * ovlp))


def test_uhf_inputs_per_spin_and_the_ports_uhf():
    inp = scf.make_inputs(OH, 7, CPU)
    nao = inp["nao"]
    assert inp["nocc"] == (5, 4) and inp["frozen"] == 0
    assert [c.shape for c in inp["mo"]] == [(nao, nao)] * 2
    assert [f.shape for f in inp["fock_ao"]] == [(nao, nao)] * 2
    assert inp["B"].shape == (inp["naux"], nao, nao)
    assert all(x.dtype == torch.float64 for x in inp["mo"] + inp["fock_ao"])
    e_port, s2_port = _port_uhf(OH, 7)
    assert abs(inp["e_scf"] - e_port) < 1e-9
    assert abs(inp["s2"] - s2_port) < 1e-7
    assert 0.75 < inp["s2"] < 0.76


def test_uhf_is_the_same_state_at_every_seed():
    a = scf.make_inputs(OH, 3, CPU)
    b = scf.make_inputs(OH, 2718281828459045, CPU)
    assert abs(a["e_scf"] - b["e_scf"]) < 1e-10
    assert abs(a["s2"] - b["s2"]) < 1e-8


def test_uhf_at_spin_0_is_the_rhf():
    cfg = json.load(open(H2O_PATH))
    atoms = scf.geometry(cfg["atoms"], 5, cfg["translation_angstrom"])
    mol = M(atom=atoms, basis=cfg["basis"])
    B = scf.df_factors(mol, cfg["auxbasis"], CPU)
    _, _, e_rhf, _ = scf.rhf(mol, B, CPU)
    _, _, e_uhf, s2, _ = uscf.uhf(mol, B, cfg["auxbasis"], CPU)
    assert abs(e_uhf - e_rhf) < 1e-10
    assert abs(s2) < 1e-8


def test_frozen_orbitals_are_cut_from_each_spin():
    inp = scf.make_inputs(dict(OH, frozen=1), 7, CPU)
    full = scf.make_inputs(OH, 7, CPU)
    assert inp["nocc"] == (4, 3)
    for cut, whole in zip(inp["mo"], full["mo"]):
        assert cut.shape[1] == whole.shape[1] - 1


# ------------------------------------- an open-shell cell added by files

# A test driver that runs nothing of the program: its unit reads the
# occupied-virtual block of each spin's MO Fock matrix, which a converged
# UHF leaves at zero.
BRILLOUIN_DRIVER = '''
import torch
from types import SimpleNamespace


def setup(ctx, inputs):
    ctx.rec.update(eris_s=0.0, warmup_s=0.0)
    na = inputs["nocc"][0]
    nv = inputs["mo"][0].shape[1] - na
    return dict(inputs=inputs,
                er=SimpleNamespace(Lov=torch.empty(inputs["naux"], na, nv)))


def unit(state, ctx):
    inp = state["inputs"]
    state["gap"] = max(float((c.T @ f @ c)[:n, n:].abs().max())
                       for c, f, n in zip(inp["mo"], inp["fock_ao"],
                                          inp["nocc"]))
    return dict(ok=True, count=dict(check=1))


def probe(state, ctx):
    pass


def answers(state):
    return state["gap"]


def judge(ctx, inputs, ans, names):
    return dict(brillouin=ans)
'''


def _files(root):
    """Relative paths of the files under ``root``, build outputs left out."""
    out = set()
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in ("__pycache__", "build")]
        out.update(os.path.relpath(os.path.join(d, f), root) for f in files)
    return out


def test_an_open_shell_cell_is_added_by_files_and_entries(tmp_path):
    """The OH configuration, a traffic mix, a limits file and a driver, the
    cell's entry and its end-to-end metric's entry in BENCHMARK.json: the
    cell runs, and no file of the harness differs from the tree's."""
    bench_dir = tmp_path / "ccbench"
    shutil.copytree(BENCH_DIR, bench_dir)
    added = {"configs/oh_vdz.json", "traffic/uhf_checks.json",
             "limits/oh_vdz.uhf.json", "drivers/brillouin.py"}
    shutil.copy(OH_PATH, bench_dir / "configs" / "oh_vdz.json")
    (bench_dir / "traffic" / "uhf_checks.json").write_text(json.dumps(dict(
        driver="brillouin", per="check", metric="uhf_check_s",
        trace_units=1)))
    (bench_dir / "limits" / "oh_vdz.uhf.json").write_text(json.dumps(
        {"compare": {"brillouin": {"limit": 1e-6, "lower": 0,
                                   "upper": 1}}}))
    (bench_dir / "drivers" / "brillouin.py").write_text(BRILLOUIN_DRIVER)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(name="oh_vdz.uhf", config="oh_vdz",
                                   traffic="uhf_checks", chips=1, why="t"))
    bench["end_to_end"].append(dict(
        name="uhf_check_s", unit="s", better="lower", bound=0.25,
        source="host_clock", workloads=["oh_vdz.uhf"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cell_mod.resolve("oh_vdz.uhf", bench_dir=str(bench_dir))
    out = main.run_cell(c, 2718281828459045, 0.0, 0, CPU,
                        time.perf_counter())
    assert out["correct"] and out["attempted"] == 1, out["checks"]
    assert set(out["metrics"]) == {"uhf_check_s", "setup_s"}
    assert _files(bench_dir) == _files(BENCH_DIR) | added
    for rel in _files(BENCH_DIR):
        assert (bench_dir / rel).read_bytes() == \
            open(os.path.join(BENCH_DIR, rel), "rb").read(), rel
