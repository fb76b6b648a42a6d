"""CPU tests of the benchmark harness (ccbench/): the cells resolve through
their files, the last line has the contract's keys, the port agrees with
the plain reference on H2O/cc-pVDZ for each kind of traffic, a broken
timed path is judged incorrect, a run loads nothing of JAX, the reference
loads nothing of the program, and the frozen counts match a hand count.

Run from the checkout's root:  python -m pytest ccbench/tests -q
The tests marked ``cuda`` run the correctness control on the card.
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from ccbench.harness import cell as cell_mod
from ccbench.harness import counts, devtrace, main

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "ccbench")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
DATA = os.path.join(BENCH_DIR, "tests", "data")
H2O = json.load(open(os.path.join(DATA, "h2o_vdz.json")))
# the (T) cell's files are in ccbench/, its entries (left out of
# BENCHMARK.json while its host-paced spread exceeds any bound) here
TRIPLES = json.load(open(os.path.join(DATA, "triples_entries.json")))
WITH_T = {k: v + TRIPLES.get(k, []) if isinstance(v, list) else v
          for k, v in BENCH.items()}
CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# one cell of each traffic kind, the last line's numbers each compares
KINDS = {"ccsd_cycles": "benzene_vtz.ccsd", "lambda_cycles": "w8_vtz.lambda",
         "triples_energies": "benzene_vtz.triples"}


def h2o_cell(workload, limit=1e-7):
    """The cell ``workload`` run on H2O/cc-pVDZ in fp64, every number it
    compares held to ``limit``."""
    c = cell_mod.resolve(workload, WITH_T)
    c.config = H2O
    c.limits = {"compare": {k: {"limit": limit} for k in c.limits["compare"]}}
    return c


def run_h2o(workload, trace=0, seconds=0.0, limit=1e-7):
    return main.run_cell(h2o_cell(workload, limit), 2718281828459045,
                         seconds, trace, CPU, time.perf_counter())


# --------------------------------------------------------------- contract

def test_benchmark_json_follows_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "ccbench/run.py"]
    assert BENCH["paths"] == ["ccbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    ncell = 24
    assert ((2 + 14 * ncell) * (BENCH["run_seconds"] + 60)
            + ncell * 180 + 1200) <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("ccbench/")
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] \
            == c["reduced"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", CELLS):
            wl = e2e[m["moves"]].get("workloads", CELLS)
            assert w in wl, (m["name"], w)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 and len(w["why"]) <= 200
               for w in BENCH["workloads"])


@pytest.mark.parametrize("workload", CELLS + ["benzene_vtz.triples"])
def test_cell_resolves_through_its_files(workload):
    c = cell_mod.resolve(workload, WITH_T)
    for fn in ("setup", "unit", "probe", "answers", "judge"):
        assert callable(getattr(c.driver, fn))
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and c.traffic["metric"] in reported
    assert len(reported) >= 2 and c.per_layer
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    assert c.limits["compare"]
    for v in c.limits["compare"].values():
        assert v["lower"] < v["limit"] < v["upper"]


def test_readers_return_nothing_without_data():
    rec = dict(shape=(10, 2, 5), per_unit_s=1.0, units=[{}])
    for m in WITH_T["per_layer"]:
        if m["name"].startswith("mfu."):
            continue
        reader = cell_mod._load_module(
            os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"), "r")
        assert reader.read(rec) is None, m["name"]


# ---------------------------------------------------------- the last line

def test_last_line_keys_and_trace_metrics(cpu_budget):
    out = run_h2o("w8_vtz.ccsd")
    assert list(out)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"ccsd_cycle_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    traced = run_h2o("benzene_vtz.ccsd", trace=1)
    assert traced["correct"]
    assert {"eris_s", "warmup_s", "sweep_s.ccsd_cycle",
            "ccsd_cycles.ccsd_cycle", "cycle_rest_s.ccsd_cycle",
            "sweep_roofline.ccsd_cycle"} <= set(traced["metrics"])


def test_without_a_card_the_run_prints_no_result(tmp_path):
    """run.py exits non-zero with nothing on stdout where there is no
    card, and in a directory that holds only the benchmark's files."""
    for root in (ROOT, str(tmp_path)):
        if root != ROOT:
            shutil.copytree(BENCH_DIR, os.path.join(root, "ccbench"))
            shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
        proc = subprocess.run(
            [sys.executable, "ccbench/run.py", "--workload", CELLS[0],
             "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=root,
            capture_output=True, text=True,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert proc.returncode != 0 and proc.stdout.strip() == ""


# ------------------------------------------- the port against the reference

@pytest.mark.parametrize("traffic", sorted(KINDS))
def test_port_agrees_with_reference(traffic, cpu_budget):
    out = run_h2o(KINDS[traffic])
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


def test_reference_is_the_port_function_for_function(cpu_budget):
    """At one random amplitude point the reference's residual, Lambda
    residual and (T) energy are the port's to rounding (fp64)."""
    from ccbench.inputmaker import scf
    from ccbench.reference import ccsd as ref
    from ccbench.reference import triples as ref_t
    from pyscf_mpcc_tpu_torch.cc import ccsd_t, lambda_ad
    from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
    inp = scf.make_inputs(H2O, 7, CPU)
    er = eris_mod.make_eris_df(inp["B"], inp["mo"], inp["fock_ao"],
                               inp["nocc"], dtype=torch.float64,
                               keep_ovvv=False, device=CPU)
    ints = ref.mo_ints(inp["B"], inp["mo"], inp["fock_ao"], inp["nocc"])
    g = torch.Generator().manual_seed(0)
    o, v = ints.fov.shape
    t1, l1 = 0.02 * torch.randn(2, o, v, generator=g, dtype=torch.float64)
    t2, l2 = 0.02 * torch.randn(2, o, o, v, v, generator=g,
                                dtype=torch.float64)
    t2 = 0.5 * (t2 + t2.permute(1, 0, 3, 2))
    l2 = 0.5 * (l2 + l2.permute(1, 0, 3, 2))
    for a, b in zip(lambda_ad.residual(t1, t2, er, ntile=2),
                    ref.residual(t1, t2, ints)):
        assert torch.allclose(a, b, rtol=0, atol=1e-13)
    _, _, s1, s2, _ = lambda_ad._lambda_step(l1, l2, t1, t2, er, ntile=2)
    for a, b in zip((s1, s2), ref.lambda_residual(t1, t2, l1, l2, ints)):
        assert torch.allclose(a, b, rtol=0, atol=1e-13)
    e_port = ccsd_t.kernel(t1, t2, er, tile=4, engine="xla")
    assert abs(e_port - ref_t.energy(t1, t2, ints, rows=3)) < 1e-14


# ------------------------------------------------ a broken timed path fails

def _faults():
    from pyscf_mpcc_tpu_torch.cc import ccsd_t, lambda_ad, rccsd

    def unchanged_update(t1, t2, eris, *a, **k):
        return t1.clone(), t2.clone()

    def unchanged_lambda(l1, l2, *a, **k):
        z = torch.zeros((), dtype=l2.dtype)
        return l1.clone(), l2.clone(), torch.zeros_like(l1), \
            torch.zeros_like(l2), z

    real_kernel, real_t = rccsd.kernel, ccsd_t.kernel

    def t2_altered(*a, **k):
        conv, e, t1, t2 = real_kernel(*a, **k)
        t2 = t2.clone()
        t2[0, 0, 0, 0] += 1e-3
        return conv, e, t1, t2

    def energy_altered(*a, **k):
        conv, e, t1, t2 = real_kernel(*a, **k)
        return conv, e + 1e-5, t1, t2

    def triples_altered(*a, **k):
        return real_t(*a, **k) + 1e-6

    return {
        "ccsd_state_unchanged": ("w8_vtz.ccsd", rccsd, "update_amps",
                                 unchanged_update),
        "ccsd_amplitude_altered": ("w8_vtz.ccsd", rccsd, "kernel",
                                   t2_altered),
        "ccsd_energy_altered": ("benzene_vtz.ccsd", rccsd, "kernel",
                                energy_altered),
        "lambda_state_unchanged": ("w8_vtz.lambda", lambda_ad,
                                   "_lambda_step", unchanged_lambda),
        "triples_energy_altered": ("benzene_vtz.triples", ccsd_t, "kernel",
                                   triples_altered),
    }


FAULTS = ["ccsd_state_unchanged", "ccsd_amplitude_altered",
          "ccsd_energy_altered", "lambda_state_unchanged",
          "triples_energy_altered"]


@pytest.mark.parametrize("fault", FAULTS)
def test_broken_timed_path_is_judged_incorrect(fault, cpu_budget,
                                               monkeypatch):
    """The rest of a run (inputs, set-up, window, reference, judgement)
    with the timed path broken underneath: correct comes out false.  The
    cells' own limits are used, on H2O."""
    workload, mod, attr, fn = _faults()[fault]
    c = cell_mod.resolve(workload, WITH_T)
    c.config = H2O
    monkeypatch.setattr(mod, attr, fn)
    out = main.run_cell(c, 31415926535897, 0.0, 0, CPU, time.perf_counter())
    assert not out["correct"], out["checks"]


def test_sound_h2o_runs_pass_the_cells_limits(cpu_budget):
    """The same runs without a fault pass the cells' own limits."""
    for workload in sorted(set(v[0] for v in _faults().values())):
        c = cell_mod.resolve(workload, WITH_T)
        c.config = H2O
        out = main.run_cell(c, 31415926535897, 0.0, 0, CPU,
                            time.perf_counter())
        assert out["correct"], (workload, out["checks"])


# ------------------------------------------------------ import boundaries

def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_and_reference_imports_no_program():
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            tops = set(_imports(path))
            assert not tops & set(main.FORBIDDEN), path
            rel = os.path.relpath(path, BENCH_DIR)
            if rel.startswith(("reference", "inputmaker")):
                assert "pyscf_mpcc_tpu_torch" not in tops, path


CHILD = """
import sys, time, json, torch
sys.path.insert(0, {root!r})
from pyscf_mpcc_tpu_torch import config
config.MAX_MEMORY = 2000
from ccbench.harness import cell, main
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""

RUN = """
c = cell.resolve("benzene_vtz.triples", {bench})
c.config = json.load(open({h2o!r}))
c.limits = {{"compare": {{k: {{"limit": 1.0}} for k in c.limits["compare"]}}}}
main.run_cell(c, 5, 0.0, 0, torch.device("cpu"), time.perf_counter())
"""

REFERENCE_ONLY = """
import sys, torch
sys.path.insert(0, {root!r})
from ccbench.inputmaker import scf
from ccbench.reference import ccsd, triples
import json
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_and_the_reference_no_program():
    h2o = os.path.join(BENCH_DIR, "tests", "data", "h2o_vdz.json")
    src = CHILD.format(root=ROOT, body=RUN.format(h2o=h2o, bench=WITH_T))
    proc = subprocess.run([sys.executable, "-c", src], cwd=ROOT,
                          capture_output=True, text=True, check=True)
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "pyscf_mpcc_tpu_torch" in tops
    assert not tops & set(main.FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c",
                           REFERENCE_ONLY.format(root=ROOT)], cwd=ROOT,
                          capture_output=True, text=True, check=True)
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not tops & ({"pyscf_mpcc_tpu_torch"} | set(main.FORBIDDEN))


# --------------------------------------------------- adding a cell by files

def test_a_cell_is_added_by_files_and_entries(tmp_path, cpu_budget):
    """A new configuration, traffic mix and limits file, the cell's entry
    and its end-to-end metric's entry in BENCHMARK.json: no file of the
    harness is edited."""
    bench_dir = tmp_path / "ccbench"
    shutil.copytree(BENCH_DIR, bench_dir)
    shutil.copy(os.path.join(DATA, "h2o_vdz.json"),
                bench_dir / "configs" / "h2o_vdz.json")
    (bench_dir / "traffic" / "ccsd_solves.json").write_text(json.dumps(dict(
        driver="ccsd", per="solve", metric="ccsd_solve_s", trace_units=1)))
    (bench_dir / "limits" / "h2o_vdz.solves.json").write_text(json.dumps(
        {"compare": {"ccsd_step": {"limit": 1e-7, "lower": 0,
                                   "upper": 1}}}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(name="h2o_vdz.solves", config="h2o_vdz",
                                   traffic="ccsd_solves", chips=1, why="t"))
    bench["end_to_end"].append(dict(
        name="ccsd_solve_s", unit="s", better="lower", bound=0.25,
        source="host_clock", workloads=["h2o_vdz.solves"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cell_mod.resolve("h2o_vdz.solves", bench_dir=str(bench_dir))
    out = main.run_cell(c, 11, 0.0, 0, CPU, time.perf_counter())
    assert out["correct"]
    assert set(out["metrics"]) == {"ccsd_solve_s", "setup_s"}


# ----------------------------------------------------------------- counts

def test_counts_match_a_hand_count():
    no, nv, nx = 2, 3, 4
    ladder = nx * 81 + 4 * 81                   # naux nv^4 + no^2 nv^4
    rest = (2 * nx * 4 * 9 * 6 + 2 * nx * 2 * 9 * 4 + 2 * 8 * 27 * 8
            + 2 * 16 * 9 * 3 + 2 * 8 * 9 * 6 + 2 * 4 * 27 * 2)
    assert counts.sweep_flops(no, nv, nx) == ladder + rest
    # Lvv Lov Loo; ovov oovv; ovoo oooo; fock; t1 t2 in and out
    nbytes = (nx * (9 + 6 + 4) + 2 * 36 + 24 + 16 + 25 + 2 * (6 + 36)) * 4
    assert counts.sweep_bytes(no, nv, nx) == nbytes
    # one triple a > b > c at nvir 3; six W terms of 2 no^3 nv + 2 no^4
    assert counts.triples_flops(no, nv) == 6 * (2 * 8 * 3 + 2 * 16)
    assert counts.triples_bytes(no, nv, nx) == (
        6 + 2 * 36 + 24 + nx * (6 + 9) + 2 + 3) * 4 + 8
    assert counts.least_time(989e12, 0.0) == pytest.approx(1.0)


def test_device_trace_reduction():
    class Ev:
        def __init__(self, start, dur, name):
            self.s, self.d, self.n = start, dur, name

        def device_type(self):
            return "DeviceType.CUDA"

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.d

        def name(self):
            return self.n

    evs = [Ev(0, 100, "void gemm<float>(x)"), Ev(50, 100, "copy"),
           Ev(400, 100, "void combine_kernel<float>(Args)"),
           Ev(600, 50, "Memcpy DtoH")]
    r = devtrace.reduce(evs, 1e-6)
    assert r["busy_s"] == pytest.approx(300e-9)
    assert r["kernel_s"] == pytest.approx(300e-9)
    assert r["idle_gaps"][0] == ["copy -> combine_kernel",
                                 pytest.approx(250e-9)]


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_judged_incorrect(workload):
    """The correctness control at the cell's own size: the timed path in
    TF32 (run.py --control tf32) comes out not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, "ccbench/run.py", "--workload", workload, "--seed",
         "1123581321345589", "--seconds", "1", "--trace", "0", "--control",
         "tf32"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] \
        is False
