"""The port's full-(T) campaign scripts on the CPU at small sizes, against
the JAX package.

- examples/w8_triples (the twin of examples/w8_triples_chip.py) on the
  (H2O)2/cc-pVDZ checkpoint that w8_parity_certify.run(small=True) writes
  in fp64 (weigend fitting, 2 frozen; nocc 8, nvir 38, 35 tiles of edge
  8): every engine at full precision against the JAX package's
  ccsd_t.kernel(engine='xla') on its make_eris_df of the same arrays,
  and the bf16 tiers ('dot-high', 'default') on the fused and resident
  engines against the JAX package's bf16x3 / bf16 function (its resident
  engine in interpret mode: hilo, then _dot3 in mode 'split' / 'bf16').
  The JAX references are computed once (module fixture).
- The spec parser keeps the JAX script's spellings and raises on unknown
  ones; main prints one W8TRIPLES line a spec with the stated keys, and a
  spec that raises prints an error line while the next one runs.
- examples/w8_ccsd_pipeline (the twin of examples/w8_ccsd_pipeline.py)
  on H2O/cc-pVDZ (weigend, 1 frozen) against the JAX package's facade,
  RHF(mol).density_fit() -> CCSD(mf, frozen=1) -> .ccsd_t(tile=8), on
  the same settings: E_SCF, E_corr and E(T) within 1e-9.

fp64 on both sides; (T) within rtol 1e-10 (summation order only: the
bf16 products are exact in fp64 on both sides).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyscf_mpcc_tpu import config as jconfig
from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.cc import CCSD as JCCSD
from pyscf_mpcc_tpu.cc import ccsd_t as jccsd_t
from pyscf_mpcc_tpu.cc import eris as jeris_mod
from pyscf_mpcc_tpu.scf import RHF as JRHF
from pyscf_mpcc_tpu_torch import config
from pyscf_mpcc_tpu_torch.cc import ccsd_t
from pyscf_mpcc_tpu_torch.examples import w8_ccsd_pipeline as pipe
from pyscf_mpcc_tpu_torch.examples import w8_parity_certify as w8
from pyscf_mpcc_tpu_torch.examples import w8_triples as w8t
from pyscf_mpcc_tpu_torch.lib import memory

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL = 1e-10
TILE = 8
# (the JAX script's keys, the port's keys) of a W8TRIPLES line
JAX_KEYS = {"system", "engine", "tile", "precision", "e_ccsd_corr", "e_t",
            "wall_T_sec", "device"}
PORT_KEYS = {"engine_resolved", "w1_mode", "dtype", "n_tiles",
             "ms_per_tile", "eris_s", "peak_gib", "plan_gib"}
H2O = [["O", (0.0, 0.0, 0.0)], ["H", (0.0, -0.757, 0.587)],
       ["H", (0.0, 0.757, 0.587)]]


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    """W8_SCRATCH of the (H2O)2/cc-pVDZ fp64 checkpoint (in its ``small``
    subdirectory, as w8_parity_certify --small writes it)."""
    base = tmp_path_factory.mktemp("w8")
    r = w8.run(CPU, small=True, scratch=str(base / "small"))
    assert r["ccsd_converged"] and (r["nocc"], r["nvir"]) == (8, 38)
    return base


@pytest.fixture(scope="module")
def jax_ref(scratch):
    """JAX's (T) on its make_eris_df of the checkpoint's arrays: 'xla' at
    full precision, and the resident engine (interpret mode) at 'high'
    and 'default'."""
    d = scratch / "small"
    with np.load(d / "scf.npz") as z, np.load(d / "amps.npz") as a:
        nocc = a["t1"].shape[0]
        frozen = int(z["nelectron"]) // 2 - nocc
        er = jeris_mod.make_eris_df(z["B"], z["mo_full"][:, frozen:],
                                    z["fock_ao"], nocc, keep_ovvv=False)
        t1, t2 = jnp.asarray(a["t1"]), jnp.asarray(a["t2"])
    out = {None: float(jccsd_t.kernel(t1, t2, er, tile=TILE, engine="xla"))}
    for prec in ("high", "default"):
        out[prec] = float(jccsd_t.kernel(t1, t2, er, tile=TILE,
                                         engine="resident",
                                         dot_precision=prec))
    assert abs(out[None]) > 1e-3 and out["high"] != out[None]
    return out


def _run(spec, scratch):
    [r] = w8t.run(spec, TILE, CPU, scratch=str(scratch / "small"))
    assert "error" not in r, r
    return r


@pytest.mark.parametrize("spec", ["xla", "fused:highest", "resident:highest",
                                  "fused:dot-highest", "auto:highest"])
def test_full_precision_matches_jax_xla(scratch, jax_ref, spec):
    r = _run(spec, scratch)
    np.testing.assert_allclose(r["e_t"], jax_ref[None], rtol=RTOL, atol=0)
    assert r["n_tiles"] == 35 and r["w1_mode"] == "f32"
    # 'auto' runs the CPU's engine
    assert r["engine_resolved"] == ("xla" if spec.startswith("auto")
                                    else spec.partition(":")[0])


@pytest.mark.parametrize("engine", ["fused", "resident"])
@pytest.mark.parametrize("precision,dot", [("dot-high", "high"),
                                           ("default", "default")])
def test_bf16_tiers_match_jax_resident(scratch, jax_ref, engine, precision,
                                       dot):
    r = _run(f"{engine}:{precision}", scratch)
    np.testing.assert_allclose(r["e_t"], jax_ref[dot], rtol=RTOL, atol=0)
    assert r["w1_mode"] == {"high": "split", "default": "bf16"}[dot]


def test_spec_parser():
    assert w8t.parse_specs("fused:dot-high,xla,resident:default,"
                           "auto:dot-highest,fused:highest") == [
        ("fused", "dot-high", "high"), ("xla", "highest", None),
        ("resident", "default", "default"), ("auto", "dot-highest", None),
        ("fused", "highest", None)]
    for bad in ("flat:highest", "fused:high", "fused:tf32", "fused4"):
        with pytest.raises(ValueError, match="unknown"):
            w8t.parse_specs(f"xla,{bad}")


def test_main_prints_one_line_per_spec(scratch, monkeypatch, capsys):
    monkeypatch.setenv("W8_SCRATCH", str(scratch))
    out = w8t.main(["xla,fused:dot-high", str(TILE), "--device", "cpu",
                    "--small"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("W8TRIPLES ")]
    assert [json.loads(ln.split(" ", 1)[1]) for ln in lines] == out
    assert [(r["engine"], r["precision"]) for r in out] == [
        ("xla", "highest"), ("fused", "dot-high")]
    for r in out:
        assert set(r) == JAX_KEYS | PORT_KEYS
        assert r["device"] == "cpu" and r["peak_gib"] is None
        assert r["ms_per_tile"] == pytest.approx(
            r["wall_T_sec"] / r["n_tiles"] * 1e3)
    persistent, live = memory.triples_tile_bytes(8, 38, 142, TILE,
                                                 torch.float64, "fused",
                                                 "high")
    assert out[1]["plan_gib"] == (persistent + live) / 2**30


def test_a_failing_spec_prints_an_error_and_the_next_runs(scratch,
                                                          monkeypatch):
    kernel = ccsd_t.kernel

    def fails_fused(*args, engine, **kw):
        if engine == "fused":
            raise RuntimeError("out of memory")
        return kernel(*args, engine=engine, **kw)

    monkeypatch.setattr(w8t.ccsd_t, "kernel", fails_fused)
    bad, good = w8t.run("fused,xla", TILE, CPU,
                        scratch=str(scratch / "small"))
    assert bad == dict(engine="fused", precision="highest",
                       error="RuntimeError: out of memory")
    assert good["engine_resolved"] == "xla" and "error" not in good


def test_pipeline_matches_jax_facade(monkeypatch):
    # both packages' ladder planners on the same budget (the JAX one falls
    # back to 12 GiB on the CPU backend)
    monkeypatch.setattr(jconfig, "MAX_MEMORY", 12 * 1024)
    monkeypatch.setattr(config, "MAX_MEMORY", 12 * 1024)
    monkeypatch.setattr(pipe, "SMALL", (H2O, "cc-pvdz", "weigend", 1))
    jmf = JRHF(jgto.M(atom=H2O, basis="cc-pvdz")).density_fit("weigend")
    jmf.conv_tol = 1e-10
    jmf.kernel()
    jcc = JCCSD(jmf, frozen=1)
    jcc.conv_tol = 1e-7
    je, _, _ = jcc.kernel()
    jet = jcc.ccsd_t(tile=8)
    r = pipe.run(True, CPU)
    assert r["scf_converged"] and r["ccsd_converged"] and jcc.converged
    assert (r["nocc"], r["nvir"], r["dtype"]) == (4, 19, "torch.float64")
    assert r["ccsd_cycles"] > 0 and r["ccsd_normt"] < 1e-6
    assert abs(r["e_scf"] - jmf.e_tot) < 1e-9
    assert abs(r["e_corr"] - float(je)) < 1e-9
    assert abs(r["e_t"] - float(jet)) < 1e-9
    assert r["e_tot"] == r["e_scf"] + r["e_corr"] + r["e_t"]


def test_facade_plans_ladder_tiles_on_cpu(monkeypatch):
    """The facade's ladder tiling on the CPU: one tile without
    config.MAX_MEMORY (no device memory to plan against), lib/memory's
    plan with it, the ntile knob over both; the CCSD runs without a
    budget."""
    from pyscf_mpcc_tpu_torch import gto
    from pyscf_mpcc_tpu_torch.cc.driver import CCSD
    from pyscf_mpcc_tpu_torch.scf import RHF
    mf = RHF(gto.M(atom=H2O, basis="cc-pvdz")).density_fit("weigend")
    mf.conv_tol = 1e-10
    mf.kernel()
    cc = CCSD(mf, frozen=1, device=CPU)
    er = cc.ao2mo()
    monkeypatch.setattr(config, "MAX_MEMORY", 0)
    assert cc.ladder_ntile(er) == cc.ladder_ntile(er, vjp=True) == 1
    e, _, _ = cc.kernel()
    assert cc.converged and e < 0
    monkeypatch.setattr(config, "MAX_MEMORY", 1)
    args = (cc.nocc, cc.nmo - cc.nocc, er.Lov.shape[0], cc.dtype)
    for vjp in (False, True):
        assert cc.ladder_ntile(er, vjp=vjp) == memory.plan_ladder_ntile(
            *args, budget=2**20, vjp=vjp) > 1
    cc.ntile = 3
    assert cc.ladder_ntile(er) == cc.ladder_ntile(er, vjp=True) == 3
