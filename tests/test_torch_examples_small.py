"""The port's twins of the JAX package's two small example scripts,
examples/properties_showcase.py and examples/umpcc_o2.py, on the CPU in
fp64, held to their PINS (the values the JAX scripts print): energies
within 1e-8 Ha, EOM roots and GF poles within 1e-6 Ha, the rest within
their printed digits (the twins' TOL).

The showcase's device stages (DF-MP2, CCSD, EOM, GF) run in every test
run; its two host-only stages, MP2-F12 (mp/mp2f12) and the spin-flip
root (cc/gccsd_slow), each held to the JAX package by its own tests,
run with the whole script only under the slow mark.  The JAX scripts
themselves run to check that what they print equals the PINS: umpcc_o2
(O2/sto-3g, seconds) always, the showcase (minutes) under the slow mark.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

from conftest import clean_child_env
from pyscf_mpcc_tpu_torch.examples import properties_showcase, umpcc_o2

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TWINS = {"properties_showcase": properties_showcase, "umpcc_o2": umpcc_o2}


def _showcase_device_stages(device):
    """The showcase's stages less its two host-only ones, as the chip
    script's phase 19 runs them."""
    ps = properties_showcase
    _, out = ps.dfmp2_stage(device)
    cc, r = ps.ccsd_stage(device)
    out.update(r)
    out.update(ps.eom_stage(cc))
    out.update(ps.gf_stage(cc))
    return out


def _held_to_pins(twin, out, keys):
    gaps = twin.compare(out)
    assert set(gaps) == keys and set(twin.PINS) == set(twin.TOL)
    bad = {k: v for k, v in gaps.items() if not v[0] <= v[1]}
    assert not bad, bad


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_matches_pins(name, capsys):
    twin = TWINS[name]
    if name == "properties_showcase":
        out = _showcase_device_stages(CPU)
        _held_to_pins(twin, out, set(twin.PINS) - {"e_f12", "sf"})
        return
    out = twin.run(CPU)
    _held_to_pins(twin, out, set(twin.PINS))
    # the JAX script's lines, then the values as one JSON object
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("{") and len(lines) == _NLINES[name] + 1


@pytest.mark.slow
def test_whole_showcase_matches_pins(capsys):
    twin = properties_showcase
    out = twin.run(CPU)
    _held_to_pins(twin, out, set(twin.PINS))
    lines = capsys.readouterr().out.splitlines()
    assert (lines[-1].startswith("{")
            and len(lines) == _NLINES["properties_showcase"] + 1)


def _floats(text):
    return [float(x) for x in re.findall(r"-?\d+\.\d*(?:e[-+]\d+)?", text)]


def _parse_properties(text):
    """The values of examples/properties_showcase.py's lines, by the twin's
    keys."""
    keys = {"RHF (AutoAux DF)": ["e_rhf"], "DF-MP2": ["e_mp2"],
            "  natocc (unrelaxed)": "natocc_unrelaxed",
            "  natocc (relaxed)": "natocc_relaxed",
            "MP2-F12/SP (fc)": ["e_f12"], "CCSD ": ["e_ccsd"],
            "  T1 diag": ["t1_diag", "d1_diag", "d2_diag"],
            "EE-EOM": "ee", "IP-EOM": "ip", "EA-EOM": "ea", "SF-EOM": "sf",
            "GF moment-0": ["gf_rdm1_gap"]}
    out = {}
    for ln in text.splitlines():
        if ln.startswith("momGF-CCSD IP poles:"):
            poles, wts = ln.split("(weights")
            out["gf_ip"], out["gf_ip_weights"] = _floats(poles), _floats(wts)
            continue
        for head, key in keys.items():
            if ln.startswith(head):
                vals = _floats(ln.split("=")[-1] if head == "GF moment-0"
                               else ln[len(head):])
                if isinstance(key, str):
                    out[key] = vals
                else:
                    out.update(zip(key, vals))
    return out


def _parse_umpcc(text):
    out = {}
    for ln in text.splitlines():
        for head, key in (("E(UHF)", "e_uhf"), ("UMP2", "e_ump2"),
                          ("UCCSD", "e_uccsd")):
            if ln.startswith(head):
                out[key] = _floats(ln)[-1]
        if ln.startswith("UMPCC"):
            out["e_umpcc"], out["share_pct"] = _floats(ln)[:2]
    return out


_PARSE = {"properties_showcase": _parse_properties, "umpcc_o2": _parse_umpcc}
_NLINES = {"properties_showcase": 13, "umpcc_o2": 4}


@pytest.mark.parametrize("name", [
    pytest.param("properties_showcase", marks=pytest.mark.slow),
    "umpcc_o2"])
def test_pins_are_what_the_jax_script_prints(name):
    res = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                       name + ".py")],
                         env=clean_child_env(), cwd=ROOT, capture_output=True,
                         text=True, timeout=1200, check=True)
    assert len(res.stdout.splitlines()) == _NLINES[name]
    assert _PARSE[name](res.stdout) == TWINS[name].PINS
