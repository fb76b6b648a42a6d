"""The port's spans and counters (pyscf_mpcc_tpu_torch.utils.profiling) and
the solver loops that record them, on the CPU.

- Outside a profiler session nothing is recorded: no span, no counter,
  no CUDA event, no synchronisation.
- Under ``torch.profiler.profile(activities=[CPU])`` spans nest, carry
  their parent and the solve of their root span, counters add up, a
  device span's device interval is its host interval, and a new session
  replaces the last one's spans, also when it records none.
- Where torch lacks the session-start call the recorder watches, nothing
  is recorded and nothing raises.
- rccsd.kernel on the device DIIS ring and lambda_ad.kernel on
  H2O/cc-pVDZ (DF, fp64): one ``*.cycle`` span per cycle line printed,
  the listed children in order, 4 host syncs (``sync.*`` spans) a CCSD
  cycle plus 2 a solve and 3 a Lambda cycle; the nine ``lambda.seg.*``
  spans in rccsd.residual_segments order.
- ccsd_t.kernel counts its tiles, and with the fused engine's plain
  version records one ``triples.prep`` and one ``triples.launch`` a
  chunk.

The card's side (the clock of the device intervals against the
profiler's kernels) is tests/test_torch_tracing_gpu.py.
"""

import contextlib
import io
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pyscf_mpcc_tpu_torch import gto
from pyscf_mpcc_tpu_torch.cc import ccsd_t, lambda_ad, rccsd
from pyscf_mpcc_tpu_torch.cc.driver import CCSD
from pyscf_mpcc_tpu_torch.scf import RHF
from pyscf_mpcc_tpu_torch.utils import profiling

CPU = torch.device("cpu")
CCSD_CHILDREN = ["ccsd.update_amps", "sync.normt", "ccsd.diis",
                 "ccsd.energy", "sync.energy"]
DIIS_CHILDREN = ["sync.diis_count", "sync.gram"]


def _traced(fn):
    """fn() under a CPU profiler session; returns (result, stdout,
    spans, counts)."""
    out = io.StringIO()
    with profile(activities=[ProfilerActivity.CPU]), \
            contextlib.redirect_stdout(out):
        r = fn()
    spans, counts = profiling.session()
    return r, out.getvalue(), spans, counts


def _syncs(spans):
    return sum(s.name.startswith("sync.") for s in spans)


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


@pytest.fixture(scope="module")
def h2o():
    mol = gto.M(atom="O 0 0 0; H 0 -0.757 0.587; H 0 0.757 0.587",
                basis="cc-pvdz")
    mf = RHF(mol).density_fit()
    mf.conv_tol = 1e-10
    mf.kernel()
    er = CCSD(mf, device=CPU).ao2mo()
    conv, _, t1, t2 = rccsd.kernel(er, conv_tol=1e-8, conv_tol_normt=1e-6)
    assert conv
    return er, t1, t2


def test_nothing_is_recorded_outside_a_session(h2o, monkeypatch):
    er, _, _ = h2o

    def forbidden(*a, **k):
        raise AssertionError("CUDA event or synchronisation while off")

    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    before = (list(profiling._REC.spans), dict(profiling._REC.counts))
    assert profiling.span("x", device=True) is profiling._OFF
    with profiling.span("x", device=True):
        profiling.count("x")
    rccsd.kernel(er, max_cycle=2, diis_backend="device")
    assert (profiling._REC.spans, profiling._REC.counts) == before


def test_nesting_parents_solves_counts_and_sessions():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a"):
            profiling.count("n")
            with profiling.span("b", device=True):
                profiling.count("n", 2)
                with profiling.span("sync.c"):
                    pass
            with profiling.span("d"):
                pass
        with profiling.span("e"):
            profiling.count("n", 5)
        profiling.count("n", 7)
    spans, counts = profiling.session()
    assert [s.name for s in spans] == ["a", "b", "sync.c", "d", "e"]
    assert [s.parent for s in spans] == [None, 0, 1, 0, None]
    a, b, c, d, e = spans
    assert a.solve == b.solve == c.solve == d.solve != e.solve
    assert counts == {"n": 15}
    assert b.device == b.host and a.device is None and c.device is None
    for s in spans:
        assert s.host[0] <= s.host[1]
    assert a.host[0] <= b.host[0] <= c.host[0] <= c.host[1] <= b.host[1] \
        <= d.host[0] <= d.host[1] <= a.host[1]
    # self time: the span's interval less its children's, on the device
    # clock for a device span (a host-only child takes none of it)
    assert a.self_ns == (a.host[1] - a.host[0]) - (b.host[1] - b.host[0]) \
        - (d.host[1] - d.host[0])
    assert b.self_ns == b.device[1] - b.device[0]
    # the next session starts afresh
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("f"):
            pass
    spans, counts = profiling.session()
    assert [s.name for s in spans] == ["f"] and counts == {}
    assert spans[0].solve > e.solve
    # a session that records nothing leaves nothing of the last one
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert profiling.session() == ([], {})


def test_no_session_hook_leaves_tracing_off(monkeypatch):
    from torch.autograd import profiler as ap
    monkeypatch.setattr(profiling, "_REC", profiling._Recorder())
    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.delattr(ap, "_run_on_profiler_start")
        with pytest.warns(UserWarning, match="_run_on_profiler_start"):
            with profiling.span("a", device=True) as a:
                profiling.count("n")
    assert a is None
    assert profiling.session() == ([], {})


def test_device_spans_through_cuda_events(monkeypatch):
    """The CUDA branch with stand-in events stamped on the host clock: one
    synchronisation a session (the anchor), two events a device span on
    the stream current at its start, device intervals placed through the
    anchor, none for a host span."""
    import time
    calls = dict(sync=0, events=0, streams=0)

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            calls["events"] += 1
            self.t = None

        def record(self, stream):
            assert stream == "stream0"
            self.t = time.time_ns() + 1000      # the stream runs late

        def elapsed_time(self, end):
            return (end.t - self.t) / 1e6

        def synchronize(self):
            pass

    def stream(dev):
        calls["streams"] += 1
        return "stream0"

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.__setitem__(
                            "sync", calls["sync"] + 1))
    monkeypatch.setattr(torch.cuda, "Event", Event)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a", device=True):
            with profiling.span("b", device=True):
                pass
            with profiling.span("c"):
                pass
    spans, _ = profiling.session()
    assert calls == dict(sync=1, events=5, streams=2)
    a, b, c = spans
    assert c.device is None
    for s in (a, b):
        # within the anchor's rounding (host stamp 1 us before the event)
        assert abs(s.device[0] - s.host[0] - 1000) < 5000
        assert s.device[0] <= s.device[1]
    assert a.self_ns == (a.device[1] - a.device[0]) - (b.device[1]
                                                      - b.device[0])


def test_ccsd_kernel_spans_and_syncs(h2o):
    er, _, _ = h2o
    (conv, *_), out, spans, counts = _traced(lambda: rccsd.kernel(
        er, conv_tol=1e-8, conv_tol_normt=1e-6, diis_backend="device",
        verbose=5))
    assert conv
    ncyc = out.count("E_corr(RCCSD)")
    assert ncyc > 3
    cycles = [i for i, s in enumerate(spans) if s.name == "ccsd.cycle"]
    assert len(cycles) == ncyc
    assert spans[0].name == "ccsd.solve"
    assert {spans[i].parent for i in cycles} == {0}
    for i in cycles:
        assert _children(spans, i) == CCSD_CHILDREN
        diis = spans.index(next(s for s in spans[i:]
                                if s.name == "ccsd.diis"))
        assert _children(spans, diis) == DIIS_CHILDREN
        assert spans[i].device is not None
    assert _syncs(spans) == 4 * ncyc + 2 and counts == {}
    assert len({s.solve for s in spans}) == 1


def test_lambda_kernel_spans_and_segments(h2o):
    er, t1, t2 = h2o
    (conv, _, _), out, spans, counts = _traced(lambda: lambda_ad.kernel(
        t1, t2, er, conv_tol=1e-7, diis_backend="device", verbose=5))
    assert conv
    ncyc = out.count("lambda cycle")
    assert ncyc > 3
    segs = ["lambda.seg." + fn.__name__[len("seg_"):]
            for fn, _ in rccsd.residual_segments(er)]
    assert segs == ["lambda.seg." + p for p in (
        "t1_fvv", "t1_foo", "t1_fov", "t1_rest", "k_light", "ring_voov",
        "ring_vovo", "oooo", "ladder")]
    cycles = [i for i, s in enumerate(spans) if s.name == "lambda.cycle"]
    assert len(cycles) == ncyc
    assert spans[0].name == "lambda.solve"
    for i in cycles:
        assert _children(spans, i) == (["lambda.energy_grad"] + segs
                                       + ["sync.dl", "lambda.diis"])
    assert _syncs(spans) == 3 * ncyc


@pytest.mark.parametrize("engine,chunk", [("xla", 1), ("fused", 3)])
def test_triples_counts_tiles_and_chunks(h2o, engine, chunk):
    er, t1, t2 = h2o
    e, _, spans, counts = _traced(lambda: ccsd_t.kernel(
        t1, t2, er, tile=4, engine=engine, chunk=chunk))
    nvt = math.ceil(t1.shape[1] / 4)
    ntiles = nvt * (nvt + 1) * (nvt + 2) // 6
    assert counts == {"triples.tiles": ntiles}
    assert spans[0].name == "triples.energy"
    names = [s.name for s in spans]
    if engine == "fused":
        nchunk = math.ceil(ntiles / chunk)
        assert names[1:] == ["triples.prep", "triples.launch"] * nchunk
        assert all(s.parent == 0 for s in spans[1:])
        e_xla = ccsd_t.kernel(t1, t2, er, tile=4, engine="xla")
        assert abs(e - e_xla) < 1e-12
    else:
        assert names == ["triples.energy"]


def test_trace_writes_the_program_rows(h2o, tmp_path):
    import json
    er, _, _ = h2o
    with profiling.trace(str(tmp_path)):
        rccsd.kernel(er, max_cycle=2, diis_backend="device")
    doc = json.load(open(tmp_path / "trace.json"))
    prog = [e for e in doc["traceEvents"]
            if e.get("pid") == profiling.PROGRAM_PID and e["ph"] == "X"]
    host = [e["name"] for e in prog if e["tid"] == 0]
    dev = [e["name"] for e in prog if e["tid"] == 1]
    assert host.count("ccsd.cycle") == 2 and dev.count("ccsd.cycle") == 2
    assert "sync.gram" in host and "sync.gram" not in dev
    assert not [e for e in doc["traceEvents"]
                if e.get("pid") == profiling.PROGRAM_PID and e["ph"] == "C"]
    assert any(e["name"].startswith("aten::") for e in doc["traceEvents"])
