"""The program's spans on the card share the profiler's clock.

Needs a CUDA device; skipped elsewhere.  Run on the card with
``python -m pytest tests/test_torch_tracing_gpu.py -o addopts='' --noconftest -s``
(tests/conftest.py imports jax, which the card's machine may not have;
``-s`` shows the offsets measured).  The profiler records CUDA activity
alone, as the benchmark's traced window does (ccbench/harness/devtrace.py):

- the switch: the profiler's flag is set under that session;
- a ``device=True`` span around a synchronised ``torch.cuda._sleep``
  kernel: its device interval contains the kernel's Kineto interval with at
  most 0.1 ms to spare at each end, and its host interval contains the
  kernel's ``cudaLaunchKernel`` runtime event;
- a fused (T) at a small shape (``testing.synthetic_eris``, nocc 4,
  nvir 11, tile 4, chunk 3) records one ``triples.prep`` and one
  ``triples.launch`` a chunk, each launch's device interval holding the
  combine kernel of its chunk;
- two sessions back to back: the second holds only its own spans.
"""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pyscf_mpcc_tpu_torch import testing
from pyscf_mpcc_tpu_torch.cc import ccsd_t
from pyscf_mpcc_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

SLACK_NS = 100_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pyscf_mpcc_tpu_torch.lib import device
    device.set_fp32_precision()
    torch.cuda.synchronize()
    return torch.device("cuda")


def _events(prof):
    out = []
    for ev in prof.profiler.kineto_results.events():
        s = int(ev.start_ns())
        out.append((str(ev.device_type()), ev.name(), s,
                    s + int(ev.duration_ns())))
    return out


def test_device_span_is_on_the_profilers_clock(cuda):
    torch.cuda._sleep(1000)             # the kernel loaded before the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert torch._C._autograd._profiler_enabled()
        with profiling.span("warm", device=True):   # the session's anchor
            pass
        with profiling.span("sleep", device=True):
            torch.cuda._sleep(2_000_000)    # about a millisecond
            torch.cuda.synchronize()
    spans, _ = profiling.session()
    sp = next(s for s in spans if s.name == "sleep")
    evs = _events(prof)
    # at::cuda::sleep's kernel is spin_kernel
    k = [e for e in evs if "CUDA" in e[0] and "spin_kernel" in e[1]]
    launch = [e for e in evs if e[1] == "cudaLaunchKernel"
              and sp.host[0] <= e[2]]
    assert len(k) == 1, [e[1] for e in evs if "CUDA" in e[0]]
    (_, _, k0, k1), = k
    d0, d1 = sp.device
    print(f"\nsleep kernel {(k1 - k0) / 1e3:.1f} us; device span starts "
          f"{(k0 - d0) / 1e3:.2f} us before it and ends {(d1 - k1) / 1e3:.2f}"
          f" us after it; host span {(sp.host[1] - sp.host[0]) / 1e3:.1f} us")
    assert d0 <= k0 <= k1 <= d1
    assert k0 - d0 <= SLACK_NS and d1 - k1 <= SLACK_NS
    assert launch, "no cudaLaunchKernel in the host span"
    _, _, l0, l1 = launch[0]
    print(f"cudaLaunchKernel {(l0 - sp.host[0]) / 1e3:.2f} us after the "
          f"host span opens, ends {(sp.host[1] - l1) / 1e3:.2f} us before it "
          f"closes")
    assert sp.host[0] <= l0 <= l1 <= sp.host[1]


def test_fused_triples_records_a_prep_and_a_launch_a_chunk(cuda):
    er = testing.synthetic_eris(4, 11, 30, device=cuda, dtype=torch.float32,
                                build_ovvv=False)
    g = torch.Generator().manual_seed(3)
    t1 = (0.02 * torch.randn(4, 11, generator=g)).to(cuda)
    t2 = 0.02 * torch.randn(4, 4, 11, 11, generator=g)
    t2 = (0.5 * (t2 + t2.permute(1, 0, 3, 2))).to(cuda)
    ccsd_t.kernel(t1, t2, er, tile=4, engine="fused", chunk=3)   # build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ccsd_t.kernel(t1, t2, er, tile=4, engine="fused", chunk=3)
    spans, counts = profiling.session()
    nvt = math.ceil(11 / 4)
    ntiles = nvt * (nvt + 1) * (nvt + 2) // 6
    nchunk = math.ceil(ntiles / 3)
    names = [s.name for s in spans]
    assert names.count("triples.prep") == names.count("triples.launch") \
        == nchunk
    assert counts == {"triples.tiles": ntiles}
    combine = sorted(e[2:] for e in _events(prof)
                     if "CUDA" in e[0] and "combine" in e[1].lower())
    launches = [s.device for s in spans if s.name == "triples.launch"]
    assert len(combine) == nchunk
    for (k0, k1), (d0, d1) in zip(combine, launches):
        assert d0 <= k0 and k1 <= d1


def test_a_new_session_keeps_only_its_own_spans(cuda):
    for name in ("first", "second"):
        with profile(activities=[ProfilerActivity.CUDA]):
            with profiling.span(name, device=True):
                torch.cuda._sleep(1000)
    spans, _ = profiling.session()
    assert [s.name for s in spans] == ["second"]
