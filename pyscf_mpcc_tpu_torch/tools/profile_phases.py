#!/usr/bin/env python
"""cProfile of chip_smoke.py's host-bound phases 9-12 on the card.

    python -m pyscf_mpcc_tpu_torch.tools.profile_phases [outdir]

Run from the repo root on a machine with the card.  Builds the kernels,
then runs open_shell_phase (9), umpcc_phase (10), spinorb_phase (11) and
eom_stream_phase (12) of chip_smoke.py under cProfile, one after another
as the script does, and writes each phase's wall seconds and its 45
functions of most internal time and 90 of most cumulative time to
``outdir/prof_p<N>.txt`` (default build/profile).  cProfile adds a cost to
every Python call, so the seconds are above the script's own; the lists
say where the host's time goes, not how long a phase takes.
"""

import cProfile
import io
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    outdir = argv[0] if argv else os.path.join(ROOT, "build", "profile")
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pyscf_mpcc_tpu_torch.lib import device as devpol
    from pyscf_mpcc_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        raise RuntimeError("profile_phases needs the card")
    devpol.set_fp32_precision()
    _build.load_all(("triples_combine", "triples_resident", "triples_probe",
                     "slab_relayout"))
    dev = torch.device("cuda")
    smi = cs.nvidia_smi("name,power.limit").strip()
    os.makedirs(outdir, exist_ok=True)

    def prof(name, fn):
        pr = cProfile.Profile()
        t0 = time.perf_counter()
        pr.enable()
        out = fn()
        pr.disable()
        sec = time.perf_counter() - t0
        s = io.StringIO()
        st = pstats.Stats(pr, stream=s)
        st.sort_stats("tottime").print_stats(45)
        st.sort_stats("cumulative").print_stats(90)
        with open(os.path.join(outdir, f"prof_{name}.txt"), "w") as f:
            f.write(f"{name} {sec:.1f} s ({smi})\n" + s.getvalue())
        print(name, f"{sec:.1f}", flush=True)
        return out

    mf_oh = prof("p9", lambda: cs.open_shell_phase(torch, smi, dev))
    prof("p10", lambda: cs.umpcc_phase(torch, smi, dev, mf_oh))
    prof("p11", lambda: cs.spinorb_phase(torch, smi, dev))
    # phase 4's sweep, the unit of 12(d), as the script measures it on the
    # card (3.16 s at the (H2O)8 shape, PERF.md §5)
    prof("p12", lambda: cs.eom_stream_phase(torch, smi, dev, 3.16))


if __name__ == "__main__":
    main()
