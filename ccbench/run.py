#!/usr/bin/env python3
"""Run one cell of the benchmark of pyscf_mpcc_tpu_torch once.

    python3 ccbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card.  Prints
progress and the compared numbers to stderr, and one JSON object as the
last line of stdout (see ccbench/harness/main.py).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(ROOT, "build", "ccbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
sys.path.insert(0, ROOT)

from ccbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
