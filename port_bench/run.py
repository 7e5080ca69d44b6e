"""The benchmark of skyplane_tpu_torch's gateway daemons on one NVIDIA GPU.

    python3 port_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout. Prints progress and the numbers compared
on standard error, and one JSON result line last on standard output (see
``pbench/harness.py``).
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(_HERE), str(_HERE.parent)]

if __name__ == "__main__":
    from pbench.harness import main

    sys.exit(main(t_start=T_START))
