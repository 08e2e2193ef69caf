"""Run one cell of the port's H100 benchmark (``BENCHMARK.json``).

    python3 h100bench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run it from the root of a checkout on a machine with the card; see
``h100bench/README.md``.
"""
import time

T0 = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], T0))
