"""Entry point of the benchmark: ``python3 portbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` (see harness.py)."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
