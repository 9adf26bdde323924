"""The sweep that fixed a serve mix's rate (the benchmark's own runs never
run it): one exported student, the open loop at each rate in turn.

    python3 portbench/sweep.py --workload <serve cell> --rates 40,60,80
        [--seconds 10] [--seed 1]

Prints, for each rate, the latency percentiles and the wait of the last
requests: a wait that grows through the window means the rate is above
what the system sustains.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import cells as C  # noqa: E402
from portbench import family  # noqa: E402
from portbench.harness import Cell  # noqa: E402
from portbench.run_cells import _sync, arrivals, open_loop  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)
    torch.set_num_threads(1)
    cell = Cell(a.workload)
    device = torch.device("cuda", 0)
    sc = C.ServeCell(family.load(cell.cfg["family"]), cell.cfg, cell.traffic,
                     a.seed, device)
    sync = _sync(device)
    for i in range(cell.traffic["warmup_requests"]):
        sc.request(i)
    sync()
    for rate in (float(r) for r in a.rates.split(",")):
        due = arrivals(rate, a.seconds)
        lat, wall, _ = open_loop(sc.request, sync, due, 0, a.seed)
        ms = 1e3 * np.asarray(lat)
        tail = max(1, len(ms) // 10)
        print(json.dumps({"rate": rate, "requests": len(ms), "wall_s": wall,
                          "p50_ms": float(np.percentile(ms, 50)),
                          "p95_ms": float(np.percentile(ms, 95)),
                          "max_ms": float(ms.max()),
                          "first_tenth_mean_ms": float(ms[:tail].mean()),
                          "last_tenth_mean_ms": float(ms[-tail:].mean())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
