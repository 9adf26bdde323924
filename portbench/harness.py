"""The benchmark of gcc_tpu_torch on one NVIDIA H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``portbench/configs/
<config>.json``) and a traffic mix (``portbench/traffic/<mix>.json``); its
numbers' limits are in ``portbench/limits/<cell>.json`` and each per-layer
metric is read by ``portbench/metrics/<metric>.py``. The configuration
names its family (``portbench/families/<family>.py``: the program's engine
and the plain reference), the mix its entry kind (``portbench/entries/
<entry>.py``: what the window drives and the quantities it measures).
An end-to-end metric is named ``<quantity>[.<qualifier>]``
(``train_images_per_s.unet``): one measured quantity, with a bound of its
own in each configuration. Set-up builds the program's state from the
seed and drives the first iterations (or warm-up requests); the window
runs for ``--seconds``; with ``--trace 1`` a profiled slice follows it.
After the window the program's state is freed and the plain reference
(``portbench/reference/``) decides ``correct``.

The last line of standard output is one JSON object; the numbers compared
are the last lines of standard error and the result's last key. Without
a card the run fails: it does not fall back to the CPU. ``--smoke 1`` runs
the cell on the CPU at the configuration's and mix's ``smoke`` sizes for
the tests, and reports no device metric.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gcc_tpu")


def parse_args(argv):
    p = argparse.ArgumentParser("portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--smoke", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _smoke(d: dict) -> dict:
    """d with its ``smoke`` entries laid over it (one level deep)."""
    out = dict(d)
    for k, v in d.get("smoke", {}).items():
        out[k] = dict(d[k], **v) if isinstance(v, dict) and \
            isinstance(d.get(k), dict) else v
    return out


class Cell:
    """A workload of BENCHMARK.json with its files."""

    def __init__(self, name: str, smoke: bool = False):
        self.bench = load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.w = name, cells[name]
        self.cfg = load_json(ROOT / self._config_file())
        self.traffic = load_json(HERE / "traffic" / f"{self.w['traffic']}.json")
        if smoke:
            self.cfg, self.traffic = _smoke(self.cfg), _smoke(self.traffic)
        self.limits = load_json(HERE / "limits" / f"{name}.json")

    def _config_file(self) -> str:
        for c in self.bench["configs"]:
            if c["name"] == self.w["config"]:
                return c["file"]
        raise SystemExit(f"no configuration {self.w['config']!r}")

    def end_to_end(self):
        from portbench.cells import listed
        return listed(self.bench["end_to_end"], self.name, set())

    def per_layer(self):
        from portbench.cells import listed
        reported = {m["name"] for m in self.end_to_end()}
        return listed(self.bench["per_layer"], self.name, reported)


def card() -> dict:
    """The card's name, count and power limit (nvidia-smi)."""
    import torch
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        info["power_limit"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "not read"
    return info


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def read_metric(name: str, readings):
    """portbench/metrics/<name>.py's read(readings), or None."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(readings)


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    cell = Cell(args.workload, bool(args.smoke))
    chips = cell.w["chips"]
    cache = ROOT / "build" / "portbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "extensions"))
    import torch

    torch.set_num_threads(1)  # one host thread: steadier host times
    if args.smoke:
        device, info = torch.device("cpu"), {"kind": "cpu", "count": 0}
    else:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            say(f"portbench: {chips} CUDA device(s) needed, "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                " found; no result")
            return 2
        device, info = torch.device("cuda", 0), card()
        say(f"card: {info['kind']}, {info['count']} device(s), power limit "
            f"{info['power_limit']}")

    entry = importlib.import_module(
        f"portbench.entries.{cell.traffic['entry']}")
    out = entry.run(cell, args, device, t_start)

    found = forbidden_modules()
    if found:
        say(f"portbench: the process loaded {found} by the window's close; "
            f"no result")
        return 3

    metrics = {}
    if args.trace == 0:
        # an end-to-end metric is named <quantity>[.<qualifier>]: one
        # quantity may carry a bound of its own in each configuration
        for m in cell.end_to_end():
            v = out["end_to_end"].get(m["name"].split(".")[0])
            if v is None:
                raise RuntimeError(f"{m['name']} was not measured")
            if not args.smoke:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    elif not args.smoke:
        for m in cell.per_layer():
            v = read_metric(m["name"], out["readings"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_block = {"platform": "gpu" if device.type == "cuda" else "cpu",
                    "kind": info["kind"], "count": chips if device.type
                    == "cuda" else 0,
                    "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_block}
    sl = out["readings"].slice
    if args.trace == 1 and sl is not None and device.type == "cuda":
        device_block["busy_s"] = sl.busy_s
        device_block["window_s"] = sl.window_s
        result["breakdown"] = {"device_ops": sl.top_ops(),
                               "idle_gaps": sl.idle_gaps()}
    elif args.trace == 1:
        result["breakdown"] = {"device_ops": [], "idle_gaps": []}
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]}
                        for k, v in out["checks"].items()}
    for line in out["check_lines"]:
        say(line)
    print(json.dumps(result), flush=True)
    return 0
