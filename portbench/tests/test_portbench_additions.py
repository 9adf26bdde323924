"""A later change adds a model family, an entry kind, a configuration, a
traffic mix, a cell and a per-layer metric as new files and entries only:
in a copy of the benchmark, a throwaway family module, entry module,
configuration, mix, limits file and metric reader are added beside the
others, and the new cell runs in smoke mode with no file of the benchmark
edited."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

FAMILY = '''"""A throwaway family: pix2pix's engine and reference, a new name."""
from portbench.families.pix2pix import Pix2Pix


class Throwaway(Pix2Pix):
    pass


FAMILY = Throwaway()
'''

ENTRY = '''"""A throwaway entry: the train entry with a quantity of its own."""
from portbench.entries import train


def run(cell, args, device, t_start):
    out = train.run(cell, args, device, t_start)
    r = out["readings"]
    out["end_to_end"]["throwaway_iters_per_s"] = r.units / r.window_s
    return out
'''


@pytest.mark.parametrize("trace", [0, 1])
def test_new_files_and_entries_only(tmp_path, trace):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "pix2pix_unet_cityscapes.json")
                     .read_text())
    cfg["name"] = "throwaway_unet"
    cfg["family"] = "throwaway_family"
    (pb / "families" / "throwaway_family.py").write_text(FAMILY)
    (pb / "entries" / "throwaway_entry.py").write_text(ENTRY)
    cfg["hyper"]["lambda_content"] = 10.0
    (pb / "configs" / "throwaway_unet.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "train_b16.json").read_text())
    mix["smoke"] = {"batch": 4}
    mix["entry"] = "throwaway_entry"
    (pb / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    shutil.copy(pb / "limits" / "unet_train_b128.json",
                pb / "limits" / "throwaway_cell.json")
    (pb / "metrics" / "throwaway_metric.py").write_text(
        "def read(r):\n    return float(r.units) if r.units else None\n")
    bench["configs"].append({"name": "throwaway_unet", "source": "x",
                             "file": "portbench/configs/throwaway_unet.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway_cell",
                               "config": "throwaway_unet",
                               "traffic": "throwaway_mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "throwaway_iters_per_s.throwaway",
                                "unit": "iters/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["throwaway_cell"]})
    bench["per_layer"].append({"name": "throwaway_metric", "unit": "n",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine step",
                               "moves": "throwaway_iters_per_s.throwaway",
                               "workloads": ["throwaway_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, str(pb / "run.py"), "--workload", "throwaway_cell",
         "--seed", "7", "--seconds", "0.2", "--trace", str(trace),
         "--smoke", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["attempted"] > 0

    # the copy's harness finds the new cell's metric and its reader
    probe = (
        "import sys, types; sys.path.insert(0, '.');"
        "from portbench.harness import Cell, read_metric;"
        "c = Cell('throwaway_cell', smoke=True);"
        "names = [m['name'] for m in c.per_layer()];"
        "assert 'throwaway_metric' in names, names;"
        "print(read_metric('throwaway_metric', types.SimpleNamespace("
        "units=5)))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "5.0"
