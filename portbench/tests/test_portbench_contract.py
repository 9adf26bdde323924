"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, files under the paths; the harness and the reference import
neither JAX nor the JAX package (by whole top-level names) nor read the
old benchmark; a run without a card prints no result."""

import ast
import json
import os
import re
import subprocess
import sys

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "gcc_tpu", "benchmarks", "bench"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    assert all(_text(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (ROOT / p).is_dir() and not p.endswith("_torch")


def test_names_units_and_entries():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(names)
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(cells)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _text(w["why"])
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json") \
            .is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _text(m["layer"])
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", []):
            assert cell in cells
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    from portbench.harness import Cell
    for w in BENCH["workloads"]:
        c = Cell(w["name"])
        e2e = {m["name"] for m in c.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer()


def test_train_cells_compare_full_pools_on_distinct_rows():
    """The compared iterations run on rows that all differ, and where the
    configuration has replay pools, the last two start with them full, so
    the pools' swap path is compared too."""
    from portbench.cells import check_steps
    from portbench.harness import Cell
    for w in BENCH["workloads"]:
        for smoke in (False, True):
            c = Cell(w["name"], smoke)
            if c.traffic["entry"] != "train":
                continue
            n, batch = check_steps(c.traffic), c.traffic["batch"]
            assert n <= c.traffic["ring"], w["name"]
            pool = c.cfg["hyper"].get("pool_size", 0)
            assert (n - 2) * batch >= pool, (w["name"], smoke)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def _strings(path):
    """The string constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)
            and isinstance(n.value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_module_of_the_benchmark_imports_jax_or_the_old_benchmark():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path
        if "tests" not in path.parts:
            assert not [s for s in _strings(path)
                        if "benchmarks/" in s or "bench.py" in s], path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        assert "gcc_tpu_torch" not in set(_imports(path)), path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import types
    from portbench import harness
    monkeypatch.setitem(sys.modules, "gcc_tpu_torch_probe.x",
                        types.ModuleType("probe"))
    assert "gcc_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gcc_tpu.probe",
                        types.ModuleType("probe"))
    assert harness.forbidden_modules() == ["gcc_tpu"]


def test_a_run_without_a_card_prints_no_result(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "unet_serve_b512", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_run_with_only_the_benchmark_files_fails(tmp_path):
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "unet_serve_b512",
         "--seed", "1", "--seconds", "1", "--trace", "0", "--smoke", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
