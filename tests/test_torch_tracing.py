"""The port's host spans (``gcc_tpu_torch/utils/tracing.py``) under
``torch.profiler`` with CPU activity, one ``train_arch_step`` of each family
at smoke sizes (``torch_parallel_workers.FAMILIES``: the U-Net pix2pix,
online and DARTS; CycleGAN, its pools full after one step; SAGAN; SRGAN):

* exactly one ``gcc.step``; the five sub-update spans once each, in the
  engine's order, inside it;
* every ``Adam.step`` call is one ``gcc.adam`` nested in a sub-update (SAGAN's
  DupAdam makes three a step of D or G); CycleGAN's four pool queries are
  ``gcc.pool`` spans, two in each D update;
* every name the step records is in ``tracing.SPANS``, and no event of the
  step is a user-scope annotation (which the profiler would mirror on the
  device's timeline);
* the step's losses and state with the profiler on equal those with it off,
  bit for bit;
* the exported serving graph holds no profiler op;
* the module refuses to import without ``_RecordFunctionFast``.
"""

import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parallel_workers as W  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gcc_tpu_torch.engines.common import Adam, DupAdam  # noqa: E402
from gcc_tpu_torch.utils import tracing  # noqa: E402
from gcc_tpu_torch.utils.serve_export import export_generator  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401

FAMILIES = ("unet", "cyclegan", "sagan", "srgan")
PARTS = ("teacher_d", "teacher_g", "student_d", "student_g")
ORDER = {  # D-then-G in pix2pix and SAGAN, G-then-D in CycleGAN and SRGAN
    "unet": PARTS, "sagan": PARTS,
    "cyclegan": ("teacher_g", "teacher_d", "student_g", "student_d"),
    "srgan": ("teacher_g", "teacher_d", "student_g", "student_d"),
}
USER_SCOPE = torch._C._profiler.RecordScope.USER_SCOPE
_RUNS = {}


def _adams(state):
    for opt in state.opts.values():
        yield from (opt.single, opt.double) if isinstance(opt, DupAdam) \
            else (opt,)


def _run(family, traced):
    """Steps 1 and 2 of ``family`` from the seed-0 init; step 2 under the
    profiler when ``traced``. Returns step 2's events (name, start, end,
    scope) in order of start, its Adam.step calls, its losses and the
    final state."""
    eng = W.engine(family)
    state = eng.init_state(seed=0)
    (tb, vb), (tb2, vb2) = W.batches(family)
    T = lambda b: W._tensors(b, "cpu", torch.float32)  # noqa: E731
    state, _ = eng.train_arch_step(state, T(tb), T(vb), W.LR, 0.9)
    before = sum(a.count for a in _adams(state))
    events = []
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state, m = eng.train_arch_step(state, T(tb2), T(vb2), W.LR, 0.9)
        events = sorted(((e.name(), e.start_ns(), e.end_ns(), e.scope())
                         for e in prof.profiler.kineto_results.events()),
                        key=lambda e: e[1])
    else:
        state, m = eng.train_arch_step(state, T(tb2), T(vb2), W.LR, 0.9)
    adam_calls = sum(a.count for a in _adams(state)) - before
    return {"events": events, "adam_calls": adam_calls,
            "losses": {k: v.detach().clone() for k, v in m.items()},
            "state": state.state_dict()}


def traced(family):
    if family not in _RUNS:
        _RUNS[family] = _run(family, traced=True)
    return _RUNS[family]


def _spans(run, name):
    return [e for e in run["events"] if e[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("family", FAMILIES)
def test_one_step_span_holds_the_sub_updates_in_order(family):
    run = traced(family)
    (step,) = _spans(run, "gcc.step")
    parts = [e for e in run["events"]
             if e[0][4:] in PARTS + ("arch",) and e[0].startswith("gcc.")]
    assert [e[0][4:] for e in parts] == list(ORDER[family]) + ["arch"]
    assert all(_inside(e, step) for e in parts)
    # the sub-updates follow one another; none holds another
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))


@pytest.mark.parametrize("family", FAMILIES)
def test_every_adam_step_is_one_span_inside_a_sub_update(family):
    run = traced(family)
    parts = [e for e in run["events"] if e[0] in
             {f"gcc.{p}" for p in PARTS + ("arch",)}]
    adams = _spans(run, "gcc.adam")
    assert len(adams) == run["adam_calls"] > 0
    assert all(sum(_inside(a, p) for p in parts) == 1 for a in adams)
    pools = _spans(run, "gcc.pool")
    if family == "cyclegan":
        (td,), (sd,) = _spans(run, "gcc.teacher_d"), _spans(run,
                                                             "gcc.student_d")
        assert [sum(_inside(q, p) for q in pools) for p in (td, sd)] \
            == [2, 2]
    assert len(pools) == (4 if family == "cyclegan" else 0)


@pytest.mark.parametrize("family", FAMILIES)
def test_span_names_are_known_and_none_is_a_user_annotation(family):
    run = traced(family)
    names = {e[0] for e in run["events"] if e[0].startswith("gcc.")}
    assert names <= set(tracing.SPANS)
    assert names >= {"gcc.step", "gcc.arch", "gcc.adam"}
    assert [e for e in run["events"] if e[3] == USER_SCOPE] == []


@pytest.mark.parametrize("family", FAMILIES)
def test_the_profiler_leaves_the_step_bit_for_bit(family):
    on, off = traced(family), _run(family, traced=False)
    assert on["losses"].keys() == off["losses"].keys()
    for k, v in on["losses"].items():
        assert torch.equal(v, off["losses"][k]), k

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tree

    a, b = dict(leaves(on["state"])), dict(leaves(off["state"]))
    assert a.keys() == b.keys()
    for path, v in a.items():
        assert np.array_equal(np.asarray(v), np.asarray(b[path])), path


@pytest.mark.parametrize("family", ["unet", "cyclegan"])
def test_the_exported_graph_holds_no_profiler_op(family):
    eng = W.engine(family)
    state = eng.init_state(seed=0)
    size = W.FAMILIES[family][1]["crop_size"]
    ep = export_generator(eng, state, (1, 3, size, size))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets
    assert not [t for t in targets
                if "profiler" in t or "record_function" in t]


def test_the_module_refuses_to_import_without_the_fast_span(monkeypatch):
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    spec = importlib.util.spec_from_file_location("tracing_copy",
                                                  tracing.__file__)
    with pytest.raises(ImportError, match="_RecordFunctionFast"):
        spec.loader.exec_module(importlib.util.module_from_spec(spec))


def test_every_span_has_a_one_line_meaning():
    for name, meaning in tracing.SPANS.items():
        assert name.startswith("gcc.") and meaning
        assert "\n" not in meaning
