"""Named host spans of the cooperative iteration, read by ``torch.profiler``.

``span(name)`` is a context that the profiler records as a host range named
``name`` at function scope, the scope of an aten operator: it lands among
the trace's host events on the profiler's own clock, beside the CUDA
runtime's launch calls and the device's kernels, and is not mirrored on
the device's timeline (a user-scope ``record_function`` range is, and costs
about twenty times as much when no profiler runs). With no profiler
running a span records nothing and costs well under a microsecond.

``spanned(name)`` spans every call of a function. ``SPANS`` names every
span the port opens: the engines' sub-updates and arch step, the step that
holds them, Adam's steps and the replay pools' queries. Nothing in
``models/``, ``ops/layers.py`` or the exported serving graph opens one. A
``torch.profiler`` trace of ``cli.train --profile_steps N`` shows them,
and so does the benchmark's traced slice (``portbench/spans.py``).
"""

from __future__ import annotations

import functools

import torch

try:
    _RecordFunctionFast = torch._C._profiler._RecordFunctionFast
except AttributeError as e:  # a span left out would read as zero time
    raise ImportError(
        f"torch {torch.__version__} has no "
        "torch._C._profiler._RecordFunctionFast; gcc_tpu_torch's spans "
        "need it") from e

SPANS = {
    "gcc.step": "one train_arch_step: the cooperative train step, then "
                "the arch step",
    "gcc.teacher_d": "the teacher D update, with the teacher's no-grad "
                     "forward and the teacher pools' queries that feed it",
    "gcc.teacher_g": "the teacher G update (in SRGAN with the teacher's "
                     "no-grad forward before it), or the frozen teacher's "
                     "target forwards under normal distillation",
    "gcc.student_d": "the student D update, with the student's no-grad "
                     "forward and the student pools' queries that feed it",
    "gcc.student_g": "the student G update: its forwards, distillation, "
                     "backward and Adam step",
    "gcc.arch": "the arch step: alpha clipping, the teacher discrepancy "
                "EMA and the Adam step of D's mask alphas",
    "gcc.adam": "one Adam.step over an optimizer's parameters",
    "gcc.pool": "one replay-pool query: its per-image loop over the batch",
}


def span(name: str) -> _RecordFunctionFast:
    """A host span named ``name`` (a key of ``SPANS``) for a ``with``
    block."""
    return _RecordFunctionFast(name)


def spanned(name: str):
    """A decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            with _RecordFunctionFast(name):
                return fn(*args, **kw)
        return wrapped
    return wrap
