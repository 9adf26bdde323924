"""Faults planted in the program underneath the harness, for the tests
and the calibration (a benchmark run plants none):

  unchanged   every optimizer step returns its state unchanged
  half_batch  each iteration trains on the first half of its batches
              (the losses' means over the rest)
  pool_noswap once a replay pool is full, its coin flip never swaps: it
              returns each incoming image (its draws stay in step)
  altered     the served module's first image of each request negated
"""

from __future__ import annotations

import contextlib

import torch


class _Altered:
    def __init__(self, ep):
        self.ep = ep

    def module(self):
        inner = self.ep.module()

        def serve(x):
            y = inner(x).clone()
            y[0] = -y[0]
            return y
        return serve


@contextlib.contextmanager
def planted(name):
    """The program with fault ``name`` (None: as it is) for the block."""
    from gcc_tpu_torch.engines import common
    from gcc_tpu_torch.ops import pool
    from gcc_tpu_torch.utils import serve_export

    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "unchanged":
        patch(common.Adam, "step", lambda self, params, grads, lr: None)
    elif name == "half_batch":
        step = common.CombinedStepMixin.train_arch_step

        def half(self, state, batch, val_batch, *args, **kw):
            def cut(b):
                return {k: v[:v.shape[0] // 2] for k, v in b.items()}
            return step(self, state, cut(batch), cut(val_batch), *args, **kw)
        patch(common.CombinedStepMixin, "train_arch_step", half)
    elif name == "pool_noswap":
        def noswap(self, images, generator):
            size, out = self.buffer.shape[0], []
            for img in images.to(self.buffer.dtype):
                if self.count < size:
                    self.buffer[self.count].copy_(img)
                    self.count += 1
                else:
                    torch.rand((), generator=generator)
                    torch.randint(size, (), generator=generator)
                out.append(img)
            return torch.stack(out).to(images.dtype)
        patch(pool.ReplayPool, "_query", noswap)
    elif name == "altered":
        export = serve_export.export_generator
        patch(serve_export, "export_generator",
              lambda *a, **kw: _Altered(export(*a, **kw)))
    elif name is not None:
        raise ValueError(f"no fault {name!r}")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
