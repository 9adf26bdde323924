"""CycleGAN's replay pool, below the engines so that utils/weights.py can
carry it across in the JAX layout."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from gcc_tpu_torch.parallel.mesh import all_gather_rows, local_rows
from gcc_tpu_torch.utils.tracing import spanned


class ReplayPool(nn.Module):
    """The replay pool of generated images that feeds a discriminator update
    (port of gcc_tpu/engines/common.py:328-374; utils/image_pool.py:23-54):
    a device buffer of ``pool_size`` NCHW images and its fill count.

    ``query`` has ImagePool.query's sequential semantics: while the pool
    fills, each image is stored and returned; once full, a coin flip either
    swaps the image in at a random slot and returns the one it evicts, or
    returns the image. The draws come from the caller's ``torch.Generator``
    (on the host, so a query never waits for the device). Size 0 passes the
    images through unchanged. The count travels with ``state_dict`` as the
    module's extra state. The buffer stays fp32 whatever the images' dtype:
    images are cast to it as they are stored, and ``query`` returns the
    images' dtype (gcc_tpu/engines/common.py:345-374).

    Under a data-parallel mesh the pool is global: every rank gathers the
    global batch's images, queries its replicated pool with its replicated
    generator as the 1-process run does, and keeps its rows, so pools and
    generators stay identical across the ranks.
    """

    def __init__(self, pool_size: int, image_shape: Sequence[int]):
        super().__init__()
        self.register_buffer("buffer",
                             torch.zeros((pool_size,) + tuple(image_shape)))
        self.count = 0

    def get_extra_state(self) -> torch.Tensor:
        return torch.tensor(self.count, dtype=torch.int32)

    def set_extra_state(self, state) -> None:
        self.count = int(state)

    @spanned("gcc.pool")
    @torch.no_grad()
    def query(self, images: torch.Tensor,
              generator: torch.Generator) -> torch.Tensor:
        size = self.buffer.shape[0]
        if size == 0:
            return images
        return local_rows(self._query(all_gather_rows(images), generator))

    def _query(self, images: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
        size = self.buffer.shape[0]
        out = []
        for img in images.to(self.buffer.dtype):
            if self.count < size:
                self.buffer[self.count].copy_(img)
                self.count += 1
                out.append(img)
                continue
            swap = float(torch.rand((), generator=generator)) > 0.5
            idx = int(torch.randint(size, (), generator=generator))
            if swap:
                out.append(self.buffer[idx].clone())
                self.buffer[idx].copy_(img)
            else:
                out.append(img)
        return torch.stack(out).to(images.dtype)
