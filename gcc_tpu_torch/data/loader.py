"""Batching loader with threaded decode (copy of gcc_tpu/data/loader.py).

Replaces torch DataLoader (data/__init__.py:61-91): per-epoch shuffle unless
serial_batches, num_threads decode workers (image decoding and the numpy
resampler release the GIL for the heavy work), and a small prefetch queue
that overlaps the next batch's host work with device compute. Batches stay
NHWC numpy on the host; the CLI moves them to the device.

``shard=(rank, world)``: one rank of a data-parallel mesh. Every rank walks
the same global batches (the same shuffle from the same seed) and yields its
rows [rank B/W, (rank+1) B/W) of each. A whole-batch dataset
(PackedDataset.get_batch) draws every item's transform parameters, so the
stream stays the 1-process run's, and builds only the rank's rows; the
per-item datasets draw theirs inside the decode, so a rank decodes the
global batch and keeps its rows.
"""

from __future__ import annotations

import concurrent.futures as futures
from typing import Dict, Iterator, List, Tuple

import numpy as np

from gcc_tpu_torch.parallel.mesh import rows


def collate(samples: List[Dict]) -> Dict:
    out = {}
    for k in samples[0]:
        v0 = samples[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_threads: int = 4, prefetch: int = 2, seed: int = 0,
                 drop_last: bool = False, shard: Tuple[int, int] = (0, 1)):
        rows(*shard, batch_size)  # raises where the batch does not split
        self.shard = shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_threads = max(1, num_threads)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self._epoch = None

    def set_epoch(self, epoch: int) -> None:
        """Key the next epoch's shuffle to `epoch` (torch
        DistributedSampler.set_epoch convention): a resumed
        `--continue_train` run then replays the SAME per-epoch data order
        an uninterrupted run would have seen, instead of restarting the
        shuffle stream from scratch. Without a call, the legacy
        sequential-stream behavior is unchanged."""
        self._epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = self.rng if self._epoch is None else \
                np.random.RandomState(self.seed * 1000003 + self._epoch)
            rng.shuffle(idx)
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[Dict]:
        # Per-ITEM task submission: every image in a batch decodes on its own
        # pool thread (decoding and numpy's loops release the GIL), so one
        # batch saturates all workers instead of building serially on one
        # thread. `prefetch` batches of item-futures stay in flight to overlap
        # the next batch's host work with device compute; batch order kept.
        #
        # Datasets with get_batch (PackedDataset) take a whole-batch path
        # instead: one pool task per batch, since there is no decode to
        # spread, only mmap slicing, and per-item futures would dominate it.
        batches = self._index_batches()
        whole_batch = hasattr(self.dataset, "get_batch")
        with futures.ThreadPoolExecutor(self.num_threads) as pool:
            pending = []
            it = iter(batches)

            def submit_next():
                try:
                    b = next(it)
                except StopIteration:
                    return False
                if whole_batch:
                    pending.append(pool.submit(self.dataset.get_batch, b,
                                               rows(*self.shard, len(b))))
                else:
                    pending.append(
                        [pool.submit(self.dataset.__getitem__, int(i))
                         for i in b])
                return True

            for _ in range(self.prefetch):
                if not submit_next():
                    break
            while pending:
                futs = pending.pop(0)
                submit_next()
                if whole_batch:
                    yield futs.result()
                else:
                    yield collate([f.result()
                                   for f in futs][rows(*self.shard,
                                                       len(futs))])


class InfiniteLoader:
    """Endless batch stream (the reference re-creates val iterators per epoch,
    train.py:131; the darts val stream here just cycles)."""

    def __init__(self, loader: Loader):
        self.loader = loader
        self._it = iter(loader)

    def __next__(self) -> Dict:
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)

    def close(self) -> None:
        """End the current pass: its decode pool finishes what it started
        and its threads exit."""
        self._it.close()
