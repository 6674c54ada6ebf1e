"""Host-side batching and device prefetch (counterpart of
fal_net_tpu/data/loader.py).

Replaces the reference's ``torch.utils.data.DataLoader(num_workers=4)``
(Train_Stage1_K.py:156-160) with a thread-pool decoder (PIL and numpy
release the GIL) whose batches are those of fal_net_tpu's loader: the epoch
order is shuffled by ``(seed, epoch)`` and each item's augmentation rng is
``(seed, epoch, index)``.  :func:`prefetch_to_device` stages the next batch
in pinned host memory and copies it with ``non_blocking=True``, so the copy
overlaps the current step.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator

import numpy as np
import torch


def _collate(samples) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], str):
            out[key] = vals  # file names
        elif isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) or isinstance(vals[0], np.floating):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = vals
    return out


class DataLoader:
    """Iterates a dataset (``len`` + ``get(index, rng)``) in batches of numpy
    arrays; with ``drop_last`` (the default) a ragged tail is dropped, as the
    reference's loader does, else it comes last and short.

    ``shard_id`` / ``num_shards``: data parallelism over ranks, as JAX's
    loader (fal_net_tpu/data/loader.py:45-100): every shard draws the same
    permutation of the epoch and shard *r* takes ``order[r::num_shards]``
    (cut to ``len(dataset) // num_shards``), in batches of ``batch_size``,
    the per-rank batch.  Since each item's rng is (seed, epoch, index), the
    shards' batch *k* together are the samples of a one-shard loader's
    batch *k* at ``num_shards * batch_size``.  Ranks that split rows
    (``--spatial``) shard by their data group alone: the ranks of a group
    load the same samples with the same augmentation."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        drop_last: bool = True,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} is not in [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _shard_len(self) -> int:
        return len(self.dataset) // self.num_shards

    def __len__(self) -> int:
        n = self._shard_len()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        if self.num_shards > 1:
            order = order[self.shard_id::self.num_shards][: self._shard_len()]
        n = len(order)

        def fetch(i: int):
            rng = np.random.default_rng((self.seed, self.epoch, int(i)))
            return self.dataset.get(int(i), rng)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = collections.deque()
            idx = 0
            for b in range(len(self)):
                hi = min((b + 2) * self.batch_size, n)  # keep ~2 batches in flight
                while idx < hi:
                    pending.append(pool.submit(fetch, order[idx]))
                    idx += 1
                yield _collate([pending.popleft().result() for _ in range(min(self.batch_size, n - b * self.batch_size))])


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Numeric numpy fields -> tensors on ``device`` (NHWC images become
    NCHW); other fields pass through.  On CUDA the host copy is pinned and
    the upload is non-blocking, on the current stream."""
    out = {}
    for k, v in batch.items():
        if not (isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.number)):
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.ndim == 4:
            t = t.permute(0, 3, 1, 2)
        if device.type == "cuda":
            t = t.contiguous().pin_memory()
            out[k] = t.to(device, non_blocking=True)
        else:
            out[k] = t.contiguous().to(device)
    return out


def prefetch_to_device(iterator: Iterator[Dict[str, Any]], device: torch.device) -> Iterator[Dict[str, Any]]:
    """Stage up to two upcoming batches (:func:`to_device`) from a producer
    thread while the consumer's step runs.

    The producer uploads on its own CUDA stream; each staged batch carries
    an event that the consumer's current stream waits on before use.
    """
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch):
        if side is None:
            return to_device(batch, device), None
        with torch.cuda.stream(side):
            staged = to_device(batch, device)
            done = torch.cuda.Event()
            done.record(side)
        return staged, done

    q: "queue.Queue" = queue.Queue(maxsize=2)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def offer(item) -> None:
        # A consumer that stops early (epoch_size truncation) must not leave
        # this thread blocked on a full queue, so every put watches ``stop``.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer():
        try:
            for batch in iterator:
                if stop.is_set():
                    return
                offer(put(batch))
        except BaseException as e:  # surfaced to the consumer
            err.append(e)
        finally:
            if hasattr(iterator, "close"):
                iterator.close()  # ends the loader's worker pool
            offer(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            staged, done = item
            if done is not None:
                torch.cuda.current_stream(device).wait_event(done)
                for v in staged.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(torch.cuda.current_stream(device))
            yield staged
    finally:
        stop.set()
        t.join(timeout=10)
