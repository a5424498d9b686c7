"""Batches: `PrefetchLoader`, the training loader (a copy of the JAX
package's `data/loader.py`); a plain in-order iterator for evaluation;
padding of a short final batch (`train/loop.py::_pad_batch` there) and the
move to the device with the uint8 wire dtypes upcast there
(`train/task.py::upcast_image`/`upcast_batch` there).

`PrefetchLoader` shuffles with `default_rng(seed + epoch)`, sets
`dataset.epoch` before an epoch's workers start (so augmentation draws
differ across epochs and stay reproducible), reads samples in a pool of
threads (the default: the native augmentation releases the GIL) or of
forked processes, and queues collated batches ahead of the consumer. A
batch whose samples were all rejected comes out as None. A worker's
exception is raised in the consumer, and a consumer that stops iterating
stops the producer and its pool. Workers touch numpy only, never CUDA, so
forking them after the card is initialised is safe.

With `shard=(rank, ranks)` (data-parallel training, `parallel.mesh`) the
loader walks the same global batches of `batch_size` samples, in the same
shuffled order, and loads only this rank's rows of each: rows
[rank b, (rank + 1) b) with b = batch_size / ranks, fewer or none in a short
last batch. A sample's augmentation draws depend on its index and the
epoch only, so the ranks' batches, each padded to b (`pad_batch`, with
`empty_batch` for a rank with no row), concatenate to one process's padded
batch bit for bit. A rejected sample's row becomes a padding row where it
stands; one process would close the gap and pad at the end.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from fastposecnn_tpu_torch.data.nocs import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    collate,
    empty_instances,
)


# Process-backend worker state: the dataset reaches each worker once, through
# the pool initializer (shared copy-on-write under fork), not with every map.
_WORKER_DS = None


def _init_worker(ds):
    global _WORKER_DS
    _WORKER_DS = ds


def _worker_get(i):
    return _WORKER_DS[int(i)]


def _worker_stage_get(args):
    """A sample for the staged trainer's long-lived worker pool: (index,
    epoch, dataset_dir). The pool starts once, so the parent's dataset may
    have moved to a later epoch or another folder since; the worker's copy
    follows it before reading."""
    i, epoch, root = args
    ds = _WORKER_DS
    if epoch is not None and getattr(ds, "epoch", None) != epoch:
        ds.epoch = epoch
    if root is not None and str(getattr(ds, "dataset_dir", None)) != str(root):
        ds.repoint(root)
    return ds[int(i)]


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, prefetch: int = 2,
                 drop_last: bool = False, backend: str = "thread",
                 shard: Tuple[int, int] = (0, 1)):
        if backend not in ("thread", "process"):
            raise ValueError(f"unknown loader backend {backend!r}")
        if batch_size % shard[1]:
            raise ValueError(f"a batch of {batch_size} does not split over {shard[1]} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.backend = backend
        self.shard = shard
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        rank, ranks = self.shard
        local = self.batch_size // ranks
        for s in range(0, len(idx), self.batch_size):
            chunk = idx[s:s + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk[rank * local:(rank + 1) * local]

    def __iter__(self) -> Iterator[Optional[dict]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()  # the consumer stopped iterating
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = self.epoch

        def put(item) -> bool:
            """A bounded put that gives up once the consumer is gone (a plain
            put would block this thread, and a process pool, forever)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # The sentinel reaches the consumer on every exit path; an error
            # travels ahead of it and is raised there.
            try:
                if self.backend == "process":
                    # Forked after dataset.epoch was set above.
                    pool = ProcessPoolExecutor(self.num_workers, initializer=_init_worker,
                                               initargs=(self.dataset,))
                    get = _worker_get
                else:
                    pool = ThreadPoolExecutor(self.num_workers)
                    get = self.dataset.__getitem__
                with pool:  # shutdown(wait=True) reaps the workers on any exit
                    for chunk in self._index_batches():
                        if stop.is_set() or not put(collate(list(pool.map(get, chunk)))):
                            break
            except BaseException as e:  # noqa: BLE001
                put(("__loader_error__", e))
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        completed = False
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    completed = True
                    break
                if isinstance(item, tuple) and len(item) == 2 and item[0] == "__loader_error__":
                    raise item[1]
                yield item  # None when every sample was rejected
        finally:
            stop.set()
            while t.is_alive():  # unblock a producer stuck in put, then reap it
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)
        if completed:
            self.epoch += 1


def iterate_batches(dataset, batch_size: int,
                    shard: Tuple[int, int] = (0, 1)) -> Iterator[Optional[dict]]:
    """Collated batches of `batch_size` samples in order, the last one
    short; a batch whose samples were all rejected is None. With `shard`
    (rank, ranks), this rank's rows of each, as `PrefetchLoader` takes
    them."""
    rank, ranks = shard
    local = batch_size // ranks
    for start in range(0, len(dataset), batch_size):
        rows = range(start, min(start + batch_size, len(dataset)))[
            rank * local:(rank + 1) * local]
        yield collate([dataset[i] for i in rows])


def pad_batch(batch: dict, batch_size: int) -> Tuple[dict, int]:
    """Pad a short batch with zero samples up to `batch_size` (their GT
    slots are all invalid) and record `sample_valid` [B]. Returns (batch,
    number of real samples)."""
    n = batch["image"].shape[0]
    if n == batch_size:
        batch = dict(batch)
        batch["sample_valid"] = np.ones((n,), np.float32)
        return batch, n

    def pad(x):
        x = np.asarray(x)
        return np.pad(x, [(0, batch_size - n)] + [(0, 0)] * (x.ndim - 1))

    out = {
        "image": pad(batch["image"]),
        "mask": pad(batch["mask"]),
        "agg": {k: pad(v) for k, v in batch["agg"].items()},
        "sample_valid": np.concatenate([np.ones((n,), np.float32),
                                        np.zeros((batch_size - n,), np.float32)]),
    }
    return out, n


def empty_batch(height: int, width: int, max_instances: int) -> dict:
    """A batch of no samples in the folder dataset's layout, for `pad_batch`
    to fill with zero samples."""
    return {"image": np.zeros((0, height, width, 3), np.uint8),
            "mask": np.zeros((0, height, width), np.uint8),
            "agg": {k: np.zeros((0,) + v.shape, v.dtype) for k, v in
                    empty_instances(max_instances, height, width).items()}}


def _on_device(values, device) -> torch.Tensor:
    """A float32 vector of host constants built on `device` (a copy of a host
    array to the card waits for it)."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32, device=device)
                        for v in values])


def upcast_image(image: torch.Tensor) -> torch.Tensor:
    """NHWC wire image -> float32 NCHW: uint8 is ImageNet-normalized, a
    float image keeps its values (assumed normalized by its producer)."""
    if image.dtype == torch.uint8:
        mean = _on_device(IMAGENET_MEAN, image.device)
        std = _on_device(IMAGENET_STD, image.device)
        image = (image.float() / 255.0 - mean) / std
    return image.permute(0, 3, 1, 2).contiguous()


def _tensor(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def upcast_batch(batch: Dict, device) -> Dict:
    """A batch of numpy arrays, or of wire tensors (the staged trainer's
    gathered batches) -> tensors on `device`: image as `upcast_image`, mask
    int32, GT instance masks float32, every other GT field as it is, and
    `sample_valid` where the batch has it (`pad_batch` adds it)."""
    agg = {k: _tensor(v, device) for k, v in batch["agg"].items()}
    agg["instance_masks"] = agg["instance_masks"].float()
    out = {
        "image": upcast_image(_tensor(batch["image"], device)),
        "mask": _tensor(batch["mask"], device).to(torch.int32),
        "agg": agg,
    }
    if "sample_valid" in batch:
        out["sample_valid"] = _tensor(batch["sample_valid"], device)
    return out
