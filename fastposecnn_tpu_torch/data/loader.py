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
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from fastposecnn_tpu_torch.data.nocs import IMAGENET_MEAN, IMAGENET_STD, collate


# Process-backend worker state: the dataset reaches each worker once, through
# the pool initializer (shared copy-on-write under fork), not with every map.
_WORKER_DS = None


def _init_worker(ds):
    global _WORKER_DS
    _WORKER_DS = ds


def _worker_get(i):
    return _WORKER_DS[int(i)]


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, prefetch: int = 2,
                 drop_last: bool = False, backend: str = "thread"):
        if backend not in ("thread", "process"):
            raise ValueError(f"unknown loader backend {backend!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.backend = backend
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
        for s in range(0, len(idx), self.batch_size):
            chunk = idx[s:s + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

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


def iterate_batches(dataset, batch_size: int) -> Iterator[Optional[dict]]:
    """Collated batches of `batch_size` samples in order, the last one
    short; a batch whose samples were all rejected is None."""
    for start in range(0, len(dataset), batch_size):
        stop = min(start + batch_size, len(dataset))
        yield collate([dataset[i] for i in range(start, stop)])


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


def upcast_image(image: torch.Tensor) -> torch.Tensor:
    """NHWC wire image -> float32 NCHW: uint8 is ImageNet-normalized, a
    float image keeps its values (assumed normalized by its producer)."""
    if image.dtype == torch.uint8:
        mean = torch.as_tensor(IMAGENET_MEAN, device=image.device)
        std = torch.as_tensor(IMAGENET_STD, device=image.device)
        image = (image.float() / 255.0 - mean) / std
    return image.permute(0, 3, 1, 2).contiguous()


def upcast_batch(batch: Dict, device) -> Dict:
    """A numpy batch -> tensors on `device`: image as `upcast_image`, mask
    int32, GT instance masks float32, every other GT field as it is, and
    `sample_valid` where the batch has it (`pad_batch` adds it)."""
    agg = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch["agg"].items()}
    agg["instance_masks"] = agg["instance_masks"].float()
    out = {
        "image": upcast_image(torch.from_numpy(batch["image"]).to(device)),
        "mask": torch.from_numpy(batch["mask"]).to(device).to(torch.int32),
        "agg": agg,
    }
    if "sample_valid" in batch:
        out["sample_valid"] = torch.from_numpy(batch["sample_valid"]).to(device)
    return out
