"""Batches for evaluation: a plain in-order iterator (in place of the JAX
package's threaded `PrefetchLoader`), padding of a short final batch
(`train/loop.py::_pad_batch`) and the move to the device with the uint8
wire dtypes upcast there (`train/task.py::upcast_image`/`upcast_batch`).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from fastposecnn_tpu_torch.data.nocs import IMAGENET_MEAN, IMAGENET_STD, collate


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
    """uint8 NHWC wire image -> ImageNet-normalized float32 NCHW; a float
    NCHW image passes through (assumed normalized by its producer)."""
    if image.dtype == torch.uint8:
        mean = torch.as_tensor(IMAGENET_MEAN, device=image.device)
        std = torch.as_tensor(IMAGENET_STD, device=image.device)
        img = (image.float() / 255.0 - mean) / std
        return img.permute(0, 3, 1, 2).contiguous()
    return image


def upcast_batch(batch: Dict, device) -> Dict:
    """A padded numpy batch -> tensors on `device`: image as `upcast_image`,
    mask int32, GT instance masks float32, every other GT field as it is."""
    agg = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch["agg"].items()}
    agg["instance_masks"] = agg["instance_masks"].float()
    return {
        "image": upcast_image(torch.from_numpy(batch["image"]).to(device)),
        "mask": torch.from_numpy(batch["mask"]).to(device).to(torch.int32),
        "agg": agg,
        "sample_valid": torch.from_numpy(batch["sample_valid"]).to(device),
    }
