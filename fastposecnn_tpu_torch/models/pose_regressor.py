"""The PoseRegressor network in NCHW: a shared ResNet encoder, four FPN
decoders and four heads (counterpart of the JAX package's
`models/pose_regressor.py`).

Module names follow the reference's state_dict layout (`encoder.*`,
`{mask,rotation,translation,scales}_decoder.*`,
`{segmentation,rotation,translation,scales}_head.*`), so the released
Lightning checkpoints (after the `model.` prefix strip) load directly.

Output dict (channels flat and class-major, class c of a field of width k
in channels [c*k, (c+1)*k)):
  mask       [B, C, H, W]        class logits, background included
  quaternion [B, 4(C-1), H, W]
  xy         [B, 2(C-1), H, W]   translation channels 3k and 3k+1
  z          [B, C-1, H, W]      translation channel 3k+2 (log-depth)
  scales     [B, 3(C-1), H, W]

In training mode each decoder drops whole channels (`fpn.FPNDecoder`);
`forward` takes the four decoders' keep masks as `dropout_keep` (keyed
mask, rotation, translation, scales), or draws them from `generator`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from fastposecnn_tpu_torch.models.fpn import FPNDecoder, SegmentationHead, draw_keep
from fastposecnn_tpu_torch.models.resnet import ResNetEncoder

DECODERS = ("mask", "rotation", "translation", "scales")


class PoseRegressorNet(nn.Module):
    """ResNet18 encoder, FPN decoders of 256 pyramid and 128 segmentation
    channels (dropout 0.2), heads upsampling x4: the reference's sizes."""

    def __init__(self, num_classes: int = 7):
        super().__init__()
        c = num_classes
        self.num_classes = c
        self.encoder = ResNetEncoder()
        ec = self.encoder.out_channels
        self.mask_decoder = FPNDecoder(ec)
        self.rotation_decoder = FPNDecoder(ec)
        self.translation_decoder = FPNDecoder(ec)
        self.scales_decoder = FPNDecoder(ec)
        sc = 128
        self.segmentation_head = SegmentationHead(sc, c)
        self.rotation_head = SegmentationHead(sc, 4 * (c - 1))
        self.translation_head = SegmentationHead(sc, 3 * (c - 1))
        self.scales_head = SegmentationHead(sc, 3 * (c - 1))
        n = 3 * (c - 1)
        self.register_buffer(
            "xy_index", torch.tensor([i for i in range(n) if i % 3 != 2]),
            persistent=False)
        self.register_buffer(
            "z_index", torch.tensor([i for i in range(n) if i % 3 == 2]),
            persistent=False)

    def draw_dropout_keep(self, batch: int, device,
                          generator: Optional[torch.Generator] = None
                          ) -> Dict[str, torch.Tensor]:
        """One train-mode keep mask [B, C, 1, 1] per decoder."""
        decoders = {name: getattr(self, f"{name}_decoder") for name in DECODERS}
        return {name: draw_keep(batch, dec.channels, dec.dropout, device, generator)
                for name, dec in decoders.items()}

    def forward(self, x: torch.Tensor,
                dropout_keep: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        if x.shape[-2] % 32 or x.shape[-1] % 32:
            raise ValueError(
                "input spatial dims must be multiples of 32 for the FPN "
                f"top-down pathway, got {x.shape[-2]}x{x.shape[-1]}"
            )
        feats = self.encoder(x)
        keep = dropout_keep or {}

        def decode(name):
            return getattr(self, f"{name}_decoder")(feats, keep.get(name),
                                                    generator)

        mask = self.segmentation_head(decode("mask"))
        quat = self.rotation_head(decode("rotation"))
        xyz = self.translation_head(decode("translation"))
        scales = self.scales_head(decode("scales"))
        return {
            "mask": mask,
            "quaternion": quat,
            "xy": xyz.index_select(1, self.xy_index),
            "z": xyz.index_select(1, self.z_index),
            "scales": scales,
        }
