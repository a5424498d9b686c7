"""The plain reference's optimizer: the FastPoseCNN trainer's chain (the
JAX package's `make_optimizer`, which the port copies), written out per
parameter in float32.

  1. x0 on the gradients of the modules the preset freezes;
  2. clip by global norm (GRADIENT_CLIP_VAL);
  3. RAdam scaling (b1 0.9, b2 0.999, eps 1e-8, rectification threshold 5;
     the step's scalars in float64 rounded to float32);
  4. + WEIGHT_DECAY * param;
  5. x0 frozen, x ENCODER_LEARNING_RATE / LEARNING_RATE on the encoder;
  6. x(-LEARNING_RATE);
  7. Lookahead (sync every 5 steps, slow step 0.5).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

B1, B2, EPS, THRESHOLD = 0.9, 0.999, 1e-8, 5.0
FREEZE_GROUPS = {
    "FREEZE_ENCODER": ("encoder",),
    "FREEZE_MASK_TRAINING": ("mask_decoder", "segmentation_head"),
    "FREEZE_ROTATION_TRAINING": ("rotation_decoder", "rotation_head"),
    "FREEZE_TRANSLATION_TRAINING": ("translation_decoder", "translation_head"),
    "FREEZE_SCALES_TRAINING": ("scales_decoder", "scales_head"),
}


def _f32(x: float) -> float:
    return float(np.float32(x))


def frozen_modules(hp: Dict) -> set:
    return {m for flag, mods in FREEZE_GROUPS.items() if hp.get(flag) for m in mods}


class RAdamLookahead:
    def __init__(self, hp: Dict, params: Dict[str, torch.Tensor]):
        frozen = frozen_modules(hp)
        self.hp = hp
        self.freeze, self.ratio = {}, {}
        enc = _f32(hp["ENCODER_LEARNING_RATE"] / hp["LEARNING_RATE"])
        for name in params:
            top = name.split(".", 1)[0]
            self.freeze[name] = 0.0 if top in frozen else 1.0
            self.ratio[name] = 0.0 if top in frozen else enc if top == "encoder" else 1.0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.slow = {n: p.detach().clone() for n, p in params.items()}
        self.count = 0
        self.la_step = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        hp = self.hp
        u = {n: grads[n] * self.freeze[n] for n in params}
        norm = torch.sqrt(sum((g * g).sum() for g in u.values()))
        clip = hp["GRADIENT_CLIP_VAL"]
        u = {n: torch.where(norm < clip, g, (g / norm) * clip) for n, g in u.items()}
        self.count += 1
        t = self.count
        ro_inf = 2.0 / (1.0 - B2) - 1.0
        b2t = B2 ** t
        ro = ro_inf - 2 * t * b2t / (1 - b2t)
        bc1, bc2 = _f32(1 - B1 ** t), _f32(1 - b2t)
        for n in params:
            self.mu[n] = u[n] * (1 - B1) + self.mu[n] * B1
            self.nu[n] = u[n] * u[n] * (1 - B2) + self.nu[n] * B2
            mu_hat = self.mu[n] / bc1
            if ro >= THRESHOLD:
                r = _f32(math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                   / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)))
                u[n] = mu_hat * r / (torch.sqrt(self.nu[n] / bc2) + EPS)
            else:
                u[n] = mu_hat
        self.la_step += 1
        for n, p in params.items():
            step = (u[n] + hp["WEIGHT_DECAY"] * p) * self.ratio[n] * -hp["LEARNING_RATE"]
            fast = p + step
            if self.la_step % 5:
                p.copy_(fast)
            else:
                self.slow[n] = self.slow[n] + (fast - self.slow[n]) * 0.5
                p.copy_(self.slow[n])
