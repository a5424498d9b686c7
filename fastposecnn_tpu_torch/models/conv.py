"""`Conv2d`: an `nn.Conv2d` that computes in a given dtype as flax's
`nn.Conv(dtype=...)` does (the JAX package's networks take `dtype=` on
every convolution).

The parameters stay float32 (same state_dict keys and dtypes as
`nn.Conv2d`). In `compute_dtype` the input and the weight are cast to it,
convolved, and the bias, cast to it, is added after the convolution's
output was rounded: flax's `y = conv(x, w); y += b`, which a fused bias
(`F.conv2d(x, w, b)`) rounds differently in bfloat16. With a float32
`compute_dtype` the forward is `nn.Conv2d`'s own, on the input cast to the
parameters' dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:  # flax promotes the input to the parameters' dtype
            return super().forward(x.to(self.weight.dtype))
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[None, :, None, None]
