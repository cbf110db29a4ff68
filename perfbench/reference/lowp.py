"""The control: the plain reference computed one precision below the
configuration's. For a bfloat16 configuration that is fp8: every conv's
input and kernel rounded to float8_e4m3fn under a per-tensor scale (the
tensor's largest magnitude mapped to 448), and in a backward the gradient
flowing into them rounded to float8_e5m2 alike (the usual fp8 training
recipe). The products and sums themselves stay float32.
"""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(x, dtype, top):
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


def fp8(x):
    return _Fp8.apply(x)


OPS = {"fp8": fp8}
# the rounding one precision below each configuration's compute dtype
BELOW = {"bfloat16": "fp8", "float16": "fp8"}
