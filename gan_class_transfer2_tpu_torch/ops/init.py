"""Parameter initializers — counterpart of gan_class_transfer2_tpu/ops/init.py.

TF/Keras ``glorot_uniform`` with TF's fan rules (reference train.py:134, 149,
161). Kernels are stored HWIO in dataflow orientation, so the transposed-conv
rule (fans computed on TF's (kh, kw, out, in) storage) is explicit:

  * Conv2D (kh, kw, in, out):              fan_in = kh·kw·in,  fan_out = kh·kw·out
  * Conv2DTranspose, stored (kh, kw, in, out): fan_in = kh·kw·out, fan_out = kh·kw·in
  * Dense (in, out):                       fan_in = in, fan_out = out

The published CycleGAN's networks take N(0, 0.02) kernels instead
(``normal_reset``). Draws come from an explicit ``torch.Generator``; they are not the JAX
package's numbers (different generators), only the same distribution.
"""

from __future__ import annotations

import torch


def glorot_uniform(generator: torch.Generator, shape, fan_in: int, fan_out: int):
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return out.uniform_(-limit, limit, generator=generator)


def conv_kernel(generator, kh, kw, in_ch, out_ch, transpose=False):
    """Glorot-uniform conv kernel, HWIO; ``transpose=True`` uses TF's
    Conv2DTranspose fan rule."""
    rf = kh * kw
    if transpose:
        fan_in, fan_out = rf * out_ch, rf * in_ch
    else:
        fan_in, fan_out = rf * in_ch, rf * out_ch
    return glorot_uniform(generator, (kh, kw, in_ch, out_ch), fan_in, fan_out)


def dense_kernel(generator, in_ch, out_ch):
    return glorot_uniform(generator, (in_ch, out_ch), in_ch, out_ch)


@torch.no_grad()
def normal_reset(module, generator: torch.Generator, std: float = 0.02):
    """The published CycleGAN's ``init_weights`` (``init_type="normal"``,
    gain 0.02): N(0, std²) for every parameter named ``kernel``, zeros for
    the rest, drawn in ``parameters()`` order from ``generator`` and copied
    to each parameter's device. Returns ``module``."""
    for name, p in module.named_parameters():
        if name.endswith("kernel"):
            draw = torch.empty(p.shape, dtype=torch.float32, device=generator.device)
            p.copy_(draw.normal_(0.0, std, generator=generator))
        else:
            p.zero_()
    return module
