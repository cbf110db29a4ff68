"""The Denoiser U-Net — counterpart of gan_class_transfer2_tpu/models/unet.py.

Same topology (reference train.py:175-215): ``octaves`` nested levels, each
``DownShuffle(f_i) → Block(f_i) → inner → Block(f_i) → UpShuffle(u_i)`` in a
skip connection, with ``f_i = min(pixel_size·2^i, max_size)`` and
``u_i = min(pixel_size·2^i // 2, max_size)``; outer
``Block(pixel_size) → nest → Block(pixel_size) → Dense(out)``.

``Denoiser`` holds the parameters under the names of ``init_unet``'s pytree
(``octaves.0.down.kernel`` ↔ ``params["octaves"][0]["down"]["kernel"]``), in
float32, HWIO. ``unet_apply(cfg, model, x, t)`` is the forward: it reads
``cfg`` for the compute dtype, so one set of weights runs under any of
them; ops/conv.py picks the conv kernels from the tensors. Params are cast
to ``cfg.compute_dtype`` at apply. Concat skips are never materialised
(``concat_elision``): a level returns a (branch, skip) pair and each
consumer splits its kernel along input channels.
The timestep is ignored unless ``per_step_output``.

Under tensor parallelism (``parallel/mesh.shard_state``) a conv layer may
hold only this rank's output channels; every conv goes through
``parallel/tensor.layer_apply``, which gathers them, so what the forward
computes does not change.

GAN mode (``g_norm`` other than ``"none"``) adds ``down_norm``/``up_norm``
(γ ones, β zeros) to every octave, under the JAX pytree's names, and runs
each k4/s2 conv without its ReLU, then the norm, then the ReLU
(unet.py:163-213); with a (branch, skip) pair into the up conv, the norm
applies to the summed pre-activation.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import conv as conv_ops
from ..ops import init as init_ops
from ..ops import norm as norm_ops
from ..parallel import tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


class Conv(nn.Module):
    """One conv or dense layer's ``kernel`` (HWIO or (in, out)) and ``bias``."""

    def __init__(self, kernel_shape):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel_shape))
        self.bias = nn.Parameter(torch.zeros(kernel_shape[-1]))


def _block(in_ch: int, filters: int, depth: int):
    """Block(filters): ``depth`` × 3×3/s1 SAME ReLU convs (train.py:123-143)."""
    layers = nn.ModuleList()
    c = in_ch
    for _ in range(depth):
        layers.append(Conv((3, 3, c, filters)))
        c = filters
    return layers, c


class Level(nn.Module):
    """One octave: ``down``, ``block_in``, ``block_out``, ``up`` and, for
    residual skips, ``skip_dense``."""


class Denoiser(nn.Module):
    """Parameters of ``init_unet`` (zeros until ``reset_parameters``)."""

    def __init__(self, cfg, in_channels: int = 3, out_channels: int | None = None):
        super().__init__()
        self.cfg = cfg
        out_channels = cfg.out_channels() if out_channels is None else out_channels
        self.pre_block, c = _block(in_channels, cfg.pixel_size, cfg.block_depth)
        self.octaves = nn.ModuleList()
        skip_channels = []
        for i in range(cfg.octaves):
            f = cfg.octave_filters(i)
            skip_channels.append(c)
            level = Level()
            level.down = Conv((4, 4, c, f))
            if cfg.g_norm != "none":  # GAN-mode knob; the reference model has none
                level.down_norm = norm_ops.init_norm(f)
            level.block_in, c = _block(f, f, cfg.block_depth)
            self.octaves.append(level)
        self.middle, c = _block(c, cfg.middle_filters(), cfg.block_depth)
        for i in reversed(range(cfg.octaves)):
            level = self.octaves[i]
            level.block_out, c = _block(c, cfg.octave_filters(i), cfg.block_depth)
            u = cfg.octave_up_filters(i)
            level.up = Conv((4, 4, c, u))
            if cfg.g_norm != "none":
                level.up_norm = norm_ops.init_norm(u)
            c = u
            if cfg.skip_mode == "concat":
                c = c + skip_channels[i]
            elif cfg.skip_mode == "residual":
                level.skip_dense = nn.Parameter(torch.zeros(c, skip_channels[i]))
                c = skip_channels[i]
        self.post_block, c = _block(c, cfg.pixel_size, cfg.block_depth)
        self.head = Conv((c, out_channels))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Glorot-uniform kernels (TF fan rules), zero biases, drawn in the
        order ``init_unet`` draws them. ``generator`` lives on the CPU; the
        draws are copied to the parameters' device. Norms take no draws."""

        def conv(layer, transpose=False):
            kh, kw, i, o = layer.kernel.shape
            layer.kernel.copy_(init_ops.conv_kernel(generator, kh, kw, i, o, transpose))
            layer.bias.zero_()

        for layer in self.pre_block:
            conv(layer)
        for level in self.octaves:
            conv(level.down)
            for layer in level.block_in:
                conv(layer)
        for layer in self.middle:
            conv(layer)
        for level in reversed(self.octaves):
            for layer in level.block_out:
                conv(layer)
            conv(level.up, transpose=True)
            if hasattr(level, "skip_dense"):
                level.skip_dense.copy_(init_ops.dense_kernel(generator, *level.skip_dense.shape))
        for layer in self.post_block:
            conv(layer)
        self.head.kernel.copy_(init_ops.dense_kernel(generator, *self.head.kernel.shape))
        self.head.bias.zero_()
        for level in self.octaves:
            for name in ("down_norm", "up_norm"):
                if hasattr(level, name):
                    getattr(level, name).reset_parameters()
        return self

    def forward(self, x, t=None):
        return unet_apply(self.cfg, self, x, t)


def _conv_relu(layers, h, dtype):
    for layer in layers:
        h = tensor.layer_apply(layer, dtype, _conv3_relu, h)
    return h


def _conv3_relu(x, kernel, bias):
    return conv_ops.conv2d(x, kernel, bias, stride=1, relu=True)


def _pair_block_conv(h, layer, dtype):
    """Conv over a logical concat kept as an unmaterialised pair:
    conv(concat(a, b), K) = conv(a, K[:, :, :ca]) + conv(b, K[:, :, ca:]);
    the sum, bias and ReLU in the second conv's epilogue."""
    if not isinstance(h, tuple):
        return _conv_relu([layer], h, dtype)

    def pair(a, b, kernel, bias):
        ca = a.shape[-1]
        ya = conv_ops.conv2d(a, kernel[:, :, :ca], None, stride=1)
        return conv_ops.conv2d(b, kernel[:, :, ca:], bias, stride=1, relu=True, other=ya)

    return tensor.layer_apply(layer, dtype, pair, *h)


def _pair_up_conv(h, layer, dtype, relu: bool = True):
    if not isinstance(h, tuple):
        return tensor.layer_apply(
            layer, dtype, lambda x, k, b: conv_ops.up_conv(x, k, b, relu=relu), h)

    def pair(a, b, kernel, bias):
        ca = a.shape[-1]
        ya = conv_ops.up_conv(a, kernel[:, :, :ca], None, relu=False)
        return conv_ops.up_conv(b, kernel[:, :, ca:], bias, relu=relu, other=ya)

    return tensor.layer_apply(layer, dtype, pair, *h)


def _pair_dense(h, layer, dtype):
    kernel, bias = layer.kernel.to(dtype), layer.bias.to(dtype)
    if not isinstance(h, tuple):
        return conv_ops.dense(h, kernel, bias)
    a, b = h
    ca = a.shape[-1]
    return conv_ops.dense(a, kernel[:ca]) + conv_ops.dense(b, kernel[ca:], bias)


def _blocks_after_pair(layers, h, dtype):
    """A block whose first conv may receive a (branch, skip) pair."""
    for n, layer in enumerate(layers):
        h = _pair_block_conv(h, layer, dtype) if n == 0 else _conv_relu([layer], h, dtype)
    return h


def octave_down(cfg, level, h, dtype):
    """One octave's descent: down conv (+ norm) + block_in. Returns
    ``(h, skip)``."""
    inp = h
    normed = cfg.g_norm != "none"
    h = tensor.layer_apply(
        level.down, dtype,
        lambda x, k, b: conv_ops.down_conv(x, k, b, relu=not normed), h)
    if normed:
        h = torch.relu(norm_ops.apply_norm(cfg.g_norm, h, level.down_norm))
    return _conv_relu(level.block_in, h, dtype), inp


def octave_up(cfg, level, h, inp, dtype):
    """One octave's ascent: block_out + up conv (+ norm) + skip merge with
    ``inp``."""
    h = _blocks_after_pair(level.block_out, h, dtype)
    normed = cfg.g_norm != "none"
    h = _pair_up_conv(h, level.up, dtype, relu=not normed)
    if normed:
        h = torch.relu(norm_ops.apply_norm(cfg.g_norm, h, level.up_norm))
    if cfg.skip_mode == "concat":
        h = h.to(inp.dtype)  # branch cast (reference train.py:113-119)
        if cfg.concat_elision:
            return (h, inp)
        return torch.cat([h, inp], dim=-1)
    if cfg.skip_mode == "residual":
        return inp + conv_ops.dense(h, level.skip_dense.to(dtype)).to(inp.dtype)
    return h


def unet_head(cfg, model, h, t, dtype):
    """post_block + Dense head (+ the vestigial per-step gather on t−1)."""
    h = _blocks_after_pair(model.post_block, h, dtype)
    return per_step_gather(cfg, _pair_dense(h, model.head, dtype), t)


def per_step_gather(cfg, pred, t):
    """The head's (B, H, W, steps·3) output at each sample's step t − 1
    under ``per_step_output`` (unet.py:226-233); ``pred`` itself otherwise.
    Per sample and pixel, so a block of rows gathers alike."""
    if not cfg.per_step_output:
        return pred
    b, hh, ww, _ = pred.shape
    pred = pred.reshape(b, hh, ww, cfg.steps, 3)
    t_idx = (t.reshape(b, 1, 1, 1, 1).long() - 1).expand(b, hh, ww, 1, 3)
    return torch.gather(pred, 3, t_idx)[..., 0, :]


_FP32_LOCK = threading.Lock()
_fp32_regions = 0  # open ieee_fp32 regions on the card, process-wide
_fp32_saved = None  # the TF32 flags as the first open region found them


@contextlib.contextmanager
def ieee_fp32(dtype, device):
    """float32 convs and matmuls in IEEE float32 (the JAX package's
    Precision.HIGHEST): on the card cuDNN would otherwise run float32 convs in
    TF32. The flags are process-wide and read when a conv or matmul runs,
    forward or backward, so a caller that differentiates holds this context
    from the loss forward through ``backward()`` (the train step does);
    ``unet_apply`` holds it around its own forward.

    Regions may overlap, nested or across threads (an async checkpoint
    thread, the sampler between train steps, a server's requests): a count
    under a lock makes the first region to open save the flags and clear
    them, and the last to close restore them, so no region turns TF32 back
    on while another is open. Regions of other dtypes (TF32 applies only to
    float32 ops) and off the card are left alone."""
    global _fp32_regions, _fp32_saved
    if dtype != torch.float32 or device.type != "cuda":
        yield
        return
    with _FP32_LOCK:
        if _fp32_regions == 0:
            _fp32_saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _fp32_regions += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _fp32_regions -= 1
            if _fp32_regions == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
                    _fp32_saved)


def unet_apply(cfg, model: Denoiser, x, t=None):
    """Forward pass. ``x``: (B, H, W, C) in [-1, 1). ``t``: (B,) timesteps,
    ignored unless ``cfg.per_step_output``.

    ``cfg.remat`` rematerialises each inner octave in the backward (JAX's
    ``jax.checkpoint`` at unet.py:255-257): ``rec(i + 1, ·)`` runs under
    ``torch.utils.checkpoint``, which keeps only its input and recomputes
    the rest when the gradient needs it. The recompute holds its own
    ``ieee_fp32`` region and reopens the ranks over which the forward took
    batch norm's statistics (``ops/norm.stats_over``), so it runs as the
    forward ran on whatever thread autograd calls it (on the card, its
    device thread); B4's autograd Function is recomputed as it ran."""
    dtype = DTYPES[cfg.compute_dtype]
    stats = norm_ops.stats_names()
    with ieee_fp32(dtype, x.device):
        h = _conv_relu(model.pre_block, x.to(dtype), dtype)

        def rec(i, h):
            level = model.octaves[i]
            h, inp = octave_down(cfg, level, h, dtype)
            if i + 1 < cfg.octaves:
                if cfg.remat and torch.is_grad_enabled():
                    h = checkpoint(_inner, i + 1, h, use_reentrant=False)
                else:
                    h = rec(i + 1, h)
            else:
                h = _conv_relu(model.middle, h, dtype)
            return octave_up(cfg, level, h, inp, dtype)

        def _inner(i, h):
            with ieee_fp32(dtype, h.device), norm_ops.stats_over(*stats):
                return rec(i, h)

        h = (rec(0, h) if cfg.octaves > 0
             else _conv_relu(model.middle, h, dtype))
        return unet_head(cfg, model, h, t, dtype)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
