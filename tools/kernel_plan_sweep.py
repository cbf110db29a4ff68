#!/usr/bin/env python3
"""Sweeps the plans of the port's two planned kernels on one NVIDIA card and
prints their device time, so that a plan's choice can be checked against
its neighbours:

  * B4 (csrc/down_conv.cu): at the four full-width down convs, batch 4 and
    16, float32 and bfloat16, the split of K the plan picks, half of it and
    twice it; device time of the kernel and its split-K sum, by
    torch.profiler;
  * B3 (csrc/instance_norm.cu): at the seven GAN maps at batch 16, every
    cluster size from 1 to 8 that puts at least 64 blocks on the card;
  * the host cost of one B4 call (wrapper, bare C entry, one F.conv2d) at a
    shape whose device time is small.

Run it from the root of a checkout on a machine with a card:

    python3 tools/kernel_plan_sweep.py
"""

import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gan_class_transfer2_tpu_torch.ops import _build  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import norm  # noqa: E402

B4_SHAPES = ((128, 128, 256), (64, 256, 512), (32, 512, 512), (16, 512, 512))
B3_MAPS = ((256, 64), (128, 128), (64, 256), (32, 512), (16, 512), (8, 512), (4, 512))


def device_us(fn, reps=10):
    """Device time of one call of fn, summed over its CUDA kernels."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / reps


def host_us(fn, reps=300):
    """Wall time of one call of fn, back to back, synchronised at the end."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def sweep_b4(gen):
    chosen = fdc.plan
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (4, 16):
            for hw, c, o in B4_SHAPES:
                x = torch.randn((batch, hw, hw, c), generator=gen, device="cuda").to(dtype)
                k = (torch.randn((4, 4, c, o), generator=gen, device="cuda")
                     / (16 * c) ** 0.5).to(dtype)
                b = (torch.randn((o,), generator=gen, device="cuda") * 0.1).to(dtype)
                p0 = chosen(batch, hw, hw, c, o, dtype)
                m = batch * (hw // 2) ** 2
                out = []
                for split in sorted({max(1, p0.split // 2), p0.split, p0.split * 2}):
                    if p0.k_slices % split:
                        continue
                    p = p0._replace(split=split, ws_elems=split * m * p0.o_pad if split > 1 else 0)
                    fdc.plan = lambda *a, p=p: p
                    try:
                        with torch.inference_mode():
                            us = device_us(lambda: fdc.down_conv_fused(x, k, b))
                    finally:
                        fdc.plan = chosen
                    out.append(f"split {split} ({p.blocks} blocks) {us:.1f}")
                print(f"[sweep] B4 {str(dtype)[6:]} batch {batch} {hw}²x{c}->{o}, plan split "
                      f"{p0.split}: device us {'; '.join(out)}")
                del x, k, b


def sweep_b3(gen):
    chosen = norm.plan
    for dtype in (torch.float32, torch.bfloat16):
        for hw, c in B3_MAPS:
            x = torch.randn((16, hw, hw, c), generator=gen, device="cuda").to(dtype)
            g, bt = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
            base = -(-c // norm.CHANNELS) * 16
            out = []
            for s in (1, 2, 4, 8):
                if base * s < 64:
                    continue
                p = norm.NormPlan(s, -(-hw * hw // s), base * s)
                norm.plan = lambda *a, p=p: p
                try:
                    us = device_us(lambda: norm.instance_norm_fused(x, g, bt))
                finally:
                    norm.plan = chosen
                bound = 2 * x.numel() * x.element_size() / 3.35e12 * 1e6
                out.append(f"S {s} ({p.blocks} blocks) {us:.1f} = {bound / us:.0%}")
            s0 = chosen(16, hw, hw, c).cluster
            print(f"[sweep] B3 {str(dtype)[6:]} 16x{hw}²x{c}, plan S {s0}: device us (share of "
                  f"the byte bound) {'; '.join(out)}")
            del x


def host_cost(gen):
    x = torch.randn((4, 16, 16, 512), generator=gen, device="cuda").bfloat16()
    k = (torch.randn((4, 4, 512, 512), generator=gen, device="cuda") / 90).bfloat16()
    b = (torch.randn((512,), generator=gen, device="cuda") * 0.1).bfloat16()
    p = fdc.plan(4, 16, 16, 512, 512, torch.bfloat16)
    y = torch.empty((4, 8, 8, 512), dtype=torch.bfloat16, device="cuda")
    ws = torch.empty(p.ws_elems, device="cuda")
    fn = fdc._entry(torch.bfloat16)
    args = (x.data_ptr(), k.data_ptr(), b.data_ptr(), y.data_ptr(), ws.data_ptr(), 4, 16, 16,
            512, 512, 512, 1, p.split, *p.box, torch.cuda.current_stream().cuda_stream)
    xl = x.permute(0, 3, 1, 2)
    wl = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        rows = {"down_conv_fused": host_us(lambda: fdc.down_conv_fused(x, k, b)),
                "bare C entry": host_us(lambda: fn(*args)),
                "F.conv2d": host_us(lambda: F.conv2d(xl, wl, b, stride=2, padding=1))}
        dev = device_us(lambda: fdc.down_conv_fused(x, k, b))
    print(f"[sweep] host us a call, bf16 batch 4 16²x512->512 (device {dev:.1f} us): "
          + ", ".join(f"{k} {v:.1f}" for k, v in rows.items()))


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_plan_sweep: needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[sweep] {card.splitlines()[0]}; torch {torch.__version__}")
    _build.build_all(["down_conv", "instance_norm"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    sweep_b4(gen)
    sweep_b3(gen)
    host_cost(gen)


if __name__ == "__main__":
    main()
