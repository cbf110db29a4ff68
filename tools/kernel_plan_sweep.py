#!/usr/bin/env python3
"""Sweeps the plans of the port's two planned kernels on one NVIDIA card and
prints their device time, so that a plan's choice can be checked against
its neighbours:

  * B4 (csrc/down_conv.cu): at the four full-width down convs, batch 4 and
    16, float32 and bfloat16, the split of K the plan picks, half of it and
    twice it; device time of the kernel and its split-K sum, by
    torch.profiler;
  * B3 (csrc/instance_norm.cu): at the seven GAN maps at batch 16, every
    cluster size from 1 to 8 that puts at least 64 blocks on the card; then
    B3 over height blocks at the 12 norm blocks of a spatial rank (the
    default model on 2 height shards, batch 16): device time of the stats
    and merge-and-apply pair under ``norm.block_plan`` with each
    ``lane_pixels`` (where a group stops being a few warps and takes a
    block, then a cluster) and, where a group takes a block, each cluster
    size;
  * the host cost of one B4 call (wrapper, bare C entry, one F.conv2d) at a
    shape whose device time is small;
  * B1 (csrc/diffuse.cu) at batch 16 × 256²×3: device time with L2 warm
    and cold (after a 64 MB scrub write), ptxas registers and spills, the
    SASS instructions by class, two probes built here and nowhere else (the
    Philox rounds cut to one XOR: what Philox costs; ``--use_fast_math``:
    what the IEEE log, cos and sqrt cost), the host µs of one wrapper call
    against the bare C entry, and the launches and host µs of the train
    step's draw of (t, seed) and its forward diffusion
    (``trainer.draw_and_diffuse``);
  * B1's knobs (``b1-knobs``): groups a thread and the form of Philox's
    multiply, set by substitution in its source, device time of each;
  * B3's statistics pass over height blocks (``b3-pass1``), what it is
    short of: at the two largest norm blocks of a spatial rank (the
    default model on 2 height shards, batch 16), float32 and bfloat16, the
    stats launch's device time beside a ladder of streaming kernels built
    here (the same bytes read 16 bytes a thread, 8 loads in flight, each
    element widened to float32 and run through 0, 1, 2, 4, 8 or 16 FFMAs):
    the ladder's first rung is what the loads alone take, and the rung the
    stats launch matches says how many issue slots an element costs it;
    then the static SASS of each kernel of csrc/instance_norm.cu by class.

Run it from the root of a checkout on a machine with a card, with the
sections to run (default all):

    python3 tools/kernel_plan_sweep.py [b4] [b3] [host] [b1] [b1-knobs] [b3-pass1]
"""

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gan_class_transfer2_tpu_torch.ops import _build  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import fused_down_conv as fdc  # noqa: E402
from gan_class_transfer2_tpu_torch.ops import norm  # noqa: E402

B4_SHAPES = ((128, 128, 256), (64, 256, 512), (32, 512, 512), (16, 512, 512))
B3_MAPS = ((256, 64), (128, 128), (64, 256), (32, 512), (16, 512), (8, 512), (4, 512))


def device_us(fn, reps=10, match=None):
    """Device time of one call of fn, summed over its CUDA kernels (those
    whose name contains ``match``, when given)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if match is None or match in e.key) / reps


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


def spatial_blocks():
    """The 12 (B, h, W, C) norm blocks of a rank: the default model on 2
    height shards at batch 16, each octave's down norm, then its up norm."""
    from gan_class_transfer2_tpu_torch.config import Config

    cfg = Config().validate()
    out = []
    for i in range(cfg.octaves):
        d, u = cfg.size >> (i + 1), cfg.size >> i
        out += [(16, d // 2, d, cfg.octave_filters(i)), (16, u // 2, u, cfg.octave_up_filters(i))]
    return out


LANE_PIXELS = (2, 4, 8, 16, 32, 64)


def sweep_b3_blocks(gen):
    chosen = norm.block_plan
    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in spatial_blocks():
            b, h, w, c = shape
            x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 2).to(dtype)
            g, bt = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
            parts = torch.stack([norm.block_stats(x), norm.block_stats(x)]).contiguous()
            nq = b * -(-c // norm.CHANNELS)
            plans = {f"lane_pixels {n}": chosen(b, h, w, c, dtype, n) for n in LANE_PIXELS}
            p0 = chosen(b, h, w, c, dtype)
            if p0.wpg == norm.WARPS:
                for s in (1, 2, 4, 8):
                    plans[f"S {s}"] = norm.BlockPlan(p0.wpg, p0.wpb, s, -(-h * w // s), nq * s)
            out = []
            for tag, p in plans.items():
                norm.block_plan = lambda *a, p=p: p
                try:
                    us = device_us(lambda: (norm.block_stats(x),
                                            norm.block_merge_apply(x, parts, g, bt)))
                finally:
                    norm.block_plan = chosen
                totals[(dtype, tag)] = totals.get((dtype, tag), 0.0) + us
                out.append(f"{tag} (wpg {p.wpg}, wpb {p.wpb}, S {p.cluster}, {p.blocks} blocks) "
                           f"{us:.1f}")
            print(f"[sweep] B3 height block {str(dtype)[6:]} {shape}, plan wpg {p0.wpg} wpb "
                  f"{p0.wpb} S {p0.cluster}: stats + merge-and-apply device us " + "; ".join(out))
            del x
    for dtype in (torch.float32, torch.bfloat16):
        print(f"[sweep] B3 height blocks {str(dtype)[6:]}, the 12 blocks' pairs summed, device "
              f"us: " + "; ".join(f"{tag} {us:.1f}" for (dt, tag), us in totals.items()
                                  if dt == dtype and not tag.startswith("S ")))


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


# ------------------------------------------------------------------ B1

SASS_CLASSES = ("IMAD.HI", "IMAD.WIDE", "IMAD", "LOP3", "IADD3", "SHF", "I2F", "MUFU", "FFMA",
                "FMUL", "FADD", "LDG", "STG")
# the Philox rounds of a probe: one XOR of the key into each counter, so the
# words still vary with (group, sample, half, seed) and nothing is folded away
NO_PHILOX = ("  for (int i = 0; i < BLOCKS; ++i) {\n    c[i][0] ^= k0;\n    c[i][1] ^= k1;\n"
             "    c[i][2] ^= k0;\n    c[i][3] ^= k1;\n  }\n")


def _tool(name):
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(found):
        raise RuntimeError(f"{name} not found")
    return found


def build_variant(tag, source, extra=()):
    """nvcc ``source`` (text) with the port's flags and ``extra`` into
    build/; returns (CDLL, ptxas lines, SASS counts by class)."""
    key = hashlib.sha1(source.encode() + " ".join(extra).encode()).hexdigest()[:10]
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD / f"probe-{tag}-{key}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(source)
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc {tag}:\n{done.stderr}")
    ptxas = [ln.strip() for ln in (done.stdout + done.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "stack" in ln]
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts = collections.Counter()
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", sass):
        op = m.group(1)
        counts[next((c for c in SASS_CLASSES if op == c or op.startswith(c + ".")), "other")] += 1
    return ctypes.CDLL(str(so)), ptxas, counts


def without_philox(source, body):
    """The source with philox4x32_10's rounds replaced by ``body``."""
    pat = r"(__device__ __forceinline__ void philox4x32_10\(.*?\) \{\n).*?\n\}\n"
    out, n = re.subn(pat, lambda m: m.group(1) + body + "}\n", source, count=1, flags=re.S)
    if n != 1:
        raise RuntimeError("philox4x32_10 not found in the source")
    return out


def _table_args(fn, x, t, table, seed, out):
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, n = x.shape
    return (x.data_ptr(), t.data_ptr(), table.data_ptr(), table.shape[0], seed.data_ptr(),
            out.data_ptr(), b, n, _build.current_stream(x.device.index))


INT_CLASSES = ("IMAD.HI", "IMAD.WIDE", "IMAD", "LOP3", "IADD3", "SHF")


def sweep_b1(gen):
    from gan_class_transfer2_tpu_torch.config import Config
    from gan_class_transfer2_tpu_torch.ops import fused_diffusion as fd
    from gan_class_transfer2_tpu_torch.train import trainer

    cfg = Config().validate()
    b, n = 16, cfg.size * cfg.size * 3
    x = torch.rand((b, n), generator=gen, device="cuda") * 2 - 1
    t = torch.randint(1, cfg.steps + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    table = fd.scale_table(cfg.steps, cfg.schedule, "cuda")
    seed = torch.randint(0, 2**62, (1,), generator=gen, device="cuda")
    out = torch.empty_like(x)
    scrub = torch.empty(16 * 2**20, device="cuda")  # 64 MB, more than the 50 MB L2
    ref = fd.diffuse_plain(x, t, table, seed)
    nbytes = 8 * x.numel()
    print(f"[b1] x ({b}, {n}) float32; {nbytes / 1e6:.1f} MB moved; byte bound "
          f"{nbytes / 3.35e12 * 1e6:.2f} us at 3.35 TB/s")
    source = (_build.CSRC / "diffuse.cu").read_text()
    ints = {}
    for tag, src, extra in (("as built", source, ()),
                            ("no Philox", without_philox(source, NO_PHILOX), ()),
                            ("fast math", source, ("--use_fast_math",))):
        lib, ptxas, sass = build_variant(tag.replace(" ", "_"), src, extra)
        fn = lib.gct2_diffuse_f32
        args = _table_args(fn, x, t, table, seed, out)

        def call(fn=fn, args=args):
            err = fn(*args)
            if err:
                raise RuntimeError(f"CUDA error {err}")

        if tag == "as built":
            bare = call
        ints[tag] = sum(sass[c] for c in INT_CLASSES)
        call()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        warm = device_us(call, reps=100, match="diffuse")
        cold = device_us(lambda: (scrub.fill_(1.0), call()), reps=100, match="diffuse")
        print(f"[b1] csrc/diffuse.cu, {tag}: device us L2 warm {warm:.2f}, cold {cold:.2f} "
              f"(= {nbytes / 3.35e12 * 1e6 / cold:.0%} of the byte bound); max|out - plain| "
              f"{err:.3e}; ptxas {' | '.join(ptxas)}")
        print("[b1]   SASS (static, whole kernel): "
              + ", ".join(f"{c} {sass[c]}" for c in (*SASS_CLASSES, "other")))
    groups = int(re.search(r"constexpr int GROUPS = (\d+);", source).group(1))
    philox = ints["as built"] - ints["no Philox"]
    print(f"[b1] integer SASS the Philox rounds add: {philox} for a thread's {4 * groups} "
          f"elements, {philox / (4 * groups):.1f} an element")
    # host cost of one call, back to back: the bare C entry, the wrapper, and
    # the wrapper's CUDA-event mean (as chip_smoke.py times it)
    print(f"[b1] host us a call, back to back: wrapper "
          f"{host_us(lambda: fd.diffuse_fused(x, t, table, seed)):.2f}; bare C entry "
          f"{host_us(bare):.2f}; CUDA-event mean of the wrapper "
          f"{cuda_event_us(lambda: fd.diffuse_fused(x, t, table, seed)):.2f}")

    # the step's prologue on the fused path: the draws of t and the seed, and
    # B1 through its autograd Function
    batch = x.reshape(b, cfg.size, cfg.size, 3)
    step_gen = torch.Generator(device="cuda").manual_seed(1)

    def prologue():
        trainer.draw_and_diffuse(cfg, batch, step_gen)

    for _ in range(3):
        prologue()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prologue()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    launches = sum(e.count for e in rows if e.key in ("cudaLaunchKernel", "cudaMemcpyAsync"))
    kernels = [(e.key, e.count) for e in rows if e.device_time_total > 0
               and not e.key.startswith(("cuda", "aten::", "Activity"))]
    print(f"[b1] draw_and_diffuse (fused path, generator on the card): {launches} launches a "
          f"step ({sum(c for _, c in kernels)} device ops), host us a call "
          f"{host_us(prologue):.2f}, device us {device_us(prologue):.2f}; "
          + "; ".join(f"{c} x {k[:50]}" for k, c in kernels))


B1_KNOBS = {
    # float4 groups a thread takes
    "groups": ("constexpr int GROUPS = 2;", "constexpr int GROUPS = {};"),
    # each Philox product as one 32×32→64 multiply (IMAD.WIDE.U32) instead
    # of a low and a high multiply
    "wide": ("const uint32_t lo0 = 0xD2511F53u * c[i][0], hi0 = __umulhi(0xD2511F53u, c[i][0]);\n"
             "      const uint32_t lo1 = 0xCD9E8D57u * c[i][2], hi1 = __umulhi(0xCD9E8D57u, c[i][2]);",
             "const unsigned long long p0 = 0xD2511F53ull * c[i][0], p1 = 0xCD9E8D57ull * c[i][2];\n"
             "      const uint32_t lo0 = static_cast<uint32_t>(p0), hi0 = static_cast<uint32_t>(p0 >> 32);\n"
             "      const uint32_t lo1 = static_cast<uint32_t>(p1), hi1 = static_cast<uint32_t>(p1 >> 32);"),
}


def sweep_b1_knobs(gen):
    """Device time of csrc/diffuse.cu with its knobs set otherwise (by
    substitution in its source, B1_KNOBS), at batch 16 × 256²×3, L2 warm
    and cold; then the host cost of one call at a shape whose device time
    is small."""
    from gan_class_transfer2_tpu_torch.ops import fused_diffusion as fd

    b, n = 16, 256 * 256 * 3
    x = torch.rand((b, n), generator=gen, device="cuda") * 2 - 1
    t = torch.randint(1, 201, (b,), generator=gen, device="cuda", dtype=torch.int32)
    table = fd.scale_table(200, "quadratic", "cuda")
    seed = torch.randint(0, 2**62, (1,), generator=gen, device="cuda")
    out = torch.empty_like(x)
    scrub = torch.empty(16 * 2**20, device="cuda")
    ref = fd.diffuse_plain(x, t, table, seed)
    source = (_build.CSRC / "diffuse.cu").read_text()
    if any(old not in source for old, _ in B1_KNOBS.values()):
        raise RuntimeError("a knob's text is not in csrc/diffuse.cu")
    for groups in (1, 2, 4, 8):
        for wide in (False, True):
            src = source.replace(B1_KNOBS["groups"][0], B1_KNOBS["groups"][1].format(groups))
            if wide:
                src = src.replace(*B1_KNOBS["wide"])
            lib, ptxas, sass = build_variant(f"knob_g{groups}{'w' if wide else ''}", src)
            fn = lib.gct2_diffuse_f32
            args = _table_args(fn, x, t, table, seed, out)
            call = lambda fn=fn, args=args: fn(*args)  # noqa: E731
            call()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            warm = device_us(call, reps=100, match="diffuse")
            cold = device_us(lambda: (scrub.fill_(1.0), call()), reps=100, match="diffuse")
            regs = next((ln.split("Used ")[1].split(",")[0] for ln in ptxas if "Used" in ln), "?")
            print(f"[b1-knobs] groups {groups}, wide {wide}: device us warm {warm:.2f}, cold "
                  f"{cold:.2f}; {regs}; max|out - plain| {err:.1e}; SASS IMAD.WIDE "
                  f"{sass['IMAD.WIDE']} IMAD.HI {sass['IMAD.HI']} IMAD {sass['IMAD']} LOP3 "
                  f"{sass['LOP3']} IADD3 {sass['IADD3']}")
    # the host's share: one call at a shape whose device time is ~2 us
    xs, ts, small = x[:1, :768].contiguous(), t[:1].contiguous(), out[:1, :768].contiguous()
    fn = fd._entry()
    args = _table_args(fn, xs, ts, table, seed, small)
    print(f"[b1-knobs] host us a call at (1, 768): wrapper "
          f"{host_us(lambda: fd.diffuse_fused(xs, ts, table, seed)):.2f}, bare C entry "
          f"{host_us(lambda: fn(*args)):.2f}, torch.empty_like "
          f"{host_us(lambda: torch.empty_like(xs)):.2f}")


# ------------------------------------------------------- B3's pass 1

LADDER_SOURCE = r"""
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// x read once as 16-byte words, 8 in flight a thread (B3's load pattern);
// each element widened and put through OPS dependent FFMAs (none: its bits
// folded by XOR, so the loads stay live)
template <typename T, int OPS>
__global__ void __launch_bounds__(256) ladder(const uint4* __restrict__ x, size_t n, float* out) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  float acc[VEC];
  uint32_t bits = 0;
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += 8 * stride) {
    uint4 raw[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      raw[k] = i + k * stride < n ? x[i + k * stride] : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if constexpr (OPS == 0) {
        bits ^= raw[k].x ^ raw[k].y ^ raw[k].z ^ raw[k].w;
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float e = widen(reinterpret_cast<const T*>(&raw[k])[v]);
#pragma unroll
          for (int o = 0; o < OPS; ++o) acc[v] = __fmaf_rn(acc[v], 0.999f, e);
        }
      }
    }
  }
  float s = __uint_as_float(bits);
#pragma unroll
  for (int v = 0; v < VEC; ++v) s += acc[v];
  if (s == 1234.5f) out[0] = s;  // never true; keeps the work
}

template <typename T>
int run(const void* x, size_t n, void* out, int ops, int blocks, void* stream) {
  const uint4* xv = static_cast<const uint4*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ops) {
    case 0: ladder<T, 0><<<blocks, 256, 0, s>>>(xv, n, o); break;
    case 1: ladder<T, 1><<<blocks, 256, 0, s>>>(xv, n, o); break;
    case 2: ladder<T, 2><<<blocks, 256, 0, s>>>(xv, n, o); break;
    case 4: ladder<T, 4><<<blocks, 256, 0, s>>>(xv, n, o); break;
    case 8: ladder<T, 8><<<blocks, 256, 0, s>>>(xv, n, o); break;
    case 16: ladder<T, 16><<<blocks, 256, 0, s>>>(xv, n, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ladder_f32(const void* x, size_t n, void* out, int ops, int blocks, void* s) {
  return run<float>(x, n, out, ops, blocks, s);
}
extern "C" int ladder_bf16(const void* x, size_t n, void* out, int ops, int blocks, void* s) {
  return run<__nv_bfloat16>(x, n, out, ops, blocks, s);
}
"""
LADDER_OPS = (0, 1, 2, 4, 8, 16)


def sass_by_function(so):
    """{demangled kernel name: Counter of SASS classes} of a built library."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = chunk.split("\n", 1)
        filt = shutil.which("c++filt")
        if filt:
            name = subprocess.run([filt, name.strip()], capture_output=True,
                                  text=True).stdout.strip()
        counts = collections.Counter()
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", body):
            op = m.group(1)
            counts[next((c for c in B3_SASS if op == c or op.startswith(c + ".")),
                        "other")] += 1
        out[name] = counts
    return out


B3_SASS = ("FADD", "FMUL", "FFMA", "MUFU", "FSETP", "CALL", "SHFL", "BAR", "LDG", "STG",
           "PRMT", "IMAD", "SHF")


def sweep_b3_pass1(gen):
    from gan_class_transfer2_tpu_torch.config import Config

    lib, ptxas, _ = build_variant("ladder", LADDER_SOURCE)
    cfg = Config().validate()
    top = (16, cfg.size // 2, cfg.size, cfg.octave_up_filters(0))  # the 256² up norm's block
    nxt = (16, cfg.size // 4, cfg.size // 2, cfg.octave_filters(0))  # the 128² down norm's
    stream = _build.current_stream(0)
    out = torch.zeros(1, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        fn = getattr(lib, "ladder_f32" if dtype == torch.float32 else "ladder_bf16")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for shape in (top, nxt):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            nbytes = x.numel() * x.element_size()
            bound = nbytes / 3.35e12 * 1e6
            stats = device_us(lambda: norm.block_stats(x), reps=20)
            rungs = []
            for ops in LADDER_OPS:
                def call(ops=ops):
                    err = fn(x.data_ptr(), nbytes // 16, out.data_ptr(), ops, 132 * 8, stream)
                    if err:
                        raise RuntimeError(f"ladder: CUDA error {err}")
                rungs.append(f"{ops} FFMA {device_us(call, reps=20):.1f}")
            print(f"[b3-pass1] {str(dtype)[6:]} block {shape} ({nbytes / 1e6:.1f} MB, read "
                  f"bound {bound:.1f} us): stats launch {stats:.1f} us = {bound / stats:.0%} of "
                  f"the bound; streaming ladder (device us; FFMAs an element after widening): "
                  + "; ".join(rungs))
            del x
    for name, counts in sass_by_function(_build.library_path("instance_norm")).items():
        print(f"[b3-pass1] SASS (static) {name[:90]}: "
              + ", ".join(f"{c} {counts[c]}" for c in (*B3_SASS, "other")))


def cuda_event_us(fn, reps=50):
    """CUDA-event mean over back-to-back calls, as chip_smoke.py times."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


SECTIONS = {"b4": sweep_b4, "b3": lambda gen: (sweep_b3(gen), sweep_b3_blocks(gen)), "host": host_cost, "b1": sweep_b1,
            "b1-knobs": sweep_b1_knobs, "b3-pass1": sweep_b3_pass1}


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_plan_sweep: needs an NVIDIA card")
    names = sys.argv[1:] or list(SECTIONS)
    if any(n not in SECTIONS for n in names):
        sys.exit(f"kernel_plan_sweep: sections are {sorted(SECTIONS)}, got {names}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[sweep] {card.splitlines()[0]}; torch {torch.__version__}")
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in names:
        SECTIONS[name](gen)


if __name__ == "__main__":
    main()
