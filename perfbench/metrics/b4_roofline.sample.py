"""b4_roofline.sample: the hand-written 4×4/s2 down conv B4
(``ops/fused_down_conv.py``, ``csrc/down_conv.cu``; device operations
``down_conv_bf16_kernel`` / ``down_conv_f32_kernel`` and their split-K
``split_reduce_kernel``) in the sampler, against its least time: the larger
of its operations at the dense peak and its bytes at the bandwidth, over
B4's device time in the traced window, %.

B4 serves the down convs its shape gate admits (the kernel's domain, from
``supported`` in the port: C a multiple of 128, an output of at least 8 × 8,
O a multiple of its tile); the reference's forwards record every down
conv's shape, and one launch of the main kernel a call is required."""

from perfbench.harness import counts, readers

KERNELS = r"\b(down_conv_(bf16|f32)_kernel|split_reduce_kernel)\b"
MAIN = r"\bdown_conv_(bf16|f32)_kernel\b"


def served(x_shape, k_shape) -> bool:
    b, c, h, w = x_shape
    o = k_shape[3]
    tile = min(o, 128 if c >= 256 else 256)
    return c % 128 == 0 and h % 2 == 0 and w % 2 == 0 and h // 2 >= 8 and (
        w // 2 >= 8) and o % tile == 0


def read(run):
    dtype = run.config["compute_dtype"]
    calls = [c for c in run.extra.get("calls_per_unit", [])
             if c[0] == "down_conv" and served(c[1], c[2])]
    return readers.roofline(run, KERNELS, calls, lambda c: counts.down_conv(c[1], c[2], dtype),
                            launch_pattern=MAIN)
