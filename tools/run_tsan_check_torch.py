"""Race check of the PyTorch port's native data loader
(gan_class_transfer2_tpu_torch/data/native/dataloader.cc) under
ThreadSanitizer.

The loader runs a pool of C++ workers that claim batches, decode and
augment them, and hand them to ``dl_next`` in claim order; ``dl_stop`` may
come from another thread while a consumer is blocked in ``dl_next``. This
tool builds the source with ``g++ -fsanitize=thread`` into the git-ignored
``gan_class_transfer2_tpu_torch/build/`` directory and drives it through
ctypes in a subprocess with ``libtsan`` preloaded, in four cases:

  1. 50 batches at 4 workers (a ring of 2: maximum contention);
  2. a stop in the middle of an epoch at 8 workers, then destruction;
  3. destruction without a stop, workers still running;
  4. a stop while another thread is blocked in ``dl_next``.

    python tools/run_tsan_check_torch.py

Exit 0: every case ran and TSan reported nothing. Exit 1: a TSan report
(printed). Any other code: the build or the probe failed.
"""

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gan_class_transfer2_tpu_torch")
SOURCE = os.path.join(PORT, "data", "native", "dataloader.cc")
BUILD = os.path.join(PORT, "build")

PROBE = r"""
import ctypes, os, sys, threading, time
import numpy as np

lib = ctypes.CDLL(os.environ["TSAN_LIB"])
lib.dl_create.restype = ctypes.c_void_p
lib.dl_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
lib.dl_next.restype = ctypes.c_int
lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
lib.dl_stop.restype = None
lib.dl_stop.argtypes = [ctypes.c_void_p]
lib.dl_destroy.restype = None
lib.dl_destroy.argtypes = [ctypes.c_void_p]

SIZE, BATCH = 16, 4
small = sys.argv[1:9]
large = sys.argv[9:]


def create(paths, workers, capacity):
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    h = lib.dl_create(arr, len(paths), SIZE, BATCH, workers, capacity, 0)
    assert h, "dl_create failed"
    return h


out = np.empty((BATCH, SIZE, SIZE, 3), np.float32)
ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

# 1. 50 batches at 4 workers
h = create(small, 4, 2)
for _ in range(50):
    assert lib.dl_next(h, ptr) == 0
lib.dl_destroy(h)
print("case 1: 50 batches at 4 workers", flush=True)

# 2. a stop in the middle of an epoch at 8 workers
h = create(small, 8, 2)
for _ in range(3):
    assert lib.dl_next(h, ptr) == 0
lib.dl_stop(h)
assert lib.dl_next(h, ptr) == -1
lib.dl_destroy(h)
print("case 2: stop mid-epoch at 8 workers", flush=True)

# 3. destruction without a stop
h = create(small, 4, 2)
assert lib.dl_next(h, ptr) == 0
lib.dl_destroy(h)
print("case 3: destroy without stop", flush=True)

# 4. a stop while another thread is blocked in dl_next: large images and
# one worker keep the consumer waiting
h = create(large, 1, 1)
codes, entered = [], threading.Event()
own = np.empty_like(out)


def consume():
    own_ptr = own.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    while True:
        entered.set()
        rc = lib.dl_next(h, own_ptr)  # ctypes drops the GIL here
        codes.append(rc)
        if rc != 0:
            return


t = threading.Thread(target=consume)
t.start()
assert entered.wait(30)
time.sleep(0.2)
lib.dl_stop(h)
t.join(60)
assert not t.is_alive(), "the consumer stayed blocked after dl_stop"
assert codes and codes[-1] == -1, codes
lib.dl_destroy(h)
print(f"case 4: stop with a consumer blocked in dl_next ({len(codes) - 1} batches before)",
      flush=True)
print("tsan probe done", flush=True)
"""


def build() -> str:
    """The TSan build of the loader with the port's own link flags
    (``native_loader._flags()``: zlib, and libjpeg where its header is
    found), at -O1 with ``-fsanitize=thread -g``; returns the library's
    path."""
    from gan_class_transfer2_tpu_torch.data import native_loader

    os.makedirs(BUILD, exist_ok=True)
    out = os.path.join(BUILD, "dataloader-tsan.so")
    cmd = ["g++", "-O1", "-g", "-fsanitize=thread", "-fPIC", "-std=c++17", "-shared",
           "-pthread", "-o", out, SOURCE, *native_loader._flags()]
    subprocess.run(cmd, check=True)
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    import numpy as np

    from gan_class_transfer2_tpu_torch.utils import png

    lib = build()
    tsan = subprocess.run(["g++", "-print-file-name=libtsan.so"], capture_output=True,
                          text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(0)
        paths = []
        for i, side in enumerate([20] * 8 + [512] * 4):
            p = os.path.join(d, f"i{i}.png")
            png.write_png(p, rng.integers(0, 256, (side, side, 3), dtype=np.uint8))
            paths.append(p)
        env = dict(os.environ, TSAN_LIB=lib, LD_PRELOAD=tsan,
                   TSAN_OPTIONS="halt_on_error=0 exitcode=66")
        proc = subprocess.run([sys.executable, "-c", PROBE, *paths], env=env,
                              capture_output=True, text=True, timeout=600)
    sys.stdout.write(proc.stdout)
    if "WARNING: ThreadSanitizer" in proc.stderr:
        sys.stderr.write(proc.stderr)
        print("TSAN: data races detected", file=sys.stderr)
        return 1
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-2000:])
        print(f"TSAN probe exit {proc.returncode}", file=sys.stderr)
        return proc.returncode
    print("TSAN: no data races in the 4 cases")
    return 0


if __name__ == "__main__":
    sys.exit(main())
