#!/usr/bin/env python3
"""Checks which collectives the gloo backend takes on CUDA tensors, with two
ranks sharing one card, and times a gradient-sized all-reduce.

The port's data-parallel ranks share a card over gloo when there are more
ranks than cards (nccl refuses two ranks on one device;
``parallel/multihost.backend_and_device``), and hand gloo the CUDA tensors
themselves. This probe spawns two processes on ``cuda:0``, runs
``all_reduce``, ``broadcast``, ``all_gather``, ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``barrier`` on CUDA tensors and prints each
rank's result or error, then times three all-reduces of 41.7 M float32
values (the default model's gradient) on the card and from pinned host
memory. Run it from the root of a checkout on a machine with a card:

    python3 tools/gloo_cuda_probe.py
"""

import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N_GRAD = 41_700_000  # floats in the default model's gradient


def _worker(rank, port, queue):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    dev = torch.device("cuda:0")
    out = {}

    def attempt(name, fn):
        try:
            value = fn()
            torch.cuda.synchronize()
            out[name] = ("ok", value)
        except RuntimeError as e:  # what gloo raises for a tensor it does not take
            out[name] = ("error", f"{type(e).__name__}: {str(e)[:200]}")

    x = torch.full((1000,), float(rank + 1), device=dev)
    attempt("all_reduce", lambda: (dist.all_reduce(x), x[0].item())[1])
    y = torch.full((10,), float(rank), device=dev)
    attempt("broadcast", lambda: (dist.broadcast(y, 0), y[0].item())[1])
    z = torch.full((4, 3), float(rank), device=dev)
    parts = [torch.empty_like(z) for _ in range(2)]
    attempt("all_gather", lambda: (dist.all_gather(parts, z), [p[0, 0].item() for p in parts])[1])
    flat = torch.empty((8, 3), device=dev)
    attempt("all_gather_into_tensor",
            lambda: (dist.all_gather_into_tensor(flat, z), flat[:, 0].tolist())[1])
    half = torch.empty((2,), device=dev)
    attempt("reduce_scatter_tensor",
            lambda: (dist.reduce_scatter_tensor(half, torch.ones(4, device=dev)),
                     half.tolist())[1])
    attempt("barrier", dist.barrier)

    def timed(t):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_reduce(t)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return times

    g = torch.randn(N_GRAD, device=dev)
    attempt("all_reduce_167MB_cuda_s", lambda: timed(g))
    attempt("all_reduce_167MB_pinned_host_s", lambda: timed(g.cpu().pin_memory()))
    queue.put((rank, out))
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs a CUDA card", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, port, queue)) for r in range(2)]
    for p in procs:
        p.start()
    results = [queue.get(timeout=300) for _ in procs]
    for p in procs:
        p.join(60)
    for rank, out in sorted(results):
        for name, value in out.items():
            print(rank, name, value)
    return 0 if all(v[0] == "ok" for _, out in results for v in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
