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
memory. Then three more jobs on ``cuda:0``, each in processes of its own
(a failure inside gloo can kill a process; a rank that dies is reported
with its exit code): ``send``/``recv`` (2 ranks), ``batch_isend_irecv``
to both neighbours, a halo exchange (4 ranks), and
``all_gather``/``all_reduce`` over subgroups of two ranks ({0, 1}, {2, 3}
and {0, 2}, {1, 3}, made by ``new_group`` on every rank; 4 ranks), each on
CUDA tensors. Exit 0 when every job reported. Run it from the root of a
checkout on a machine with a card:

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
    """The collectives of data parallelism on two ranks, and the timings."""
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


def _dev():
    return torch.device("cuda:0")


def _attempt(out, name, fn):
    try:
        value = fn()
        torch.cuda.synchronize()
        out[name] = ("ok", value)
    except RuntimeError as e:  # what gloo raises for a tensor it does not take
        out[name] = ("error", f"{type(e).__name__}: {str(e)[:200]}")


def _send_recv(rank, world, out):
    dev = _dev()
    t = torch.full((6,), float(rank), device=dev)
    peer = rank ^ 1

    def run():
        if rank % 2 == 0:
            dist.send(t, peer)
            dist.recv(t, peer)
            return t[0].item()
        got = torch.empty_like(t)
        dist.recv(got, peer)
        dist.send(t, peer)
        return got[0].item()

    _attempt(out, "send_recv", run)


def _halo(rank, world, out):
    """Each rank's first row up, last row down, as a halo exchange."""
    dev = _dev()
    x = torch.arange(8.0, device=dev).reshape(4, 2) + 100 * rank
    top, bottom = torch.zeros(2, device=dev), torch.zeros(2, device=dev)

    def run():
        ops = []
        if rank > 0:
            ops += [dist.P2POp(dist.isend, x[0].contiguous(), rank - 1),
                    dist.P2POp(dist.irecv, top, rank - 1)]
        if rank < world - 1:
            ops += [dist.P2POp(dist.isend, x[-1].contiguous(), rank + 1),
                    dist.P2POp(dist.irecv, bottom, rank + 1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [top.tolist(), bottom.tolist()]

    _attempt(out, "batch_isend_irecv_halo", run)


def _subgroups(rank, world, out):
    """all_gather and all_reduce over subgroups {0, 1}, {2, 3} ("model")
    and {0, 2}, {1, 3} ("data"), made by new_group on every rank."""
    dev = _dev()
    groups = {}
    for name, members in {"model": [[0, 1], [2, 3]], "data": [[0, 2], [1, 3]]}.items():
        for ranks in members:
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g
    for name, g in groups.items():
        z = torch.full((3, 2), float(rank), device=dev)
        parts = [torch.empty_like(z) for _ in range(2)]
        _attempt(out, f"subgroup_{name}_all_gather",
                 lambda: (dist.all_gather(parts, z, group=g), [p[0, 0].item() for p in parts])[1])
        r = torch.full((5,), float(rank + 1), device=dev)
        _attempt(out, f"subgroup_{name}_all_reduce",
                 lambda: (dist.all_reduce(r, group=g), r[0].item())[1])


JOBS = {"send_recv": (_send_recv, 2), "batch_isend_irecv": (_halo, 4),
        "subgroups": (_subgroups, 4)}


def _probe_worker(name, rank, port, queue):
    fn, world = JOBS[name]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    out = {}
    fn(rank, world, out)
    queue.put((rank, out))
    dist.destroy_process_group()


def _spawn(target, world, args=(), timeout=120):
    """``target(*args, rank, port, queue)`` on ``world`` processes. Returns
    [(rank, results)] of the ranks that reported and, for a rank that died
    without reporting (a crash inside gloo kills the process), (rank,
    {"exit": ("crashed", its exit code)})."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=target, args=(*args, r, port, queue)) for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    while len(results) < world and time.monotonic() < deadline:
        try:
            rank, out = queue.get(timeout=1.0)
            results[rank] = out
        except Exception:  # queue.Empty: check for dead ranks
            if all(not p.is_alive() for p in procs) and queue.empty():
                break
    for r, p in enumerate(procs):
        p.join(5)
        if p.is_alive():
            p.terminate()
            p.join(5)
        if r not in results:
            results[r] = {"exit": ("crashed", p.exitcode)}
    return sorted(results.items())


def main():
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs a CUDA card", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    for rank, out in _spawn(_worker, 2, timeout=300):
        for name, value in out.items():
            print(rank, name, value, flush=True)
    for job in JOBS:
        for rank, out in _spawn(_probe_worker, JOBS[job][1], (job,)):
            for name, value in out.items():
                print(f"{job} rank {rank}", name, value, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
