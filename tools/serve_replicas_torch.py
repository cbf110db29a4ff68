"""Latency and throughput of the PyTorch port's /sample served over in-process
replicas (``serve.server.build_service`` over a ``parallel/mesh.LocalMesh`` of
the host's cards) against one card, and against the same replicas with each
block run from a thread of its own.

Three services, each built by ``build_service`` (random weights from the
seed, full width, the B4 kernel path, ``sample_stride`` 50):

  * ``one card``: the host's devices stubbed to cuda:0;
  * ``replicas, serial``: every card of the host (or, with
    ``--replicas-on-card0 N``, N replicas on cuda:0), as ``cli serve`` runs:
    the replicas' blocks one after another from the calling thread;
  * ``replicas, threads``: the same service with ``mesh._on_replicas``
    replaced by ``_threaded``, each block from a thread of its own (the
    alternative the port does not take: the threads contend for the GIL).

Each is driven over HTTP (``serve.server.Server``) by concurrent clients:
/sample npy of 1 image at concurrency 1 and 8, and of 16 images at
concurrency 1. Printed: p50/p99/max ms and images/s of each, the card's name
and power limit, and one JSON object as the last line (also written to
``--out``). The replica services' 16-image sample is checked within 1 uint8
level of one card's on the same noise.

  python tools/serve_replicas_torch.py --out chiprun_out/serve_replicas.json
  python tools/serve_replicas_torch.py --replicas-on-card0 2
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _post(port: int, body: bytes) -> int:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/sample", body)
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


def _drive(port: int, num: int, conc: int, per_client: int) -> dict:
    """``conc`` clients, each ``per_client`` requests of ``num`` images back
    to back: p50/p99/max ms, images/s over the wall time."""
    body = json.dumps({"num": num, "format": "npy"}).encode()
    lat, bad, lock = [], [], threading.Lock()

    def client():
        for _ in range(per_client):
            t0 = time.perf_counter()
            status = _post(port, body)
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    bad.append(status)

    _post(port, body)  # warm: the first request of a size builds its buckets' state
    threads = [threading.Thread(target=client) for _ in range(conc)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if bad or len(lat) != conc * per_client:
        raise RuntimeError(f"/sample num {num} at concurrency {conc}: statuses {bad}")
    p50, p99 = np.percentile(lat, [50, 99])
    return {"num": num, "concurrency": conc, "requests": len(lat), "p50_ms": float(p50),
            "p99_ms": float(p99), "max_ms": float(max(lat)),
            "images_per_s": num * len(lat) / wall}


def _threaded(mesh, fn, args):
    """``mesh._on_replicas`` with each block from a thread of its own (the
    first from the caller's) under the caller's inference mode and with its
    replica's device current."""
    import torch

    inference, outs, errors = torch.is_inference_mode_enabled(), [None] * len(args), []

    def run(i):
        try:
            with torch.inference_mode(inference), torch.cuda.device(mesh.devices[i]):
                outs[i] = fn(*args[i])
        except BaseException as e:  # noqa: BLE001 - raised in the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(1, len(args))]
    for t in threads:
        t.start()
    run(0)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return outs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--replicas-on-card0", type=int, default=0, metavar="N",
                   help="N replicas on cuda:0 instead of one a card")
    p.add_argument("--requests", type=int, default=60,
                   help="requests at concurrency 1 (a quarter of it for each client at 8)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write the JSON object here")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("serve_replicas_torch: no CUDA device", file=sys.stderr)
        return 1
    from gan_class_transfer2_tpu_torch.config import Config
    from gan_class_transfer2_tpu_torch.ops import _build
    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib
    from gan_class_transfer2_tpu_torch.serve import server as srv_mod

    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(cards.strip())
    card = cards.splitlines()[0].strip()
    _build.build_all()
    cfg = Config(sample_stride=50, conv_impl="pallas", seed=args.seed,
                 checkpoint_dir="").validate()
    real_devices, serial = mesh_lib.local_devices, mesh_lib._on_replicas
    if args.replicas_on_card0:
        replicas = [torch.device("cuda", 0)] * args.replicas_on_card0
    else:
        replicas = real_devices("cuda")
    if len(replicas) < 2:
        print("serve_replicas_torch: one device; pass --replicas-on-card0 N", file=sys.stderr)
        return 1

    def build(devices):
        mesh_lib.local_devices = lambda device: devices
        try:
            return srv_mod.build_service(cfg, "diffusion", "cuda")
        finally:
            mesh_lib.local_devices = real_devices

    one, many = build([torch.device("cuda", 0)]), build(replicas)
    state = one._gen.get_state()
    a = one._run_sample(16)
    many._gen.set_state(state)
    b = many._run_sample(16)
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    if diff.max() > 1:
        raise RuntimeError(f"{len(replicas)} replicas against one card: {diff.max()} levels")
    print(f"replicas {[str(d) for d in replicas]}: /sample of 16 within {diff.max()} level "
          f"of one card on {float((diff > 0).mean()):.2e} of the values")

    n1, n8 = args.requests, max(args.requests // 4, 1)
    loads = ((1, 1, n1), (1, 8, n8), (16, 1, max(n1 // 3, 1)))
    results = {}
    for name, svc, runner in (("one card", one, serial), ("replicas, serial", many, serial),
                              ("replicas, threads", many, _threaded)):
        mesh_lib._on_replicas = runner
        srv = srv_mod.Server(svc).start()
        try:
            results[name] = [_drive(srv.port, num, conc, per) for num, conc, per in loads]
        finally:
            srv.httpd.shutdown()
            srv.httpd.server_close()
            mesh_lib._on_replicas = serial
        for r in results[name]:
            print(f"{name}: /sample num {r['num']} at concurrency {r['concurrency']}: p50 "
                  f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, max {r['max_ms']:.3f} ms, "
                  f"{r['images_per_s']:.2f} images/s over {r['requests']} requests ({card})")
    one.close()
    many.close()
    out = {"cards": cards.strip().splitlines(), "replicas": [str(d) for d in replicas],
           "results": results}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
