"""Async serving frontend (stdlib asyncio) over the same ModelService —
counterpart of gan_class_transfer2_tpu/serve/aio.py.

The threaded frontend (server.py) spends one OS thread per connection; this
one multiplexes all connections on one event loop, and only the device work
(which blocks in the batchers) runs on a thread pool, so many concurrent
clients still coalesce into the same device batches. Same endpoints and
wire format as server.py, selected with ``serve --frontend aio``. HTTP/1.1
is parsed by hand on asyncio streams; connections are Connection: close.
"""

from __future__ import annotations

import asyncio
import base64
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Optional
from urllib.parse import parse_qs

from .server import (
    MAX_BODY,
    ModelService,
    SampleSpec,
    ServerBusy,
    _decode_image,
    _image_format,
    _npy_bytes,
    _npz_bytes,
    _png_bytes,
)


def _response(code: int, content_type: str, body: bytes) -> bytes:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              500: "Internal Server Error",
              503: "Service Unavailable"}.get(code, "OK")
    retry = "Retry-After: 1\r\n" if code == 503 else ""
    return (
        f"HTTP/1.1 {code} {reason}\r\n"
        f"Content-Type: {content_type}\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"{retry}"
        "Connection: close\r\n\r\n"
    ).encode() + body


def _json_response(code: int, obj) -> bytes:
    return _response(code, "application/json", json.dumps(obj).encode())


class AsyncServer:
    """asyncio HTTP frontend; device work delegated to a thread pool."""

    def __init__(self, service: ModelService, host: str = "127.0.0.1",
                 port: int = 0, max_workers: int = 32):
        self.service = service
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="gct2-aio")
        # in-flight shed: each blocking call occupies a worker until its
        # device batch completes, so without a cap the excess would sit in
        # the executor's UNBOUNDED queue (the batchers' serve_max_queue 503
        # unreachable, latency and memory growing without bound). Beyond 2×
        # the worker count, requests get a fast 503 + Retry-After.
        self._max_inflight = 2 * max_workers
        self._inflight = 0
        # streams get their OWN small pool: a producer that already
        # committed its 200 multipart header must not wait behind queued
        # request work (the stream count itself is bounded by the
        # serve_max_streams slot acquired before the header)
        self._stream_pool = ThreadPoolExecutor(
            max_workers=max(getattr(service.cfg, "serve_max_streams", 2), 2),
            thread_name_prefix="gct2-aio-stream",
        )

    # ------------------------------------------------------------ plumbing

    MAX_HEADERS = 100
    MAX_BODY = MAX_BODY  # shared with the threaded frontend (server.py)

    async def _read_request(self, reader):
        request_line = await asyncio.wait_for(reader.readline(), 30)
        parts = request_line.decode("latin-1").split()
        if len(parts) < 2:
            raise ValueError("malformed request line")
        method, target = parts[0], parts[1]
        headers = {}
        # +1: the blank terminator line consumes an iteration too, so a
        # request with exactly MAX_HEADERS headers is still accepted
        for _ in range(self.MAX_HEADERS + 1):
            line = await asyncio.wait_for(reader.readline(), 30)
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        else:
            raise ValueError("too many headers")
        length = int(headers.get("content-length", 0))
        if length > self.MAX_BODY:
            raise ValueError(f"body too large ({length} > {self.MAX_BODY})")
        # bound the whole body read: a trickling client must not hold the
        # connection (and its buffer) forever
        body = (
            await asyncio.wait_for(reader.readexactly(length), 120)
            if length > 0
            else b""
        )
        return method, target, headers, body

    async def _run_blocking(self, fn, *args):
        # single-threaded loop: counter updates need no lock
        if self._inflight >= self._max_inflight:
            raise ServerBusy(
                f"server overloaded ({self._inflight} requests in flight)"
            )
        self._inflight += 1
        try:
            return await asyncio.get_running_loop().run_in_executor(
                self._pool, fn, *args
            )
        finally:
            self._inflight -= 1

    async def _parse_json(self, body: bytes) -> dict:
        """Parse a JSON object body; big bodies parse on the pool so a 64 MB
        garbage upload cannot stall the event loop."""
        if len(body) > 65536:
            req = await self._run_blocking(json.loads, body)
        else:
            req = json.loads(body or b"{}")
        if not isinstance(req, dict):
            raise ValueError("request body must be a JSON object")
        return req

    # ------------------------------------------------------------- routing

    async def _handle_stream(self, writer, stream):
        """Chunked multipart stream of intermediate diffusion states —
        the blocking generator (created by the caller BEFORE the 200
        header, so check_streamable errors and the ServerBusy stream shed
        surface as clean 4xx/503 responses) runs on the pool and feeds an
        async queue. A mid-stream failure can only terminate the multipart
        body early (never append a second status line)."""
        boundary = "gct2frame"
        writer.write(
            (
                "HTTP/1.1 200 OK\r\n"
                f"Content-Type: multipart/x-mixed-replace; boundary={boundary}\r\n"
                "Connection: close\r\n\r\n"
            ).encode()
        )
        import threading

        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()
        # consumer sets this when the client is gone: the producer then
        # stops after the CURRENT device segment instead of computing every
        # remaining one for nobody (each segment holds the device lock)
        abandoned = threading.Event()

        def produce():
            try:
                for snapshot in stream:
                    if abandoned.is_set():
                        return
                    # PNG-encode HERE on the producer thread: per-frame
                    # encoding on the event loop would stall every connection
                    loop.call_soon_threadsafe(
                        queue.put_nowait, _png_bytes(snapshot[0])
                    )
                loop.call_soon_threadsafe(queue.put_nowait, None)
            except Exception as e:  # noqa: BLE001 — surfaced to the drain loop
                loop.call_soon_threadsafe(queue.put_nowait, e)
            finally:
                stream.close()  # release the stream slot promptly

        # the dedicated stream pool: a producer mid-stream (header already
        # committed) must not wait behind queued request work
        producer = loop.run_in_executor(self._stream_pool, produce)
        try:
            failed = False
            while True:
                item = await queue.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    # header already committed: log, abort WITHOUT the clean
                    # terminator so the client can detect the truncation
                    print(
                        f"stream aborted: {type(item).__name__}: {item}",
                        file=sys.stderr,
                    )
                    failed = True
                    break
                body = item  # already PNG-encoded by the producer
                writer.write(
                    f"--{boundary}\r\nContent-Type: image/png\r\n"
                    f"Content-Length: {len(body)}\r\n\r\n".encode()
                    + body + b"\r\n"
                )
                await writer.drain()
            if not failed:
                writer.write(f"--{boundary}--\r\n".encode())
        except Exception as e:  # noqa: BLE001 — consumer-side failure; the
            # 200 header is committed, so never let this escape to _handle
            # (it would append a JSON 500 after the multipart header)
            print(f"stream aborted: {type(e).__name__}: {e}", file=sys.stderr)
        finally:
            abandoned.set()
            await producer

    async def _route(self, method, target, body, writer) -> Optional[bytes]:
        service = self.service
        path, _, query = target.partition("?")
        if method == "GET":
            if path == "/healthz":
                return _json_response(200, {"status": "ok", "step": service.step,
                                            "frontend": "aio"})
            if path == "/metrics":
                return _response(
                    200, "text/plain; version=0.0.4",
                    service.metrics_text().encode(),
                )
            return _json_response(404, {"error": f"unknown path {path}"})
        if method != "POST":
            return _json_response(404, {"error": f"unsupported method {method}"})
        # every POST handler below runs decode → device → encode inside ONE
        # blocking closure on the pool: image/base64/large-JSON work on the
        # event loop would freeze every other connection for its duration.
        # Validation (SampleSpec, direction, edits) is shared with the
        # threaded frontend.
        if path == "/sample":
            spec = SampleSpec(await self._parse_json(body))
            if spec.stream:
                # create the stream BEFORE the 200 header: check_streamable
                # errors and the ServerBusy stream shed surface pre-header
                stream = service.sample_stream(
                    spec.num, segments=spec.segments, class_idx=spec.class_idx
                )
                await self._handle_stream(writer, stream)
                return None  # response already written

            def run_sample():
                images = service.sample(spec.num, class_idx=spec.class_idx)
                if spec.npy:
                    return _response(200, "application/octet-stream",
                                     _npy_bytes(images))
                if spec.b64:
                    return _json_response(200, {
                        "images": [base64.b64encode(_png_bytes(im)).decode()
                                   for im in images]
                    })
                return _response(200, "image/png", _png_bytes(images[0]))

            return await self._run_blocking(run_sample)
        if path == "/reload":
            step = await self._run_blocking(service.reload)
            return _json_response(200, {"step": step})
        if path == "/denoise":
            fmt = _image_format(parse_qs(query))

            def run_denoise():
                img = _decode_image(body, service.cfg.size)
                out = service.denoise(img)
                if fmt == "npy":
                    return _response(200, "application/octet-stream",
                                     _npy_bytes(out))
                return _response(200, "image/png", _png_bytes(out[0]))

            return await self._run_blocking(run_denoise)
        if path == "/edit":
            q = parse_qs(query)
            fmt = _image_format(q)
            raw = q.get("edits", ["pixelate,shift,quantise"])
            edits = tuple(e for e in raw[0].split(",") if e)
            cls = q.get("class", [None])[0]

            def run_edit():
                img = _decode_image(body, service.cfg.size)
                out = service.edit(
                    img, edits, None if cls is None else int(cls)
                )
                if fmt == "npy":  # keyed outputs → one .npz
                    return _response(200, "application/octet-stream",
                                     _npz_bytes(out))
                return _json_response(200, {
                    k: base64.b64encode(_png_bytes(v[0])).decode()
                    for k, v in out.items()
                })

            return await self._run_blocking(run_edit)
        if path == "/transfer":
            q = parse_qs(query)
            fmt = _image_format(q)
            direction = q.get("direction", ["ab"])[0]
            if "to" not in q and direction not in ("ab", "ba"):
                return _json_response(400, {"error": "direction must be ab|ba"})

            def run_transfer():
                img = _decode_image(body, service.cfg.size)
                if "to" in q:  # multi-class conditional transfer
                    out = service.transfer_to(img, int(q["to"][0]))
                else:
                    out = service.transfer(img, direction)
                if fmt == "npy":
                    return _response(200, "application/octet-stream",
                                     _npy_bytes(out))
                return _response(200, "image/png", _png_bytes(out[0]))

            return await self._run_blocking(run_transfer)
        return _json_response(404, {"error": f"unknown path {path}"})

    async def _handle(self, reader, writer):
        try:
            try:
                method, target, _headers, body = await self._read_request(reader)
            except ValueError as e:
                # malformed request (bad request line, bogus/oversized
                # Content-Length, too many headers): answer 400 like the
                # threaded frontend does — the silent drop below is only for
                # clients that went away mid-read
                writer.write(_json_response(400, {"error": str(e)}))
                await writer.drain()
                return
            try:
                resp = await self._route(method, target, body, writer)
            except ServerBusy as e:
                # load shed: overloaded batcher queue — tell the client to
                # back off instead of queueing unboundedly (server.ServerBusy)
                resp = _response(
                    503, "application/json",
                    json.dumps({"error": str(e)}).encode(),
                )
            except ValueError as e:
                resp = _json_response(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — fault barrier per request
                resp = _json_response(500, {"error": f"{type(e).__name__}: {e}"})
            if resp is not None:
                writer.write(resp)
            await writer.drain()
        except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                ConnectionError):
            pass  # client went away — drop quietly
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    # ----------------------------------------------------------- lifecycle

    async def _serve(self, ready: Optional[asyncio.Event] = None,
                     announce: bool = False):
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        if announce:
            # print the BOUND port (matters for --port 0 / ephemeral)
            print(
                f"serving on {self.host}:{self.port} "
                f"(step {self.service.step}, asyncio)",
                flush=True,
            )
        if ready is not None:
            ready.set()
        async with self._server:
            await self._server.serve_forever()

    def run_forever(self, announce: bool = True):
        """Blocking entry (CLI)."""
        try:
            asyncio.run(self._serve(announce=announce))
        finally:
            self._pool.shutdown(wait=False)
            self._stream_pool.shutdown(wait=False)
            self.service.close()

    # Threaded wrapper so tests can drive it like server.Server
    def start(self):
        import threading

        self._loop = asyncio.new_event_loop()
        started = threading.Event()
        self._start_error: Optional[BaseException] = None

        def runner():
            asyncio.set_event_loop(self._loop)
            ready = asyncio.Event()

            async def main():
                task = asyncio.ensure_future(self._serve(ready))
                waiter = asyncio.ensure_future(ready.wait())
                # a bind failure ends the serve task before ready is set:
                # raise it now instead of waiting out start()'s timeout
                await asyncio.wait({task, waiter}, return_when=asyncio.FIRST_COMPLETED)
                if not waiter.done():
                    waiter.cancel()
                    task.result()
                started.set()
                await task

            try:
                self._loop.run_until_complete(main())
            except asyncio.CancelledError:
                pass
            except Exception as e:  # noqa: BLE001 — e.g. bind failure: the
                # real OSError must reach start()'s caller, not die here
                self._start_error = e
                started.set()

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()
        if not started.wait(timeout=30):
            raise RuntimeError("async server failed to start")
        if self._start_error is not None:
            raise RuntimeError(
                f"async server failed to start: {self._start_error}"
            ) from self._start_error
        return self

    def stop(self):
        def cancel_all():
            if self._server is not None:
                self._server.close()
            for task in asyncio.all_tasks(self._loop):
                task.cancel()

        self._loop.call_soon_threadsafe(cancel_all)
        self._thread.join(timeout=10)
        if not self._thread.is_alive():
            # each start() creates a fresh loop; leaving it open would leak
            # its epoll fd + self-pipe per start/stop cycle
            self._loop.close()
        self._pool.shutdown(wait=False)
        self._stream_pool.shutdown(wait=False)
        self.service.close()
