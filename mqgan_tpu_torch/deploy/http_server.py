"""HTTP front end for the micro-batching codec server (counterpart of
``mqgan_tpu/deploy/http_server.py``), and the HTTP pieces the port's other
servers share: the error type, the .npy / .npz bodies, the listening server.

One runtime (``ExportedPreEncoder``) is shared by one ``CodecServer`` per
op; each POST handler thread blocks on its clip's future while the
micro-batching workers coalesce concurrent clips into bucket-aligned
batches. The wire format is numpy's own (``.npy`` bodies, ``.npz`` for
reencode's token + mel pair; loaded with allow_pickle=False). Backpressure
surfaces as status codes: 429 when the ingress queue is at max_queue, 413
for clips longer than the largest bucket, 400 for malformed payloads.

Endpoints:
  GET  /healthz   -> JSON {ok, mel_channels, buckets, ops, ...}
  GET  /stats     -> JSON {op: ServerStats.summary()}
  POST /encode    .npy (T, mel) float mel  -> .npy (T,) int32 tokens
  POST /decode    .npy (T,) int tokens     -> .npy (T, mel) float32 mel
  POST /reencode  .npy (T, mel) float mel  -> .npz {tokens, mel}
  Optional request header ``X-Clip-Length: n`` marks trailing rows of the
  payload as padding (the contract of CodecServer.submit(length=n)).

CLI:  python -m mqgan_tpu_torch.deploy.http_server --model_dir DIR
      [--port 8765] [--ops encode,decode,reencode] [--max_batch 64]
      [--max_delay_ms 5] [--max_queue 1024] [--device cuda]
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder
from mqgan_tpu_torch.deploy.server import CodecServer, ServerOverloadedError

DEFAULT_OPS = ("encode", "decode", "reencode")
# refuse absurd request bodies before np.load sees them (the largest real
# payload is bucket_T x mel float32; 256 MiB covers any exported config)
MAX_BODY_BYTES = 256 << 20


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _load_npy(body: bytes) -> np.ndarray:
    try:
        return np.load(io.BytesIO(body), allow_pickle=False)
    except (ValueError, OSError, EOFError) as e:
        raise _HTTPError(400, f"body is not a valid .npy payload: {e}")


class CodecHTTPService:
    """Owns the runtime + per-op CodecServers; maps requests to responses
    (kept apart from the request handler so it is testable directly)."""

    def __init__(
        self,
        model_dir: Optional[str] = None,
        runtime=None,
        *,
        ops: Sequence[str] = DEFAULT_OPS,
        max_batch: int = 64,
        max_delay_ms: float = 5.0,
        max_queue: int = 1024,
        device=None,
    ):
        """runtime: a CodecRuntime; else one is loaded from model_dir on
        ``device`` (None: CUDA, which raises without a card)."""
        if runtime is None:
            if model_dir is None:
                raise ValueError("need model_dir or runtime")
            runtime = ExportedPreEncoder(model_dir, device=device)
        self.runtime = runtime
        bad = [o for o in ops if o not in DEFAULT_OPS]
        if bad:
            raise ValueError(f"unknown ops {bad}; choose from {DEFAULT_OPS}")
        self.servers = {
            op: CodecServer(runtime=runtime, op=op, max_batch=max_batch,
                            max_delay_ms=max_delay_ms, max_queue=max_queue)
            for op in ops
        }

    # ------------------------------------------------------------------
    def health(self) -> dict:
        rt = self.runtime
        return {
            "ok": True,
            "ops": sorted(self.servers),
            "mel_channels": rt.mel_channels,
            "buckets": rt.buckets,
            "codebook_size": rt.codebook_size,
            "fsq_levels": list(rt.model.fsq_levels),
            "n_devices": rt.n_devices,
            "device": str(rt.device),
        }

    def stats(self) -> dict:
        return {op: srv.stats.summary() for op, srv in self.servers.items()}

    def handle(self, op: str, body: bytes, length: Optional[int]) -> bytes:
        """One clip through op; returns the serialized response body.
        Raises _HTTPError with the right status on every client error."""
        srv = self.servers.get(op)
        if srv is None:
            raise _HTTPError(404, f"op {op!r} not served (have "
                                  f"{sorted(self.servers)})")
        data = _load_npy(body)
        if op == "decode":
            if data.ndim != 1 or not np.issubdtype(data.dtype, np.integer):
                raise _HTTPError(
                    400, f"decode expects a 1-D integer token array, got "
                         f"shape {data.shape} dtype {data.dtype}")
            data = data.astype(np.int32)
        else:
            if data.ndim != 2 or data.shape[1] != self.runtime.mel_channels:
                raise _HTTPError(
                    400, f"{op} expects a (T, {self.runtime.mel_channels}) "
                         f"mel array, got shape {data.shape}")
            data = data.astype(np.float32)
        if length is not None and not (0 <= length <= data.shape[0]):
            raise _HTTPError(
                400, f"X-Clip-Length {length} outside [0, {data.shape[0]}]")
        if data.shape[0] > self.runtime.buckets[-1]:
            raise _HTTPError(413, f"clip length {data.shape[0]} exceeds the "
                                  f"largest bucket {self.runtime.buckets[-1]}")
        try:
            future = srv.submit(data, length)
        except ServerOverloadedError as e:
            raise _HTTPError(429, str(e))
        except RuntimeError as e:  # the server is closed
            raise _HTTPError(503, str(e))
        result = future.result()
        if op == "reencode":
            tokens, mel = result
            return _npz_bytes(tokens=np.asarray(tokens), mel=np.asarray(mel))
        return _npy_bytes(np.asarray(result))

    def close(self):
        for srv in self.servers.values():
            srv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Handler(BaseHTTPRequestHandler):
    # bound per server by a subclass (HTTPServerThread); a class attribute
    # so the stdlib constructor stays untouched
    service = None
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: /stats has the counts
        pass

    def _reply(self, status: int, body: bytes, content_type: str):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, status: int, obj) -> None:
        self._reply(status, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        if self.path == "/healthz":
            self._reply_json(200, self.service.health())
        elif self.path == "/stats":
            self._reply_json(200, self.service.stats())
        else:
            self._reply_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        op = self.path.lstrip("/")
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                raise _HTTPError(400, "missing/empty request body")
            if n > MAX_BODY_BYTES:
                raise _HTTPError(413, f"body {n} bytes exceeds {MAX_BODY_BYTES}")
            body = self.rfile.read(n)
            length_hdr = self.headers.get("X-Clip-Length")
            try:
                length = int(length_hdr) if length_hdr is not None else None
            except ValueError:
                raise _HTTPError(400, f"bad X-Clip-Length {length_hdr!r}")
            out = self.service.handle(op, body, length)
        except _HTTPError as e:
            self._reply_json(e.status, {"error": e.message})
            return
        except Exception as e:  # noqa: BLE001 — never kill the conn thread
            self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        ctype = "application/x-npz" if op == "reencode" else "application/x-npy"
        self._reply(200, out, ctype)


class _ThreadedHTTPD(ThreadingHTTPServer):
    # the stdlib's listen backlog of 5 resets bursts of concurrent clients
    # before accept(); widened on this class only, not on the stdlib's
    request_queue_size = 128
    daemon_threads = True


class HTTPServerThread:
    """A threading HTTP server of ``handler`` bound to ``service``: each
    connection gets a thread that blocks on its request, so the batchers
    behind the service see all in-flight requests at once. ``close`` stops
    the server and closes the service."""

    def __init__(self, handler: type, service, host: str = "127.0.0.1",
                 port: int = 0):
        self.service = service
        bound = type(f"_Bound{handler.__name__}", (handler,), {"service": service})
        self._httpd = _ThreadedHTTPD((host, port), bound)
        self._thread = None

    @property
    def address(self) -> tuple:
        return self._httpd.server_address

    @property
    def url(self) -> str:
        host, port = self.address[:2]
        return f"http://{host}:{port}"

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self._httpd.serve_forever()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
        self.service.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


class CodecHTTPServer(HTTPServerThread):
    def __init__(self, service: CodecHTTPService, host: str = "127.0.0.1",
                 port: int = 0):
        super().__init__(_Handler, service, host, port)


def serve_until_interrupted(server: HTTPServerThread) -> None:
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Serve an exported codec over HTTP.")
    p.add_argument("--model_dir", required=True,
                   help="exported artifact dir (deploy.export)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--ops", default="encode,decode,reencode",
                   help="comma-separated subset of encode,decode,reencode")
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--max_delay_ms", type=float, default=5.0)
    p.add_argument("--max_queue", type=int, default=1024)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    service = CodecHTTPService(
        args.model_dir, ops=tuple(args.ops.split(",")),
        max_batch=args.max_batch, max_delay_ms=args.max_delay_ms,
        max_queue=args.max_queue, device=args.device)
    server = CodecHTTPServer(service, host=args.host, port=args.port)
    print(f"serving {sorted(service.servers)} from {args.model_dir} on "
          f"{server.url} ({service.runtime.device})", flush=True)
    serve_until_interrupted(server)


if __name__ == "__main__":
    main()
