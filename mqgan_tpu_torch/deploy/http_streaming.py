"""Live codec streams over HTTP (counterpart of
``mqgan_tpu/deploy/http_streaming.py``): session endpoints on top of the
continuous-batching StreamingCodecServer, beside the whole-clip endpoints
of deploy/http_server.py.

Remote clients open a session, feed chunks as ``.npy`` bodies and receive
whatever new output the stream's fixed-window cadence emits; the server
batches span executions across sessions (deploy/streaming_server.py).

Endpoints (besides deploy/http_server.py's):
  POST /stream/open           JSON {"kind": "duplex"|"encoder"|"decoder",
                              "align": int?} -> JSON {session, kind,
                              latency_frames, window, mel_channels}
  POST /stream/<id>/feed      .npy chunk -> .npy newly-emitted output
                              (possibly empty until the first window fills)
  POST /stream/<id>/flush     -> .npy tail (stream stays open; reset+reuse)
  POST /stream/<id>/close     -> JSON ack
  GET  /stream/stats          -> JSON {sessions, decode/encode batcher stats}

Chunk payloads per kind: encoder/duplex feed (n, mel_channels) float mels;
decoder feeds 1-D int token chunks. Sessions idle longer than
``idle_timeout_s`` are swept (a dropped client must not leak host buffers).

CLI:  python -m mqgan_tpu_torch.deploy.http_streaming --model_dir DIR
      [--port 8766] [--window W] [--max_batch 8] [--idle_timeout 600]
      [--data_parallel] [--device cuda]

``--data_parallel`` splits each coalesced span batch (and each whole-clip
batch) over every visible card, as deploy/http_server.py's flag does.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Optional

import numpy as np

from mqgan_tpu_torch.deploy.http_server import (CodecHTTPService,
                                                HTTPServerThread, _Handler,
                                                _HTTPError, _load_npy,
                                                _npy_bytes,
                                                serve_until_interrupted)
from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder
from mqgan_tpu_torch.deploy.streaming_server import StreamingCodecServer

KINDS = ("duplex", "encoder", "decoder")


class _Session:
    def __init__(self, kind: str, stream):
        self.kind = kind
        self.stream = stream
        self.lock = threading.Lock()  # feeds of one session serialize
        self.last_used = time.monotonic()


class StreamingHTTPService(CodecHTTPService):
    """CodecHTTPService + a StreamingCodecServer session registry."""

    def __init__(
        self,
        model_dir: Optional[str] = None,
        runtime=None,
        *,
        window: Optional[int] = None,
        stream_max_batch: int = 8,
        stream_max_delay_ms: float = 3.0,
        idle_timeout_s: float = 600.0,
        **codec_kwargs,
    ):
        super().__init__(model_dir, runtime, **codec_kwargs)
        self.streaming = StreamingCodecServer.from_runtime(
            self.runtime, window=window, max_batch=stream_max_batch,
            max_delay_ms=stream_max_delay_ms)
        self.idle_timeout_s = float(idle_timeout_s)
        self._sessions: dict[str, _Session] = {}
        self._slock = threading.Lock()

    # ------------------------------------------------------------------
    def open_stream(self, kind: str, align: int = 1) -> dict:
        if kind not in KINDS:
            raise _HTTPError(400, f"unknown stream kind {kind!r}; choose "
                                  f"from {KINDS}")
        if kind == "duplex":
            stream = self.streaming.open_duplex(enc_align=align)
        elif kind == "encoder":
            stream = self.streaming.open_encoder(align=align)
        else:
            stream = self.streaming.open_decoder()
        sid = uuid.uuid4().hex
        with self._slock:
            self._sweep_locked()
            self._sessions[sid] = _Session(kind, stream)
        return {
            "session": sid,
            "kind": kind,
            "latency_frames": int(stream.latency_frames),
            "window": int(self.streaming.window),
            "mel_channels": self.runtime.mel_channels,
        }

    def _get(self, sid: str) -> _Session:
        with self._slock:
            sess = self._sessions.get(sid)
        if sess is None:
            raise _HTTPError(404, f"no such stream session {sid!r} "
                                  "(expired or closed?)")
        return sess

    def _sweep_locked(self):
        """Drop sessions idle past the timeout (call with _slock held)."""
        if self.idle_timeout_s <= 0:
            return
        cutoff = time.monotonic() - self.idle_timeout_s
        for sid in [s for s, v in self._sessions.items()
                    if v.last_used < cutoff]:
            del self._sessions[sid]

    def _check_chunk(self, sess: _Session, chunk: np.ndarray) -> np.ndarray:
        mel_ch = self.runtime.mel_channels
        if sess.kind == "decoder":
            if chunk.ndim != 1 or not np.issubdtype(chunk.dtype, np.integer):
                raise _HTTPError(
                    400, f"decoder streams feed 1-D integer token chunks, "
                         f"got shape {chunk.shape} dtype {chunk.dtype}")
            return chunk.astype(np.int32)
        if chunk.ndim != 2 or chunk.shape[1] != mel_ch:
            raise _HTTPError(
                400, f"{sess.kind} streams feed (n, {mel_ch}) mel chunks, "
                     f"got shape {chunk.shape}")
        return chunk.astype(np.float32)

    def feed_stream(self, sid: str, body: bytes) -> bytes:
        sess = self._get(sid)
        chunk = self._check_chunk(sess, _load_npy(body))
        with sess.lock:
            sess.last_used = time.monotonic()
            out = sess.stream.feed(chunk)
        return _npy_bytes(np.asarray(out))

    def flush_stream(self, sid: str) -> bytes:
        sess = self._get(sid)
        with sess.lock:
            sess.last_used = time.monotonic()
            out = sess.stream.flush()
            # flush drains the stream; reset so the session is reusable for
            # the next clip without re-opening
            sess.stream.reset()
        return _npy_bytes(np.asarray(out))

    def close_stream(self, sid: str) -> dict:
        with self._slock:
            existed = self._sessions.pop(sid, None) is not None
        return {"closed": existed, "session": sid}

    def stream_stats(self) -> dict:
        with self._slock:
            n = len(self._sessions)
        out = {"sessions": n}
        out.update(self.streaming.stats())
        return out

    def close(self):
        with self._slock:
            self._sessions.clear()
        self.streaming.close()
        super().close()


class StreamingHandler(_Handler):
    """Codec endpoints + /stream/* session routing."""

    def do_GET(self):
        if self.path == "/stream/stats":
            self._reply_json(200, self.service.stream_stats())
        else:
            super().do_GET()

    def do_POST(self):
        if not self.path.startswith("/stream/"):
            super().do_POST()
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n > 0 else b""
            parts = self.path.strip("/").split("/")
            if parts == ["stream", "open"]:
                try:
                    spec = json.loads(body or b"{}")
                except json.JSONDecodeError as e:
                    raise _HTTPError(400, f"open expects a JSON body: {e}")
                out = self.service.open_stream(
                    spec.get("kind", "duplex"), int(spec.get("align", 1)))
                self._reply_json(200, out)
                return
            if len(parts) == 3 and parts[0] == "stream":
                sid, action = parts[1], parts[2]
                if action == "feed":
                    self._reply(200, self.service.feed_stream(sid, body),
                                "application/x-npy")
                    return
                if action == "flush":
                    self._reply(200, self.service.flush_stream(sid),
                                "application/x-npy")
                    return
                if action == "close":
                    self._reply_json(200, self.service.close_stream(sid))
                    return
            raise _HTTPError(404, f"unknown stream path {self.path}")
        except _HTTPError as e:
            self._reply_json(e.status, {"error": e.message})
        except Exception as e:  # noqa: BLE001 — never kill the conn thread
            self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})


class StreamingHTTPServer(HTTPServerThread):
    def __init__(self, service: StreamingHTTPService,
                 host: str = "127.0.0.1", port: int = 0):
        super().__init__(StreamingHandler, service, host, port)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Serve live codec streams (and whole clips) over HTTP.")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8766)
    p.add_argument("--window", type=int, default=None,
                   help="streaming window (default: the largest bucket; "
                        "smaller = lower latency, more dispatches)")
    p.add_argument("--max_batch", type=int, default=8,
                   help="span-batcher coalescing bound across sessions")
    p.add_argument("--max_delay_ms", type=float, default=3.0)
    p.add_argument("--idle_timeout", type=float, default=600.0,
                   help="seconds of inactivity before a session is swept")
    p.add_argument("--data_parallel", action="store_true",
                   help="split each batch over every visible card")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    runtime = ExportedPreEncoder(args.model_dir, device=args.device,
                                 data_parallel=args.data_parallel)
    service = StreamingHTTPService(
        runtime=runtime, window=args.window, stream_max_batch=args.max_batch,
        stream_max_delay_ms=args.max_delay_ms,
        idle_timeout_s=args.idle_timeout)
    server = StreamingHTTPServer(service, host=args.host, port=args.port)
    print(f"serving streams + {sorted(service.servers)} from "
          f"{args.model_dir} on {server.url} ({runtime.device}, "
          f"{runtime.n_devices} device(s))",
          flush=True)
    serve_until_interrupted(server)


if __name__ == "__main__":
    main()
