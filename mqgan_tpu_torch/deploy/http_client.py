"""Python client for the port's HTTP codec and streaming servers (a copy of
``mqgan_tpu/deploy/http_client.py``: same wire format, same API).

Thin stdlib-and-numpy wrapper over the wire format of ``deploy/http_server.py``
and ``deploy/http_streaming.py`` (``.npy``/``.npz`` bodies, JSON control
endpoints), so remote callers get the API shape of the in-process runtime:

    from mqgan_tpu_torch.deploy.http_client import CodecClient

    c = CodecClient("http://codec-host:8765")
    tokens = c.encode(mel)                     # (T, mel) -> (T,) int32
    mel2 = c.decode(tokens)                    # (T,) -> (T, mel)
    tokens, refined = c.reencode(mel)
    print(c.health(), c.stats())

    with c.open_duplex() as stream:            # http_streaming servers
        out = stream.feed(mel_chunk)           # newly emitted frames
        tail = stream.flush()

Raises CodecHTTPStatusError carrying the server's status + error message
(429 = queue full, 413 = clip exceeds the largest exported bucket, ...).
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.request
from typing import Optional

import numpy as np


class CodecHTTPStatusError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


def _request(url: str, data: Optional[bytes], headers: dict,
             timeout: float) -> bytes:
    req = urllib.request.Request(
        url, data=data, method="POST" if data is not None else "GET")
    for k, v in headers.items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            message = json.loads(body).get("error", body.decode())
        except (ValueError, AttributeError):  # a non-JSON error body
            message = body.decode(errors="replace")
        raise CodecHTTPStatusError(e.code, message) from None


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


class StreamClient:
    """One live session on an http_streaming server. Context-managed:
    leaving the block closes the session server-side."""

    def __init__(self, client: "CodecClient", info: dict):
        self._c = client
        self.session = info["session"]
        self.kind = info["kind"]
        self.latency_frames = int(info["latency_frames"])
        self.window = int(info["window"])

    def _url(self, action: str) -> str:
        return f"{self._c.base_url}/stream/{self.session}/{action}"

    def feed(self, chunk: np.ndarray) -> np.ndarray:
        """Feed one chunk; returns the newly emitted output (possibly
        empty until the first window fills)."""
        body = _request(self._url("feed"), _npy(np.asarray(chunk)), {},
                        self._c.timeout)
        return np.load(io.BytesIO(body), allow_pickle=False)

    def flush(self) -> np.ndarray:
        """Drain the tail; the session resets and is reusable."""
        body = _request(self._url("flush"), b"", {}, self._c.timeout)
        return np.load(io.BytesIO(body), allow_pickle=False)

    def close(self) -> None:
        _request(self._url("close"), b"", {}, self._c.timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self.close()
        except (CodecHTTPStatusError, OSError):
            pass  # already closed / server gone — nothing to clean up


class CodecClient:
    def __init__(self, base_url: str, timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = float(timeout)

    # ---- whole-clip codec endpoints (http_server) --------------------
    def _post_clip(self, op: str, data: np.ndarray,
                   length: Optional[int]) -> bytes:
        headers = {}
        if length is not None:
            headers["X-Clip-Length"] = str(int(length))
        return _request(f"{self.base_url}/{op}", _npy(np.asarray(data)),
                        headers, self.timeout)

    def encode(self, mel: np.ndarray,
               length: Optional[int] = None) -> np.ndarray:
        """(T, mel) float mel -> (T,) int32 FSQ tokens."""
        return np.load(io.BytesIO(self._post_clip("encode", mel, length)),
                       allow_pickle=False)

    def decode(self, tokens: np.ndarray,
               length: Optional[int] = None) -> np.ndarray:
        """(T,) int tokens -> (T, mel) refined mel."""
        return np.load(io.BytesIO(self._post_clip("decode", tokens, length)),
                       allow_pickle=False)

    def reencode(self, mel: np.ndarray, length: Optional[int] = None):
        """(T, mel) -> (tokens (T,), refined mel (T, mel))."""
        out = np.load(io.BytesIO(self._post_clip("reencode", mel, length)),
                      allow_pickle=False)
        return out["tokens"], out["mel"]

    def health(self) -> dict:
        return json.loads(_request(f"{self.base_url}/healthz", None, {},
                                   self.timeout))

    def stats(self) -> dict:
        return json.loads(_request(f"{self.base_url}/stats", None, {},
                                   self.timeout))

    # ---- streaming sessions (http_streaming) -------------------------
    def _open(self, kind: str, align: int) -> StreamClient:
        body = json.dumps({"kind": kind, "align": align}).encode()
        info = json.loads(_request(f"{self.base_url}/stream/open", body, {},
                                   self.timeout))
        return StreamClient(self, info)

    def open_duplex(self, align: int = 1) -> StreamClient:
        """Live mel in -> re-encoded mel out (feed (n, mel) chunks)."""
        return self._open("duplex", align)

    def open_encoder(self, align: int = 1) -> StreamClient:
        """Live mel in -> tokens out."""
        return self._open("encoder", align)

    def open_decoder(self) -> StreamClient:
        """Live tokens in -> mel out (feed 1-D int chunks)."""
        return self._open("decoder", 1)

    def stream_stats(self) -> dict:
        return json.loads(_request(f"{self.base_url}/stream/stats", None,
                                   {}, self.timeout))
