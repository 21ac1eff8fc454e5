"""Continuous batching for concurrent live codec streams (a copy of
``mqgan_tpu/deploy/streaming_server.py`` over the port's runtime).

A single StreamingDecoder/StreamingEncoder (deploy/streaming.py) runs its
fixed-window spans at B=1, so a server of N live sessions would pay N
separate dispatches per window stride, each too small to fill the card.
This module multiplexes any number of live sessions over ONE device by
batching their span executions: every session still owns its host-side
stream state (buffers, emit cursors — tiny numpy arrays), but the window
runs are coalesced by a background worker into one (n, window) dispatch,
n <= max_batch, with the linger-then-flush policy of deploy/server.py.
Because a span's content never depends on when it runs (deploy/streaming.py
emits on position-determined windows only), batching cannot change which
spans a session runs; under exact fp32 mixers each stream equals a solo
StreamingDecoder/StreamingEncoder run up to the last bits a batched GEMM
may change. Sessions are free: all per-session state lives on the host.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from mqgan_tpu_torch.deploy.server import ServerStats
from mqgan_tpu_torch.deploy.streaming import StreamingDecoder, StreamingEncoder


@dataclass
class _SpanReq:
    x: np.ndarray  # (window,) + in_tail
    mask: np.ndarray  # (window,) bool, True = padded
    future: Future
    t_submit: float


class _SpanBatcher:
    """Coalesce same-shaped span requests into one batched dispatch.

    fn: (B, window) + in_tail, (B, window) bool -> (B, window) + out_tail,
    called at B = the number of waiting spans (<= max_batch).
    """

    def __init__(
        self,
        fn: Callable,
        max_batch: int,
        max_delay_s: float,
    ):
        self.fn = fn
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.stats = ServerStats()
        self._queue: deque[_SpanReq] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, x: np.ndarray, mask: np.ndarray) -> Future:
        req = _SpanReq(x, mask, Future(), time.monotonic())
        with self._cond:
            if self._closed:
                raise RuntimeError("server is closed")
            self._queue.append(req)
            self.stats.requests += 1
            self.stats.queued += 1
            self._cond.notify_all()
        return req.future

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join()
        for r in self._queue:
            if not r.future.done():
                r.future.set_exception(RuntimeError("server closed"))

    # ------------------------------------------------------------------
    def _run(self):
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                # linger briefly for concurrent sessions' spans, launch
                # immediately once full (same policy as deploy/server.py)
                deadline = self._queue[0].t_submit + self.max_delay_s
                while len(self._queue) < self.max_batch and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                batch = []
                while self._queue and len(batch) < self.max_batch:
                    batch.append(self._queue.popleft())
                self.stats.queued -= len(batch)
            if batch:
                self._flush(batch)

    def _flush(self, batch):
        try:
            rows = np.stack([r.x for r in batch])
            masks = np.stack([r.mask for r in batch])
            out = np.asarray(self.fn(rows, masks))
            now = time.monotonic()
            with self._cond:
                self.stats.batches += 1
                self.stats.rows += len(batch)
                for r in batch:
                    self.stats.latencies_ms.append((now - r.t_submit) * 1e3)
            for i, r in enumerate(batch):
                r.future.set_result(out[i])
        except Exception as e:  # noqa: BLE001 — fail the whole batch loudly
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)


def _proxy(batcher: _SpanBatcher) -> Callable:
    """Adapt the (1, W) span interface of _WindowedStreamer.fn to a
    batched submit: the session thread blocks here while its span rides a
    shared dispatch."""

    def fn(x, mask):
        return batcher.submit(x[0], mask[0]).result()[None]

    return fn


class DuplexSession:
    """One live mel -> tokens -> mel loop over the server's batchers."""

    def __init__(self, enc: StreamingEncoder, dec: StreamingDecoder):
        self.encoder = enc
        self.decoder = dec

    @property
    def latency_frames(self) -> int:
        return self.encoder.latency_frames + self.decoder.latency_frames

    def feed(self, mel: np.ndarray) -> np.ndarray:
        return self.decoder.feed(self.encoder.feed(mel))

    def flush(self) -> np.ndarray:
        out = self.decoder.feed(self.encoder.flush())
        tail = self.decoder.flush()
        if not out.size:
            return tail
        return np.concatenate([out, tail], axis=0) if tail.size else out

    def reset(self):
        self.encoder.reset()
        self.decoder.reset()


class StreamingCodecServer:
    """Serve any number of concurrent streaming sessions on one device.

    decode_fn / encode_fn take BATCHED fixed windows —
    (B, window [, C]) plus a (B, window) pad mask — exactly the whole-
    window fns of deploy/streaming.py with a leading batch,
    B <= max_batch.

    Sessions opened here run the spans solo StreamingDecoder/
    StreamingEncoder objects run; they only share the dispatches.
    """

    def __init__(
        self,
        *,
        decode_fn: Optional[Callable] = None,
        encode_fn: Optional[Callable] = None,
        window: int,
        mel_channels: int,
        dec_halos: Optional[tuple] = None,
        enc_halo: Optional[int] = None,
        align: int = 8,
        max_batch: int = 8,
        max_delay_ms: float = 3.0,
    ):
        if decode_fn is None and encode_fn is None:
            raise ValueError("need decode_fn and/or encode_fn")
        self.window = int(window)
        self.mel_channels = int(mel_channels)
        self.align = int(align)
        self._dec_halos = dec_halos
        self._enc_halo = enc_halo
        delay_s = float(max_delay_ms) / 1e3
        self._dec_batcher = (
            _SpanBatcher(decode_fn, max_batch, delay_s)
            if decode_fn is not None else None)
        self._enc_batcher = (
            _SpanBatcher(encode_fn, max_batch, delay_s)
            if encode_fn is not None else None)

    # ------------------------------------------------------------------
    @classmethod
    def from_runtime(cls, runtime, window: Optional[int] = None,
                     max_batch: int = 8, max_delay_ms: float = 3.0):
        """Batch sessions over a runtime's largest bucket (or ``window``);
        a flush runs at its true batch size."""

        def decode_fn(idx, mask):
            return runtime.decode(idx, (~mask).sum(1).astype(np.int32))

        def encode_fn(mel, mask):
            return runtime.encode(mel, (~mask).sum(1).astype(np.int32))

        return cls(
            decode_fn=decode_fn, encode_fn=encode_fn,
            window=int(window or runtime.buckets[-1]),
            mel_channels=runtime.mel_channels,
            dec_halos=runtime.decoder_halos, enc_halo=runtime.encoder_halo,
            align=runtime.halo_align, max_batch=max_batch,
            max_delay_ms=max_delay_ms)

    # ------------------------------------------------------------------
    def open_decoder(self) -> StreamingDecoder:
        if self._dec_batcher is None:
            raise ValueError("server has no decode_fn")
        if self._dec_halos is None:
            raise ValueError("server needs dec_halos to open decoders")
        halo_l, halo_r = self._dec_halos
        return StreamingDecoder(
            _proxy(self._dec_batcher), halo_l, halo_r, window=self.window,
            align=self.align, mel_channels=self.mel_channels)

    def open_encoder(self, align: int = 1) -> StreamingEncoder:
        if self._enc_batcher is None:
            raise ValueError("server has no encode_fn")
        if self._enc_halo is None:
            raise ValueError("server needs enc_halo to open encoders")
        return StreamingEncoder(
            _proxy(self._enc_batcher), self._enc_halo, window=self.window,
            mel_channels=self.mel_channels, align=align)

    def open_duplex(self, enc_align: int = 1) -> DuplexSession:
        return DuplexSession(self.open_encoder(align=enc_align),
                             self.open_decoder())

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        out = {}
        if self._dec_batcher is not None:
            out["decode"] = self._dec_batcher.stats.summary()
        if self._enc_batcher is not None:
            out["encode"] = self._enc_batcher.stats.summary()
        return out

    def close(self):
        for b in (self._dec_batcher, self._enc_batcher):
            if b is not None:
                b.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
