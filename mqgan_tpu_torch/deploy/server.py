"""Micro-batching server over the port's codec runtime (a copy of
``mqgan_tpu/deploy/server.py`` ``CodecServer`` and ``ServerStats``).

Concurrent clients submit single clips of arbitrary length; a background
worker coalesces waiting requests of one time bucket into a batch and runs
the runtime once per batch. A batch launches when ``max_batch`` clips of one
bucket wait or when the oldest request has waited ``max_delay_ms``,
whichever comes first. ``max_queue`` bounds the ingress queue (reject, or
block with ``block_on_full``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class _Request:
    data: np.ndarray  # (T, mel) float for encode/reencode, (T,) int for decode
    length: int
    bucket: int
    future: Future
    t_submit: float


class ServerOverloadedError(RuntimeError):
    """submit() rejected: the ingress queue is at max_queue."""


@dataclass
class ServerStats:
    requests: int = 0
    rejected: int = 0
    queued: int = 0
    batches: int = 0
    rows: int = 0
    latencies_ms: deque = field(default_factory=lambda: deque(maxlen=4096))

    @staticmethod
    def _pct(lat, p):
        return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0

    def summary(self) -> dict:
        lat = sorted(self.latencies_ms)
        return {
            "requests": self.requests,
            "rejected": self.rejected,
            "queued": self.queued,
            "batches": self.batches,
            "mean_batch_size": self.rows / self.batches if self.batches else 0.0,
            "p50_latency_ms": round(self._pct(lat, 0.50), 2),
            "p95_latency_ms": round(self._pct(lat, 0.95), 2),
        }


class CodecServer:
    """Threaded micro-batching front end for one runtime op: "reencode"
    (mel -> (tokens, refined mel)), "encode" or "decode"."""

    def __init__(self, runtime, *, op: str = "reencode", max_batch: int = 64,
                 max_delay_ms: float = 5.0, max_queue: int = 1024,
                 block_on_full: bool = False):
        if op not in ("reencode", "encode", "decode"):
            raise ValueError(f"unknown op {op!r}")
        self.runtime = runtime
        self.op = op
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.max_queue = int(max_queue)
        self.block_on_full = bool(block_on_full)
        self.stats = ServerStats()
        self._queues: dict[int, deque[_Request]] = {
            b: deque() for b in runtime.buckets}
        self._cond = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, data: np.ndarray, length: Optional[int] = None) -> Future:
        """Queue one clip; the Future resolves to the op's result for that
        clip trimmed to its length: tokens (T,), mel (T, C), or a
        (tokens, mel) tuple for reencode."""
        data = np.asarray(data)
        t = data.shape[0]
        length = int(length) if length is not None else t
        if t > self.runtime.buckets[-1]:
            raise ValueError(
                f"clip length {t} exceeds the largest bucket "
                f"{self.runtime.buckets[-1]}; chunk it")
        bucket = self.runtime.bucket_for(t)
        req = _Request(data, length, bucket, Future(), time.monotonic())
        with self._cond:
            if self._closed:
                raise RuntimeError("server is closed")
            while self.stats.queued >= self.max_queue and not self._closed:
                if not self.block_on_full:
                    self.stats.rejected += 1
                    raise ServerOverloadedError(
                        f"{self.stats.queued} requests queued "
                        f"(max_queue={self.max_queue})")
                self._cond.wait()
            if self._closed:
                raise RuntimeError("server is closed")
            self._queues[bucket].append(req)
            self.stats.requests += 1
            self.stats.queued += 1
            self._cond.notify_all()
        return req.future

    def __call__(self, data: np.ndarray, length: Optional[int] = None):
        return self.submit(data, length).result()

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _oldest(self):
        """(bucket, submit time) of the oldest waiting request, or (None, None)."""
        best, t0 = None, None
        for b, q in self._queues.items():
            if q and (t0 is None or q[0].t_submit < t0):
                best, t0 = b, q[0].t_submit
        return best, t0

    def _run(self):
        while True:
            with self._cond:
                bucket, t0 = self._oldest()
                while bucket is None and not self._closed:
                    self._cond.wait()
                    bucket, t0 = self._oldest()
                if bucket is None and self._closed:
                    return
                deadline = t0 + self.max_delay_s
                while (len(self._queues[bucket]) < self.max_batch
                       and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                batch = []
                q = self._queues[bucket]
                while q and len(batch) < self.max_batch:
                    batch.append(q.popleft())
                self.stats.queued -= len(batch)
                self._cond.notify_all()
            self._flush(bucket, batch)

    def _flush(self, bucket: int, batch: List[_Request]):
        try:
            rows = []
            for r in batch:
                pad = bucket - r.data.shape[0]
                width = ((0, pad),) + ((0, 0),) * (r.data.ndim - 1)
                rows.append(np.pad(r.data, width) if pad else r.data)
            lengths = np.asarray([r.length for r in batch], np.int32)
            out = getattr(self.runtime, self.op)(np.stack(rows), lengths)
            now = time.monotonic()
            # stats before any future resolves, so a client that sees its
            # result never reads stale counts
            with self._cond:
                self.stats.batches += 1
                self.stats.rows += len(batch)
                for r in batch:
                    self.stats.latencies_ms.append((now - r.t_submit) * 1e3)
            for i, r in enumerate(batch):
                if self.op == "reencode":
                    idx, mel = out
                    res = (idx[i, : r.length], mel[i, : r.length])
                else:
                    res = out[i, : r.length]
                r.future.set_result(res)
        except Exception as e:  # noqa: BLE001 — fail the whole batch loudly
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
