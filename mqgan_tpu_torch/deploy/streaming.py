"""Streaming codec: incremental token -> mel decode AND mel -> token
encode, with fixed algorithmic latency (a copy of
``mqgan_tpu/deploy/streaming.py`` over the port's runtime).

Frames/tokens arrive in chunks and outputs are emitted incrementally, each
span through one FIXED window: every span is one dispatch of shape
(1, window), so the card always sees the shape of one bucket.

Decode direction (StreamingDecoder): the whole decode side is time-local
(causal trunk — CBAM dropped — plus the 5x5 post mel-mixer and the UNet
refiner; see core/chunking.py), with left/right receptive halos
(halo_l, halo_r) = decoder_halos(). Once a frame has halo_r tokens of
future context buffered it can be emitted; every emitted frame is
numerically identical to the offline (whole-clip) decode under exact
mixers. Output latency is halo_r frames (+ the caller's chunk cadence);
flush() emits the tail exactly, because a real clip end is a clip end in
both passes. Under a Chebyshev (poly) mixer the fit range is taken per
dispatch, so streamed frames equal offline ones only to the
interpolation's tolerance.

Encode direction (StreamingEncoder): mel frames in, FSQ tokens out — the
live front half of a streaming duplex (microphone -> tokens -> LM ->
tokens -> mel). Conv receptive fields are exact (encoder_halo() per
side); the one approximation is the encoder CBAM channel gates' global
pooled statistics, which pool over the window rather than the
(unknowable, future-including) whole clip — the approximation class of
offline chunked re-encode (core/chunking.py docstring). Spans are gated on
full position-determined windows [k * stride, k * stride + window), so
streamed tokens equal an offline pass over those windows and NEVER depend
on the feed cadence. chunk_plan's windows start halo earlier (its first is
window - halo long), so where the CBAM statistics of the two differ a few
tokens can too. The cost is latency window - halo_l (the window is the
knob).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


class _WindowedStreamer:
    """Shared incremental machinery: buffer a 1-D stream (items may carry
    a channel tail), run a fixed-width windowed function over spans whose
    kept region has full left/right halo context, emit monotonically."""

    def __init__(
        self,
        fn: Callable,
        halo_l: int,
        halo_r: int,
        window: int,
        align: int,
        in_dtype,
        in_tail: tuple,
        out_dtype,
        out_tail: Optional[tuple],
        full_windows: bool = False,
    ):
        stride = window - halo_l - halo_r
        if stride < align:
            raise ValueError(
                f"window {window} too small for halos {halo_l}+{halo_r}")
        self.fn = fn
        self.halo_l = int(halo_l)
        self.halo_r = int(halo_r)
        self.window = int(window)
        self.align = int(align)
        # full_windows: only run position-determined spans — either the
        # whole fixed window is buffered, or the stream has closed (then
        # the span end is the final clip length, equally deterministic).
        # Required when fn has any global-over-window behavior (the
        # encoder CBAM gates): otherwise emitted values would depend on
        # how much data happened to have arrived (the feed cadence), not
        # just on the stream contents. Time-local fns (decode) skip this
        # for lower latency. The spans are a function of position only,
        # so full-window streaming equals an offline pass over the same
        # windows, cadence-invariantly.
        self._full_windows = bool(full_windows)
        self._in_dtype = in_dtype
        self._in_tail = tuple(in_tail)
        self._out_dtype = out_dtype
        self._tail = tuple(out_tail) if out_tail is not None else None
        self.reset()

    # ------------------------------------------------------------------
    def reset(self) -> None:
        self._items: List[np.ndarray] = []
        self._n = 0  # total input positions received
        self._emitted = 0  # output positions already returned
        self._drop = 0  # positions discarded from the left of the buffer
        self._closed = False

    @property
    def latency_frames(self) -> int:
        """Algorithmic output latency: a position is emitted once halo_r
        positions of future context have arrived."""
        return self.halo_r

    # ------------------------------------------------------------------
    def _buffer(self) -> np.ndarray:
        if len(self._items) > 1:
            self._items = [np.concatenate(self._items, axis=0)]
        return (self._items[0] if self._items
                else np.zeros((0,) + self._in_tail, self._in_dtype))

    def _run_span(self, ws: int, we: int) -> np.ndarray:
        """Run the fn on global span [ws, we) through the fixed window."""
        buf = self._buffer()
        seg = buf[ws - self._drop: we - self._drop]
        x = np.zeros((1, self.window) + self._in_tail, self._in_dtype)
        x[0, : len(seg)] = seg
        mask = np.arange(self.window)[None, :] >= len(seg)
        out = np.asarray(self.fn(x, mask))
        return out[0, : len(seg)]

    def _emit_until(self, hi: int) -> np.ndarray:
        """Emit positions [self._emitted, hi), hi already context-safe."""
        outs = []
        while self._emitted < hi:
            ws = max(0, self._emitted - self.halo_l)
            ws -= ws % self.align
            if self._full_windows and ws + self.window > self._n \
                    and not self._closed:
                break  # wait for the whole position-determined window
            we = min(self._n, ws + self.window)
            lo, up = self._emitted, min(hi, we - (0 if we == self._n and
                                                  self._closed else self.halo_r))
            if up <= lo:
                break
            frames = self._run_span(ws, we)
            outs.append(frames[lo - ws: up - ws])
            self._emitted = up
        # drop positions no longer reachable by any future window's left edge
        keep_from = max(0, self._emitted - self.halo_l - self.align)
        if keep_from > self._drop and self._items:
            buf = self._buffer()
            self._items = [buf[keep_from - self._drop:]]
            self._drop = keep_from
        if not outs:
            return np.zeros((0,) + self._out_shape_tail(), self._out_dtype)
        return np.concatenate(outs, axis=0)

    def _out_shape_tail(self):
        return self._tail or ()

    # ------------------------------------------------------------------
    def feed(self, x: np.ndarray) -> np.ndarray:
        """Append a chunk of the input stream and return every output
        position that now has full future context (may be empty while the
        stream warms up)."""
        if self._closed:
            raise RuntimeError("stream is closed; call reset()")
        x = np.asarray(x, self._in_dtype).reshape((-1,) + self._in_tail)
        if x.shape[0]:
            self._items.append(x)
            self._n += x.shape[0]
        out = self._emit_until(max(self._emitted, self._n - self.halo_r))
        if out.size and self._tail is None:
            self._tail = out.shape[1:]
        return out

    def flush(self) -> np.ndarray:
        """End of stream: emit the remaining halo_r-latency tail. The clip
        end is a real clip end, so these positions also match offline."""
        self._closed = True
        return self._emit_until(self._n)


class StreamingDecoder(_WindowedStreamer):
    """Incremental token -> refined-mel decoder.

    Parameters
    ----------
    decode_fn: (indices (1, W) int32, pad_mask (1, W) bool) -> (1, W, mel)
        A whole-window decode. W may be any length <= ``window`` (the fn
        is called with exactly ``window`` columns every time, so every
        span has the shape of one bucket).
    halo_l, halo_r: decode-side receptive halos (core/chunking.decoder_halos).
    window: window length; must fit halo_l + halo_r + align.
    align: window starts stay multiples of this (refiner pooling grid,
        2**refiner_depth — core/chunking.halo_align).
    mel_channels: output channel count; when given, warm-up feeds return
        correctly-shaped (0, mel_channels) arrays (otherwise (0,) until the
        first emission reveals the shape).
    """

    def __init__(
        self,
        decode_fn: Callable,
        halo_l: int,
        halo_r: int,
        window: int,
        align: int = 8,
        mel_channels: Optional[int] = None,
    ):
        super().__init__(
            decode_fn, halo_l, halo_r, window, align,
            in_dtype=np.int32, in_tail=(),
            out_dtype=np.float32,
            out_tail=(int(mel_channels),) if mel_channels else None,
        )

    # ------------------------------------------------------------------
    @classmethod
    def from_runtime(cls, runtime, window: Optional[int] = None,
                     align: Optional[int] = None):
        """Wrap a CodecRuntime (an ExportedPreEncoder, say): uses its
        largest bucket, its model's decode-side halos and its pooling-grid
        alignment."""
        window = int(window or runtime.buckets[-1])

        def decode_fn(idx, mask):
            lengths = (~mask).sum(axis=1).astype(np.int32)
            # runtime.decode pads/trims to its own buckets; feed exactly
            # one bucket-sized window so no re-bucketing happens
            return runtime.decode(idx, lengths)

        halo_l, halo_r = runtime.decoder_halos
        return cls(decode_fn, halo_l, halo_r, window,
                   align=int(align or runtime.halo_align),
                   mel_channels=runtime.mel_channels)


class StreamingEncoder(_WindowedStreamer):
    """Incremental mel -> FSQ-token encoder (live tokenization; the front
    half of a streaming duplex with StreamingDecoder).

    Parameters
    ----------
    encode_fn: (mel (1, W, C) float32, pad_mask (1, W) bool) -> (1, W) int
        A whole-window encode (the runtime's encode at one bucket).
    halo: symmetric per-side conv halo (core/chunking.encoder_halo).
    window: window length; must fit 2*halo + 1. Smaller windows
        trade compute redundancy for latency (see latency_frames).
    mel_channels: input channel count (the mel band count).

    Tokens are conv-exact vs offline; the CBAM channel gates pool over
    the window rather than the whole (future-including) clip — the same
    approximation class as offline chunked re-encode. Spans are gated on
    full position-determined windows (base class full_windows), so the
    streamed tokens equal an offline pass over those windows and never
    depend on the feed cadence.
    """

    def __init__(
        self,
        encode_fn: Callable,
        halo: int,
        window: int,
        mel_channels: int,
        align: int = 1,
    ):
        super().__init__(
            encode_fn, halo, halo, window, align,
            in_dtype=np.float32, in_tail=(int(mel_channels),),
            out_dtype=np.int32, out_tail=(),
            full_windows=True,
        )

    @property
    def latency_frames(self) -> int:
        """Worst-case output latency: a position waits for the rest of
        its full window (window - halo_l frames of lookahead), because
        the CBAM gate statistics must be position-determined, not
        arrival-determined. Choose the window to set the latency."""
        return self.window - self.halo_l

    # ------------------------------------------------------------------
    @classmethod
    def from_runtime(cls, runtime, window: Optional[int] = None):
        """Wrap a CodecRuntime's encode side (its largest bucket and its
        model's encoder halo)."""
        window = int(window or runtime.buckets[-1])

        def encode_fn(mel, mask):
            lengths = (~mask).sum(axis=1).astype(np.int32)
            return runtime.encode(mel, lengths)

        return cls(encode_fn, runtime.encoder_halo, window,
                   mel_channels=runtime.mel_channels)
