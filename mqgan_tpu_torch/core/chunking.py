"""Overlap-chunked long-sequence evaluation plans (a copy of
``mqgan_tpu/core/chunking.py``: same plans, same halos).

Clips longer than the largest bucket run through it in overlapping windows;
each window's seam region is discarded, so every kept frame has its FULL
receptive field inside the window:

* the causal decoder trunk needs only LEFT context (2*(k-1) per
  ResidualBlock1D — two causal convs each),
* the post mel-mixer is a symmetric 5x5 (+-2 frames),
* the UNet refiner needs +-(its multiscale conv footprint) on both sides,
  and its pooling grid must stay aligned — window starts are multiples of
  2**depth so every pooled frame pairs the same neighbors as a full pass.

With those halos the DECODE side of a chunked pass is numerically
equivalent to a single full-length pass (~1e-5 in fp32). The ENCODE side is
conv-exact under the same scheme, with one documented approximation: the
non-causal encoder blocks' CBAM channel gate pools over the whole window
(>= the largest bucket) rather than the whole clip, so token choices near a
window's edge can differ from a full-length encode where the clip is
non-stationary at that scale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class ChunkSpan:
    """One window of a chunk plan, all indices in GLOBAL frames."""

    start: int  # window start (inclusive)
    stop: int  # window stop (exclusive); stop - start <= window
    keep_lo: int  # first kept frame (global)
    keep_hi: int  # one past the last kept frame (global)

    @property
    def local_lo(self) -> int:
        return self.keep_lo - self.start

    @property
    def local_hi(self) -> int:
        return self.keep_hi - self.start


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# Flagship (hifispeech/hifimusic) generator architecture: the single
# fallback used when an exported manifest predates the halo fields.
# Keep these HERE (next to the halo math) — runtime/streaming/reencode all
# import them rather than re-hardcoding the tuple.
FLAGSHIP_KERNEL_SIZES: Tuple[int, ...] = (3, 3, 5, 7)
FLAGSHIP_REFINER_DEPTH: int = 3


def halo_align(refiner_depth: int) -> int:
    """Window starts must be multiples of this so the UNet pooling grid
    pairs the same frame neighbors as a full-length pass."""
    return 2 ** refiner_depth


def refiner_halo(depth: int) -> int:
    """Symmetric per-side receptive footprint of UNetRefiner in frames:
    each ConvBlock is two 3x3 convs (+-2 at its own resolution); the level
    resolutions are 1, 2, .., 2**depth, 2**depth, .., 2, 1 plus the final
    3x3 post conv (+-1), plus one frame per pooling stage for grid edges."""
    per_side = 2  # pre block at full resolution
    for i in range(depth):
        per_side += 2 * 2 ** (i + 1)  # down_i after its pool
    per_side += 2 * 2 ** depth  # mid
    for i in range(depth):
        per_side += 2 * 2 ** (depth - 1 - i)  # up_i
    per_side += 1  # post conv
    per_side += depth  # pooling-grid edge slack
    return per_side


def decoder_halos(
    kernel_sizes: Tuple[int, ...],
    refiner_depth: int,
    mixer_kernel: int = 5,
) -> Tuple[int, int]:
    """(left, right) halo for the token -> mel DECODE side alone.

    Every decode op is time-local (causal blocks drop CBAM; the refiner has
    no global pooling), so with these halos a chunked decode is numerically
    EQUAL to a full-length decode on the kept frames (~1e-5 fp32,
    tests/test_torch_chunking.py). x_post at frame i reads refiner_in
    [i-r, i+r] -> decoder_out [i-r-mix, i+r+mix] -> tokens
    [i-r-mix-dec_left, i+r+mix] (causal trunk: left 2*(k-1) per block)."""
    dec_left = sum(2 * (k - 1) for k in kernel_sizes)
    r = refiner_halo(refiner_depth)
    mix = mixer_kernel // 2
    align = 2 ** refiner_depth
    return (_round_up(dec_left + mix + r, align), _round_up(mix + r, align))


def encoder_halo(
    kernel_sizes: Tuple[int, ...],
    mixer_kernel: int = 5,
    sam_kernel: int = 7,
) -> int:
    """Symmetric per-side conv receptive span of the ENCODE side alone
    (mel -> tokens): pre mixer +-(mixer_kernel//2); per non-causal block
    two k-wide convs plus the CBAM spatial gate's sam_kernel-wide time
    conv (nn/attention.py SAM1D). The encoder has no pooling grid, so no
    alignment applies. Exact up to the CBAM channel gate's global stats
    (module docstring)."""
    return mixer_kernel // 2 + sum(
        2 * (k // 2) + sam_kernel // 2 for k in kernel_sizes)


def generator_halos(
    kernel_sizes: Tuple[int, ...],
    refiner_depth: int,
    mixer_kernel: int = 5,
    sam_kernel: int = 7,
) -> Tuple[int, int]:
    """(left, right) halo in frames such that a frame with that much
    context inside its window gets the same conv receptive field as in a
    full-length pass, for the WHOLE encode+decode pipeline.

    Receptive fields COMPOSE: the leftmost token the decode of kept frame i
    reads (decoder_halos() away) itself needs the encoder's full conv
    context (pre mixer +-(mixer_kernel//2), non-causal blocks +-2*(k//2)
    convs PLUS the CBAM spatial gate's +-(sam_kernel//2) time conv,
    nn/attention.py SAM1D) inside the window, so the encoder span is
    ADDED to the decode span on both sides. Exact up to the encoder CBAM
    channel gate's window approximation (module docstring)."""
    enc = encoder_halo(kernel_sizes, mixer_kernel, sam_kernel)
    dec_l, dec_r = decoder_halos(kernel_sizes, refiner_depth, mixer_kernel)
    align = 2 ** refiner_depth
    return _round_up(enc + dec_l, align), _round_up(enc + dec_r, align)


def chunk_plan(
    t: int, window: int, halo_l: int, halo_r: int, align: int = 8,
    strict: bool = True,
) -> List[ChunkSpan]:
    """Cover [0, t) with keep regions whose windows fit ``window`` frames.

    Invariants (tested): keep regions tile [0, t) exactly; every window
    start is a multiple of ``align`` (pooling-grid alignment); every kept
    frame has >= halo_l/halo_r context inside its window except where the
    clip itself ends; window lengths never exceed ``window``.

    ``strict=False``: when the window cannot fit the full halos, shrink
    them proportionally (keeping align multiples) instead of raising —
    best-effort context beats a hard failure for serving tools handling
    arbitrary exported bucket sets; still >= the no-overlap alternative."""
    if t <= window:
        return [ChunkSpan(0, t, 0, t)]
    halo_l = _round_up(halo_l, align)
    stride = window - halo_l - halo_r
    stride -= stride % align
    if stride <= 0:
        if not strict and halo_l + halo_r > 0:
            budget = window - 2 * align  # leave >= align frames of stride
            if budget > 0:
                scale = budget / (halo_l + halo_r)
                halo_l = (int(halo_l * scale) // align) * align
                halo_r = (int(halo_r * scale) // align) * align
                stride = window - halo_l - halo_r
                stride -= stride % align
        if stride <= 0:
            raise ValueError(
                f"window {window} too small for halos {halo_l}+{halo_r}")
    spans = []
    ks = 0
    while ks < t:
        ke = min(ks + stride, t)
        ws = max(0, ks - halo_l)
        we = min(t, ke + halo_r)
        if we - ws > window:  # only possible on the first span (ws==0)
            we = ws + window
            ke = min(ke, we - halo_r)
        spans.append(ChunkSpan(ws, we, ks, ke))
        ks = ke
    return spans
