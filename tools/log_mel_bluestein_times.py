"""Time the Bluestein log-mel kernel (``csrc/log_mel_bluestein.cu``) at each
candidate chirp-z length L, on a card, at the shapes of ``chip_smoke.py``
phase 8: the 64 seeded clips of 261,632 samples (phase 8's audio batch) at
n_fft 2050 (hop 512) and 1201 (hop 300), 128 mels, 44.1 kHz.

For each n_fft the candidates are the lengths with no prime factor above 7
from the least the chirp-z transform takes up to 1.25 times it (at most
``--candidates`` of them, the smallest first, and the planner's own choice
always). Each candidate's log-mel is first held against the plain version
in float64 (max|k - p64| <= max(1e-4, the fp32 plain version's own error),
as phase 8 holds row 4c), then timed with CUDA events, median of 10 runs of
10 back-to-back calls; the torch.stft chain and the DFT kernel are timed at
the same n_fft beside them.

    python tools/log_mel_bluestein_times.py [--n-fft 2050 1201] [--candidates 8]

Prints the card and its power limit, one line per candidate (its radices,
ms, and ms against the planner's choice) and, as the last line, all of it
as one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def spec(n_fft: int):
    from mqgan_tpu_torch.core.config import SpectrogramConfig

    hop = 512 if n_fft == 2050 else n_fft // 4
    return SpectrogramConfig(filter_length=n_fft, hop_length=hop, win_length=n_fft)


def candidates(n_fft: int, count: int) -> list:
    from mqgan_tpu_torch.ops.stft_kernels import (BLUESTEIN_MAX_POINTS, bluestein_length,
                                                  bluestein_sizes, mixed_radices)

    least = bluestein_sizes(n_fft)[2]
    found = [n for n in range(least, min(int(1.25 * least), BLUESTEIN_MAX_POINTS) + 1)
             if mixed_radices(n) is not None][:count]
    return sorted(set(found) | {bluestein_length(n_fft)})


def main() -> None:
    import torch

    from mqgan_tpu_torch.ops.stft_kernels import (bluestein_length, bluestein_plan,
                                                  bluestein_tensors, dft_mel_tables,
                                                  log_mel, log_mel_dft, log_mel_plain,
                                                  log_mel_tables, mixed_radices)
    from mqgan_tpu_torch.signal.stft import _padded_window, hann_window

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n-fft", type=int, nargs="+", default=[2050, 1201])
    parser.add_argument("--candidates", type=int, default=8)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    wav = cs._audio_batch(dev, cs.SEED + 5)
    result = {"card": card, "n_fft": {}}
    for n_fft in args.n_fft:
        cfg = spec(n_fft)
        hop = cfg.hop_length
        cos, sin, fbank = (x.to(dev) for x in dft_mel_tables(cfg))
        ref = log_mel_plain(wav, *(x.to(dev) for x in dft_mel_tables(cfg, np.float64)), hop)
        limit = max(1e-4, float((log_mel_plain(wav, cos, sin, fbank, hop) - ref).abs().max()))
        chosen = bluestein_length(n_fft)
        planned = log_mel_tables(cfg, dev)
        padded = _padded_window(cfg.win_length, n_fft).numpy()
        rows = {}
        for length in candidates(n_fft, args.candidates):
            tables = dataclasses.replace(planned, **bluestein_tensors(
                bluestein_plan(n_fft, padded, length), dev))
            err = float((log_mel(wav, tables) - ref).abs().max())
            if not err <= limit:
                cs.fail(f"n_fft {n_fft} L {length}: max|k-p64| {err:.3e} > {limit:.3e}")
            ms = cs.time_ms(lambda: log_mel(wav, tables), 10, inner=10)
            rows[length] = dict(radices=list(mixed_radices(length)), ms=ms, max_abs_err=err)
        del ref
        window = hann_window(cfg.win_length, device=dev)
        chain = cs.time_ms(lambda: cs.log_mel_library(wav, window, fbank, n_fft, hop,
                                                      cfg.win_length), 10, inner=10)
        dft = cs.time_ms(lambda: log_mel_dft(wav, cos, sin, fbank, hop), 5)
        for length, row in rows.items():
            print(f"n_fft {n_fft} L {length} {row['radices']}: {row['ms']:.4f} ms "
                  f"({row['ms'] / rows[chosen]['ms']:.3f}x the planner's L {chosen}), "
                  f"max|k-p64| {row['max_abs_err']:.3e} (limit {limit:.3e})")
        print(f"n_fft {n_fft}: torch.stft chain {chain:.4f} ms, the DFT kernel {dft:.4f} ms")
        result["n_fft"][n_fft] = dict(chosen=chosen, limit=limit, chain_ms=chain,
                                      dft_ms=dft, lengths=rows)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
