"""Dataset-level FSQ token statistics — codebook-health QC for token dumps
(a copy of ``mqgan_tpu/deploy/token_stats.py``).

Run it over a ``deploy.reencode --save_tokens`` output directory to see
whether the codec uses its implicit codebook. FSQ cannot collapse its
*grid*, but an encoder can still route everything through a few codes; this
reports usage, distribution shape (entropy/perplexity, top-code
concentration) and a bigram predictability number that says how much an LM
could exploit.

Offline tooling: numpy only.

CLI:  python -m mqgan_tpu_torch.deploy.token_stats --tokens_dir DIR
      [--codebook_size 1000] [--no_bigram] [--out stats.json]
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field

import numpy as np

from mqgan_tpu_torch.utils.npy import find_npy_files, load_npy


@dataclass
class TokenStats:
    n_files: int = 0
    n_failed: int = 0
    n_tokens: int = 0
    codebook_size: int = 0
    # global unigram distribution
    used_codes: int = 0
    usage: float = 0.0            # used_codes / codebook_size
    unigram_entropy_bits: float = 0.0
    unigram_perplexity: float = 0.0
    top1_share: float = 0.0       # mass of the single most frequent code
    top16_share: float = 0.0
    # conditional (bigram) structure: how predictable is the next token
    bigram_cond_entropy_bits: float = 0.0
    bigram_perplexity: float = 0.0
    # per-file spread
    per_file_used_codes_min: int = 0
    per_file_used_codes_median: float = 0.0
    per_file_used_codes_max: int = 0
    out_of_range_tokens: int = 0
    special_tokens: int = 0       # BOS/EOS (>= codebook_size) if present
    files_failed: list = field(default_factory=list)

    def summary(self) -> str:
        lines = [
            f"files: {self.n_files} ({self.n_failed} failed)",
            f"tokens: {self.n_tokens:,}",
            f"codebook: {self.used_codes}/{self.codebook_size} codes used "
            f"({100 * self.usage:.1f}%)",
            f"unigram: {self.unigram_entropy_bits:.2f} bits "
            f"(perplexity {self.unigram_perplexity:.1f})",
            f"concentration: top-1 {100 * self.top1_share:.1f}%, "
            f"top-16 {100 * self.top16_share:.1f}%",
            f"bigram: {self.bigram_cond_entropy_bits:.2f} bits/token "
            f"(perplexity {self.bigram_perplexity:.1f})",
            f"per-file used codes: min {self.per_file_used_codes_min} / "
            f"median {self.per_file_used_codes_median:.0f} / "
            f"max {self.per_file_used_codes_max}",
        ]
        if self.special_tokens:
            lines.append(f"special (BOS/EOS-range) tokens: {self.special_tokens}")
        if self.out_of_range_tokens:
            lines.append(f"!! out-of-range tokens: {self.out_of_range_tokens}")
        return "\n".join(lines)


def _entropy_bits(counts: np.ndarray) -> float:
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts[counts > 0].astype(np.float64) / total
    return float(-(p * np.log2(p)).sum())


def compute_token_stats(
    tokens_dir: str,
    codebook_size: int = 1000,
    bigram: bool = True,
) -> TokenStats:
    """Scan every .npy under tokens_dir (int token arrays, any shape —
    flattened per file) and accumulate dataset-level statistics.

    Tokens in [codebook_size, codebook_size + 2] count as BOS/EOS-range
    "special" (the PreEncoder reserves codebook_size+1/+2); anything else
    outside [0, codebook_size) is reported as out-of-range — a real
    dataset-corruption signal."""
    files = find_npy_files(tokens_dir)
    stats = TokenStats(codebook_size=codebook_size)
    counts = np.zeros(codebook_size, np.int64)
    # bigram accumulation per *observed* predecessor: a dict keeps memory
    # at O(observed pairs), fine for 1000-code books
    pair_counts: dict = {}
    per_file_used = []

    for path in files:
        try:
            toks = np.asarray(load_npy(path)).reshape(-1).astype(np.int64)
        except (OSError, ValueError):  # unreadable file: report, keep going
            stats.n_failed += 1
            stats.files_failed.append(path)
            continue
        stats.n_files += 1
        stats.n_tokens += int(toks.size)
        special = (toks >= codebook_size) & (toks <= codebook_size + 2)
        stats.special_tokens += int(special.sum())
        bad = (toks < 0) | (toks > codebook_size + 2)
        stats.out_of_range_tokens += int(bad.sum())
        valid = toks[(toks >= 0) & (toks < codebook_size)]
        if valid.size == 0:
            per_file_used.append(0)
            continue
        c = np.bincount(valid, minlength=codebook_size)
        counts += c
        per_file_used.append(int((c > 0).sum()))
        if bigram and valid.size > 1:
            pairs = valid[:-1] * codebook_size + valid[1:]
            uniq, n = np.unique(pairs, return_counts=True)
            for k, v in zip(uniq.tolist(), n.tolist()):
                pair_counts[k] = pair_counts.get(k, 0) + v

    total = counts.sum()
    stats.used_codes = int((counts > 0).sum())
    stats.usage = stats.used_codes / codebook_size if codebook_size else 0.0
    stats.unigram_entropy_bits = _entropy_bits(counts)
    stats.unigram_perplexity = float(2.0 ** stats.unigram_entropy_bits)
    if total:
        srt = np.sort(counts)[::-1]
        stats.top1_share = float(srt[0] / total)
        stats.top16_share = float(srt[:16].sum() / total)
    if per_file_used:
        stats.per_file_used_codes_min = int(min(per_file_used))
        stats.per_file_used_codes_median = float(np.median(per_file_used))
        stats.per_file_used_codes_max = int(max(per_file_used))

    if bigram and pair_counts:
        # H(next | prev) = H(pair) - H(prev over pairs)
        pc = np.fromiter(pair_counts.values(), np.int64, len(pair_counts))
        keys = np.fromiter(pair_counts.keys(), np.int64, len(pair_counts))
        prev_ids = keys // codebook_size
        prev_counts = np.zeros(codebook_size, np.int64)
        np.add.at(prev_counts, prev_ids, pc)
        stats.bigram_cond_entropy_bits = (
            _entropy_bits(pc) - _entropy_bits(prev_counts))
        stats.bigram_perplexity = float(2.0 ** stats.bigram_cond_entropy_bits)
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Codebook-health statistics over an FSQ token dump "
                    "(deploy.reencode --save_tokens output).")
    p.add_argument("--tokens_dir", required=True)
    p.add_argument("--codebook_size", type=int, default=1000,
                   help="product of the model's fsq_levels "
                        "(flagship [8,5,5,5] -> 1000)")
    p.add_argument("--no_bigram", action="store_true",
                   help="skip the bigram pass (faster on huge dumps)")
    p.add_argument("--out", default=None, help="also write stats JSON here")
    args = p.parse_args(argv)

    stats = compute_token_stats(args.tokens_dir, args.codebook_size,
                                bigram=not args.no_bigram)
    print(stats.summary())
    if args.out:
        d = {k: v for k, v in stats.__dict__.items() if k != "files_failed"}
        d["files_failed"] = stats.files_failed[:50]
        with open(args.out, "w") as f:
            json.dump(d, f, indent=1)
        print(f"wrote {args.out}")
    return stats


if __name__ == "__main__":
    main()
