"""Dataset QC: screen log-mel .npy files for degenerate content (the port's
own copy of ``mqgan_tpu/signal/qc.py``).

Behavioral contract (reference qc_mels.py:12-93, thresholds :74-91):
a clip is quarantined when it hard-fails (unreadable, wrong rank/bins,
non-finite, values far outside the expected log-mel range) or when at
least two statistical red flags fire together — near-rank-1 structure,
negligible temporal change, time-gradients tiny relative to frequency
gradients, a static spectral centroid, or a nearly constant value range.
Quarantined files are moved aside and every verdict is appended to a CSV
audit log.

This is offline host tooling, so it is plain numpy. Structure here is
ours: one vectorized statistics pass feeding a declarative check table.

Usage: python -m mqgan_tpu_torch.signal.qc SRC DST [--csv out.csv]
       [--expect-bins M] [--val-min LO] [--val-max HI] [--mirror]
"""

from __future__ import annotations

import argparse
import csv
import shutil
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Callable, Iterator

import numpy as np

# Numeric thresholds are behavioral spec, cited from reference
# qc_mels.py:74-91. A clip fails the soft screen when at least
# MIN_SOFT_REASONS of the named checks fire (the ">1 reason" rule,
# qc_mels.py:91).
MIN_SOFT_REASONS = 2
RANGE_SLACK_DB = 5.0
EXPECTED_VALUE_RANGE = (-20.0, 10.0)


@dataclass
class MelStats:
    """Summary statistics of one (T, M) log-mel array."""

    spectral_flux: float
    temporal_std_median: float
    grad_time_vs_freq: float
    centroid_variance: float
    dominant_mode_energy: float
    value_min: float
    value_max: float

    @property
    def value_span(self) -> float:
        return self.value_max - self.value_min


# name -> predicate over MelStats; each True is one red flag.
SOFT_CHECKS: list[tuple[str, Callable[[MelStats], bool]]] = [
    ("rank1_like", lambda s: s.dominant_mode_energy > 0.985),
    ("very_low_temporal_change",
     lambda s: s.spectral_flux < 0.03 and s.temporal_std_median < 0.12),
    ("time_grad_tiny_vs_freq", lambda s: s.grad_time_vs_freq < 0.15),
    ("centroid_static", lambda s: s.centroid_variance < 5.0),
    ("nearly_constant_values", lambda s: s.value_span < 0.6),
]


def compute_stats(mel: np.ndarray) -> MelStats:
    """One pass over a finite (T, M) float array."""
    t, m = mel.shape
    eps = 1e-8

    time_diff = np.diff(mel, axis=0) if t > 1 else np.zeros((1, m))
    freq_diff = np.diff(mel, axis=1) if m > 1 else np.zeros((t, 1))

    # mean L2 frame-to-frame change, normalized by sqrt(bins)
    flux = float(np.linalg.norm(time_diff, axis=1).mean() / np.sqrt(m + eps))
    anisotropy = float(
        (np.abs(time_diff).mean() + eps) / (np.abs(freq_diff).mean() + eps)
    )

    # softmax-weighted bin index per frame; its variance over time
    weights = np.exp(mel - mel.max(axis=1, keepdims=True))
    bins = np.arange(m, dtype=np.float64)
    centroid = weights @ bins / (weights.sum(axis=1) + eps)

    # fraction of variance in the leading mode, via the (M, M) Gram
    # spectrum of the time-centered array (same quantity as a rank-1
    # singular-energy ratio, computed on the small axis)
    centered = mel - mel.mean(axis=0, keepdims=True)
    try:
        eig = np.linalg.eigvalsh(centered.T.astype(np.float64) @ centered)
        eig = np.clip(eig, 0.0, None)
        dominant = float(eig[-1] / (eig.sum() + eps))
    except np.linalg.LinAlgError:
        dominant = 1.0  # can't factor it => treat as degenerate

    return MelStats(
        spectral_flux=flux,
        temporal_std_median=float(np.median(mel.std(axis=0))),
        grad_time_vs_freq=anisotropy,
        centroid_variance=float(centroid.var()),
        dominant_mode_energy=dominant,
        value_min=float(mel.min()),
        value_max=float(mel.max()),
    )


def mel_qc(mel: np.ndarray, expect_bins: int | None = None,
           value_range: tuple[float, float] = EXPECTED_VALUE_RANGE):
    """Screen one array. Returns (is_bad, report_dict).

    Hard failures (any single one quarantines): not 2-D, wrong bin count,
    non-finite values, values outside value_range by > RANGE_SLACK_DB.
    Soft failures quarantine only in combination (MIN_SOFT_REASONS).
    """
    report: dict = {}
    if mel.ndim != 2:
        return True, {"reason": "not_2d", "ndim": mel.ndim, "reasons": ["not_2d"]}

    if mel.shape[0] < mel.shape[1]:  # stored (M, T); we analyze (T, M)
        mel = mel.T
        report["transposed"] = True

    if expect_bins is not None and mel.shape[1] != expect_bins:
        report.update(reason="wrong_bins", reasons=["wrong_bins"])
        return True, report
    if not np.isfinite(mel).all():
        report.update(reason="nan_or_inf", reasons=["nan_or_inf"])
        return True, report

    stats = compute_stats(mel)
    report.update(asdict(stats), value_span=stats.value_span)

    lo, hi = value_range
    if stats.value_min < lo - RANGE_SLACK_DB or stats.value_max > hi + RANGE_SLACK_DB:
        report.update(reason="values_out_of_expected_range",
                      reasons=["values_out_of_expected_range"])
        return True, report

    fired = [name for name, check in SOFT_CHECKS if check(stats)]
    report["reasons"] = fired
    return len(fired) >= MIN_SOFT_REASONS, report


class QuarantineLog:
    """CSV audit trail, one row per quarantined file."""

    FIELDS = ("rel_path", "src", "quarantined_to", "reasons",
              "dominant_mode_energy", "spectral_flux", "temporal_std_median",
              "grad_time_vs_freq", "centroid_variance", "value_min",
              "value_max", "value_span")

    def __init__(self, csv_path: Path):
        csv_path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = csv_path.open("w", newline="")
        self._writer = csv.DictWriter(
            self._fh, fieldnames=self.FIELDS, extrasaction="ignore")
        self._writer.writeheader()

    def record(self, rel: Path, src: Path, dst: Path, report: dict) -> None:
        reasons = report.get("reasons") or [report.get("reason", "unknown")]
        self._writer.writerow({
            "rel_path": str(rel), "src": str(src), "quarantined_to": str(dst),
            "reasons": ";".join(reasons),
            **{k: report.get(k, "") for k in self.FIELDS[4:]},
        })

    def close(self) -> None:
        self._fh.close()


def _iter_verdicts(src_dir: Path, expect_bins, value_range
                   ) -> Iterator[tuple[Path, bool, dict]]:
    """Yield (file, is_bad, report) for every .npy under src_dir."""
    for npy in sorted(src_dir.rglob("*.npy")):
        try:
            mel = np.load(npy)
        except Exception as err:  # unreadable data is always quarantined
            yield npy, True, {"reasons": [f"load_error:{err}"]}
            continue
        is_bad, report = mel_qc(mel, expect_bins=expect_bins,
                                value_range=value_range)
        yield npy, is_bad, report


def scan_and_move(src_dir, bad_dir, csv_path, expect_bins=None,
                  value_low=EXPECTED_VALUE_RANGE[0],
                  value_high=EXPECTED_VALUE_RANGE[1], mirror=False):
    """Screen a tree of .npy mels; move failures into bad_dir + log CSV.

    With mirror=True the quarantine keeps the source's subdirectory layout;
    otherwise files land flat in bad_dir.
    """
    src_dir, bad_dir = Path(src_dir), Path(bad_dir)
    bad_dir.mkdir(parents=True, exist_ok=True)
    log = QuarantineLog(Path(csv_path))

    counts = {"total": 0, "bad": 0}
    try:
        for npy, is_bad, report in _iter_verdicts(
                src_dir, expect_bins, (value_low, value_high)):
            counts["total"] += 1
            if not is_bad:
                continue
            rel = npy.relative_to(src_dir)
            dst = bad_dir / (rel if mirror else rel.name)
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.move(str(npy), str(dst))
            log.record(rel, npy, dst, report)
            counts["bad"] += 1
    finally:
        log.close()

    print(f"QC scanned {counts['total']} mel files; "
          f"quarantined {counts['bad']} (audit log: {csv_path})")
    return counts


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Statistical QC for log-mel .npy datasets: quarantine "
                    "degenerate clips and write a CSV audit log.")
    parser.add_argument("src")
    parser.add_argument("dst")
    parser.add_argument("--csv", default="bad_mels.csv")
    parser.add_argument("--expect-bins", type=int, default=None)
    parser.add_argument("--val-min", type=float, default=EXPECTED_VALUE_RANGE[0])
    parser.add_argument("--val-max", type=float, default=EXPECTED_VALUE_RANGE[1])
    parser.add_argument("--mirror", action="store_true")
    args = parser.parse_args(argv)
    return scan_and_move(args.src, args.dst, args.csv, args.expect_bins,
                         args.val_min, args.val_max, args.mirror)


if __name__ == "__main__":
    main()
