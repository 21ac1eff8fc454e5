"""Static-shape bucket policy (a copy of ``mqgan_tpu/core/buckets.py``
``BucketPolicy``, the part the runtime uses).

Inference lengths are rounded up to the nearest bucket and right-padded;
pad masks keep the semantics identical and outputs are trimmed on the host.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass


@dataclass(frozen=True)
class BucketPolicy:
    buckets: tuple

    def __post_init__(self):
        object.__setattr__(self, "buckets",
                           tuple(sorted(set(int(b) for b in self.buckets))))
        if not self.buckets:
            raise ValueError("need at least one bucket")

    def bucket_for(self, length: int) -> int:
        """Smallest bucket >= length; the largest bucket if length exceeds
        all (callers chunk or reject longer sequences)."""
        idx = bisect.bisect_left(self.buckets, int(length))
        if idx == len(self.buckets):
            return self.buckets[-1]
        return self.buckets[idx]
