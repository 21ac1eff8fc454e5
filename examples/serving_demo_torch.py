"""Online-serving demo on the PyTorch port: concurrent clients against a
micro-batched codec.

Usage:
  python examples/serving_demo_torch.py --model_dir EXPORT_DIR [--clips 32]
      [--max_batch 64] [--max_delay_ms 5] [--device cuda|cpu]

The counterpart of examples/serving_demo.py: spawns N client threads that
each submit one random-length mel clip to a shared CodecServer
(mqgan_tpu_torch/deploy/server.py) over an artifact of
mqgan_tpu_torch.deploy.export (ExportedPreEncoder), and prints the batching
stats — mean batch occupancy and p50/p95 client latency. Runs on the card
unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--clips", type=int, default=32)
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--max_delay_ms", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card is an error) or cpu")
    args = p.parse_args(argv)

    from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder
    from mqgan_tpu_torch.deploy.server import CodecServer

    rt = ExportedPreEncoder(args.model_dir, device=args.device)
    rng = np.random.default_rng(args.seed)
    max_t = rt.buckets[-1]
    clips = [
        rng.standard_normal((int(rng.integers(max_t // 4, max_t + 1)),
                             rt.mel_channels)).astype(np.float32)
        for _ in range(args.clips)
    ]

    results = [None] * len(clips)
    with CodecServer(runtime=rt, op="reencode", max_batch=args.max_batch,
                     max_delay_ms=args.max_delay_ms) as srv:
        def client(i):
            results[i] = srv(clips[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(clips))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = srv.stats.summary()

    for clip, (idx, mel) in zip(clips, results):
        assert idx.shape[0] == clip.shape[0] and mel.shape == clip.shape
    print(f"{len(clips)} clips served; stats: {stats}")


if __name__ == "__main__":
    main()
