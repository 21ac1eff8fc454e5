"""Time the token LMs' eager served samplers on a card at the decode shape
of ``chip_smoke.py`` phase 12f: B=64 rows, prompt 0, L=512 tokens after an
L=32 warm-up, vocab mask forbidding pad (0) and BOS (1), default sampling
knobs, the tokens copied to the host. Models: the flagship transformer
(vocab 1003, 10 genres, emb 512, 6 layers, 8 heads, MLP ratio 4) with an
fp32 and a bf16 KV cache, and the flagship LSTM (the LM trainer's
defaults: 2 layers of 1024), seeded weights.

Each ``--root`` (default: this checkout) gets a worker process that imports
``mqgan_tpu_torch`` from it, builds the models and warms each up. The
workers then time one dispatch at a time, taking turns, the order
alternating from pair to pair (A B, then B A), so that two checkouts meet
the same host on one card:

    python tools/served_decode_ms.py [--root A [--root B]] [--pairs 10]

Prints the card and its power limit, then per model and root the ms per
token of each dispatch, their median and quartiles and the tokens'
checksum, and for two roots the pairs each won; the last line is all of it
as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

LM = dict(vocab_size=1003, num_genres=10, emb_dim=512, n_layers=6, n_heads=8,
          mlp_ratio=4, pad_id=0)
MODELS = ("transformer fp32 KV", "transformer bf16 KV", "lstm")
B, L, WARM = 64, 512, 32


def worker(root: str) -> None:
    """Answer each model name read from stdin with one timed dispatch:
    a JSON line {"ms": ms per token, "checksum": sum of the tokens}."""
    sys.path.insert(0, root)
    import torch

    from mqgan_tpu_torch.models.token_lm import build_token_lm, served_sampler
    from mqgan_tpu_torch.utils.init import seeded_init_

    dev = torch.device("cuda")
    rows = (torch.arange(B, device=dev) % LM["num_genres"], torch.arange(B, device=dev),
            torch.zeros((B, 1), dtype=torch.long, device=dev),
            torch.zeros(B, dtype=torch.long, device=dev))
    mask = torch.ones(LM["vocab_size"], dtype=torch.bool, device=dev)
    mask[:2] = False
    transformer = seeded_init_(build_token_lm(dict(LM, arch="transformer"),
                                              for_inference=True), 1).to(dev).eval()
    lstm = seeded_init_(build_token_lm(dict(LM, arch="lstm", lstm_hid=1024,
                                            lstm_layers=2), for_inference=True),
                        2).to(dev).eval()
    models = dict(zip(MODELS, ((transformer, {}),
                               (transformer, {"kv_dtype": torch.bfloat16}),
                               (lstm, {}))))

    def dispatch(name, length):
        model, extra = models[name]
        return served_sampler(model)(model, *rows, 1.0, 0, 0.0, mask, max_len=length,
                                     bos_id=1, **extra).cpu()

    for name in MODELS:
        dispatch(name, WARM)
    print("ready", flush=True)
    for line in sys.stdin:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dispatch(line.strip(), L)
        ms = 1e3 * (time.perf_counter() - t0) / L
        print(json.dumps({"ms": ms, "checksum": int(out.sum())}), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", action="append", default=None,
                   help="a checkout to time (given once or twice)")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = [os.path.abspath(r) for r in (args.root or [here])]
    if args.worker:
        worker(roots[0])
        return
    if len(roots) > 2:
        sys.exit("served_decode_ms: one or two roots")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[:1]
    print(f"card: {card}", flush=True)
    procs = {r: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                                  "--root", r], stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, text=True) for r in roots}
    result = {"card": card, "roots": roots, "models": {}}
    try:
        for r, proc in procs.items():
            if proc.stdout.readline().strip() != "ready":
                sys.exit(f"served_decode_ms: the worker of {r} failed")
        runs = {name: {r: [] for r in roots} for name in MODELS}
        for i in range(args.pairs):
            for name in MODELS:
                for r in (roots if i % 2 == 0 else roots[::-1]):
                    procs[r].stdin.write(name + "\n")
                    procs[r].stdin.flush()
                    runs[name][r].append(json.loads(procs[r].stdout.readline()))
    finally:
        for proc in procs.values():
            proc.stdin.close()
            proc.wait()
    for name in MODELS:
        entry = {}
        for r in roots:
            ms = [x["ms"] for x in runs[name][r]]
            q1, med, q3 = statistics.quantiles(ms, n=4)
            entry[r] = {"ms_per_token": ms, "median": med, "q1": q1, "q3": q3,
                        "checksums": sorted({x["checksum"] for x in runs[name][r]})}
            print(f"{name} {r}: median {med:.4f} ms/token (quartiles {q1:.4f}, "
                  f"{q3:.4f}), checksums {entry[r]['checksums']}")
        if len(roots) == 2:
            a, b = (entry[r]["ms_per_token"] for r in roots)
            entry["wins"] = [sum(x < y for x, y in zip(a, b)),
                             sum(y < x for x, y in zip(a, b))]
            print(f"{name}: pairs won {entry['wins'][0]} ({roots[0]}) and "
                  f"{entry['wins'][1]} ({roots[1]}) of {len(a)}")
        result["models"][name] = entry
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
