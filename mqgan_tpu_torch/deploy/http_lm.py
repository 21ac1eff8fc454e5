"""HTTP generation server for the token LMs, with continuous batching
(counterpart of ``mqgan_tpu/deploy/http_lm.py``):

  GET  /healthz    -> JSON {ok, arch, vocab_size, num_genres, has_codec, ...}
  GET  /statz      -> JSON continuous-batching stats
  POST /generate   JSON body:
      {"genre": 0, "length": 512,            # required
       "n": 1,                               # samples (n batched rows)
       "temperature": 1.0, "top_k": 0, "top_p": 0.0,
       "seed": 1234,                         # omit -> fresh entropy
       "prompt_tokens": [..],                # optional continuation prefix
       "decode": false}                      # true needs a codec_dir
    -> .npy (n, length) int32 tokens, or with "decode": true an .npz of
       tokens and the codec's mel (n, length, mel_channels)

Two backends: a training run dir of this package's trainer (``lm_run``,
the eager served sampler) or an LM artifact (``lm_export``,
``deploy/export_lm.py``: its traced programs, replayed as CUDA graphs on a
card), whose buckets are then the dispatch grid. ``codec_dir``, a codec artifact
(``deploy/runtime.py`` ``ExportedPreEncoder``), adds ids >= its codebook
size to the forbidden set and answers ``"decode": true``; decodes are
serialised by a lock.

A background worker coalesces every pending request whose (prompt bucket,
generation bucket, temperature, top_k, top_p) group matches into one
dispatch of the per-row served sampler (``models/lm_sampling.py``): per-row
seeds and prompt lengths ride one batch. The served samplers give each row
the tokens it would get alone, so coalescing does not change a client's
tokens (on a card: wherever the logits of the batched and the solo dispatch
agree; see ROADMAP.md Queue 3). Requested lengths round up to a
``length_grid`` multiple and prompts to a ``prompt_grid`` multiple, and a
dispatch's width pads to a power of two, so the set of dispatch shapes stays
small; ``warmup`` runs each once before traffic, so that cuBLAS and the
caching allocator settle. A request with n samples takes n rows with seeds
seed, seed + 1, ..., seed + n - 1. pad and BOS are never sampled.

The service runs on CUDA unless given ``device="cpu"``.

CLI:  python -m mqgan_tpu_torch.deploy.http_lm (--lm_run RUN_DIR |
      --lm_export EXP) [--codec_dir CODEC] [--port 8767] [--max_length 8192]
      [--length_grid 128] [--max_batch 16] [--max_delay_ms 3] [--kv_bf16]
      [--no_prewarm] [--prewarm_lengths ...] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler
from typing import Optional

import numpy as np
import torch

from mqgan_tpu_torch.deploy.http_server import (HTTPServerThread, _HTTPError,
                                                _npy_bytes, _npz_bytes,
                                                serve_until_interrupted)
from mqgan_tpu_torch.deploy.server import ServerStats

MAX_SAMPLES = 16


def pow2_at_least(n: int) -> int:
    """The dispatch width of n rows: the next power of two >= n."""
    width = 1
    while width < n:
        width *= 2
    return width


@dataclass
class _GenReq:
    """One /generate call, expanded to its batch rows at flush time."""

    key: tuple  # (p_bucket, l_bucket, temperature, top_k, top_p)
    genre: int
    seed: int
    n: int
    length: int
    prompt: Optional[np.ndarray]  # (P,) int32 or None
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.monotonic)


class _LMBatcher:
    """Coalesce same-group generation requests into one batched dispatch.

    rows_fn(genres (B,), seeds (B,), prompts list, p_bucket, l_bucket,
    temperature, top_k, top_p) -> (B, l_bucket) int32. A batch launches when
    ``max_batch`` rows of the head request's group wait or when the head has
    waited ``max_delay_s``; the head always dispatches, even when its n
    alone exceeds ``max_batch``, so the queue never stalls.
    """

    def __init__(self, rows_fn, max_batch: int, max_delay_s: float):
        self.rows_fn = rows_fn
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.stats = ServerStats()
        # (p_bucket, l_bucket, width) shapes already run: a request riding a
        # shape's first run is counted cold; warmup() fills this set
        self._seen_shapes: set[tuple] = set()
        self._queue: deque[_GenReq] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, req: _GenReq) -> Future:
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

    def _rows_for(self, key) -> int:
        return sum(r.n for r in self._queue if r.key == key)

    def _run(self):
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                head = self._queue[0]
                deadline = head.t_submit + self.max_delay_s
                while (self._rows_for(head.key) < self.max_batch
                       and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                batch, rows, rest = [], 0, deque()
                while self._queue:
                    r = self._queue.popleft()
                    if (r.key == head.key
                            and (not batch or rows + r.n <= self.max_batch)):
                        batch.append(r)
                        rows += r.n
                    else:
                        rest.append(r)
                self._queue = rest
                self.stats.queued -= len(batch)
                if rest:
                    self._cond.notify_all()
            if batch:
                self._flush(head.key, batch)

    def _flush(self, key, batch):
        p_bucket, l_bucket, temperature, top_k, top_p = key
        try:
            genres, seeds, prompts = [], [], []
            for r in batch:
                for i in range(r.n):
                    genres.append(r.genre)
                    seeds.append((r.seed + i) & 0xFFFFFFFF)
                    prompts.append(r.prompt)
            # pad the width to a power of two: the warmed shapes; dummy rows
            # cannot change the real rows (the samplers are per row)
            real = len(genres)
            width = pow2_at_least(real)
            genres += [0] * (width - real)
            seeds += [0] * (width - real)
            prompts += [None] * (width - real)
            shape = (p_bucket, l_bucket, width)
            cold = shape not in self._seen_shapes
            out = self.rows_fn(np.asarray(genres, np.int64),
                               np.asarray(seeds, np.int64), prompts, p_bucket,
                               l_bucket, temperature, top_k, top_p)
            out = np.asarray(out).astype(np.int32)[:real]
            now = time.monotonic()
            with self._cond:
                self._seen_shapes.add(shape)
                self.stats.batches += 1
                self.stats.rows += real
                for r in batch:
                    lat = (now - r.t_submit) * 1e3
                    self.stats.latencies_ms.append(lat)
                    (self.stats.cold_latencies_ms if cold
                     else self.stats.warm_latencies_ms).append(lat)
            row = 0
            for r in batch:
                r.future.set_result(out[row: row + r.n, : r.length])
                row += r.n
        except Exception as e:  # noqa: BLE001 — fail the whole batch loudly
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)


class LMHTTPService:
    def __init__(self, lm_run: Optional[str] = None,
                 codec_dir: Optional[str] = None, *, length_grid: int = 128,
                 max_length: int = 8192, lm_export: Optional[str] = None,
                 prompt_grid: int = 16, max_batch: int = MAX_SAMPLES,
                 max_delay_ms: float = 3.0, kv_bf16: bool = False,
                 device=None):
        """Serve a training run dir of this package's trainer (``lm_run``)
        or an LM artifact (``lm_export``) on ``device`` (None: CUDA), with
        an optional codec artifact (``codec_dir``) for decode. ``kv_bf16``
        stores a run-dir transformer's KV cache in bf16 (an artifact
        records its own cache dtype)."""
        if (lm_run is None) == (lm_export is None):
            raise ValueError("pass exactly one of lm_run (a run dir of "
                             "mqgan_tpu_torch.train.lstm_trainer) and "
                             "lm_export (an artifact of deploy.export_lm)")
        self.exported = None
        self._kv = {}
        if lm_export is not None:
            from mqgan_tpu_torch.deploy.export_lm import ExportedMusicLM

            self.exported = ExportedMusicLM(lm_export, device)
            m = self.exported.manifest
            self.arch = self.exported.arch
            self.device = self.exported.device
            self.lm_args = {"vocab_size": m["vocab_size"],
                            "num_genres": m["num_genres"],
                            "bos_id": m["bos_id"], "pad_id": m["pad_id"]}
            # the artifact serves lengths up to its largest bucket
            max_length = min(max_length, self.exported.gen_buckets[-1])
        else:
            from mqgan_tpu_torch.deploy.export_lm import load_lm_from_run
            from mqgan_tpu_torch.models.token_lm import lm_arch, served_sampler

            self.model, self.lm_args = load_lm_from_run(lm_run, device)
            self.device = next(self.model.parameters()).device
            self.arch = lm_arch(self.model)
            self._sampler = served_sampler(self.model)
            if kv_bf16 and self.arch == "transformer":
                self._kv = {"kv_dtype": torch.bfloat16}
        self.codec = None
        self._codec_lock = threading.Lock()
        if codec_dir:
            from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder

            self.codec = ExportedPreEncoder(codec_dir, device=self.device)
        self.length_grid = int(length_grid)
        self.prompt_grid = int(prompt_grid)
        self.max_length = int(max_length)
        a = self.lm_args
        # with a codec attached, an id it cannot decode is never sampled
        forbidden = {a["pad_id"], a["bos_id"]}
        if self.codec is not None:
            forbidden |= set(range(self.codec.codebook_size, a["vocab_size"]))
        self.forbidden = tuple(sorted(forbidden))
        vocab_mask = torch.ones((a["vocab_size"],), dtype=torch.bool)
        vocab_mask[list(self.forbidden)] = False
        self._vocab_mask = vocab_mask.to(self.device)
        self.batcher = _LMBatcher(self._generate_rows, max_batch,
                                  float(max_delay_ms) / 1e3)

    def _buckets_for(self, length: int, prompt_len: int) -> tuple[int, int]:
        """(p_bucket, l_bucket) a request rides: the batcher's group axes
        (an artifact's buckets, or the length and prompt grids)."""
        if self.exported is not None:
            rt = self.exported
            return (rt._bucket(rt.prompt_buckets, max(prompt_len, 1), "prompt length"),
                    rt._bucket(rt.gen_buckets, length, "length"))
        l_bucket = -(-length // self.length_grid) * self.length_grid
        p_bucket = (1 if prompt_len == 0 else
                    -(-prompt_len // self.prompt_grid) * self.prompt_grid)
        return p_bucket, l_bucket

    def _generate_rows(self, genres, seeds, prompts, p_bucket, l_bucket,
                       temperature, top_k, top_p) -> np.ndarray:
        """The batcher's dispatch: per-row (genre, seed, prompt) rows at one
        (P, L) bucket pair and one sampling-params triple."""
        if self.exported is not None:
            return self.exported.generate_rows(
                genres, seeds, l_bucket, prompts=prompts,
                temperature=temperature, top_k=top_k, top_p=top_p,
                forbidden=self.forbidden)
        b = genres.shape[0]
        p_lens = np.asarray([0 if p is None else len(p) for p in prompts],
                            np.int64)
        prompt_arr = np.zeros((b, p_bucket), np.int64)
        for i, p in enumerate(prompts):
            if p is not None:
                prompt_arr[i, : p_lens[i]] = p
        dev = self.device
        out = self._sampler(
            self.model, torch.from_numpy(genres).to(dev),
            torch.from_numpy(seeds).to(dev), torch.from_numpy(prompt_arr).to(dev),
            torch.from_numpy(p_lens).to(dev), temperature, top_k, top_p,
            self._vocab_mask, max_len=l_bucket, bos_id=self.lm_args["bos_id"],
            **self._kv)
        return out.cpu().numpy()

    def warmup(self, lengths=None, prompt_lens=None, verbose: bool = False) -> int:
        """Run every dispatch shape once before traffic: each (prompt bucket,
        generation bucket) of ``lengths`` (default: an artifact's generation
        buckets, else one ``length_grid``) and ``prompt_lens`` (default:
        none, plus an artifact's prompt buckets), at every power-of-two
        width up to the one ``max_batch`` rows pad to. Returns the number of
        shapes run."""
        rt = self.exported
        if lengths is None:
            lengths = (self.length_grid,) if rt is None else tuple(rt.gen_buckets)
        if prompt_lens is None:
            prompt_lens = (0,) if rt is None else (0,) + tuple(rt.prompt_buckets)
        widths = [1]
        while widths[-1] < self.batcher.max_batch:
            widths.append(widths[-1] * 2)
        shapes = []
        for length in lengths:
            for p_len in prompt_lens:
                p_bucket, l_bucket = self._buckets_for(
                    min(int(length), self.max_length), int(p_len))
                for width in widths:
                    if (p_bucket, l_bucket, width) not in shapes:
                        shapes.append((p_bucket, l_bucket, width))
        if rt is not None:  # the card's state buffers once, at the largest shape
            rt.reserve(max(w for _, _, w in shapes), max(p for p, _, _ in shapes),
                       max(l for _, l, _ in shapes))
        n = 0
        for p_bucket, l_bucket, width in shapes:
            if (p_bucket, l_bucket, width) in self.batcher._seen_shapes:
                continue
            t0 = time.monotonic()
            prompts = [None] * width
            prompts[0] = np.zeros((p_bucket,), np.int64)
            self._generate_rows(np.zeros((width,), np.int64),
                                np.zeros((width,), np.int64), prompts, p_bucket,
                                l_bucket, 1.0, 0, 0.0)
            self.batcher._seen_shapes.add((p_bucket, l_bucket, width))
            n += 1
            if verbose:
                print(f"warmup P={p_bucket} L={l_bucket} B={width}: "
                      f"{time.monotonic() - t0:.2f}s", flush=True)
        return n

    def health(self) -> dict:
        out = {
            "ok": True,
            "arch": self.arch,
            "vocab_size": self.lm_args["vocab_size"],
            "num_genres": self.lm_args["num_genres"],
            "bos_id": self.lm_args["bos_id"],
            "pad_id": self.lm_args["pad_id"],
            "max_length": self.max_length,
            "has_codec": self.codec is not None,
            "backend": "checkpoint" if self.exported is None else "exported",
            "device": str(self.device),
        }
        if self.codec is not None:
            out["mel_channels"] = self.codec.mel_channels
            out["codebook_size"] = self.codec.codebook_size
        return out

    def stats(self) -> dict:
        return self.batcher.stats.summary()

    def generate(self, spec: dict) -> tuple[bytes, str]:
        try:
            genre = int(spec["genre"])
            length = int(spec["length"])
        except (KeyError, TypeError, ValueError) as e:
            raise _HTTPError(400, f"generate needs integer 'genre' and "
                                  f"'length': {e}")
        if not 0 <= genre < self.lm_args["num_genres"]:
            raise _HTTPError(400, f"genre {genre} outside "
                                  f"[0, {self.lm_args['num_genres']})")
        if not 1 <= length <= self.max_length:
            raise _HTTPError(413, f"length {length} outside "
                                  f"[1, {self.max_length}]")
        try:
            n = int(spec.get("n", 1))
            temperature = float(spec.get("temperature", 1.0))
            top_k = int(spec.get("top_k", 0))
            top_p = float(spec.get("top_p", 0.0))
            seed = spec.get("seed")
            seed = (int.from_bytes(os.urandom(4), "little") if seed is None
                    else int(seed))
        except (TypeError, ValueError) as e:
            raise _HTTPError(400, f"n, temperature, top_k, top_p and seed "
                                  f"must be numbers: {e}")
        if not 1 <= n <= MAX_SAMPLES:
            raise _HTTPError(400, f"n {n} outside [1, {MAX_SAMPLES}]")
        decode = bool(spec.get("decode", False))
        if decode and self.codec is None:
            raise _HTTPError(400, "decode requested but the server has no "
                                  "codec_dir attached")
        prompt_np = None
        if spec.get("prompt_tokens"):
            try:
                prompt_np = np.asarray(spec["prompt_tokens"], np.int64)
            except (TypeError, ValueError) as e:
                raise _HTTPError(400, f"prompt_tokens must be a flat int "
                                      f"list: {e}")
            if prompt_np.ndim != 1 or prompt_np.size == 0:
                raise _HTTPError(400, "prompt_tokens must be a non-empty "
                                      "flat int list")
            if not ((0 <= prompt_np)
                    & (prompt_np < self.lm_args["vocab_size"])).all():
                raise _HTTPError(400, "prompt_tokens outside the vocab")
            if (self.exported is not None
                    and prompt_np.size > self.exported.prompt_buckets[-1]):
                raise _HTTPError(413, f"prompt length {prompt_np.size} exceeds "
                                      f"the largest exported prompt bucket "
                                      f"{self.exported.prompt_buckets[-1]}")
        p_bucket, l_bucket = self._buckets_for(
            length, 0 if prompt_np is None else prompt_np.size)
        req = _GenReq(key=(p_bucket, l_bucket, temperature, top_k, top_p),
                      genre=genre, seed=seed & 0xFFFFFFFF, n=n, length=length,
                      prompt=prompt_np)
        tokens = self.batcher.submit(req).result()
        if decode:
            with self._codec_lock:
                mel = self.codec.decode(tokens)
            return _npz_bytes(tokens=tokens, mel=mel), "application/x-npz"
        return _npy_bytes(tokens), "application/x-npy"

    def close(self):
        self.batcher.close()


class _LMHandler(BaseHTTPRequestHandler):
    service: LMHTTPService = None
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def _reply(self, status, body, content_type):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, status, obj):
        self._reply(status, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        if self.path == "/healthz":
            self._reply_json(200, self.service.health())
        elif self.path == "/statz":
            self._reply_json(200, self.service.stats())
        else:
            self._reply_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/generate":
            self._reply_json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            try:
                spec = json.loads(self.rfile.read(n) if n else b"{}")
            except json.JSONDecodeError as e:
                raise _HTTPError(400, f"generate expects a JSON body: {e}")
            if not isinstance(spec, dict):
                raise _HTTPError(400, "generate expects a JSON object")
            body, ctype = self.service.generate(spec)
        except _HTTPError as e:
            self._reply_json(e.status, {"error": e.message})
            return
        except Exception as e:  # noqa: BLE001 — never kill the conn thread
            self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, body, ctype)


class LMHTTPServer(HTTPServerThread):
    def __init__(self, service: LMHTTPService, host: str = "127.0.0.1",
                 port: int = 0):
        super().__init__(_LMHandler, service, host, port)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Serve token-LM generation (and codec decode) over HTTP "
                    "with continuous batching.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--lm_run",
                     help="run dir of mqgan_tpu_torch.train.lstm_trainer "
                          "(best.json + the .pt it names)")
    src.add_argument("--lm_export",
                     help="LM artifact dir of mqgan_tpu_torch.deploy.export_lm")
    p.add_argument("--codec_dir", default=None,
                   help="codec artifact dir (deploy.export): enables "
                        "decode=true and masks undecodable ids out of sampling")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8767)
    p.add_argument("--max_length", type=int, default=8192)
    p.add_argument("--length_grid", type=int, default=128)
    p.add_argument("--max_batch", type=int, default=MAX_SAMPLES,
                   help="max coalesced rows per generation dispatch")
    p.add_argument("--max_delay_ms", type=float, default=3.0,
                   help="linger before dispatching a short batch")
    p.add_argument("--kv_bf16", action="store_true",
                   help="run-dir transformer: bf16 KV cache (halves its reads; "
                        "streams consistent within the dtype, not equal to "
                        "fp32-cache streams); an artifact records its own")
    p.add_argument("--no_prewarm", action="store_true",
                   help="skip running the dispatch-shape grid before traffic")
    p.add_argument("--prewarm_lengths", type=int, nargs="+", default=None,
                   help="generation lengths to warm (default: the artifact's "
                        "buckets, or one --length_grid)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain paths)")
    args = p.parse_args(argv)

    service = LMHTTPService(args.lm_run, args.codec_dir,
                            length_grid=args.length_grid,
                            max_length=args.max_length, lm_export=args.lm_export,
                            max_batch=args.max_batch,
                            max_delay_ms=args.max_delay_ms,
                            kv_bf16=args.kv_bf16, device=args.device)
    if not args.no_prewarm:
        t0 = time.monotonic()
        n = service.warmup(lengths=args.prewarm_lengths, verbose=True)
        print(f"warmed {n} dispatch shapes in {time.monotonic() - t0:.1f}s")
    server = LMHTTPServer(service, host=args.host, port=args.port)
    print(f"serving {service.arch} LM generation from "
          f"{args.lm_run or args.lm_export} on {server.url} ({service.device}; "
          f"codec: {args.codec_dir or 'none'})", flush=True)
    serve_until_interrupted(server)


if __name__ == "__main__":
    main()
