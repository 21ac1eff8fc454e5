"""Codec runtimes (counterpart of ``mqgan_tpu/deploy/runtime.py``).

``CodecRuntime`` serves a port ``PreEncoder`` in process with the interface
the servers, streaming and re-encode use: ``buckets``, ``bucket_for``,
``encode``, ``decode``, ``reencode``, ``mel_channels``, ``codebook_size``,
and the model's overlap-chunking halos (``halos``, ``decoder_halos``,
``encoder_halo``, ``halo_align``; core/chunking.py).
Each call pads its batch's time axis up to the nearest bucket (zero mel
frames, or token 0), builds the pad mask from the clip lengths, runs the
model and trims the result back. ``reencode`` keeps the tokens on the device
between encode and decode. Sequences longer than the largest bucket are
rejected: the caller chunks them (deploy/reencode.py).

``ExportedPreEncoder`` is the runtime of an exported artifact
(deploy/export.py): it serves the artifact's traced programs of its own
platform (``torch.export.load``, after the kernels' ops are registered:
``ops/_cuda.py`` ``load_ops``), chaining encode -> decode where an artifact
has no fused reencode program, and exposes the manifest's ``fsq_levels``
and BOS/EOS ids. It also rebuilds the model from the manifest and
``weights.pt`` (``.model``: its halos, and callers that need the module).

On a card, each call replays a CUDA graph, one per (op, bucket, rows,
device): captured at the first call of that shape, after a warm-up on a
side stream (which also builds the kernels), from static input buffers
that each call fills; the outputs are copied to the host before the next
replay. The rows of a device's slice are repeat-padded up to a power of two
(the padded rows are real rows, trimmed after; the Chebyshev mixer fits the
batch's [min, max], which repeated rows keep), so a server meets a bounded
set of graphs. A runtime's graphs share one memory pool per device: a lock
runs one call at a time, and each replay's outputs are consumed before the
next. Captures in the process take ``CAPTURE_LOCK`` (torch allows one at a
time). A capture or a launch that fails raises. A graph's replay adds the
launches its capture recorded to the kernels' counters.

Data parallelism (``devices``, or ``ExportedPreEncoder(data_parallel=True)``
over every visible card): each distinct device holds a copy of the model
(parallel/mesh.py); a batch is repeat-padded to a multiple of the device
count and split into equal row slices, every slice's inputs are staged on
its device, the slices are dispatched one after another without a host
synchronisation between them (so the cards compute at once), and the
results are gathered and trimmed to the caller's rows.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from mqgan_tpu_torch.core.buckets import BucketPolicy
from mqgan_tpu_torch.core import chunking
from mqgan_tpu_torch.core.config import TrainConfig
from mqgan_tpu_torch.core.device import resolve_device
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.ops import _cuda
from mqgan_tpu_torch.parallel.mesh import (local_devices, replicate,
                                           repeat_pad_rows, split_rows)

MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "weights.pt"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# torch allows one CUDA graph capture at a time in a process; a server
# holds more than one runtime (an LM's and a codec's, in two threads), so
# every capture of this package takes this lock
CAPTURE_LOCK = threading.Lock()


def graph_rows(rows: int) -> int:
    """The rows of a slice's CUDA graph: the next power of two."""
    return 1 << max(0, rows - 1).bit_length()


class CudaGraphCall:
    """``fn(*inputs) -> tuple of tensors`` captured as one CUDA graph at
    the shapes, dtypes and device of ``example`` (module docstring). The
    warm-up's outputs, ``first``, answer the call that captured it, so that
    each call launches the kernels once."""

    def __init__(self, fn, example, pool):
        device = example[0].device
        self.static_in = [x.clone() for x in example]
        with CAPTURE_LOCK, torch.cuda.device(device), torch.no_grad():
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):  # build, load, pick algorithms
                self.first = fn(*self.static_in)
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with _cuda.COUNTERS.recording() as self.launches:
                with torch.cuda.graph(self.graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    self.static_out = fn(*self.static_in)

    def __call__(self, inputs) -> tuple:
        for buf, x in zip(self.static_in, inputs):
            buf.copy_(x)
        self.graph.replay()
        _cuda.COUNTERS.add_all(self.launches)
        return self.static_out


class CodecRuntime:
    def __init__(self, model: PreEncoder, buckets=(128, 256, 512, 1024),
                 device=None, devices=None):
        """model: a PreEncoder with its parameters loaded. device: None
        means CUDA (raises without a card); pass "cpu" explicitly to run the
        plain versions on the CPU. devices: data parallelism over this list
        (a device may repeat; the first is ``device``); None is ``device``
        alone."""
        if devices is not None:
            devices = local_devices(devices)
            device = devices[0]
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self._devices = devices or [self.device]
        self._replicas = replicate(self.model, self._devices)
        self._policy = BucketPolicy(tuple(buckets))
        self.buckets = list(self._policy.buckets)
        self._lock = threading.Lock()
        self.graphs: dict = {}  # (op, bucket, rows, device) -> CudaGraphCall
        self._pools: dict = {}  # device -> the graphs' memory pool

    @property
    def mel_channels(self) -> int:
        return self.model.mel_channels

    @property
    def codebook_size(self) -> int:
        return self.model.codebook_size

    @property
    def halos(self) -> tuple:
        """(left, right) overlap-chunking halo of the encode+decode
        pipeline."""
        return chunking.generator_halos(self.model.kernel_sizes,
                                        self.model.refiner_depth)

    @property
    def decoder_halos(self) -> tuple:
        """(left, right) halo of the token -> mel decode side alone
        (StreamingDecoder)."""
        return chunking.decoder_halos(self.model.kernel_sizes,
                                      self.model.refiner_depth)

    @property
    def encoder_halo(self) -> int:
        """Symmetric per-side halo of the mel -> token encode side alone
        (StreamingEncoder)."""
        return chunking.encoder_halo(self.model.kernel_sizes)

    @property
    def halo_align(self) -> int:
        """Chunk windows start on multiples of this (the refiner's pooling
        grid, 2**refiner_depth)."""
        return chunking.halo_align(self.model.refiner_depth)

    @property
    def n_devices(self) -> int:
        """Devices a batch is split over (1 without data parallelism)."""
        return len(self._devices)

    def bucket_for(self, t: int) -> int:
        return self._policy.bucket_for(t)

    def _prepare(self, arr: np.ndarray, lengths, pad_value=0):
        b, t = arr.shape[0], arr.shape[1]
        if t > self.buckets[-1]:
            raise ValueError(
                f"sequence length {t} exceeds the largest bucket "
                f"{self.buckets[-1]}; chunk the input")
        lengths = (np.full((b,), t, np.int32) if lengths is None
                   else np.asarray(lengths, np.int32))
        tb = self.bucket_for(t)
        if tb != t:
            pad = np.full((b, tb - t) + arr.shape[2:], pad_value, arr.dtype)
            arr = np.concatenate([arr, pad], axis=1)
        pad_mask = np.arange(tb)[None, :] >= lengths[:, None]
        return arr, pad_mask, t

    def _call(self, op: str, device: torch.device, bucket: int):
        """The eager ``fn(x, pad_mask) -> tuple`` of ``op`` on ``device``:
        encode -> (tokens,), decode -> (fp32 mel,), reencode -> both, at
        the bucket's full length."""
        m = self._replicas[device]
        if op == "encode":
            return lambda x, p: (m.encode(x, p),)
        if op == "decode":
            return lambda i, p: (m.decode(i, p).float(),)

        def reencode(x, p):
            idx = m.encode(x, p)
            return idx, m.decode(idx, p).float()

        return reencode

    def _replay(self, op: str, device: torch.device, inputs) -> tuple:
        """``op`` through the CUDA graph of these (host) inputs' shapes,
        captured at the first call of them."""
        key = (op, inputs[0].shape[1], inputs[0].shape[0], device)
        graph = self.graphs.get(key)
        if graph is None:
            if device not in self._pools:
                self._pools[device] = torch.cuda.graph_pool_handle()
            graph = CudaGraphCall(self._call(op, device, key[1]),
                                  [x.to(device) for x in inputs],
                                  self._pools[device])
            self.graphs[key] = graph
            first, graph.first = graph.first, None
            return first
        return graph(inputs)

    def _run(self, op: str, arr: np.ndarray, pad_mask: np.ndarray, t: int) -> tuple:
        """``op`` over the devices' row slices; the outputs as numpy, the
        caller's rows, trimmed to t frames."""
        n = len(self._devices)
        parts = ([(arr, pad_mask)] if n == 1 else
                 split_rows(repeat_pad_rows((arr, pad_mask), n), n))
        with self._lock:
            pending = []
            for d, part in zip(self._devices, parts):
                rows = part[0].shape[0]
                if d.type == "cuda":
                    part = repeat_pad_rows(part, graph_rows(rows))
                ins = [torch.from_numpy(np.ascontiguousarray(a)) for a in part]
                if d.type == "cuda":  # copied out: a device may repeat
                    outs = [o[:rows, :t].clone() for o in self._replay(op, d, ins)]
                else:
                    with torch.no_grad():
                        outs = [o[:rows, :t]
                                for o in self._call(op, d, arr.shape[1])(*ins)]
                pending.append(outs)
            b = arr.shape[0]
            return tuple(np.concatenate([p[j].cpu().numpy() for p in pending])[:b]
                         for j in range(len(pending[0])))

    def encode(self, spec, lengths=None) -> np.ndarray:
        """(B, T, mel) float -> (B, T) int32 FSQ indices."""
        x, pad_mask, t = self._prepare(np.asarray(spec, np.float32), lengths)
        return self._run("encode", x, pad_mask, t)[0]

    def decode(self, indices, lengths=None) -> np.ndarray:
        """(B, T) int -> (B, T, mel) float32 refined mel."""
        idx, pad_mask, t = self._prepare(np.asarray(indices, np.int32), lengths)
        return self._run("decode", idx, pad_mask, t)[0]

    def reencode(self, spec, lengths=None):
        """(B, T, mel) -> (tokens (B, T), refined mel (B, T, mel))."""
        x, pad_mask, t = self._prepare(np.asarray(spec, np.float32), lengths)
        return self._run("reencode", x, pad_mask, t)


def read_manifest(path: str) -> dict:
    """The manifest of an artifact directory, or the manifest file itself."""
    if os.path.isdir(path):
        path = os.path.join(path, MANIFEST_NAME)
    with open(path) as f:
        return json.load(f)


def manifest_config(manifest: dict) -> TrainConfig:
    """The model config an artifact was exported from."""
    return TrainConfig.from_dict({"model": {
        "mel_channels": manifest["mel_channels"],
        "generator": manifest["generator"]}})


def program_path(model_dir: str, platform: str, name: str) -> str:
    """Where an artifact keeps one platform's program ``name``."""
    return os.path.join(model_dir, platform, name)


class ExportedPreEncoder(CodecRuntime):
    """The runtime of an artifact directory written by deploy/export.py."""

    def __init__(self, model_dir: str, device=None,
                 data_parallel: bool = False, devices=None):
        """device: None means CUDA (raises without a card); "cpu" runs the
        CPU programs (the plain versions). data_parallel: split each batch
        over ``devices`` (a list, which may repeat a device), by default
        every visible card; with one card it is the single-device path."""
        if devices is not None and not data_parallel:
            raise ValueError("devices is the data_parallel device list")
        device = resolve_device(device)
        if data_parallel and devices is None:
            devices = local_devices() if device.type == "cuda" else [device]
        self.model_dir = model_dir
        self.manifest = read_manifest(model_dir)
        platform = device.type
        if platform not in self.manifest.get("platforms", ()):
            raise RuntimeError(
                f"{model_dir} holds no {platform} programs (platforms "
                f"{self.manifest.get('platforms', [])}): export it on a "
                f"{platform} device")
        cfg = manifest_config(self.manifest)
        model = PreEncoder.from_config(
            cfg.model.mel_channels, cfg.model.generator,
            dtype=DTYPES[self.manifest.get("dtype", "float32")],
            poly_mixers=self.manifest.get("poly_mixers", False),
            int8_refiner=self.manifest.get("int8_refiner", False))
        weights = os.path.join(model_dir, self.manifest.get("weights",
                                                            WEIGHTS_NAME))
        model.load_state_dict(torch.load(weights, map_location="cpu",
                                         weights_only=True))
        super().__init__(model, buckets=self.manifest["buckets"], device=device,
                         devices=devices)
        self.platform = platform
        self._programs = {}  # (op, bucket, device) -> the loaded program
        self._load_lock = threading.Lock()

    def program(self, op: str, bucket: int, device: torch.device):
        """The artifact's program ``op`` at ``bucket`` on ``device`` (None
        when the artifact has none), loaded at its first use."""
        name = self.manifest["files"][str(bucket)].get(op)
        if name is None:
            return None
        with self._load_lock:
            key = (op, bucket, device)
            if key not in self._programs:
                _cuda.load_ops()  # the programs call the kernels' ops
                self._programs[key] = load_program(
                    program_path(self.model_dir, self.platform, name), device).module()
            return self._programs[key]

    def _call(self, op: str, device: torch.device, bucket: int):
        prog = self.program(op, bucket, device)
        if op == "encode":
            return lambda x, p: (prog(x, p),)
        if op == "decode":
            return lambda i, p: (prog(i, p).float(),)
        if prog is not None:
            def fused(x, p):
                idx, mel = prog(x, p)
                return idx, mel.float()

            return fused
        enc = self.program("encode", bucket, device)
        dec = self.program("decode", bucket, device)

        def chained(x, p):  # the tokens stay on the device
            idx = enc(x, p)
            return idx, dec(idx, p).float()

        return chained

    @property
    def fsq_levels(self) -> list:
        return list(self.manifest["fsq_levels"])

    @property
    def bos_token_id(self) -> int:
        return int(self.manifest["bos_token_id"])

    @property
    def eos_token_id(self) -> int:
        return int(self.manifest["eos_token_id"])


def load_program(path: str, device: torch.device):
    """``torch.export.load`` of ``path``, on ``device`` (a CUDA program is
    saved on the card it was traced on)."""
    from torch.export.passes import move_to_device_pass

    program = torch.export.load(path)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if next(iter(program.state_dict.values())).device == device:
        return program
    return move_to_device_pass(program, device)
