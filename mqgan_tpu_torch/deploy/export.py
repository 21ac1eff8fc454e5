"""Codec export — the artifact a deployment loads (counterpart of
``mqgan_tpu/deploy/export.py``).

The artifact is a directory:

* ``manifest.json``: the JAX manifest's fields (``mel_channels``,
  ``fsq_levels``, ``codebook_size``, ``bos_token_id``/``eos_token_id``,
  ``buckets``, ``platforms``, ``int8_refiner``, ``poly_mixers``, ``files``,
  ``halos``, ``decoder_halos``, ``encoder_halo``, ``halo_align``) plus the
  generator config (``generator``), the compute dtype (``dtype``) and the
  weights file (``weights``);
* per bucket t, the traced programs ``encode_T{t}.pt2`` (mel fp32 (b, t,
  mel), pad_mask bool (b, t) -> tokens int32 (b, t)), ``decode_T{t}.pt2``
  (tokens int32 (b, t), pad_mask -> mel (b, t, mel) in the compute dtype)
  and, when no mixer is Chebyshev, the fused ``reencode_T{t}.pt2`` (-> both),
  as ``files[str(t)]`` names them; each is ``torch.export`` of the model's
  entry point with a symbolic batch ``b`` and the parameters inside the
  program, its kernels the ``mqgan::`` ops of ``ops/_cuda.py``;
* one directory of those programs per platform in ``platforms``: ``cpu``
  always, ``cuda`` when the export runs on a card. A program fixes the
  device of the tensors it makes, so each platform has its own: an export
  on the CPU traces there; an export on a card traces there and writes the
  same programs moved to the CPU (``torch.export.passes``
  ``move_to_device_pass`` rewrites the devices the graph fixes and moves
  the weights), since a trace costs seconds a program;
* ``weights.pt``: the generator's plain ``state_dict`` (fp32), read back
  with ``torch.load(..., weights_only=True)``. The runtime rebuilds the
  model from it beside the programs, and a ``--manifest`` re-export, a
  windowed encode or another dtype start from it.

``deploy/runtime.py`` ``ExportedPreEncoder`` serves the programs of its own
platform (on a card each through a CUDA graph per bucket and batch size);
``verify_export`` reloads the artifact through it and round-trips at a
length that is no bucket. As in the JAX package, a Chebyshev mixer gets no
fused program: the runtime chains encode and decode (the JAX export found
the fused program with the Chebyshev post mixer runs out of memory at the
flagship batch).

CLI:  python -m mqgan_tpu_torch.deploy.export (--config model.yaml |
      --manifest OLD/manifest.json) (--checkpoint CKPT | --seed N)
      --output DIR [--buckets 128 256 512 1024] [--bf16]
      [--poly_mixers [decode|encode|both] | --exact_mixers]
      [--int8_refiner] [--device cuda]

``--config`` takes YAML (PyYAML) or ``.json``; ``--manifest`` takes the
generator config of an earlier export. ``--checkpoint`` is any source of
``utils/checkpoint.py`` (a reference or port ``.pth``/``.pt``, an ``.npz``
JAX tree); ``--seed`` exports seeded weights. With no mixer flag the CLI
exports ``poly_mixers="decode"`` (tokens those of the exact path);
``export_preencoder`` itself exports the model as it is given.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
from typing import Sequence

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from mqgan_tpu_torch.core.chunking import (decoder_halos, encoder_halo,
                                           generator_halos, halo_align)
from mqgan_tpu_torch.core.config import GeneratorConfig, load_model_config
from mqgan_tpu_torch.core.device import resolve_device
from mqgan_tpu_torch.deploy.runtime import (MANIFEST_NAME, WEIGHTS_NAME,
                                            ExportedPreEncoder, manifest_config,
                                            program_path, read_manifest)
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.nn.conv import fold_weight_norm_
from mqgan_tpu_torch.parallel.mesh import local_devices

DEFAULT_EXPORT_BUCKETS = (128, 256, 512, 1024)
TRACE_ROWS = 2  # the example batch (b = 1 would specialise the batch to 1)
MAX_ROWS = 1 << 16


# the submodules an entry point does not run: left out of its program
_UNUSED = {"encode": ("q_out_proj", "decoder_blocks", "post", "out_proj",
                      "hidden_proj", "refiner"),
           "decode": ("proj", "pre", "encoder_blocks", "q_in_proj")}


class _EntryPoint(torch.nn.Module):
    """One traced entry point of a PreEncoder: (x, pad_mask) -> its
    output; it holds the model's parameters that the entry point uses."""

    def __init__(self, model: PreEncoder, op: str):
        super().__init__()
        model = copy.copy(model)  # shares the tensors
        model._modules = {k: None if k in _UNUSED.get(op, ()) else v
                          for k, v in model._modules.items()}
        self.model, self.op = model, op

    def forward(self, x, pad_mask):
        # the undecorated bodies of encode / decode (traced under no_grad)
        model = self.model
        if self.op == "decode":
            return model._decode_tokens(x, pad_mask)[1]
        tokens = model._fsq_head(model._encode_trunk(x, pad_mask))
        if self.op == "encode":
            return tokens
        return tokens, model._decode_tokens(tokens, pad_mask)[1]


# traced programs by key: what a trace depends on besides its root's
# tensors (the caller's key: the entry point, device, dtype, modes and
# example shapes) and the names, shapes and dtypes of those tensors, not
# their values, so a later export of the same architecture in the process
# takes the program with its own weights (tracing costs seconds); kept
# with meta tensors for weights
_TRACED: dict = {}


def module_tensors(root: torch.nn.Module) -> dict:
    """``root``'s parameters and buffers by name."""
    return {**dict(root.named_parameters()), **dict(root.named_buffers())}


def with_tensors(program, tensors: dict):
    """``program`` (shallow-copied) holding ``tensors`` in place of its own."""
    program = copy.copy(program)
    program._state_dict = {k: tensors[k] for k in program.state_dict}
    program._constants = {k: tensors.get(k, v) for k, v in program.constants.items()}
    return program


def traced(root: torch.nn.Module, key: tuple, example):
    """``torch.export`` of ``root`` (eval mode, no grad) on the (args,
    dynamic_shapes) that ``example()`` gives, holding ``root``'s tensors;
    one trace serves every root of the same ``key`` and tensor layout."""
    tensors = module_tensors(root.eval())
    key = key + (tuple((k, tuple(v.shape), v.dtype) for k, v in tensors.items()),)
    if key not in _TRACED:
        args, dims = example()
        with torch.no_grad():
            program = torch.export.export(root, args, dynamic_shapes=dims)
        program._state_dict = {k: v.to("meta") for k, v in program.state_dict.items()}
        _TRACED[key] = program
    return with_tensors(_TRACED[key], tensors)


def save_program(program, out_dir: str, platform: str, name: str,
                 cpu_tensors: dict | None = None) -> None:
    """Write ``program``, traced on ``platform``, as its file ``name``
    there and, for a card's, its copy moved to the CPU, holding
    ``cpu_tensors`` (None: its own, moved) in place of its own."""
    torch.export.save(program, program_path(out_dir, platform, name))
    if platform != "cpu":  # the pass rewrites the graph it is given
        moved = move_to_device_pass(copy.deepcopy(program), "cpu")
        if cpu_tensors is not None:
            moved = with_tensors(moved, cpu_tensors)
        torch.export.save(moved, program_path(out_dir, "cpu", name))


def trace_program(model: PreEncoder, op: str, t: int):
    """``torch.export`` of ``op`` ("encode", "decode" or "reencode") at
    bucket t on the model's device, the batch symbolic, the model's
    parameters and buffers inside."""
    dev = model.fsq_consts.device
    modes = {"encode": (model.pre.poly_approx,),
             "decode": (model.post.poly_approx, model.refiner.int8)}

    def example():
        rows = TRACE_ROWS
        x = (torch.zeros((rows, t), dtype=torch.int32, device=dev) if op == "decode"
             else torch.zeros((rows, t, model.mel_channels), device=dev))
        pad_mask = torch.zeros((rows, t), dtype=torch.bool, device=dev)
        batch = torch.export.Dim("b", min=1, max=MAX_ROWS)
        return (x, pad_mask), ({0: batch}, {0: batch})

    return traced(_EntryPoint(model, op),
                  (op, t, str(dev), model.dtype,
                   modes.get(op, (modes["encode"], modes["decode"]))), example)


def export_platforms(device) -> list:
    """"cpu", and "cuda" when the export runs on a card."""
    return ["cpu"] + (["cuda"] if resolve_device(device).type == "cuda" else [])


def _export_device(model: PreEncoder, device) -> torch.device:
    """Where an export runs: ``device``, or the model's own for None."""
    return model.fsq_consts.device if device is None else resolve_device(device)


def export_preencoder(model: PreEncoder, cfg: GeneratorConfig, out_dir: str, *,
                      buckets: Sequence[int] = DEFAULT_EXPORT_BUCKETS,
                      verify: bool = True, device=None) -> str:
    """Write ``model`` (built from ``cfg``; its dtype, mixer mode and int8
    refiner are recorded) as an artifact in ``out_dir``: the programs of
    the CPU and, when ``device`` (None: the model's device) is a card, of
    the card; with ``verify``, reload and round-trip it on ``device``."""
    device = _export_device(model, device)
    os.makedirs(out_dir, exist_ok=True)
    ks, depth = tuple(cfg.kernel_sizes), cfg.refiner_depth
    buckets = sorted(int(t) for t in buckets)
    platforms = export_platforms(device)
    ops = ("encode", "decode") + (() if model.poly_mixers else ("reencode",))
    manifest = {
        "mel_channels": model.mel_channels,
        "fsq_levels": list(model.fsq_levels),
        "codebook_size": model.codebook_size,
        "bos_token_id": model.bos_token_id,
        "eos_token_id": model.eos_token_id,
        "buckets": buckets,
        "platforms": platforms,
        "int8_refiner": bool(model.int8_refiner),
        # False | True (both mixers) | "decode" | "encode"
        "poly_mixers": (model.poly_mixers if isinstance(model.poly_mixers, str)
                        else bool(model.poly_mixers)),
        "files": {str(t): {op: f"{op}_T{t}.pt2" for op in ops} for t in buckets},
        # (left, right) seam-discard halos of overlap chunking
        # (core/chunking.py): "halos" for encode+decode, "decoder_halos" for
        # the decode side alone (StreamingDecoder); window starts are
        # multiples of "halo_align" (the refiner's pooling grid)
        "halos": list(generator_halos(ks, depth)),
        "decoder_halos": list(decoder_halos(ks, depth)),
        "encoder_halo": encoder_halo(ks),
        "halo_align": halo_align(depth),
        "generator": dataclasses.asdict(cfg),
        "dtype": str(model.dtype).removeprefix("torch."),
        "weights": WEIGHTS_NAME,
    }
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(weights, os.path.join(out_dir, WEIGHTS_NAME))
    on = local_devices([device])[0] if device.type == "cuda" else device
    on_model = fold_weight_norm_(copy.deepcopy(model).to(on).eval())
    # a card export's CPU programs hold the weights folded on the CPU, as a
    # CPU export's do
    on_cpu = (fold_weight_norm_(copy.deepcopy(model).cpu().eval())
              if on.type != "cpu" else None)
    for platform in platforms:
        os.makedirs(os.path.join(out_dir, platform), exist_ok=True)
    for t, files in manifest["files"].items():
        for op, name in files.items():
            save_program(trace_program(on_model, op, int(t)), out_dir, on.type, name,
                         None if on_cpu is None
                         else module_tensors(_EntryPoint(on_cpu, op)))
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    if verify:
        verify_export(out_dir, device=device)
    return out_dir


def verify_export(out_dir: str, device=None) -> None:
    """Reload through the runtime (the programs of ``device``'s platform)
    and round-trip at a length that is NOT one of the exported buckets;
    raises on any failure."""
    rt = ExportedPreEncoder(out_dir, device=device)
    t_verify = rt.buckets[0] - max(1, rt.buckets[0] // 4)
    rng = np.random.default_rng(0)
    spec = rng.standard_normal((2, t_verify, rt.mel_channels)).astype(np.float32)
    lengths = np.array([t_verify, t_verify - 3], np.int32)
    indices = rt.encode(spec, lengths)
    if indices.shape != (2, t_verify):
        raise RuntimeError(f"export verification: tokens {indices.shape}")
    if indices.min() < 0 or indices.max() >= rt.codebook_size:
        raise RuntimeError("export verification: tokens out of range")
    recon = rt.decode(indices, lengths)
    if recon.shape != spec.shape or not np.isfinite(recon).all():
        raise RuntimeError(f"export verification: decode {recon.shape}, "
                           f"finite {bool(np.isfinite(recon).all())}")
    print(f"export verification OK (roundtrip at T={t_verify})")


def main(argv=None) -> str:
    p = argparse.ArgumentParser(
        description="Export a PreEncoder as a deployable codec artifact.")
    cfg_src = p.add_mutually_exclusive_group(required=True)
    cfg_src.add_argument("--config", help="model config (.yaml or .json)")
    cfg_src.add_argument("--manifest",
                         help="an earlier export's manifest.json (or its "
                              "directory): export its generator config")
    weights = p.add_mutually_exclusive_group(required=True)
    weights.add_argument("--checkpoint",
                         help="a reference or port .pth/.pt, or an .npz JAX "
                              "tree (orbax dirs: tools/jax_generator_to_npz.py)")
    weights.add_argument("--seed", type=int, help="export seeded weights")
    p.add_argument("--output", required=True)
    p.add_argument("--buckets", type=int, nargs="+",
                   default=list(DEFAULT_EXPORT_BUCKETS))
    p.add_argument("--bf16", action="store_true", help="bf16 compute dtype")
    p.add_argument("--poly_mixers", nargs="?", const="both",
                   choices=["both", "decode", "encode"], default=None,
                   help="serve mel-mixer MLPs as Chebyshev interpolants (the "
                        "mel_mixer_poly kernel). 'decode' (the default) only "
                        "the post mixer: tokens stay those of the exact path. "
                        "'both'/'encode' also the pre mixer, which can flip "
                        "an FSQ code on a rounding midpoint")
    p.add_argument("--exact_mixers", action="store_true",
                   help="serve the exact mixer MLPs (no Chebyshev mode)")
    p.add_argument("--int8_refiner", action="store_true",
                   help="EXPERIMENTAL: serve the refiner's wide convs on the "
                        "int8 path (the int8_conv kernel): per-output-channel "
                        "weight scales, a per-tensor dynamic activation scale, "
                        "int32 accumulation, a few percent of output range of "
                        "deviation from the float refiner")
    p.add_argument("--device", default="cuda",
                   help="where the export runs and is verified (cuda or cpu; "
                        "cuda adds the card's programs to the CPU's)")
    args = p.parse_args(argv)
    if args.exact_mixers and args.poly_mixers:
        p.error("--exact_mixers contradicts an explicit --poly_mixers")

    cfg = (load_model_config(args.config) if args.config
           else manifest_config(read_manifest(args.manifest)))
    poly = False if args.exact_mixers else (args.poly_mixers or "decode")
    model = PreEncoder.from_config(
        cfg.model.mel_channels, cfg.model.generator,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        poly_mixers=True if poly == "both" else poly,
        int8_refiner=args.int8_refiner)
    if args.checkpoint:
        from mqgan_tpu_torch.utils.checkpoint import load_pretrained_generator

        model.load_state_dict(load_pretrained_generator(args.checkpoint, cfg.model))
    else:
        from mqgan_tpu_torch.utils.init import seeded_init_

        seeded_init_(model, args.seed)
    export_preencoder(model, cfg.model.generator, args.output,
                      buckets=args.buckets, device=args.device)
    print(f"exported to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
