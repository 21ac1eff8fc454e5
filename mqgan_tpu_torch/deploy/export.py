"""Codec export — the artifact a deployment loads (counterpart of
``mqgan_tpu/deploy/export.py``).

The artifact is a directory of two files:

* ``manifest.json``: the JAX manifest's fields (``mel_channels``,
  ``fsq_levels``, ``codebook_size``, ``bos_token_id``/``eos_token_id``,
  ``buckets``, ``poly_mixers``, ``int8_refiner``, ``halos``,
  ``decoder_halos``, ``encoder_halo``, ``halo_align``) plus the generator
  config (``generator``) and the compute dtype (``dtype``);
* ``weights.pt``: the generator's plain tensor ``state_dict`` (fp32), read
  back with ``torch.load(..., weights_only=True)``.

Why not a traced program, as the JAX package serializes StableHLO per
bucket: the port's kernels launch through ctypes (``ops/_cuda.py``), which
neither TorchScript nor ``torch.export`` can trace. The artifact does what
the per-bucket programs do all the same: ``deploy/runtime.py``
``ExportedPreEncoder`` rebuilds the model from the manifest, serves the
fixed buckets (pad up, trim back) and exposes the manifest's properties.
``verify_export`` reloads it through that runtime and round-trips at a
length that is no bucket. Registering the kernels as ``torch.library`` ops
and capturing a CUDA graph per bucket at load are open (ROADMAP.md Queue 1
item 4b).

CLI:  python -m mqgan_tpu_torch.deploy.export (--config model.yaml |
      --manifest OLD/manifest.json) (--checkpoint CKPT | --seed N)
      --output DIR [--buckets 128 256 512 1024] [--bf16]
      [--poly_mixers [decode|encode|both] | --exact_mixers] [--device cuda]

``--config`` takes YAML (PyYAML) or ``.json``; ``--manifest`` takes the
generator config of an earlier export. ``--checkpoint`` is any source of
``utils/checkpoint.py`` (a reference or port ``.pth``/``.pt``, an ``.npz``
JAX tree); ``--seed`` exports seeded weights. With no mixer flag the CLI
exports ``poly_mixers="decode"`` (tokens those of the exact path);
``export_preencoder`` itself exports the model as it is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Sequence

import numpy as np
import torch

from mqgan_tpu_torch.core.chunking import (decoder_halos, encoder_halo,
                                           generator_halos, halo_align)
from mqgan_tpu_torch.core.config import GeneratorConfig, load_model_config
from mqgan_tpu_torch.deploy.runtime import (MANIFEST_NAME, WEIGHTS_NAME,
                                            ExportedPreEncoder, manifest_config,
                                            read_manifest)
from mqgan_tpu_torch.models.preencoder import PreEncoder

DEFAULT_EXPORT_BUCKETS = (128, 256, 512, 1024)


def export_preencoder(model: PreEncoder, cfg: GeneratorConfig, out_dir: str, *,
                      buckets: Sequence[int] = DEFAULT_EXPORT_BUCKETS,
                      verify: bool = True, device=None) -> str:
    """Write ``model`` (built from ``cfg``; its dtype and mixer mode are
    recorded) as an artifact in ``out_dir``; with ``verify``, reload and
    round-trip it on ``device`` (None: CUDA)."""
    os.makedirs(out_dir, exist_ok=True)
    ks, depth = tuple(cfg.kernel_sizes), cfg.refiner_depth
    manifest = {
        "mel_channels": model.mel_channels,
        "fsq_levels": list(model.fsq_levels),
        "codebook_size": model.codebook_size,
        "bos_token_id": model.bos_token_id,
        "eos_token_id": model.eos_token_id,
        "buckets": sorted(int(t) for t in buckets),
        "int8_refiner": bool(model.int8_refiner),
        # False | True (both mixers) | "decode" | "encode"
        "poly_mixers": (model.poly_mixers if isinstance(model.poly_mixers, str)
                        else bool(model.poly_mixers)),
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
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    if verify:
        verify_export(out_dir, device=device)
    return out_dir


def verify_export(out_dir: str, device=None) -> None:
    """Reload through the runtime and round-trip at a length that is NOT
    one of the exported buckets; raises on any failure."""
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
    p.add_argument("--device", default="cuda",
                   help="where the export is verified (cuda or cpu)")
    args = p.parse_args(argv)
    if args.exact_mixers and args.poly_mixers:
        p.error("--exact_mixers contradicts an explicit --poly_mixers")

    cfg = (load_model_config(args.config) if args.config
           else manifest_config(read_manifest(args.manifest)))
    poly = False if args.exact_mixers else (args.poly_mixers or "decode")
    model = PreEncoder.from_config(
        cfg.model.mel_channels, cfg.model.generator,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        poly_mixers=True if poly == "both" else poly)
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
