#!/usr/bin/env python3
"""Convert a JAX package checkpoint into the ``.npz`` the PyTorch port reads.

The port (``mqgan_tpu_torch``) imports no JAX, so it cannot read orbax
directories. This script runs where the JAX package runs, restores the
params with ``mqgan_tpu.utils.checkpoint.load_pretrained_generator`` and
writes them flattened, one array per ``/``-joined key path
(``encoder_blocks_0/conv1/v``), with ``np.savez``:

    python tools/jax_generator_to_npz.py --checkpoint GEN/generator \\
        --config configs/model_config_hifispeech.yaml --output gen.npz

With ``--config`` the orbax tree is restored against the generator's
template; without it, as stored (any param tree, e.g. a token LM's).
The port reads the file with ``mqgan_tpu_torch.utils.checkpoint
.load_pretrained_generator`` (export, re-encode) and ``lstm_trainer
--pretrained``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dict of arrays -> {"a/b/c": np.ndarray}."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if hasattr(value, "items"):
            out.update(flatten_tree(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def restore_params(checkpoint: str, config: str | None):
    import jax
    import jax.numpy as jnp

    from mqgan_tpu.utils.checkpoint import load_pretrained_generator

    if config is None:
        return load_pretrained_generator(checkpoint, (), 0)
    from mqgan_tpu.core.config import TrainConfig
    from mqgan_tpu.models.preencoder import PreEncoder

    cfg = TrainConfig.from_yaml(config)
    gen = PreEncoder.from_config(cfg.model.mel_channels, cfg.model.generator)
    t0 = max(cfg.crop_lens)
    template = jax.eval_shape(
        gen.init, jax.random.key(0),
        jnp.zeros((1, t0, cfg.model.mel_channels), jnp.float32),
        jnp.full((1,), t0, jnp.int32))["params"]
    return load_pretrained_generator(
        checkpoint, cfg.model.generator.channels,
        cfg.model.generator.refiner_depth, template=template)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="orbax params dir (or a reference .pth, with --config)")
    p.add_argument("--config", default=None,
                   help="model config yaml: restore against the generator's "
                        "template")
    p.add_argument("--output", required=True, help="the .npz to write")
    args = p.parse_args(argv)
    flat = flatten_tree(restore_params(args.checkpoint, args.config))
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    np.savez(args.output, **flat)
    print(f"wrote {len(flat)} arrays to {args.output}")
    return args.output


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
