"""JAX parameter tree -> the port's ``state_dict``.

The input is a nested dict of numpy arrays as ``PreEncoder.init(...)["params"]``
gives it (or the subtree of one of its modules: a block, a mixer, the
refiner), or as ``ISTFTNetGenerator.init(...)["params"]`` gives it (whose
names the port's vocoder mirrors as they are), or as the token LMs'
``MusicTransformer.init`` / ``MusicLSTM.init`` give it, or a discriminator's
``init(...)["params"]`` together with its ``["batch_stats"]`` (the spectral
norms' ``u`` and ``sigma``, which become the port's buffers). Key paths map
one to one onto the port's module names:

  encoder_blocks_i / decoder_blocks_i -> encoder_blocks.i / decoder_blocks.i
  down{i} / up{i} (refiner)           -> downs.i / ups.i
  block_{i} (transformer)             -> blocks.i
  convs_{i}, discriminators_{i}       -> convs.i, discriminators.i
  SpectralNorm_i / convs_i/kernel/u   -> convs.i.u (and sigma)
  APTx_0 (a block's activation)       -> act
  kernel, embedding (Embed),
  scale (LayerNorm)                   -> weight;  v, g, bias, beta, gamma as is
  lstm_{i}/ii ... ho (LSTM gates)     as they are named

and layouts convert from JAX's to PyTorch's:

  Dense kernel (I, O)              -> Linear weight (O, I)
  Conv1d kernel / v (K, I, O)      -> (O, I, K)
  Conv2d kernel / v (H, W, I, O)   -> (O, I, H, W); the image (B, T, F, C)
                                      is (B, C, T, F) in the port, so H = T

The conversion is strict: a key of the module missing from the tree, a
leaf of the tree the module has no place for, or a wrong shape raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_RENAMES = (
    (re.compile(r"^(encoder_blocks|decoder_blocks)_(\d+)$"), r"\1.\2"),
    (re.compile(r"^down(\d+)$"), r"downs.\1"),
    (re.compile(r"^up(\d+)$"), r"ups.\1"),
    (re.compile(r"^APTx_0$"), "act"),
    (re.compile(r"^block_(\d+)$"), r"blocks.\1"),
    (re.compile(r"^(convs|discriminators)_(\d+)$"), r"\1.\2"),
)
_WEIGHT_LEAVES = ("kernel", "embedding", "scale")
_LAYOUTS = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def _rename(part: str) -> str:
    for pattern, repl in _RENAMES:
        if pattern.match(part):
            return pattern.sub(repl, part)
    return part


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def unflatten_tree(flat) -> dict:
    """A flattened tree (``/``-joined keys, as an ``.npz`` of JAX params
    holds it) -> the nested tree ``state_dict_from_jax`` takes."""
    tree: dict = {}
    for key in flat:
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(flat[key])
    return tree


def _spectral_stats(batch_stats: dict):
    """flax SpectralNorm stats -> (path, leaf): ``.../SpectralNorm_i/
    convs_i/kernel/u`` becomes ``.../convs_i/u``."""
    for path, leaf in _flatten(batch_stats):
        *parents, _module, name = path
        conv, _kernel, stat = name.split("/")
        yield tuple(parents) + (conv, stat), leaf


def state_dict_from_jax(params: dict, module: nn.Module,
                        batch_stats: dict | None = None) -> dict:
    """Convert ``params`` (and a discriminator's ``batch_stats``) for
    ``module`` (whose names mirror the JAX tree); returns a state_dict for
    ``module.load_state_dict``."""
    expected = module.state_dict()
    out = {}
    leaves = list(_flatten(params))
    if batch_stats is not None:
        leaves += list(_spectral_stats(batch_stats))
    for path, leaf in leaves:
        arr = np.asarray(leaf, dtype=np.float32)
        name = path[-1]
        if name in ("kernel", "v") and arr.ndim in _LAYOUTS:
            arr = arr.transpose(_LAYOUTS[arr.ndim])
        leaf_name = "weight" if name in _WEIGHT_LEAVES else name
        key = ".".join([_rename(p) for p in path[:-1]] + [leaf_name])
        if key not in expected:
            raise KeyError(f"JAX param {'/'.join(path)} -> {key}: the module "
                           f"has no such parameter")
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: shape {arr.shape} from the JAX tree, "
                             f"{tuple(expected[key].shape)} in the module")
        out[key] = torch.tensor(arr)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"JAX tree lacks parameters for {missing}")
    return out
