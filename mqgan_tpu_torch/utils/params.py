"""JAX parameter tree -> the port's ``state_dict``.

The input is a nested dict of numpy arrays as ``PreEncoder.init(...)["params"]``
gives it (or the subtree of one of its modules: a block, a mixer, the
refiner), or as ``ISTFTNetGenerator.init(...)["params"]`` gives it (whose
names the port's vocoder mirrors as they are). Key paths map one to one onto
the port's module names:

  encoder_blocks_i / decoder_blocks_i -> encoder_blocks.i / decoder_blocks.i
  down{i} / up{i} (refiner)           -> downs.i / ups.i
  APTx_0 (a block's activation)       -> act
  kernel                              -> weight;  v, g, bias, beta, gamma as is

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
)
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


def state_dict_from_jax(params: dict, module: nn.Module) -> dict:
    """Convert ``params`` for ``module`` (whose names mirror the JAX tree);
    returns a state_dict for ``module.load_state_dict``."""
    expected = module.state_dict()
    out = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        name = path[-1]
        if name in ("kernel", "v") and arr.ndim in _LAYOUTS:
            arr = arr.transpose(_LAYOUTS[arr.ndim])
        leaf_name = "weight" if name == "kernel" else name
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
