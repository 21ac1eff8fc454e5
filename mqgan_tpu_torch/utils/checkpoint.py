"""Generator checkpoints for the port (counterpart of
``mqgan_tpu/utils/checkpoint.py`` ``load_pretrained_generator``).

Three sources give the port's ``PreEncoder`` its weights:

* a reference PyTorch ``.pth``/``.pt`` (its ``model_state_dict`` when the
  file holds one): ``utils/torch_import.py`` maps it onto the JAX param
  tree, the bridge ``utils/params.py`` onto the port's names;
* the port's own saved ``state_dict`` (``torch.save(model.state_dict())``,
  an export's ``weights.pt``): loaded as it is;
* an ``.npz`` of a flattened JAX param tree, ``/``-joined keys
  (``encoder_blocks_0/conv1/v``): the bridge again.

Orbax directories need JAX to read, so ``tools/jax_generator_to_npz.py``
(outside both packages) converts one to that ``.npz`` first. Every source
is checked strictly: a missing key, an extra key or a wrong shape raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mqgan_tpu_torch.core.config import ModelConfig
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.utils.params import state_dict_from_jax, unflatten_tree
from mqgan_tpu_torch.utils.torch_import import (import_generator_params,
                                                strip_module_prefix)

CONVERTER = "tools/jax_generator_to_npz.py"


def load_pretrained_generator(path: str, cfg: ModelConfig) -> dict:
    """The state_dict (fp32 CPU tensors) of ``PreEncoder.from_config(
    cfg.mel_channels, cfg.generator)`` from ``path``: a reference or port
    ``.pth``/``.pt`` or a flattened JAX tree ``.npz``."""
    gen = cfg.generator
    template = PreEncoder.from_config(cfg.mel_channels, gen)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint?): the port reads "
            f"no orbax; convert it with {CONVERTER} and pass the .npz")
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as flat:
            return state_dict_from_jax(unflatten_tree(flat), template)
    if not path.endswith((".pth", ".pt")):
        raise ValueError(f"{path}: expected a .pth/.pt state_dict or an .npz "
                         f"JAX tree (orbax dirs: {CONVERTER})")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = strip_module_prefix(sd.get("model_state_dict", sd))
    expected = template.state_dict()
    if set(sd) == set(expected):  # the port's own state_dict
        template.load_state_dict(sd)
        return {k: v.detach().float() for k, v in template.state_dict().items()}
    tree = import_generator_params(sd, gen.channels, gen.refiner_depth)
    return state_dict_from_jax(tree, template)


def pretrained_generator(path: str, cfg: ModelConfig,
                         **model_kw) -> PreEncoder:
    """A CPU ``PreEncoder`` (``model_kw``: dtype, poly_mixers) with the
    weights of ``path``."""
    model = PreEncoder.from_config(cfg.mel_channels, cfg.generator, **model_kw)
    model.load_state_dict(load_pretrained_generator(path, cfg))
    return model.eval()
