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

The GAN trainer's checkpoints are the port's own (``torch.save``):
``save_checkpoint`` / ``latest_checkpoint`` / ``restore_checkpoint`` of the
whole train state, and ``save_generator_only``, which writes the generator
in the ``.pt`` format the readers above take. ``save_checkpoint`` with a
``CheckpointWriter`` writes in the background (the trainer's
``--async_checkpoint``, JAX's orbax async save): a host copy of the state is
taken before it returns, and one writer thread writes that copy.
"""

from __future__ import annotations

import json
import os
import re
import threading

import numpy as np
import torch

from mqgan_tpu_torch.core.config import ModelConfig
from mqgan_tpu_torch.models.discriminators import (
    MelSpectrogramPatchDiscriminator2D, MultiBinDiscriminator)
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.parallel.dp import barrier, world
from mqgan_tpu_torch.utils.params import state_dict_from_jax, unflatten_tree
from mqgan_tpu_torch.utils.torch_import import (
    import_generator_params, import_multibin_discriminator_params,
    import_patch_discriminator_params, strip_module_prefix)

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


# --- the trainer's checkpoints (the port's own format, torch.save) ---------

CKPT_RE = re.compile(r"checkpoint_epoch_(\d+)\.pt$")


def _atomic_save(obj, path: str) -> None:
    """torch.save to a temporary file, fsync, then rename over ``path``: a
    reader never sees a half-written checkpoint, also when the writer is
    killed."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class CheckpointWriter:
    """The background writer of ``save_checkpoint``: one thread at a time
    writes a save's host copy while the caller goes on. A new save waits
    for the previous one; ``wait`` drains the writer. A write that failed
    raises in the caller, at the next save or at ``wait``."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def submit(self, write, *args) -> None:
        """Run ``write(*args)`` on the writer thread, after the previous
        write has finished."""
        self.wait()

        def run():
            try:
                write(*args)
            except Exception as e:  # noqa: BLE001 - raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, name="checkpoint-writer")
        self._thread.start()

    def wait(self) -> None:
        """Block until the pending write (if any) is on disk; raise if it
        failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("a background checkpoint write failed") from err


def _host_copy(obj):
    """``obj`` with every tensor copied to the host (containers rebuilt, a
    state_dict's ``_metadata`` kept): what the loop may change in place
    afterwards is not in it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        out = type(obj)((k, _host_copy(v)) for k, v in obj.items())
        if hasattr(obj, "_metadata"):
            out._metadata = dict(obj._metadata)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _write_checkpoint(output_dir: str, path: str, epoch: int, state_dict: dict,
                      config_dict: dict | None) -> None:
    os.makedirs(output_dir, exist_ok=True)
    _atomic_save({"epoch": epoch, "state": state_dict}, path)
    if config_dict is not None:
        with open(os.path.join(output_dir, "config.json"), "w") as f:
            json.dump({"epoch": epoch, "config": config_dict}, f, indent=2,
                      default=str)


def save_checkpoint(output_dir: str, state, epoch: int,
                    config_dict: dict | None = None,
                    writer: CheckpointWriter | None = None) -> str:
    """The whole ``TrainState`` (``state.state_dict()``: models, spectral
    stats, optimizers, LeCam, step, the random generators' states, EMA) as
    ``output_dir/checkpoint_epoch_{epoch:03d}.pt``; the config beside it as
    ``config.json``. With a ``writer`` the file is written in the
    background from a host copy taken here; the caller drains the writer
    before it reads the file or exits. In a data-parallel group (one shared
    ``output_dir``) rank 0 writes and every rank waits for it (for its
    copy, with a writer) at a barrier; every rank restores the same file."""
    path = os.path.abspath(os.path.join(output_dir,
                                        f"checkpoint_epoch_{epoch:03d}.pt"))
    rank, _ = world()
    if rank == 0:
        if writer is None:
            _write_checkpoint(output_dir, path, epoch, state.state_dict(),
                              config_dict)
        else:
            writer.submit(_write_checkpoint, output_dir, path, epoch,
                          _host_copy(state.state_dict()), config_dict)
    barrier(state.lecam.ema_real.device)
    return path


def latest_checkpoint(output_dir: str) -> tuple[str, int] | None:
    """(path, epoch) of the newest checkpoint by epoch number, or None."""
    if not os.path.isdir(output_dir):
        return None
    best = None
    for name in os.listdir(output_dir):
        m = CKPT_RE.match(name)
        if m and (best is None or int(m.group(1)) > best[1]):
            best = (os.path.abspath(os.path.join(output_dir, name)),
                    int(m.group(1)))
    return best


def restore_checkpoint(path: str, state) -> int:
    """Load a checkpoint of ``save_checkpoint`` into ``state`` in place;
    returns its epoch."""
    # on the CPU: the random generators' states must be CPU byte tensors;
    # load_state_dict copies everything else onto the state's device
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.load_state_dict(ckpt["state"])
    return int(ckpt["epoch"])


def save_generator_only(output_dir: str, gen_state_dict: dict,
                        name: str = "generator") -> str:
    """The generator's ``state_dict`` (fp32, CPU) as ``output_dir/name.pt``:
    the port's own format, which ``load_pretrained_generator``, the
    ``--pretrained`` warm start and ``deploy/export.py --checkpoint`` read."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(output_dir, f"{name}.pt"))
    _atomic_save({k: v.detach().float().cpu() for k, v in gen_state_dict.items()},
                 path)
    return path


def load_pretrained_discriminators(path: str, cfg: ModelConfig):
    """The discriminators' state_dicts from a reference ``.pth`` that holds
    them, under ``discriminator_patch_state_dict`` and
    ``discriminator_multibin_state_dict`` (named after the config's
    sections; spectral-norm convs with ``weight_orig``), or None when the
    file holds none. Imported through ``utils/torch_import.py``."""
    if not path.endswith((".pth", ".pt")):
        return None
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    keys = ("discriminator_patch_state_dict", "discriminator_multibin_state_dict")
    if not all(k in ckpt for k in keys):
        return None
    patch = MelSpectrogramPatchDiscriminator2D.from_config(
        cfg.mel_channels, cfg.discriminator_patch)
    mb = MultiBinDiscriminator.from_config(cfg.mel_channels,
                                           cfg.discriminator_multibin)
    p_params, p_stats = import_patch_discriminator_params(ckpt[keys[0]])
    m_params, m_stats = import_multibin_discriminator_params(
        ckpt[keys[1]], cfg.discriminator_multibin.n_bins)
    return (state_dict_from_jax(p_params, patch, p_stats),
            state_dict_from_jax(m_params, mb, m_stats))
