"""PyTorch port: checkpoint import. A synthetic reference-format PreEncoder
state_dict goes through the JAX package's importer and the bridge, and
through the port's own importer; both give the same ``state_dict`` and the
models decode alike. The same for the reference MusicLSTM (and the LM
trainer's ``--pretrained``), and for the ``.npz`` source that
``tools/jax_generator_to_npz.py`` writes from an orbax checkpoint."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mqgan_tpu.models.music_lstm import MusicLSTM as JaxMusicLSTM
from mqgan_tpu.models.preencoder import PreEncoder as JaxPreEncoder
from mqgan_tpu.utils import torch_import as jax_import
from mqgan_tpu.utils.checkpoint import save_generator_only
from mqgan_tpu_torch.core.config import TrainConfig
from mqgan_tpu_torch.models.music_lstm import MusicLSTM
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.train import lstm_trainer
from mqgan_tpu_torch.utils import torch_import as port_import
from mqgan_tpu_torch.utils.checkpoint import (load_pretrained_generator,
                                              pretrained_generator)
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import MELS, NARROW, narrow_jax_params
from tools import jax_generator_to_npz

DECODE_TOL = 2e-4
CFG = TrainConfig.from_dict({"model": {"mel_channels": MELS, "generator": NARROW},
                             "data": {"crop_len": 16}})
_RENAME = {"APTx_0": "relu", "mlp_0": "mlp.0", "mlp_2": "mlp.2"}


def _ref_key(path):
    """JAX tree path -> the reference module prefix."""
    parts = []
    for p in path:
        if p.startswith(("encoder_blocks_", "decoder_blocks_")):
            parts.append(p.replace("_blocks_", "_blocks."))
        elif path[0] == "refiner" and p[:-1] in ("down", "up"):
            parts.append(f"{p[:-1]}s.{p[-1]}.conv")
        else:
            parts.append(_RENAME.get(p, p))
    return ".".join(parts)


def _torch_weight(path, arr):
    """A JAX kernel / v back to the reference's torch layout."""
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 3:
        return arr.transpose(2, 1, 0)
    if path[0] in ("pre", "post"):  # mixer convs: JAX (T, C) = torch (C, T)
        return arr.transpose(3, 2, 1, 0)
    return arr.transpose(3, 2, 0, 1)


def reference_state_dict(tree, path=()):
    """The reference PreEncoder's state_dict holding ``tree``'s weights:
    old-style weight norm (weight_g / weight_v) on the causal decoder
    blocks, the parametrization style elsewhere, 'module.' prefixed."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if "v" in v:  # a weight-normed conv
                p, o = "module." + _ref_key(path + (k,)), v["v"].shape[-1]
                w = np.ascontiguousarray(_torch_weight(path + (k,), v["v"]))
                g = v["g"].reshape((o,) + (1,) * (w.ndim - 1))
                if path and path[0].startswith("decoder_blocks"):
                    out[f"{p}.weight_g"], out[f"{p}.weight_v"] = g, w
                else:
                    out[f"{p}.parametrizations.weight.original0"] = g
                    out[f"{p}.parametrizations.weight.original1"] = w
                if "bias" in v:
                    out[f"{p}.bias"] = v["bias"]
            else:
                out.update(reference_state_dict(v, path + (k,)))
        else:
            p = "module." + _ref_key(path)
            leaf = "weight" if k == "kernel" else k
            arr = np.ascontiguousarray(_torch_weight(path, v)) if k == "kernel" else v
            out[f"{p}.{leaf}"] = arr
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def _assert_same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def _jax_decode(gen, tree, tokens):
    return np.asarray(jax.jit(functools.partial(
        gen.apply, method=JaxPreEncoder.decode))({"params": tree}, jnp.asarray(tokens)))


def test_generator_import_matches_jax(tmp_path):
    gen, tree = narrow_jax_params()
    sd = reference_state_dict(tree)
    jax_tree = jax_import.import_generator_params(sd, NARROW["channels"],
                                                  NARROW["refiner_depth"])
    port_tree = port_import.import_generator_params(sd, NARROW["channels"],
                                                    NARROW["refiner_depth"])
    port_import.validate_against_template(port_tree, tree)
    model = PreEncoder(MELS, **NARROW)
    want = state_dict_from_jax(jax_tree, model)
    _assert_same_state(state_dict_from_jax(port_tree, model), want)
    # the same through the checkpoint file, with its model_state_dict
    path = str(tmp_path / "ref.pth")
    torch.save({"model_state_dict": sd, "epoch": 3}, path)
    _assert_same_state(load_pretrained_generator(path, CFG.model), want)
    # and both models decode alike
    tokens = np.random.default_rng(0).integers(0, 1000, (2, 40)).astype(np.int32)
    out = pretrained_generator(path, CFG.model).decode(torch.from_numpy(tokens))
    np.testing.assert_allclose(out.numpy(), _jax_decode(gen, jax_tree, tokens),
                               atol=DECODE_TOL, rtol=DECODE_TOL)


def test_port_state_dict_source_and_errors(tmp_path):
    _, tree = narrow_jax_params()
    model = PreEncoder(MELS, **NARROW)
    sd = state_dict_from_jax(tree, model)
    path = str(tmp_path / "port.pt")
    torch.save(sd, path)
    _assert_same_state(load_pretrained_generator(path, CFG.model), sd)
    torch.save({k: v for k, v in sd.items() if k != "proj.bias"}, path)
    with pytest.raises(KeyError):  # neither the port's keys nor the reference's
        load_pretrained_generator(path, CFG.model)
    with pytest.raises(ValueError, match="jax_generator_to_npz"):
        load_pretrained_generator(str(tmp_path), CFG.model)
    with pytest.raises(ValueError, match="expected a .pth/.pt"):
        load_pretrained_generator(str(tmp_path / "x.ckpt"), CFG.model)


def test_npz_from_orbax_through_the_converter(tmp_path):
    gen, tree = narrow_jax_params()
    orbax_dir = save_generator_only(str(tmp_path / "gen"),
                                    jax.tree.map(jnp.asarray, tree))
    cfg_path = str(tmp_path / "model.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({"model": {"mel_channels": MELS, "generator": {
            k: list(v) if isinstance(v, tuple) else v for k, v in NARROW.items()}},
            "data": {"crop_len": 16}}, f)
    npz = jax_generator_to_npz.main(["--checkpoint", orbax_dir, "--config", cfg_path,
                                     "--output", str(tmp_path / "gen.npz")])
    want = state_dict_from_jax(tree, PreEncoder(MELS, **NARROW))
    _assert_same_state(load_pretrained_generator(npz, CFG.model), want)
    # untemplated: the tree as stored
    raw = jax_generator_to_npz.main(["--checkpoint", orbax_dir,
                                     "--output", str(tmp_path / "raw.npz")])
    _assert_same_state(load_pretrained_generator(raw, CFG.model), want)
    assert TrainConfig.from_yaml(cfg_path) == CFG


LSTM = dict(vocab_size=40, num_genres=3, emb_dim=16, lstm_hid=24, lstm_layers=2)


def _reference_lstm_state_dict(rng):
    h, e = LSTM["lstm_hid"], LSTM["emb_dim"]
    sd = {"tok_emb.weight": (LSTM["vocab_size"], e),
          "genre_emb.weight": (LSTM["num_genres"], e),
          "proj.weight": (LSTM["vocab_size"], h), "proj.bias": (LSTM["vocab_size"],)}
    for k in range(LSTM["lstm_layers"]):
        sd.update({f"lstm.weight_ih_l{k}": (4 * h, e if k == 0 else h),
                   f"lstm.weight_hh_l{k}": (4 * h, h),
                   f"lstm.bias_ih_l{k}": (4 * h,), f"lstm.bias_hh_l{k}": (4 * h,)})
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.3)
            for k, s in sd.items()}


def test_music_lstm_import_matches_jax(tmp_path, rng):
    sd = _reference_lstm_state_dict(rng)
    jax_tree = jax_import.import_music_lstm_params(sd, LSTM["lstm_layers"])
    port_tree = port_import.import_music_lstm_params(sd, LSTM["lstm_layers"])
    model = MusicLSTM(**LSTM)
    want = state_dict_from_jax(jax_tree, model)
    _assert_same_state(state_dict_from_jax(port_tree, model), want)
    # the trainer's --pretrained: the reference .pth, and an .npz JAX tree
    path = str(tmp_path / "lstm.pth")
    torch.save({"model_state_dict": sd}, path)
    lstm_trainer.load_pretrained(model, path)
    _assert_same_state(model.state_dict(), want)
    npz = str(tmp_path / "lstm.npz")
    np.savez(npz, **jax_generator_to_npz.flatten_tree(jax_tree))
    other = MusicLSTM(**LSTM)
    lstm_trainer.load_pretrained(other, npz)
    _assert_same_state(other.state_dict(), want)
    # the port's LSTM gives the JAX LSTM's logits on the imported weights
    tokens = rng.integers(0, LSTM["vocab_size"], (2, 12))
    genres = np.array([0, 2])
    jmodel = JaxMusicLSTM(**LSTM)
    want_logits = np.asarray(jmodel.apply({"params": jax.tree.map(jnp.asarray, jax_tree)},
                                          jnp.asarray(tokens), jnp.asarray(genres)))
    got = model(torch.from_numpy(tokens), torch.from_numpy(genres)).detach().numpy()
    np.testing.assert_allclose(got, want_logits, atol=1e-4, rtol=1e-4)
    with pytest.raises(SystemExit, match="jax_generator_to_npz"):
        lstm_trainer.load_pretrained(model, str(tmp_path))
