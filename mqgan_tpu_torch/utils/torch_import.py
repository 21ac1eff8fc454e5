"""Reference PyTorch checkpoint import (a copy of
``mqgan_tpu/utils/torch_import.py``, numpy only): a reference PreEncoder or
MusicLSTM state_dict -> the JAX package's param tree, which the port loads
through ``utils/params.py`` ``state_dict_from_jax`` (strict: every key and
shape).

Handles both torch weight-norm flavors found in the reference:
  * old-style  nn.utils.weight_norm        -> {prefix}.weight_g / weight_v
  * new-style  parametrizations.weight_norm -> {prefix}.parametrizations.
    weight.original0 (g) / original1 (v)

Layout conversions (into the JAX tree's layouts):
  Conv1d  (O, I, K)      -> (K, I, O)
  Conv2d  (O, I, kH, kW) -> (kH, kW, I, O)      [same H/W orientation]
  Conv2d  (O, I, kC, kT) -> (kT, kC, I, O)      [mel-mixer: H=T, W=C]
  Linear  (O, I)         -> (I, O)
  weight-norm g (O, 1..) -> (O,)

The discriminator importers return (params, batch_stats) trees, which the
bridge loads with ``state_dict_from_jax(params, module, batch_stats)``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def strip_module_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """DataParallel 'module.' cleanup."""
    return {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}


def to_numpy_state_dict(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):  # a torch tensor (numpy has no bfloat16)
            v = v.detach().cpu()
            v = (v.float() if v.is_floating_point() else v).numpy()
        out[k] = np.asarray(v)
    return out


def _conv_kernel(w: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv1d":
        return np.transpose(w, (2, 1, 0))
    if kind == "conv2d":
        return np.transpose(w, (2, 3, 1, 0))
    if kind == "conv2d_swap":
        return np.transpose(w, (3, 2, 1, 0))
    raise ValueError(kind)


def _wn_conv(sd: Mapping[str, np.ndarray], p: str, kind: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if f"{p}.weight_g" in sd:  # old-style weight norm
        out["g"] = sd[f"{p}.weight_g"].reshape(-1)
        out["v"] = _conv_kernel(sd[f"{p}.weight_v"], kind)
    elif f"{p}.parametrizations.weight.original0" in sd:  # new-style
        out["g"] = sd[f"{p}.parametrizations.weight.original0"].reshape(-1)
        out["v"] = _conv_kernel(sd[f"{p}.parametrizations.weight.original1"], kind)
    elif f"{p}.weight" in sd:  # plain conv (or weight-norm already stripped)
        out["kernel"] = _conv_kernel(sd[f"{p}.weight"], kind)
    else:
        raise KeyError(f"no conv weight found under '{p}'")
    if f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def _linear(sd: Mapping[str, np.ndarray], p: str) -> Dict[str, np.ndarray]:
    out = {"kernel": np.ascontiguousarray(sd[f"{p}.weight"].T)}
    if f"{p}.bias" in sd:
        out["bias"] = sd[f"{p}.bias"]
    return out


def _aptx(sd, p) -> Dict[str, np.ndarray]:
    return {"beta": sd[f"{p}.beta"], "gamma": sd[f"{p}.gamma"]}


def _resblock(sd, p: str, causal: bool, channels_change: bool) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "conv1": _wn_conv(sd, f"{p}.conv1", "conv1d"),
        "conv2": _wn_conv(sd, f"{p}.conv2", "conv1d"),
    }
    if f"{p}.relu.beta" in sd:  # trainable APTx ("taptx")
        d["APTx_0"] = _aptx(sd, f"{p}.relu")
    if not causal:
        d["cbam"] = {
            "channel_attention": {
                "mlp_0": _linear(sd, f"{p}.cbam.channel_attention.mlp.0"),
                "mlp_2": _linear(sd, f"{p}.cbam.channel_attention.mlp.2"),
            },
            "spatial_attention": {
                "conv": _wn_conv(sd, f"{p}.cbam.spatial_attention.conv", "conv1d"),
            },
        }
    if channels_change:
        d["residual"] = _wn_conv(sd, f"{p}.residual", "conv1d")
    return d


def _mixer(sd, p: str) -> Dict[str, Any]:
    return {
        "dw": _wn_conv(sd, f"{p}.dw", "conv2d_swap"),
        "pw": _wn_conv(sd, f"{p}.pw", "conv2d_swap"),
        "conv_out": _wn_conv(sd, f"{p}.conv_out", "conv2d_swap"),
    }


def _unet_convblock(sd, p: str) -> Dict[str, Any]:
    return {
        "conv1": _wn_conv(sd, f"{p}.conv1", "conv2d"),
        "conv2": _wn_conv(sd, f"{p}.conv2", "conv2d"),
    }


def _unet(sd, p: str, depth: int) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "pre": _unet_convblock(sd, f"{p}.pre"),
        "mid": _unet_convblock(sd, f"{p}.mid"),
        "post": _wn_conv(sd, f"{p}.post", "conv2d"),
        "reproj": {"kernel": np.ascontiguousarray(sd[f"{p}.reproj.weight"].T)},
    }
    for i in range(depth):
        d[f"down{i}"] = _unet_convblock(sd, f"{p}.downs.{i}.conv")
        d[f"up{i}"] = _unet_convblock(sd, f"{p}.ups.{i}.conv")
    return d


def import_generator_params(
    state_dict: Mapping[str, Any],
    channels,
    refiner_depth: int = 3,
) -> Dict[str, Any]:
    """Reference PreEncoder state_dict -> the JAX package's params['params']
    tree (nested dicts of numpy arrays)."""
    sd = to_numpy_state_dict(strip_module_prefix(state_dict))
    channels = list(channels)

    params: Dict[str, Any] = {
        "proj": _linear(sd, "proj"),
        "pre": _mixer(sd, "pre"),
        "post": _mixer(sd, "post"),
        "q_in_proj": _linear(sd, "q_in_proj"),
        "q_out_proj": _linear(sd, "q_out_proj"),
        "out_proj": _linear(sd, "out_proj"),
        "hidden_proj": _linear(sd, "hidden_proj"),
        "refiner": _unet(sd, "refiner", refiner_depth),
    }
    for i in range(len(channels) - 1):
        params[f"encoder_blocks_{i}"] = _resblock(
            sd, f"encoder_blocks.{i}", causal=False,
            channels_change=channels[i] != channels[i + 1],
        )
    rev = list(reversed(channels))
    for i in range(len(rev) - 1):
        params[f"decoder_blocks_{i}"] = _resblock(
            sd, f"decoder_blocks.{i}", causal=True,
            channels_change=rev[i] != rev[i + 1],
        )
    return params


def validate_against_template(imported: Mapping[str, Any], template: Mapping[str, Any], path=""):
    """Raise if the imported tree is missing keys or has shape mismatches
    relative to a freshly initialized param tree."""
    for k, tv in template.items():
        p = f"{path}/{k}"
        if k not in imported:
            raise KeyError(f"missing imported param {p}")
        iv = imported[k]
        if isinstance(tv, Mapping):
            validate_against_template(iv, tv, p)
        else:
            if tuple(np.shape(iv)) != tuple(np.shape(tv)):
                raise ValueError(
                    f"shape mismatch at {p}: imported {np.shape(iv)} vs template {np.shape(tv)}"
                )


def _sn_conv(sd: Mapping[str, np.ndarray], p: str):
    """torch spectral-norm Conv2d -> (params, sigma, u).

    torch stores weight_orig / weight_u / weight_v and divides by
    u^T W v; flax's SpectralNorm re-runs one power-iteration step from the
    stored u on every call, so u is stored as the EXACT top singular
    vector (SVD, in flax's (kh * kw * in, out) matricization), the fixed
    point of that step: the imported sigma is the true sigma_max, which a
    trained torch checkpoint's converged u and v also give."""
    kernel = _conv_kernel(sd[f"{p}.weight_orig"], "conv2d")
    mat = kernel.reshape(-1, kernel.shape[-1])
    _, s, qt = np.linalg.svd(mat, full_matrices=False)
    return {"kernel": kernel, "bias": sd[f"{p}.bias"]}, float(s[0]), qt[0]


def _se(sd, p: str) -> Dict[str, Any]:
    return {"fc1": _linear(sd, f"{p}.fc1"), "fc2": _linear(sd, f"{p}.fc2")}


def import_patch_discriminator_params(state_dict: Mapping[str, Any],
                                      prefix: str = ""):
    """Reference MelSpectrogramPatchDiscriminator2D state_dict ->
    (params, batch_stats) trees of the JAX package's layout."""
    sd = to_numpy_state_dict(strip_module_prefix(state_dict))
    pfx = f"{prefix}." if prefix else ""
    params: Dict[str, Any] = {"se_block": _se(sd, f"{pfx}se_block")}
    stats: Dict[str, Any] = {}
    i = 0
    while f"{pfx}convs.{i}.weight_orig" in sd:
        p, sigma, u = _sn_conv(sd, f"{pfx}convs.{i}")
        params[f"convs_{i}"] = p
        stats[f"SpectralNorm_{i}"] = {
            f"convs_{i}/kernel/sigma": np.asarray(sigma, np.float32),
            f"convs_{i}/kernel/u": u[None, :].astype(np.float32),
        }
        i += 1
    if i == 0:
        raise KeyError(f"no spectral-norm convs under '{pfx}convs'")
    return params, stats


def import_multibin_discriminator_params(state_dict: Mapping[str, Any],
                                         n_bins: int):
    """Reference MultiBinDiscriminator state_dict -> (params, batch_stats):
    one patch discriminator per mel band."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(n_bins):
        p, s = import_patch_discriminator_params(
            state_dict, prefix=f"discriminators.{i}")
        params[f"discriminators_{i}"] = p
        stats[f"discriminators_{i}"] = s
    return params, stats


def import_music_lstm_params(state_dict: Mapping[str, Any], lstm_layers: int = 2) -> Dict[str, Any]:
    """Reference MusicLSTM state_dict -> the JAX param tree of MusicLSTM
    (whose names the port's ``models/music_lstm.py`` mirrors).

    torch LSTM gate blocks are ordered [i, f, g, o] in weight_ih_l{k}
    (4H, in) / weight_hh_l{k} (4H, H); the tree keeps one Dense per gate
    with the bias on the hidden dense — torch's two biases sum into it
    (identical cell equations).
    """
    sd = to_numpy_state_dict(strip_module_prefix(state_dict))
    params: Dict[str, Any] = {
        "tok_emb": {"embedding": sd["tok_emb.weight"]},
        "genre_emb": {"embedding": sd["genre_emb.weight"]},
        "proj": _linear(sd, "proj"),
    }
    gates = ("i", "f", "g", "o")
    for k in range(lstm_layers):
        w_ih = sd[f"lstm.weight_ih_l{k}"]  # (4H, in)
        w_hh = sd[f"lstm.weight_hh_l{k}"]  # (4H, H)
        b = sd[f"lstm.bias_ih_l{k}"] + sd[f"lstm.bias_hh_l{k}"]  # (4H,)
        h = w_hh.shape[1]
        cell: Dict[str, Any] = {}
        for gi, g in enumerate(gates):
            sl = slice(gi * h, (gi + 1) * h)
            cell[f"i{g}"] = {"kernel": np.ascontiguousarray(w_ih[sl].T)}
            cell[f"h{g}"] = {
                "kernel": np.ascontiguousarray(w_hh[sl].T),
                "bias": b[sl],
            }
        params[f"lstm_{k}"] = cell
    return params
