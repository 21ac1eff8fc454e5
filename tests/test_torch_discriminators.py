"""The port's discriminators, SE layer and discriminator importers against
the JAX package's, fp32: logits, masks and features within 1e-5 (atol and
rtol); the spectral norms' u and sigma after one ``update_stats`` call
within 1e-6; a call without ``update_stats`` leaves them as they were."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.models import discriminators as jd
from mqgan_tpu.nn.se import ChannelSELayerMasked as JaxSE
from mqgan_tpu.utils import torch_import as jimport
from mqgan_tpu_torch.models import discriminators as td
from mqgan_tpu_torch.nn.se import ChannelSELayerMasked
from mqgan_tpu_torch.utils import torch_import as timport
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_gan_step import (  # noqa: F401 - the fixture
    one_torch_thread, seeded_tree)

TOL = 1e-5
MEL, T = 16, 32
PATCH = dict(hidden_channels=(4, 4, 8), kernel_sizes=(3, 5, 3, 3),
             strides=((1, 2), (2, 2), (2, 2), (1, 1)))
MULTIBIN = dict(n_bins=2, hidden_channels=(4, 4, 6), kernel_sizes=(3, 5, 3, 3),
                n_no_strides=1)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, T, MEL)).astype(np.float32)
    return x, np.array([T, 20, 7], np.int32)


def _models(kind):
    if kind == "patch":
        return (jd.MelSpectrogramPatchDiscriminator2D(mel_channels=MEL, **PATCH),
                td.MelSpectrogramPatchDiscriminator2D(MEL, **PATCH))
    return (jd.MultiBinDiscriminator(mel_channels=MEL, **MULTIBIN),
            td.MultiBinDiscriminator(MEL, **MULTIBIN))


def _loaded(kind, x, lengths, seed=0):
    jm, tm = _models(kind)
    v = seeded_tree(jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x),
                                   jnp.asarray(lengths)), seed)
    tm.load_state_dict(state_dict_from_jax(v["params"], tm, v["batch_stats"]))
    return jm, tm, v


def _per_bin(kind, out):
    """A discriminator's (logits, masks, features) as lists over bins."""
    logits, masks, feats = out
    if kind == "patch":
        return [logits], [masks], [feats]
    return logits, masks, feats


@pytest.mark.parametrize("kind", ["patch", "multibin"])
def test_logits_masks_features_match_jax(kind):
    x, lengths = _inputs()
    jm, tm, v = _loaded(kind, x, lengths)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(lengths), True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(lengths), True)
    for jl, jmask, jf, tl, tmask, tf in zip(*_per_bin(kind, want),
                                            *_per_bin(kind, got)):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        assert len(tf) == len(jf) > 0
        for (a, am), (b, bm) in zip(jf, tf):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL, rtol=TOL)
            np.testing.assert_array_equal(bm.numpy(), np.asarray(am))


@pytest.mark.parametrize("kind", ["patch", "multibin"])
def test_spectral_stats_update_matches_jax(kind):
    x, lengths = _inputs(1)
    jm, tm, v = _loaded(kind, x, lengths, seed=1)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    with torch.no_grad():
        tm(torch.from_numpy(x), torch.from_numpy(lengths))
    for k, t in tm.state_dict().items():
        assert torch.equal(t, before[k]), f"{k} changed without update_stats"
    (out, _), upd = jm.apply(v, jnp.asarray(x), jnp.asarray(lengths), False, True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x), torch.from_numpy(lengths), False, True)
    want = state_dict_from_jax(v["params"], tm, jax.device_get(upd["batch_stats"]))
    n = 0
    for k, t in tm.state_dict().items():
        if k.endswith((".u", ".sigma")):
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), atol=1e-6,
                                       rtol=0, err_msg=k)
            assert not torch.equal(t, before[k]) or k.endswith(".sigma")
            n += 1
    assert n == 2 * len(tm.spectral_convs())
    first = got if kind == "patch" else got[0]
    jfirst = out if kind == "patch" else out[0]
    np.testing.assert_allclose(first.numpy(), np.asarray(jfirst), atol=TOL, rtol=TOL)


def test_update_stats_method_equals_a_forward_that_updates():
    x, lengths = _inputs(2)
    _, a, _ = _loaded("patch", x, lengths, seed=2)
    _, b, _ = _loaded("patch", x, lengths, seed=2)
    with torch.no_grad():
        a(torch.from_numpy(x), torch.from_numpy(lengths), update_stats=True)
    for conv in b.spectral_convs():
        conv.update_stats()
    for k, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[k]), k


def test_spectral_norm_gradient_flows_through_sigma():
    """sigma = v W u^T carries W's gradient (u and v do not)."""
    conv = td.SNConv2d(2, 3, (3, 3), (1, 1), (1, 1))
    torch.manual_seed(0)
    with torch.no_grad():
        conv.weight.normal_()
        conv.u.normal_()
    conv.normalized_weight().sum().backward()
    g_full = conv.weight.grad.clone()
    w = conv.weight.detach()
    mat = w.permute(2, 3, 1, 0).reshape(-1, 3)
    v0 = td._l2_normalize(conv.u @ mat.t())
    u0 = td._l2_normalize(v0 @ mat)
    sigma = (v0 @ mat @ u0.t())[0, 0]
    # d/dW sum(W / sigma) = 1/sigma - sum(W) / sigma^2 * d sigma/dW
    dsigma = (v0.t() @ u0).reshape(3, 3, 2, 3).permute(3, 2, 0, 1)
    want = 1.0 / sigma - w.sum() / sigma ** 2 * dsigma
    np.testing.assert_allclose(g_full.numpy(), want.numpy(), atol=1e-5)


def test_maxpool_ceil_matches_jax():
    m = np.random.default_rng(3).random((2, 13, 29)) > 0.5
    for sh, sw in ((2, 2), (1, 2), (2, 1), (3, 2)):
        want = np.asarray(jd._maxpool2d_ceil_bool(jnp.asarray(m), sh, sw))
        got = td.maxpool2d_ceil_bool(torch.from_numpy(m), sh, sw).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_se_layer_matches_jax(masked):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 7, 16)).astype(np.float32)  # NHWC
    mask = (rng.random((2, 5, 7)) > 0.6) if masked else None
    jm = JaxSE(num_channels=16, reduction_ratio=8)
    v = jax.device_get(jm.init(jax.random.key(0), jnp.asarray(x),
                               None if mask is None else jnp.asarray(mask)))
    want = np.asarray(jm.apply(v, jnp.asarray(x),
                               None if mask is None else jnp.asarray(mask)))
    tm = ChannelSELayerMasked(16, reduction_ratio=8)
    tm.load_state_dict(state_dict_from_jax(v["params"], tm))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=TOL, rtol=TOL)


def _synthetic_patch_sd(rng, prefix, hidden, ks):
    """A reference-format patch discriminator state_dict: spectral-norm
    convs (weight_orig, weight_u, weight_v, bias) and the SE's Linears."""
    sd, c_in = {}, 1
    for i, (c_out, k) in enumerate(zip(list(hidden) + [1], ks)):
        k1, k2 = k if isinstance(k, tuple) else (k, k)
        p = f"{prefix}convs.{i}"
        sd[f"{p}.weight_orig"] = torch.from_numpy(
            rng.standard_normal((c_out, c_in, k1, k2)).astype(np.float32) * 0.2)
        sd[f"{p}.weight_u"] = torch.from_numpy(rng.standard_normal(c_out).astype(np.float32))
        sd[f"{p}.weight_v"] = torch.from_numpy(
            rng.standard_normal(c_in * k1 * k2).astype(np.float32))
        sd[f"{p}.bias"] = torch.from_numpy(rng.standard_normal(c_out).astype(np.float32) * 0.1)
        c_in = c_out
    red = max(1, hidden[-1] // 8)
    for name, shape in (("fc1", (red, hidden[-1])), ("fc2", (hidden[-1], red))):
        sd[f"{prefix}se_block.{name}.weight"] = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * 0.3)
        sd[f"{prefix}se_block.{name}.bias"] = torch.from_numpy(
            rng.standard_normal(shape[0]).astype(np.float32) * 0.1)
    return sd


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["patch", "multibin"])
def test_importers_match_jax_and_load_into_the_port(kind):
    """Synthetic reference state_dicts: the port's numpy importer gives the
    JAX importer's trees, and the port loaded from them (with the imported
    sigma/u) gives the JAX model's logits."""
    rng = np.random.default_rng(5)
    x, lengths = _inputs(5)
    jm, tm = _models(kind)
    if kind == "patch":
        sd = _synthetic_patch_sd(rng, "", PATCH["hidden_channels"],
                                 PATCH["kernel_sizes"])
        ours = timport.import_patch_discriminator_params(sd)
        theirs = jimport.import_patch_discriminator_params(sd)
    else:
        ks = tuple((3, k) for k in MULTIBIN["kernel_sizes"])
        sd = {}
        for i in range(MULTIBIN["n_bins"]):
            sd.update(_synthetic_patch_sd(rng, f"discriminators.{i}.",
                                          MULTIBIN["hidden_channels"], ks))
        ours = timport.import_multibin_discriminator_params(sd, MULTIBIN["n_bins"])
        theirs = jimport.import_multibin_discriminator_params(sd, MULTIBIN["n_bins"])
    _tree_equal(ours[0], theirs[0])
    _tree_equal(ours[1], theirs[1])
    tm.load_state_dict(state_dict_from_jax(ours[0], tm, ours[1]))
    want = jm.apply({"params": theirs[0], "batch_stats": theirs[1]},
                    jnp.asarray(x), jnp.asarray(lengths))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(lengths))
    wl = [want[0]] if kind == "patch" else want[0]
    gl = [got[0]] if kind == "patch" else got[0]
    for a, b in zip(wl, gl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL, rtol=TOL)
