"""PyTorch port: the JAX-params -> state_dict bridge and the seeded
initialiser; also the helpers the other test_torch_* files share."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.masking import sequence_mask
from mqgan_tpu.models.preencoder import PreEncoder as JaxPreEncoder
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.utils.init import seeded_init_
from mqgan_tpu_torch.utils.params import state_dict_from_jax

PERTURBED_LEAVES = ("bias", "g", "beta", "gamma")
# the narrow whole-slice configuration
NARROW = dict(channels=(16, 24, 32), kernel_sizes=(3, 5),
              refiner_base_channels=4, refiner_depth=2)
MELS = 16


def to_numpy_tree(params):
    """Flax params (maybe under "params") -> nested dict of numpy arrays."""
    tree = jax.device_get(params)
    tree = tree.get("params", tree)

    def conv(t):
        if hasattr(t, "items"):
            return {k: conv(v) for k, v in t.items()}
        return np.asarray(t)

    return conv(tree)


def perturb(tree, rng, scale=0.1):
    """Add small random values to every bias, weight-norm magnitude and APTx
    parameter, which the JAX initialisers set to constants, so that a
    parity test exercises each of them."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = perturb(v, rng, scale)
        elif k in PERTURBED_LEAVES:
            out[k] = (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@functools.lru_cache(maxsize=None)
def _narrow_tree(seed):
    gen = JaxPreEncoder(mel_channels=MELS, **NARROW)
    x = jnp.zeros((1, 16, MELS), jnp.float32)
    params = jax.jit(gen.init)(jax.random.PRNGKey(seed), x, jnp.full((1,), 16))
    return perturb(to_numpy_tree(params), np.random.default_rng(seed))


def narrow_jax_params(seed=0, **kw):
    """(JAX PreEncoder, perturbed numpy param tree) at the narrow config;
    the tree is the caller's own copy (the mixer mode does not change it)."""
    gen = JaxPreEncoder(mel_channels=MELS, **NARROW, **kw)
    return gen, copy.deepcopy(_narrow_tree(seed))


def port_model(tree, **kw):
    model = PreEncoder(MELS, **NARROW, **kw)
    model.load_state_dict(state_dict_from_jax(tree, model))
    return model.eval()


def test_bridge_loads_every_parameter():
    _, tree = narrow_jax_params()
    model = PreEncoder(MELS, **NARROW)
    sd = state_dict_from_jax(tree, model)
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(
        sd["encoder_blocks.0.conv1.v"].numpy(),
        tree["encoder_blocks_0"]["conv1"]["v"].transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["proj.weight"].numpy(),
                                  tree["proj"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["refiner.downs.1.conv2.v"].numpy(),
        tree["refiner"]["down1"]["conv2"]["v"].transpose(3, 2, 0, 1))


def test_bridge_rejects_missing_key():
    _, tree = narrow_jax_params()
    del tree["decoder_blocks_1"]["APTx_0"]["gamma"]
    with pytest.raises(KeyError, match="decoder_blocks.1.act.gamma"):
        state_dict_from_jax(tree, PreEncoder(MELS, **NARROW))


def test_bridge_rejects_extra_key():
    _, tree = narrow_jax_params()
    tree["encoder_blocks_0"]["norm1"] = {"scale": np.ones(24, np.float32)}
    with pytest.raises(KeyError, match="norm1"):
        state_dict_from_jax(tree, PreEncoder(MELS, **NARROW))


def test_bridge_rejects_wrong_shape():
    _, tree = narrow_jax_params()
    tree["q_in_proj"]["kernel"] = np.zeros((32, 5), np.float32)
    with pytest.raises(ValueError, match="q_in_proj.weight"):
        state_dict_from_jax(tree, PreEncoder(MELS, **NARROW))


def test_seeded_init_follows_the_jax_scheme():
    model = seeded_init_(PreEncoder(MELS, **NARROW), seed=3)
    again = seeded_init_(PreEncoder(MELS, **NARROW), seed=3)
    for (name, p), q in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(p, q), name
    sd = model.state_dict()
    v = sd["encoder_blocks.1.conv2.v"]
    torch.testing.assert_close(sd["encoder_blocks.1.conv2.g"],
                               v.flatten(1).norm(dim=1))
    fan_in = v.shape[1] * v.shape[2]
    assert abs(float(v.std()) - fan_in ** -0.5) < 0.2 * fan_in ** -0.5
    assert float(sd["proj.bias"].abs().max()) == 0.0
    assert float(sd["decoder_blocks.0.act.beta"]) == 1.0
    assert float(sd["decoder_blocks.0.act.gamma"]) == 0.5


def test_narrow_jax_forward_runs():
    """The JAX reference of the slice runs at the narrow config (guards the
    fixture the slice tests build on)."""
    gen, tree = narrow_jax_params()
    x = jnp.zeros((2, 24, MELS), jnp.float32)
    idx = jax.jit(functools.partial(gen.apply, method=JaxPreEncoder.encode))(
        {"params": tree}, x, sequence_mask(24, jnp.asarray([24, 9])))
    assert idx.shape == (2, 24)
