"""PyTorch port: ``nn/norm.py`` (ChannelLayerNorm, InstanceNorm1d) and the
``ResidualBlock1D`` norm choice against the JAX package's modules on the
same seeded inputs and (perturbed) weights, through the weight bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.masking import sequence_mask
from mqgan_tpu.nn.blocks import ResidualBlock1D as JaxBlock
from mqgan_tpu.nn.norm import ChannelLayerNorm as JaxLayerNorm
from mqgan_tpu.nn.norm import InstanceNorm1d as JaxInstanceNorm
from mqgan_tpu_torch.nn.blocks import ResidualBlock1D
from mqgan_tpu_torch.nn.norm import ChannelLayerNorm, InstanceNorm1d, make_norm
from mqgan_tpu_torch.utils.init import seeded_init_
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import to_numpy_tree

TOL = 1e-5
BLOCK_TOL = 1e-4  # the two frameworks sum the k-tap convs in other orders
C = 24


def _perturb_all(tree, rng):
    """Every leaf moved (the norms' scales start at 1, which hides a
    transposed or dropped scale)."""
    return {k: (_perturb_all(v, rng) if isinstance(v, dict)
                else (v + 0.2 * rng.standard_normal(v.shape)).astype(np.float32))
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["layer", "instance"])
def test_norm_matches_jax(kind, dtype):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 17, C)) + 1.5).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    jmod = JaxLayerNorm() if kind == "layer" else JaxInstanceNorm(C)
    tree = _perturb_all(to_numpy_tree(jmod.init(jax.random.key(0), jx)), rng)
    want = np.asarray(jmod.apply({"params": tree}, jx).astype(jnp.float32))
    mod = ChannelLayerNorm(C) if kind == "layer" else InstanceNorm1d(C)
    mod.load_state_dict(state_dict_from_jax(tree, mod))
    with torch.no_grad():
        out = mod(torch.from_numpy(x).to(getattr(torch, dtype)))
    # flax infers the layer norm's result type from the input and its fp32
    # parameters; the instance norm keeps the input's
    assert out.dtype == (torch.float32 if kind == "layer" else getattr(torch, dtype))
    np.testing.assert_allclose(out.float().numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("norm", ["layer", "instance"])
@pytest.mark.parametrize("cin,cout,k,causal", [(16, 24, 5, False), (24, 24, 3, True)])
def test_block_with_norm_matches_jax(norm, cin, cout, k, causal):
    rng = np.random.default_rng(1)
    b, t = 3, 29
    x = rng.standard_normal((b, t, cin)).astype(np.float32)
    lengths = np.asarray([t, 13, 1], np.int32)
    mask = sequence_mask(t, jnp.asarray(lengths))
    jblk = JaxBlock(cin, cout, kernel_size=k, act="taptx", causal=causal, norm=norm)
    tree = _perturb_all(to_numpy_tree(
        jblk.init(jax.random.key(0), jnp.asarray(x), mask, True)), rng)
    want = np.asarray(jblk.apply({"params": tree}, jnp.asarray(x), mask, True))
    blk = ResidualBlock1D(cin, cout, k, causal=causal, norm=norm)
    blk.load_state_dict(state_dict_from_jax(tree, blk))
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(np.array(mask))).numpy()
    np.testing.assert_allclose(got, want, atol=BLOCK_TOL, rtol=BLOCK_TOL)


def test_norm_choice_and_seeded_init():
    with pytest.raises(ValueError, match="norm must be"):
        make_norm("batch", 8)
    blk = seeded_init_(ResidualBlock1D(8, 8, 3, norm="instance"), 0)
    assert torch.equal(blk.norm1.weight, torch.ones(8))
    assert not blk.conv1.weight_norm and hasattr(blk.conv1, "weight")
    blk = seeded_init_(ResidualBlock1D(8, 8, 3, norm="layer"), 0)
    assert torch.equal(blk.norm2.ln.weight, torch.ones(8))
    # a "weight" block keeps its parameter names: identity norms hold none
    names = set(ResidualBlock1D(8, 12, 3).state_dict())
    assert not any(n.startswith("norm") for n in names)


def test_weight_block_with_norm_modules_is_unchanged():
    """The module path of a "weight" block (identity norms) equals its
    kernel path (the plain version on the CPU)."""
    blk = seeded_init_(ResidualBlock1D(8, 16, 3), 2)
    x = torch.randn((2, 11, 8), generator=torch.Generator().manual_seed(3))
    pad = torch.arange(11)[None, :] >= torch.tensor([[11], [6]])
    with torch.no_grad():
        kernel = blk(x, pad)
        module = blk(x, pad, deterministic=False)
    torch.testing.assert_close(module, kernel, atol=TOL, rtol=TOL)
