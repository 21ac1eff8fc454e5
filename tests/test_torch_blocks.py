"""PyTorch port: ResidualBlock1D (plain version of the block kernel) and
CBAM1D against the JAX package: its XLA path and its Pallas kernel in
interpret mode (fp32, CPU, ragged lengths)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.masking import sequence_mask
from mqgan_tpu.nn.attention import CBAM1D as JaxCBAM1D
from mqgan_tpu.nn.blocks import ResidualBlock1D as JaxBlock
from mqgan_tpu_torch.nn.attention import CBAM1D
from mqgan_tpu_torch.nn.blocks import ResidualBlock1D
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import max_err, perturb, to_numpy_tree

# the two frameworks sum the k-tap convs in different orders
TOL = 1e-4


@pytest.mark.parametrize(
    "cin,cout,k,causal",
    [(128, 128, 3, False), (128, 256, 5, False),
     (256, 128, 7, True), (128, 128, 3, True)],
)
def test_block_matches_jax_xla_and_pallas(rng, cin, cout, k, causal):
    b, t = 3, 37
    x = rng.standard_normal((b, t, cin)).astype(np.float32)
    lengths = np.asarray([t, 20, 1], np.int32)
    mask = sequence_mask(t, jnp.asarray(lengths))
    kw = dict(kernel_size=k, act="taptx", causal=causal, norm="weight")
    jblk = JaxBlock(cin, cout, **kw)
    tree = perturb(to_numpy_tree(
        jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), mask, True)), rng)
    xla = np.asarray(jblk.apply({"params": tree}, jnp.asarray(x), mask, True))
    pallas = np.asarray(JaxBlock(cin, cout, fused=True, **kw).apply(
        {"params": tree}, jnp.asarray(x), mask, True))

    blk = ResidualBlock1D(cin, cout, k, causal=causal)
    blk.load_state_dict(state_dict_from_jax(tree, blk))
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(np.array(mask))).numpy()
    print(f"max err vs XLA {max_err(got, xla):.3e}, "
          f"vs Pallas {max_err(got, pallas):.3e}")
    np.testing.assert_allclose(got, xla, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)


def test_cbam_module_matches_jax(rng):
    b, t, c = 3, 29, 64
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    mask = sequence_mask(t, jnp.asarray([t, 11, 1]))
    jmod = JaxCBAM1D(channels=c)
    tree = perturb(to_numpy_tree(
        jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), mask)), rng)
    want = np.asarray(jmod.apply({"params": tree}, jnp.asarray(x), mask))
    mod = CBAM1D(c)
    mod.load_state_dict(state_dict_from_jax(tree, mod))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(np.array(mask)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_block_training_mode_raises():
    """Training mode is the autograd branch: dropout draws from the given
    generator (a generator of another kind than the input's device raises),
    and gradients reach every parameter."""
    blk = ResidualBlock1D(8, 8, 3, dropout=0.5)
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0.0, 0.3)
    x = torch.randn(2, 6, 8)
    a = blk(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    b = blk(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    assert not torch.equal(a, blk(x, deterministic=False))
    a.square().sum().backward()
    assert all(p.grad is not None for p in blk.parameters())
    with pytest.raises((RuntimeError, TypeError)):
        blk(x, deterministic=False, generator=torch.Generator(device="meta"))
