"""PyTorch port: UNetRefiner against the JAX package (fp32, CPU), with T
not a multiple of 2**depth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.masking import sequence_mask
from mqgan_tpu.nn.unet import UNetRefiner as JaxRefiner
from mqgan_tpu_torch.nn.unet import UNetRefiner
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import max_err, perturb, to_numpy_tree

TOL = 1e-4


@pytest.mark.parametrize("t,depth,masked", [(37, 2, True), (30, 3, True),
                                            (21, 2, False)])
def test_refiner_matches_jax(rng, t, depth, masked):
    b, f, mel = 3, 18, 16
    x = rng.standard_normal((b, t, f)).astype(np.float32)
    mask = sequence_mask(t, jnp.asarray([t, 13, 1])) if masked else None
    jmod = JaxRefiner(base_ch=4, depth=depth, out_features=mel)
    tree = perturb(to_numpy_tree(jax.jit(jmod.init, static_argnums=3)(
        jax.random.PRNGKey(0), jnp.asarray(x), mask, True)), rng)
    want = np.asarray(jax.jit(jmod.apply, static_argnums=3)(
        {"params": tree}, jnp.asarray(x), mask, True))

    mod = UNetRefiner(f, base_ch=4, depth=depth, out_features=mel)
    mod.load_state_dict(state_dict_from_jax(tree, mod))
    with torch.no_grad():
        got = mod(torch.from_numpy(x),
                  None if mask is None else torch.from_numpy(np.array(mask)))
    print(f"max err vs JAX {max_err(got.numpy(), want):.3e}")
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
