"""PyTorch port: MelMixer2D (plain version of the mixer kernel, and the
Chebyshev poly path) against the JAX package (fp32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.masking import sequence_mask
from mqgan_tpu.nn.mixer2d import MelMixer2D as JaxMixer
from mqgan_tpu.ops.mixer_poly import poly_mixer_apply as jax_poly_apply
from mqgan_tpu_torch.nn.mixer2d import MelMixer2D
from mqgan_tpu_torch.ops import mixer_kernels
from mqgan_tpu_torch.ops.mixer_poly import poly_mixer_apply
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import max_err, perturb, to_numpy_tree

TOL = 1e-4
B, T, C, P = 3, 37, 128, 32
LENGTHS = (T, 20, 1)


def _setup(rng, **jax_kw):
    x = (rng.standard_normal((B, T, C)) * 0.5).astype(np.float32)
    mask = sequence_mask(T, jnp.asarray(LENGTHS))
    jmod = JaxMixer(features=P, **jax_kw)
    tree = perturb(to_numpy_tree(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), mask, True)), rng)
    return x, mask, jmod, tree


def _port(tree, **kw):
    mod = MelMixer2D(P, **kw)
    mod.load_state_dict(state_dict_from_jax(tree, mod))
    return mod


def test_exact_mixer_matches_jax_xla_and_pallas(rng):
    x, mask, jmod, tree = _setup(rng)
    xla = np.asarray(jmod.apply({"params": tree}, jnp.asarray(x), mask, True))
    pallas = np.asarray(JaxMixer(features=P, fused=True).apply(
        {"params": tree}, jnp.asarray(x), mask, True))
    with torch.no_grad():
        got = _port(tree)(torch.from_numpy(x),
                          torch.from_numpy(np.array(mask))).numpy()
    print(f"max err vs XLA {max_err(got, xla):.3e}, "
          f"vs Pallas {max_err(got, pallas):.3e}")
    np.testing.assert_allclose(got, xla, atol=TOL)
    np.testing.assert_allclose(got, pallas, atol=TOL)
    # padded rows are exactly the conv_out bias
    np.testing.assert_array_equal(
        got[np.asarray(mask)], np.float32(tree["conv_out"]["bias"][0]))


def test_plain_mixer_time_chunks_do_not_change_the_result(rng, monkeypatch):
    x, mask, _, tree = _setup(rng)
    mod = _port(tree)
    args = (torch.from_numpy(x), torch.from_numpy(np.array(mask)))
    with torch.no_grad():
        whole = mod(*args)
        # one frame of hidden per chunk: 37 chunks
        monkeypatch.setattr(mixer_kernels, "HIDDEN_CHUNK_BYTES", B * C * P * 4)
        chunked = mod(*args)
    torch.testing.assert_close(chunked, whole, atol=1e-6, rtol=1e-6)


def test_poly_mixer_apply_matches_jax(rng):
    z = (rng.standard_normal((B, T, C)) * 0.7).astype(np.float32)
    mask = np.arange(T)[None, :] >= np.asarray(LENGTHS)[:, None]
    z[mask] = 0.0
    w1 = rng.standard_normal(P).astype(np.float32)
    b1 = (rng.standard_normal(P) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal(P) * 0.2).astype(np.float32)
    b2 = np.float32(0.05)
    want = np.asarray(jax_poly_apply(jnp.asarray(z), jnp.asarray(mask),
                                     jnp.asarray(w1), jnp.asarray(b1),
                                     jnp.asarray(w2), jnp.asarray(b2)))
    got = poly_mixer_apply(torch.from_numpy(z), torch.from_numpy(mask),
                           *(torch.from_numpy(a) for a in (w1, b1, w2)),
                           torch.tensor(b2)).numpy()
    print(f"max err vs JAX poly {max_err(got, want):.3e}")
    np.testing.assert_allclose(got, want, atol=TOL)


def test_poly_mixer_module_matches_jax(rng):
    x, mask, jmod, tree = _setup(rng, poly_approx=True)
    want = np.asarray(jmod.apply({"params": tree}, jnp.asarray(x), mask, True))
    with torch.no_grad():
        got = _port(tree, poly_approx=True)(
            torch.from_numpy(x), torch.from_numpy(np.array(mask))).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("poly", [False, True])
def test_mixer_training_mode_raises(poly):
    with pytest.raises(NotImplementedError):
        MelMixer2D(4, poly_approx=poly)(torch.zeros(1, 4, 8),
                                        deterministic=False)
