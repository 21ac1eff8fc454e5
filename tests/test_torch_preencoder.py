"""PyTorch port: the whole codec slice — PreEncoder encode / decode /
forward — against the JAX package at a narrow config (fp32, CPU), in exact
and poly-decode mixer modes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.masking import sequence_mask
from mqgan_tpu.models.preencoder import PreEncoder as JaxPreEncoder
from mqgan_tpu.quant.fsq import bound
from tests.test_torch_bridge import MELS, max_err, narrow_jax_params, port_model

B, T = 3, 40
LENGTHS = (40, 29, 1)
DECODE_TOL = 2e-4
MIDPOINT_TOL = 1e-4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, MELS)).astype(np.float32)
    mask = np.array(sequence_mask(T, jnp.asarray(LENGTHS)))
    return x, mask


@pytest.mark.parametrize("poly_mixers", [False, "decode"])
def test_encode_decode_match_jax(poly_mixers):
    gen, tree = narrow_jax_params(poly_mixers=poly_mixers)
    variables = {"params": tree}
    x, mask = _inputs()
    jx, jmask = jnp.asarray(x), jnp.asarray(mask)
    j_tokens = np.array(jax.jit(functools.partial(
        gen.apply, method=JaxPreEncoder.encode))(variables, jx, jmask))
    z = jax.jit(lambda v, a, m: gen.apply(
        v, a, m, True, method=JaxPreEncoder._encode_trunk))(variables, jx, jmask)
    bounded = np.asarray(bound(z, gen.fsq_levels))
    frac = bounded - np.floor(bounded)
    far = (np.abs(frac - 0.5) > MIDPOINT_TOL).all(axis=-1)
    j_out = np.asarray(jax.jit(functools.partial(
        gen.apply, method=JaxPreEncoder.decode))(
            variables, jnp.asarray(j_tokens), jmask))

    model = port_model(tree, poly_mixers=poly_mixers)
    tokens = model.encode(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    out = model.decode(torch.from_numpy(j_tokens),
                       torch.from_numpy(mask)).numpy()
    print(f"{int((tokens != j_tokens).sum())} token flips "
          f"({int((~far).sum())} positions near a midpoint); decode max err "
          f"{max_err(out, j_out):.3e}")
    assert far.mean() > 0.95
    np.testing.assert_array_equal(tokens[far], j_tokens[far])
    np.testing.assert_allclose(out, j_out, atol=DECODE_TOL, rtol=DECODE_TOL)


def test_forward_matches_jax():
    gen, tree = narrow_jax_params()
    x, mask = _inputs(1)
    lengths = np.asarray(LENGTHS, np.int32)
    j_recon, j_post, j_idx = (np.asarray(a) for a in jax.jit(
        gen.apply, static_argnums=3)(
            {"params": tree}, jnp.asarray(x), jnp.asarray(lengths), True))
    model = port_model(tree)
    recon, post, idx = model(torch.from_numpy(x), torch.from_numpy(lengths))
    # the forward is encode, then decode of those tokens
    torch.testing.assert_close(post, model.decode(idx, torch.from_numpy(mask)))
    # this seed has no token near a rounding midpoint: the tokens agree and
    # so do both outputs
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    np.testing.assert_allclose(recon.numpy(), j_recon, atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    np.testing.assert_allclose(post.numpy(), j_post, atol=DECODE_TOL,
                               rtol=DECODE_TOL)


def test_bf16_runs_and_keeps_tokens_in_range():
    _, tree = narrow_jax_params()
    x, mask = _inputs(2)
    model = port_model(tree, dtype=torch.bfloat16, poly_mixers="decode")
    tokens = model.encode(torch.from_numpy(x), torch.from_numpy(mask))
    out = model.decode(tokens, torch.from_numpy(mask))
    assert tokens.dtype == torch.int32 and out.dtype == torch.bfloat16
    assert int(tokens.min()) >= 0 and int(tokens.max()) < model.codebook_size
    assert bool(torch.isfinite(out.float()).all())


def test_training_forward_raises():
    _, tree = narrow_jax_params()
    with pytest.raises(NotImplementedError, match="training slice"):
        port_model(tree)(torch.zeros(1, 8, MELS), torch.tensor([8]),
                         deterministic=False)
