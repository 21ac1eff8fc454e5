"""PyTorch port: FSQ quantizer and the FSQ encode head's plain version
against the JAX package (fp32, CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mqgan_tpu.ops.fsq_kernels import FSQEncodeHead, _consts, _fsq_encode_pallas
from mqgan_tpu.quant import fsq as jfsq
from mqgan_tpu_torch.ops.fsq_kernels import fsq_encode_plain, fsq_head_constants
from mqgan_tpu_torch.quant import fsq as tfsq

LEVELS = (8, 5, 5, 5)
# indices may differ only where the JAX pre-round value is this close to a
# rounding midpoint (the two frameworks sum the projection in other orders)
MIDPOINT_TOL = 1e-4


def far_from_midpoint(bounded: np.ndarray) -> np.ndarray:
    frac = bounded - np.floor(bounded)
    return (np.abs(frac - 0.5) > MIDPOINT_TOL).all(axis=-1)


def test_indices_to_codes_exact():
    idx = np.arange(int(np.prod(LEVELS)), dtype=np.int32).reshape(40, 25)
    want = np.asarray(jfsq.indices_to_codes(jnp.asarray(idx),
                                            jfsq.FSQSpec(LEVELS)))
    got = tfsq.indices_to_codes(torch.from_numpy(idx), tfsq.FSQSpec(LEVELS))
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_and_pack_match_jax(rng):
    z = (rng.standard_normal((4000, 4)) * 2.0).astype(np.float32)
    jspec, tspec = jfsq.FSQSpec(LEVELS), tfsq.FSQSpec(LEVELS)
    want = np.asarray(jfsq.codes_to_indices(
        jfsq.quantize(jnp.asarray(z), jspec), jspec))
    got = tfsq.codes_to_indices(tfsq.quantize(torch.from_numpy(z), tspec),
                                tspec).numpy()
    bounded = np.asarray(jfsq.bound(jnp.asarray(z), LEVELS))
    far = far_from_midpoint(bounded)
    assert far.mean() > 0.99
    np.testing.assert_array_equal(got[far], want[far])
    np.testing.assert_allclose(
        tfsq.bound(torch.from_numpy(z), LEVELS).numpy(), bounded, atol=1e-6)


def test_head_rounds_half_to_even():
    """Exact half-integer pre-round values, through constants that make
    bound(z) = -offset: the port's head rounds them like the JAX kernel
    (half to even), not away from zero."""
    spec = jfsq.FSQSpec(LEVELS)
    consts = _consts(spec)
    consts[1, :4] = [-0.5, 0.5, -1.5, 2.5]  # offset -> bounded 0.5 -.5 1.5 -2.5
    consts[2, :4] = 0.0  # shift: tanh(0) = 0
    c = 16
    h = np.zeros((5, c), np.float32)
    w_pad = np.zeros((c, 128), np.float32)
    b_pad = np.zeros((1, 128), np.float32)
    want = np.asarray(_fsq_encode_pallas(
        jnp.asarray(h), jnp.asarray(w_pad), jnp.asarray(b_pad),
        jnp.asarray(consts), interpret=True))
    got = fsq_encode_plain(torch.from_numpy(h), torch.zeros(c, 4),
                           torch.zeros(4), torch.from_numpy(consts[:, :4].copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    # q = [0, -0, 2, -2] + half_width [4, 2, 2, 2], basis [1, 8, 40, 200]
    assert int(got[0]) == 4 + 2 * 8 + 4 * 40 + 0 * 200


@pytest.mark.parametrize("n,c", [(111, 96), (13, 32)])
def test_head_plain_matches_pallas_head(rng, n, c):
    """Odd N; indices equal away from rounding midpoints."""
    spec = jfsq.FSQSpec(LEVELS)
    kernel = (rng.standard_normal((c, 4)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal((4,)) * 0.1).astype(np.float32)
    h = rng.standard_normal((n, c)).astype(np.float32)
    want = np.asarray(FSQEncodeHead(kernel, bias, spec, interpret=True)(
        jnp.asarray(h)))
    consts = torch.from_numpy(fsq_head_constants(tfsq.FSQSpec(LEVELS)))
    np.testing.assert_array_equal(consts.numpy(), _consts(spec)[:, :4])
    got = fsq_encode_plain(torch.from_numpy(h), torch.from_numpy(kernel),
                           torch.from_numpy(bias), consts).numpy()
    bounded = np.asarray(jfsq.bound(jnp.asarray(h @ kernel + bias), LEVELS))
    far = far_from_midpoint(bounded)
    np.testing.assert_array_equal(got[far], want[far])
    assert got.min() >= 0 and got.max() < spec.codebook_size
