"""The training side of the port's FSQ against the JAX package's: the
straight-through rounding (its gradient is the identity), the ``FSQ``
module in every form of tests/test_fsq_module_parity.py (run here against
the JAX module, not the reference checkout), and the noise dropout, held by
its statistics (JAX's threefry draws cannot be reproduced)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.quant import fsq as jfsq
from mqgan_tpu_torch.quant import fsq as tfsq
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_gan_step import one_torch_thread  # noqa: F401 - autouse


@pytest.mark.parametrize("fn", ["round_ste", "floor_ste"])
def test_ste_gradient_is_identity(fn):
    z = torch.linspace(-3.3, 3.3, 57, requires_grad=True)
    out = getattr(tfsq, fn)(z)
    want = torch.round(z) if fn == "round_ste" else torch.floor(z)
    assert torch.equal(out.detach(), want.detach())
    g = torch.randn(57)
    out.backward(g)
    assert torch.equal(z.grad, g)


FORMS = {
    "projectionless": (dict(levels=(8, 5, 5, 5)), (2, 20, 4)),
    "projection": (dict(levels=(8, 5, 5, 5), dim=12), (2, 10, 12)),
    "multi_codebook": (dict(levels=(5, 5, 5), num_codebooks=2), (2, 12, 6)),
    "channel_first": (dict(levels=(8, 5, 5, 5), channel_first=True), (2, 4, 15)),
    "symmetry_preserving": (dict(levels=(8, 5, 5), preserve_symmetry=True), (2, 9, 3)),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_fsq_module_matches_jax(form):
    kw, shape = FORMS[form]
    z = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 2
    jm = jfsq.FSQ(**kw)
    v = jax.device_get(jm.init(jax.random.key(0), jnp.asarray(z)))
    j_out, j_idx = jm.apply(v, jnp.asarray(z))
    tm = tfsq.FSQ(**kw)
    if "params" in v:
        tm.load_state_dict(state_dict_from_jax(v["params"], tm))
    zt = torch.from_numpy(z).requires_grad_()
    t_out, t_idx = tm(zt, training=True)  # no noise: equal to eval
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert t_idx.dtype == torch.int32
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               atol=1e-5, rtol=1e-5)
    # straight-through: the gradient reaches the input
    t_out.sum().backward()
    assert zt.grad is not None and bool(torch.isfinite(zt.grad).all())


def test_noise_dropout_statistics_and_clean_indices():
    """With p = 0.3: a sample skips quantization with probability p, and
    independently gets a uniform offset with probability p (its output then
    z + U(-0.5, 0.5) / half); the indices are those of the clean
    quantization; the draws follow the generator."""
    p, n = 0.3, 4000
    levels = (8, 5, 5, 5)
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n, 3, 4)).astype(np.float32))
    spec = tfsq.FSQSpec(levels, noise_dropout=p)
    clean = tfsq.quantize(z, spec)
    out = tfsq.quantize(z, spec, training=True,
                        generator=torch.Generator().manual_seed(0))
    again = tfsq.quantize(z, spec, training=True,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    half = torch.from_numpy(spec.half_width)
    is_clean = (out == clean).all(dim=(1, 2))
    is_skip = (out == z).all(dim=(1, 2))
    offset = (out - z) * half
    is_offset = ((offset.abs() <= 0.5 + 1e-5).all(dim=(1, 2)) & ~is_skip)
    assert bool((is_clean | is_skip | is_offset).all())
    # P(offset) = p; P(skip and no offset) = p (1 - p); P(clean) = (1 - p)^2
    sd = lambda q: 4 * np.sqrt(q * (1 - q) / n)  # noqa: E731
    assert abs(float(is_offset.float().mean()) - p) < sd(p)
    assert abs(float((is_skip & ~is_offset).float().mean()) - p * (1 - p)) < sd(p * (1 - p))
    assert abs(float(is_clean.float().mean()) - (1 - p) ** 2) < sd((1 - p) ** 2)
    m = tfsq.FSQ(levels, noise_dropout=p)
    _, idx = m(z, training=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(idx, tfsq.codes_to_indices(clean, spec))
    with pytest.raises(ValueError, match="generator"):
        tfsq.quantize(z, spec, training=True)
