"""PyTorch port: two codec parity runs against the JAX package on the CPU
that the narrow fp32 tests (``tests/test_torch_preencoder.py``) leave out.

- bf16 tokens. The narrow PreEncoder in bf16 on both sides. The port's bf16
  encode (its trunk in bf16, its FSQ head projecting in fp32, as the JAX
  package's Pallas head ``ops/fsq_kernels.py`` ``FSQEncodeHead`` does) is
  held against JAX's bf16 trunk (``_encode_trunk``'s layers, XLA) followed
  by that Pallas head in interpret mode. JAX's ``PreEncoder.encode`` (XLA)
  projects in bf16 instead; its flips are printed, not gated. bf16 tokens
  move wherever the two frameworks round at other places (a bias added
  before or after the product's rounding, a mixer rounded once or op by
  op), so tokens are counted, as chip_smoke.py phase 3c counts them, away
  from a rounding midpoint of JAX's fp32 pre-round values, against a
  control. Phase 3c's control, the port with its pre mixer's hidden units
  summed in another order, moves no token at this width (16 hidden units
  summed in fp32 and rounded once, in either package; printed); so the
  control is JAX's own bf16 rounding: its bf16 tokens against its fp32
  ones. The port's bf16 tokens may differ from JAX's bf16 ones, and from
  JAX's fp32 ones, at most 1.5x as often as that control.
- hifimusic's structure. ``configs/model_config_hifimusic.yaml``'s 160
  mels, kernels 3/3/5/7 over four stages, FSQ [8, 5, 5, 5], refiner 96 of
  depth 3 (hidden projection / 8), at narrow trunk channels, fp32: tokens
  equal away from a midpoint, decode within 2e-4 (``DECODE_TOL``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mqgan_tpu.core.masking import sequence_mask
from mqgan_tpu.models.preencoder import PreEncoder as JaxPreEncoder
from mqgan_tpu.ops.fsq_kernels import FSQEncodeHead
from mqgan_tpu.quant.fsq import FSQSpec, bound
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import (MELS, NARROW, max_err, narrow_jax_params, perturb,
                                     to_numpy_tree)

DECODE_TOL = 2e-4
MIDPOINT_TOL = 1e-4
TOKEN_FLIP_RATIO = 1.5  # chip_smoke.py phase 3c's bf16 ratio
LEVELS = (8, 5, 5, 5)
HIFIMUSIC = dict(channels=(16, 16, 24, 24), kernel_sizes=(3, 3, 5, 7),
                 fsq_levels=LEVELS, refiner_base_channels=96, refiner_depth=3,
                 refiner_hidden_proj_divisor=8)
HIFIMUSIC_MELS = 160


def _far(pre: np.ndarray) -> np.ndarray:
    """(N,) True where every bounded pre-round value of a row lies more than
    MIDPOINT_TOL from a rounding midpoint."""
    b = np.asarray(bound(jnp.asarray(pre), LEVELS))
    return (np.abs(b - np.floor(b) - 0.5) > MIDPOINT_TOL).all(axis=-1)


def _jax_trunk_hidden(m, x, pad):
    """JAX's encode trunk before ``q_in_proj`` (``PreEncoder._encode_trunk``
    layer by layer)."""
    h = m.pre(m.proj(x), pad, True, False)
    for block in m.encoder_blocks:
        h = block(h, pad, deterministic=True)
    return h


def _permuted_pre_mixer(model: PreEncoder, seed: int) -> PreEncoder:
    """A copy of ``model`` whose pre mixer sums its hidden units in another
    order: the same function."""
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    n = sd["pre.pw.bias"].shape[0]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    for k in sd:
        if k.startswith("pre.pw."):
            sd[k] = sd[k][perm]
        elif k == "pre.conv_out.weight":
            sd[k] = sd[k][:, perm]
    other = PreEncoder(MELS, **NARROW, dtype=model.dtype)
    other.load_state_dict(sd)
    return other.eval()


def test_bf16_tokens_flip_no_more_than_jax_bf16_rounding():
    b, t = 8, 256
    _, tree = narrow_jax_params()
    x = np.random.default_rng(7).standard_normal((b, t, MELS)).astype(np.float32)
    pad = jnp.zeros((b, t), bool)
    variables = {"params": tree}
    head = FSQEncodeHead(tree["q_in_proj"]["kernel"], tree["q_in_proj"]["bias"],
                         FSQSpec(levels=LEVELS), interpret=True)

    def jax_tokens(dtype):
        jgen = JaxPreEncoder(mel_channels=MELS, **NARROW, dtype=dtype)
        h = jax.jit(functools.partial(jgen.apply, method=_jax_trunk_hidden))(
            variables, jnp.asarray(x), pad)
        xla = jax.jit(functools.partial(jgen.apply, method=JaxPreEncoder.encode))(
            variables, jnp.asarray(x), pad)
        return (np.asarray(head(h)).reshape(-1), np.asarray(xla).reshape(-1),
                np.asarray(h.astype(jnp.float32)).reshape(-1, h.shape[-1]))

    want, xla, _ = jax_tokens(jnp.bfloat16)
    want32, _, h32 = jax_tokens(jnp.float32)
    far = _far(h32 @ tree["q_in_proj"]["kernel"] + tree["q_in_proj"]["bias"])

    model = PreEncoder(MELS, **NARROW, dtype=torch.bfloat16)
    model.load_state_dict(state_dict_from_jax(tree, model))
    model.eval()
    xt = torch.from_numpy(x)
    got = model.encode(xt).numpy().reshape(-1)
    reordered = _permuted_pre_mixer(model, 0).encode(xt).numpy().reshape(-1)

    def flips(a, c):
        return int(((a != c) & far).sum())

    control = flips(want, want32)
    print(f"bf16 tokens, B={b} T={t}, {int(far.sum())} of {far.size} away from a "
          f"midpoint: the port vs JAX's bf16 trunk + Pallas head {flips(got, want)}, "
          f"the port vs JAX's fp32 tokens {flips(got, want32)}; the control, JAX's bf16 "
          f"vs its fp32 tokens, {control}; not gated: phase 3c's reordered-sum "
          f"control {flips(reordered, got)}, the port vs JAX's XLA encode (bf16 "
          f"projection) {flips(got, xla)}")
    assert far.mean() > 0.95 and control > 0
    assert flips(got, want) <= TOKEN_FLIP_RATIO * control
    assert flips(got, want32) <= TOKEN_FLIP_RATIO * control


def test_hifimusic_structure_matches_jax_fp32():
    b, t, lengths = 2, 48, (48, 31)
    jgen = JaxPreEncoder(mel_channels=HIFIMUSIC_MELS, **HIFIMUSIC)
    params = jax.jit(jgen.init)(jax.random.PRNGKey(3),
                                jnp.zeros((1, 16, HIFIMUSIC_MELS)), jnp.full((1,), 16))
    tree = perturb(to_numpy_tree(params), np.random.default_rng(3))
    variables = {"params": tree}
    x = np.random.default_rng(4).standard_normal((b, t, HIFIMUSIC_MELS)).astype(np.float32)
    mask = np.array(sequence_mask(t, jnp.asarray(lengths)))
    jx, jmask = jnp.asarray(x), jnp.asarray(mask)
    j_tokens = np.array(jax.jit(functools.partial(
        jgen.apply, method=JaxPreEncoder.encode))(variables, jx, jmask))
    z = jax.jit(lambda v, a, m: jgen.apply(
        v, a, m, True, method=JaxPreEncoder._encode_trunk))(variables, jx, jmask)
    far = _far(np.asarray(z).reshape(-1, z.shape[-1])).reshape(b, t)
    j_out = np.asarray(jax.jit(functools.partial(
        jgen.apply, method=JaxPreEncoder.decode))(variables, jnp.asarray(j_tokens), jmask))

    model = PreEncoder(HIFIMUSIC_MELS, **HIFIMUSIC)
    model.load_state_dict(state_dict_from_jax(tree, model))
    model.eval()
    tokens = model.encode(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    out = model.decode(torch.from_numpy(j_tokens), torch.from_numpy(mask)).numpy()
    print(f"hifimusic structure: {int((tokens != j_tokens).sum())} token flips "
          f"({int((~far).sum())} near a midpoint); decode max err {max_err(out, j_out):.3e}")
    assert far.mean() > 0.95
    np.testing.assert_array_equal(tokens[far], j_tokens[far])
    np.testing.assert_allclose(out, j_out, atol=DECODE_TOL, rtol=DECODE_TOL)
