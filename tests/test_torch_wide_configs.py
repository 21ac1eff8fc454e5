"""PyTorch port: configs whose shapes the port's kernels once refused on the
card, at narrow widths against the JAX package on the CPU (the port's plain
versions there; ``chip_smoke.py`` holds each kernel against its plain
version at these shapes on the card):

- a generator at channels (36, 36, 36, 52), off the bf16 conv GEMM's
  16-byte copies: fp32 tokens equal away from a rounding midpoint and the
  decode within 2e-4 (``DECODE_TOL``); bf16 tokens (the port's trunk in
  bf16, its FSQ head projecting in fp32) against JAX's bf16 trunk + Pallas
  head in interpret mode, flipping at most 1.5x as often as JAX's own bf16
  against its fp32 tokens (``tests/test_torch_codec_parity.py``'s gate),
  and the bf16 decode within rel-L2 2e-2 of JAX's;
- the int8 refiner at base channels 24 (Cin and Cout off 16, Cout below
  32 at the top level): each of its 14 int8 convs, at its shapes for a
  37-frame clip, against JAX's ``_int8_conv``, fp32 within 1e-4 of max(1,
  max|y|) away from a rounding tie (an activation or weight within 1e-5 of
  a half of its scale, where XLA's reciprocal multiply and the port's
  division may pick other codes). The whole refiner is held conv by conv
  because at this width a clip holds such ties: a flipped code moved the
  refiner's output by 6.4e-3 of a 0.40 maximum against JAX's;
- the encode at FSQ levels of 10 and 16 dims ([5] x 10, [2] x 16: codebooks
  below 2**24, so the fp32 index sums are exact), fp32 tokens equal away
  from a midpoint.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.masking import sequence_mask
from mqgan_tpu.models.preencoder import PreEncoder as JaxPreEncoder
from mqgan_tpu.nn.unet import _int8_conv
from mqgan_tpu.ops.fsq_kernels import FSQEncodeHead
from mqgan_tpu.quant.fsq import FSQSpec, bound, codes_to_indices, quantize
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.ops.int8_conv import int8_conv, quantize_weights
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import max_err, perturb, to_numpy_tree
from tests.test_torch_codec_parity import _jax_trunk_hidden
from tests.test_torch_int8_plan import _int8_convs, _tie

DECODE_TOL = 2e-4
INT8_TOL = 1e-4
BF16_REL_L2 = 2e-2
MIDPOINT_TOL = 1e-4
TOKEN_FLIP_RATIO = 1.5
MELS = 16
OFF8 = dict(channels=(36, 36, 36, 52), kernel_sizes=(3, 3, 5),
            refiner_base_channels=4, refiner_depth=1)
# the FSQ tests' trunk: one block, the smallest that compiles fast
TINY = dict(channels=(16, 16), kernel_sizes=(3,), refiner_base_channels=4,
            refiner_depth=1)
# the generator tests' batch: (B, T, lengths)
BATCH = (4, 128, (128, 97, 128, 60))


def _far(pre: np.ndarray, levels) -> np.ndarray:
    """(N,) True where every bounded pre-round value of a row lies more than
    MIDPOINT_TOL from a rounding midpoint."""
    b = np.asarray(bound(jnp.asarray(pre), tuple(levels)))
    return (np.abs(b - np.floor(b) - 0.5) > MIDPOINT_TOL).all(axis=-1)


@functools.lru_cache(maxsize=None)
def _jax_generator(config: str):
    """(JAX PreEncoder, its config, perturbed numpy param tree) at FSQ
    levels (8, 5, 5, 5); the tree is shared: copy it before changing it."""
    kw = dict(OFF8 if config == "off8" else TINY)
    gen = JaxPreEncoder(mel_channels=MELS, **kw)
    params = jax.jit(gen.init)(jax.random.PRNGKey(5), jnp.zeros((1, 16, MELS)),
                               jnp.full((1,), 16))
    return gen, kw, perturb(to_numpy_tree(params), np.random.default_rng(5))


@functools.lru_cache(maxsize=None)
def _jax_hidden(config: str, b: int, t: int, lengths: tuple):
    """(x, pad mask, JAX's encode trunk before ``q_in_proj`` (B, T, C))."""
    gen, _, tree = _jax_generator(config)
    x = np.random.default_rng(6).standard_normal((b, t, MELS)).astype(np.float32)
    mask = np.array(sequence_mask(t, jnp.asarray(lengths)))
    h = jax.jit(functools.partial(gen.apply, method=_jax_trunk_hidden))(
        {"params": tree}, jnp.asarray(x), jnp.asarray(mask))
    return x, mask, np.asarray(h)


def _port(tree, kw, dtype=torch.float32):
    model = PreEncoder(MELS, **kw, dtype=dtype)
    model.load_state_dict(state_dict_from_jax(tree, model))
    return model.eval()


def _encode_case(config, levels, b=2, t=48, lengths=(48, 29), proj_scale=1.0):
    """JAX's fp32 encode (its trunk, then its quantizer: ``FSQ.__call__``'s
    ``quantize`` and ``codes_to_indices``) and the port's, at FSQ levels
    ``levels``: past the generator's own 4 dims the projections in and out
    of the code dims are drawn anew (the trunk's weights shared)."""
    gen, kw, tree = _jax_generator(config)
    tree = copy.deepcopy(tree)
    d, c = len(levels), tree["q_in_proj"]["kernel"].shape[0]
    if d != len(gen.fsq_levels):
        rng = np.random.default_rng(d)
        tree["q_in_proj"] = {
            "kernel": (rng.standard_normal((c, d)) / np.sqrt(c)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
        tree["q_out_proj"] = {
            "kernel": (rng.standard_normal((d, c)) / np.sqrt(d)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    tree["q_in_proj"]["kernel"] = tree["q_in_proj"]["kernel"] * proj_scale
    x, mask, h = _jax_hidden(config, b, t, lengths)
    z = jnp.asarray(h) @ tree["q_in_proj"]["kernel"] + tree["q_in_proj"]["bias"]
    spec = FSQSpec(levels=tuple(levels))
    want = np.asarray(codes_to_indices(quantize(z, spec), spec))
    far = _far(np.asarray(z).reshape(-1, d), levels).reshape(b, t)
    model = _port(tree, dict(kw, fsq_levels=tuple(levels)))
    got = model.encode(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    return gen, {"params": tree}, model, want, got, far, mask


def test_generator_at_channels_off_8_matches_jax_fp32():
    levels = (8, 5, 5, 5)
    gen, variables, model, want, got, far, mask = _encode_case("off8", levels, *BATCH)
    j_out = np.asarray(jax.jit(functools.partial(gen.apply, method=JaxPreEncoder.decode))(
        variables, jnp.asarray(want), jnp.asarray(mask)))
    out = model.decode(torch.from_numpy(want), torch.from_numpy(mask)).numpy()
    print(f"channels {OFF8['channels']} fp32: {int((got != want).sum())} token flips "
          f"({int((~far).sum())} near a midpoint); decode max err {max_err(out, j_out):.3e}")
    assert far.mean() > 0.95
    np.testing.assert_array_equal(got[far], want[far])
    np.testing.assert_allclose(out, j_out, atol=DECODE_TOL, rtol=DECODE_TOL)


def test_generator_at_channels_off_8_matches_jax_bf16():
    levels = (8, 5, 5, 5)
    b, t, _ = BATCH
    _, kw, tree = _jax_generator("off8")
    variables = {"params": tree}
    # the fp32 test's inputs and JAX trunk (computed once)
    x, mask, h32 = _jax_hidden("off8", *BATCH)
    pad = jnp.asarray(mask)
    head = FSQEncodeHead(tree["q_in_proj"]["kernel"], tree["q_in_proj"]["bias"],
                         FSQSpec(levels=levels), interpret=True)
    jgen16 = JaxPreEncoder(mel_channels=MELS, **kw, dtype=jnp.bfloat16)
    h16 = jax.jit(functools.partial(jgen16.apply, method=_jax_trunk_hidden))(
        variables, jnp.asarray(x), pad)
    want = np.asarray(head(h16)).reshape(b, t)
    want32 = np.asarray(head(jnp.asarray(h32))).reshape(b, t)
    far = _far(h32.reshape(-1, h32.shape[-1]) @ tree["q_in_proj"]["kernel"]
               + tree["q_in_proj"]["bias"], levels).reshape(b, t) & ~mask
    model = _port(tree, kw, torch.bfloat16)
    got = model.encode(torch.from_numpy(x), torch.from_numpy(mask)).numpy()

    def flips(a, c):
        return int(((a != c) & far).sum())

    control = flips(want, want32)
    j_out = np.asarray(jax.jit(functools.partial(jgen16.apply, method=JaxPreEncoder.decode))(
        variables, jnp.asarray(want32), pad)).astype(np.float32)
    out = model.decode(torch.from_numpy(want32), torch.from_numpy(mask)).float().numpy()
    valid = ~mask
    rel = float(np.linalg.norm(out[valid] - j_out[valid]) / np.linalg.norm(j_out[valid]))
    print(f"channels {OFF8['channels']} bf16, {int(far.sum())} of {far.size} tokens away "
          f"from a midpoint: the port vs JAX's bf16 trunk + Pallas head {flips(got, want)}, "
          f"vs JAX's fp32 {flips(got, want32)}; control (JAX bf16 vs fp32) {control}; "
          f"decode rel-L2 vs JAX's bf16 {rel:.3e}")
    assert far.sum() > 0.95 * valid.sum() and control > 0
    assert flips(got, want) <= TOKEN_FLIP_RATIO * control
    assert flips(got, want32) <= TOKEN_FLIP_RATIO * control
    assert rel <= BF16_REL_L2


@pytest.mark.parametrize("levels", [(5,) * 10, (2,) * 16], ids=["5x10", "2x16"])
def test_encode_past_8_code_dims_matches_jax_fp32(levels):
    """A one-block generator's trunk with projections to 10 and 16 code
    dims. Level 2's bound saturates below |z| of a few units (its shift is
    atanh of nearly 1), so there the projection is scaled by 20 for the
    codes to spread (level 5's by 3)."""
    assert FSQSpec(levels=levels).codebook_size < 2 ** 24
    _, _, _, want, got, far, _ = _encode_case(
        "tiny", levels, proj_scale=20.0 if levels[0] == 2 else 3.0)
    print(f"levels {levels}: {int((got != want).sum())} token flips "
          f"({int((~far).sum())} near a midpoint)")
    assert far.mean() > 0.9
    np.testing.assert_array_equal(got[far], want[far])
    assert len(np.unique(want)) > want.size // 4  # the codes spread


@pytest.mark.parametrize("conv", range(14))
def test_int8_refiner_at_base_24_matches_jax_fp32(conv):
    name, cin, cout, h, w = _int8_convs(MELS, 24, 3, 37)[conv]
    b = 2
    rng = np.random.default_rng(conv)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    kernel = (0.1 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(jax.jit(_int8_conv)(jnp.asarray(x), jnp.asarray(kernel),
                                          jnp.asarray(bias)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    wq, sw = quantize_weights(torch.from_numpy(kernel).permute(3, 2, 0, 1).contiguous())
    got = int8_conv(xt, wq, sw, torch.from_numpy(bias)).permute(0, 2, 3, 1).numpy()
    sx = max(np.abs(x).max(), 1e-8) / 127.0
    near = np.pad(_tie(x, sx).any(axis=-1), ((0, 0), (1, 1), (1, 1)))
    near = np.stack([near[:, i:i + h, j:j + w] for i in range(3) for j in range(3)]).any(0)
    sk = np.maximum(np.abs(kernel).max(axis=(0, 1, 2)), 1e-8) / 127.0
    far = ~near[..., None] & ~_tie(kernel, sk).any(axis=(0, 1, 2))
    err = np.abs(got - want)[far].max()
    print(f"{name} {cin} -> {cout} at {h} x {w}: max err vs JAX {err:.3e} over "
          f"{far.mean():.4f} of the outputs")
    assert far.mean() > 0.8
    assert err <= INT8_TOL * max(1.0, np.abs(want).max())
