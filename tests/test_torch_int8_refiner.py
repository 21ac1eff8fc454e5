"""PyTorch port: the int8 refiner (``PreEncoder(int8_refiner=True)``,
``nn/unet.py`` ``ConvBlock(int8=True)``, ``ops/int8_conv.py``) against the
JAX package's (``mqgan_tpu/nn/unet.py`` ``_int8_conv`` and its int8
``ConvBlock``) on the CPU, the same params in both:

- the quantized codes: the weight codes and scales of the same folded
  kernel are equal, the activation codes of the same input equal away from
  a rounding tie (x / sx within 1e-5 of a half: the two frameworks may
  divide in other ways there);
- a ConvBlock and the whole decode: fp32 within the repo's refiner and
  decode tolerances (1e-4, 2e-4 of max(1, max|x|)), bf16 within its bf16
  gate (rel-L2 2e-2: JAX evaluates the bf16 APTx chains with excess
  precision), and away from the float path (the convs really quantize);
- a training call keeps the float convs (JAX: ``int8 and deterministic``);
- the export round trip, as ``tests/test_deploy.py``'s int8 test holds
  the JAX artifact: tokens equal, the mel within 0.1 * max|mel| of the
  float decode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.masking import sequence_mask
from mqgan_tpu.models.preencoder import PreEncoder as JaxPreEncoder
from mqgan_tpu.nn.conv import weight_norm_kernel
from mqgan_tpu.nn.unet import ConvBlock as JaxConvBlock
from mqgan_tpu_torch.core.config import GeneratorConfig
from mqgan_tpu_torch.deploy import export
from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder
from mqgan_tpu_torch.nn.unet import ConvBlock
from mqgan_tpu_torch.ops.int8_conv import (activation_scale, quantize_activations,
                                           quantize_weights)
from mqgan_tpu_torch.utils.init import seeded_init_
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import (MELS, NARROW, max_err, narrow_jax_params,
                                     perturb, port_model, to_numpy_tree)
from tests.test_torch_export import _tokens_far

TOL = 1e-4
DECODE_TOL = 2e-4
BF16_REL_L2 = 2e-2
TIE = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _gate(got, want, dtype, tol):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()),
                                   rtol=0)
    else:
        assert _rel_l2(got, want) <= BF16_REL_L2


def _nchw(x_nhwc, dtype):
    return (torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)
            .contiguous(memory_format=torch.channels_last).to(dtype))


@functools.lru_cache(maxsize=None)
def _block(dtype):
    """(JAX int8 ConvBlock, its perturbed params, input x (B, T, F, C), mask)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    m = sequence_mask(8, jnp.array([8, 5]))
    jmod = JaxConvBlock(16, dropout=0.0, int8=True, dtype=DTYPES[dtype][0])
    init = jax.jit(jmod.init, static_argnums=3)
    tree = perturb(to_numpy_tree(init(jax.random.key(0), jnp.asarray(x), m, True)), rng)
    return jmod, tree, x, m


@functools.partial(jax.jit, static_argnums=4)
def _jax_codes(v, g, x, m, dtype):
    """_int8_conv's quantization (mqgan_tpu/nn/unet.py:51-60) of a conv's
    folded kernel and of a block's masked input: (k, wq, sw, xm, xq, sx)."""
    k = weight_norm_kernel(v, g).astype(dtype)
    sw = jnp.maximum(jnp.max(jnp.abs(k), axis=(0, 1, 2)), 1e-8) / 127.0
    wq = jnp.clip(jnp.round(k / sw), -127, 127).astype(jnp.int8)
    xm = jnp.where(m[:, :, None, None], 0, x).astype(dtype)
    sx = jnp.maximum(jnp.max(jnp.abs(xm)).astype(jnp.float32), 1e-8) / 127.0
    xq = jnp.clip(jnp.round(xm.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8)
    return k, wq, sw, xm, xq, sx


def _at_tie(values, scale):
    """Where values / scale lies within TIE of a rounding half."""
    r = np.asarray(values, np.float64) / np.asarray(scale, np.float64)
    return np.abs(r - np.floor(r) - 0.5) < TIE


def _within_one_ulp(got, want, dtype):
    """XLA may multiply by the divisor's reciprocal where the port divides:
    the scales agree to one unit in the last place of the dtype."""
    eps = np.finfo(np.float32).eps if dtype == "float32" else 2.0 ** -7
    np.testing.assert_array_less(np.abs(got - want), eps * np.abs(want) + 1e-30)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantized_codes_equal_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    _, tree, x, m = _block(dtype)
    for conv in ("conv1", "conv2"):
        k, wq, sw, xm, want, sx = (np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                                   else np.asarray(a) for a in _jax_codes(
            tree[conv]["v"], tree[conv]["g"], x, m, jdt))
        got_wq, got_sw = quantize_weights(
            torch.from_numpy(k.astype(np.float32)).to(tdt).permute(3, 2, 0, 1))
        _within_one_ulp(got_sw.numpy(), sw.astype(np.float32), dtype)
        tie = _at_tie(k, sw).transpose(3, 0, 1, 2)
        got_wq, wq = got_wq.numpy(), wq.transpose(3, 0, 1, 2)
        print(f"{dtype} {conv}: {int((got_sw.numpy() != sw).sum())} of {sw.size} "
              f"weight scales and {int((got_wq != wq).sum())} codes differ, "
              f"{int(tie.sum())} codes at a tie")
        np.testing.assert_array_equal(got_wq[~tie], wq[~tie])
    xt = torch.from_numpy(xm.astype(np.float32)).to(tdt)
    got_sx = activation_scale(xt)
    _within_one_ulp(got_sx.numpy(), np.float32(sx), "float32")
    got = quantize_activations(xt, got_sx).numpy()
    tie = _at_tie(xm, sx)
    print(f"{dtype}: {int(tie.sum())} activations at a tie, "
          f"{int((got != want).sum())} codes differ")
    np.testing.assert_array_equal(got[~tie], want[~tie])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_conv_block_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    jmod, tree, x, m = _block(dtype)
    want = np.asarray(jax.jit(jmod.apply, static_argnums=3)(
        {"params": tree}, jnp.asarray(x).astype(jdt), m, True)).astype(np.float32)
    mod = ConvBlock(16, 16, dropout=0.0, int8=True)
    mod.load_state_dict(state_dict_from_jax(tree, mod))
    plain = ConvBlock(16, 16, dropout=0.0)
    plain.load_state_dict(mod.state_dict())
    mt = torch.from_numpy(np.array(m))
    with torch.no_grad():
        got = mod(_nchw(x, tdt), mt).float().permute(0, 2, 3, 1).numpy()
        flt = plain(_nchw(x, tdt), mt).float().permute(0, 2, 3, 1).numpy()
    print(f"{dtype}: max err vs JAX {max_err(got, want):.3e}, int8 vs float "
          f"{max_err(got, flt):.3e}")
    _gate(got, want, dtype, TOL)
    assert np.abs(got - flt).max() > 0  # actually quantized


def test_training_call_keeps_the_float_convs(rng):
    x = _nchw(rng.standard_normal((2, 8, 12, 16)).astype(np.float32), torch.float32)
    m = torch.from_numpy(np.arange(8)[None, :] >= np.array([[8], [5]]))
    int8 = seeded_init_(ConvBlock(16, 16, dropout=0.1, int8=True), 5)
    plain = ConvBlock(16, 16, dropout=0.1)
    plain.load_state_dict(int8.state_dict())
    with torch.no_grad():
        got = int8(x, m, deterministic=False)
        assert torch.equal(got, plain(x, m, deterministic=False))
        assert not torch.equal(int8(x, m), got)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_with_int8_refiner_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    gen, tree = narrow_jax_params(int8_refiner=True,
                                  dtype=None if dtype == "float32" else jdt)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 1000, (2, 24)).astype(np.int32)
    mask = np.arange(24)[None, :] >= np.array([[24], [17]])
    want = np.asarray(jax.jit(functools.partial(gen.apply, method=JaxPreEncoder.decode))(
        {"params": tree}, jnp.asarray(tokens), jnp.asarray(mask))).astype(np.float32)
    args = (torch.from_numpy(tokens), torch.from_numpy(mask))
    got = port_model(tree, int8_refiner=True, dtype=tdt).decode(*args).float().numpy()
    flt = port_model(tree, dtype=tdt).decode(*args).float().numpy()
    valid = ~mask
    print(f"{dtype}: decode max err vs JAX {max_err(got[valid], want[valid]):.3e}, "
          f"int8 vs float refiner {max_err(got, flt):.3e}")
    _gate(got[valid], want[valid], dtype, DECODE_TOL)
    assert np.abs(got - flt).max() > 0


def test_int8_export_round_trip_like_jax(tmp_path):
    gen, tree = narrow_jax_params()
    out = export.export_preencoder(port_model(tree, int8_refiner=True),
                                   GeneratorConfig(**NARROW), str(tmp_path / "int8"),
                                   buckets=(16,), device="cpu")
    rt = ExportedPreEncoder(out, device="cpu")
    assert rt.manifest["int8_refiner"] is True and rt.model.int8_refiner
    spec = np.random.default_rng(4).standard_normal((2, 16, MELS)).astype(np.float32)
    tokens, mel = rt.reencode(spec)
    pad = np.zeros((2, 16), bool)
    want_tokens, far = _tokens_far(gen, tree, spec, pad)
    assert far.mean() > 0.95
    np.testing.assert_array_equal(tokens[far], want_tokens[far])
    want = np.asarray(jax.jit(functools.partial(gen.apply, method=JaxPreEncoder.decode))(
        {"params": tree}, jnp.asarray(tokens), jnp.asarray(pad)))
    denom = max(np.abs(want).max(), 1e-6)
    print(f"int8 artifact vs the JAX float decode: {np.abs(mel - want).max() / denom:.3e}"
          f" of max|mel|")
    assert np.abs(mel - want).max() < 0.1 * denom
