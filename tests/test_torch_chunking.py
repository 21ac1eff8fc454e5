"""PyTorch port: the overlap-chunking plans and halos (``core/chunking.py``)
equal the JAX package's over a grid of lengths, windows, halos, alignments
and strictness, raises included; and the port's chunked decode equals the
JAX package's full-length decode on the same weights."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core import chunking as jc
from mqgan_tpu.models.preencoder import PreEncoder as JaxPreEncoder
from mqgan_tpu_torch.core import chunking as pc
from tests.test_torch_bridge import NARROW, narrow_jax_params, port_model

DECODE_TOL = 2e-4


def _plan(mod, *args, **kw):
    try:
        return [(s.start, s.stop, s.keep_lo, s.keep_hi, s.local_lo, s.local_hi)
                for s in mod.chunk_plan(*args, **kw)]
    except ValueError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("t", [1, 100, 1024, 1025, 3000, 7777])
@pytest.mark.parametrize("window,halo_l,halo_r,align", [
    (1024, 128, 104, 8),   # flagship full pipeline
    (1024, 96, 72, 8),     # flagship decode side
    (1024, 28, 28, 1),     # flagship encode side (StreamingEncoder)
    (256, 128, 104, 8),    # too small: strict raises, non-strict shrinks
    (128, 60, 60, 8),
    (64, 0, 0, 4),         # disjoint chunks
    (200, 37, 11, 3),
])
@pytest.mark.parametrize("strict", [True, False])
def test_chunk_plan_matches_jax(t, window, halo_l, halo_r, align, strict):
    want = _plan(jc, t, window, halo_l, halo_r, align=align, strict=strict)
    got = _plan(pc, t, window, halo_l, halo_r, align=align, strict=strict)
    assert got == want
    if want[0] != "raises":  # the keep regions tile [0, t)
        assert want[0][2] == 0 and want[-1][3] == t
        assert all(a[3] == b[2] for a, b in zip(want, want[1:]))


@pytest.mark.parametrize("kernel_sizes", [(3,), (3, 5), (3, 3, 5, 7), (7, 5, 3, 1)])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_halos_match_jax(kernel_sizes, depth):
    assert pc.refiner_halo(depth) == jc.refiner_halo(depth)
    assert pc.halo_align(depth) == jc.halo_align(depth)
    assert pc.decoder_halos(kernel_sizes, depth) == jc.decoder_halos(kernel_sizes, depth)
    assert pc.encoder_halo(kernel_sizes) == jc.encoder_halo(kernel_sizes)
    assert pc.generator_halos(kernel_sizes, depth) == jc.generator_halos(kernel_sizes, depth)


def test_flagship_halos():
    ks, depth = pc.FLAGSHIP_KERNEL_SIZES, pc.FLAGSHIP_REFINER_DEPTH
    assert (ks, depth) == (jc.FLAGSHIP_KERNEL_SIZES, jc.FLAGSHIP_REFINER_DEPTH)
    assert pc.generator_halos(ks, depth) == (128, 104)
    assert pc.decoder_halos(ks, depth) == (96, 72)
    assert pc.encoder_halo(ks) == 28
    assert pc.halo_align(depth) == 8


def test_chunked_decode_matches_jax_full_decode():
    """The port's decode through the decode-side chunk plan equals the JAX
    package's single full-length decode (padded convention: the tail
    masked beyond the clip, as each window is)."""
    gen, tree = narrow_jax_params()
    model = port_model(tree)
    t, window = 300, 96
    tokens = np.random.default_rng(2).integers(0, 1000, (1, t)).astype(np.int32)
    t_pad = t + 32
    idx = np.zeros((1, t_pad), np.int32)
    idx[:, :t] = tokens
    mask = np.arange(t_pad)[None, :] >= t
    full = np.asarray(jax.jit(functools.partial(
        gen.apply, method=JaxPreEncoder.decode))(
            {"params": tree}, jnp.asarray(idx), jnp.asarray(mask)))[:, :t]

    halo_l, halo_r = pc.decoder_halos(NARROW["kernel_sizes"], NARROW["refiner_depth"])
    out = np.zeros_like(full)
    spans = pc.chunk_plan(t, window, halo_l, halo_r,
                          align=pc.halo_align(NARROW["refiner_depth"]))
    assert len(spans) > 2
    for s in spans:
        w = s.stop - s.start
        idx_w = np.zeros((1, window), np.int32)
        idx_w[:, :w] = tokens[:, s.start:s.stop]
        mask_w = torch.from_numpy(np.arange(window)[None, :] >= w)
        seg = model.decode(torch.from_numpy(idx_w), mask_w).numpy()
        out[:, s.keep_lo:s.keep_hi] = seg[:, s.local_lo:s.local_hi]
    np.testing.assert_allclose(out, full, atol=DECODE_TOL, rtol=DECODE_TOL)
