"""PyTorch port: sequence-parallel decode and re-encode
(``parallel/seqpar.py``) against a full-length pass of the port and against
the JAX package's ``seq_parallel_*`` over the conftest's 8 virtual CPU
devices, on the JAX tiny model of tests/test_seqpar.py with the same
(perturbed) weights; both routes (windows stacked on one device, and one
host thread a window meeting at a barrier); and the split block (the plain
versions of ``residual_block_begin`` / ``_finish``) against the unsplit
block."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.models.preencoder import PreEncoder as JaxPreEncoder
from mqgan_tpu.nn.attention import CAM1D as JaxCAM1D
from mqgan_tpu.parallel import seqpar as jax_seqpar
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.nn.attention import CAM1D
from mqgan_tpu_torch.nn.blocks import ResidualBlock1D
from mqgan_tpu_torch.ops.block_kernels import (residual_block_plain,
                                               residual_block_plain_begin,
                                               residual_block_plain_finish,
                                               split_residual_block)
from mqgan_tpu_torch.parallel import seqpar
from mqgan_tpu_torch.utils.init import seeded_init_
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import perturb, to_numpy_tree

MEL = 8
TINY = dict(channels=(16, 16, 24), kernel_sizes=(3, 5), fsq_levels=(8, 5),
            refiner_base_channels=8, refiner_depth=2,
            refiner_hidden_proj_divisor=8)
FULL_TOL = 1e-5  # port windows vs a port full pass: the pools' sum order
JAX_TOL = 2e-4  # port vs JAX: the k-tap convs and the mixer sum in other orders
MIDPOINT_TOL = 1e-4
ROUTES = {"stacked": dict(stack=True), "threads": dict(stack=False)}


@pytest.fixture(scope="module")
def models():
    jgen = JaxPreEncoder(mel_channels=MEL, dropout=0.0, **TINY)
    params = jax.jit(jgen.init)(jax.random.key(0), jnp.zeros((1, 16, MEL)),
                                jnp.full((1,), 16, jnp.int32))
    tree = perturb(to_numpy_tree(params), np.random.default_rng(0))
    model = PreEncoder(MEL, **TINY)
    model.load_state_dict(state_dict_from_jax(tree, model))
    return jgen, {"params": tree}, model.eval()


def _n_devices():
    return len(jax.devices())


def _full(model, x, lengths, t_pad):
    """The port's full-length pass at t_pad frames (the padded convention):
    (tokens, x_recon, x_post) trimmed to T, and the pre-round FSQ values'
    near-midpoint flags."""
    b, t = x.shape[0], x.shape[1]
    xp = torch.zeros((b, t_pad, MEL))
    xp[:, :t] = torch.from_numpy(x)
    pad = torch.arange(t_pad)[None, :] >= torch.from_numpy(lengths)[:, None]
    idx = model.encode(xp, pad)
    post, recon = model.decode(idx, pad, return_recon=True)
    with torch.no_grad():
        h = model._encode_trunk(xp, pad)
        z = h @ model.q_in_proj.weight.t() + model.q_in_proj.bias
        half_l, offset, shift = model.fsq_consts[:3]
        bounded = torch.tanh(z + shift) * half_l - offset
        frac = bounded - torch.floor(bounded)
        near = ((frac - 0.5).abs() < MIDPOINT_TOL).any(dim=-1)
    return (idx[:, :t].numpy(), recon[:, :t].numpy(), post[:, :t].numpy(),
            near[:, :t].numpy())


def _clip(t, b, seed):
    """Non-stationary mels: a drifting mean and a burst mid-clip, what
    window-local CBAM statistics would get wrong."""
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, t, MEL)).astype(np.float32)
    mel += np.linspace(-2.0, 2.0, t, dtype=np.float32)[None, :, None]
    mel[:, t // 3:t // 3 + 40] += 4.0
    return mel


@pytest.mark.parametrize("t,n", [(300, 8), (513, 8), (64, 8), (1024, 4),
                                 (300, 1), (7, 8)])
def test_plan_geometry_matches_jax(t, n):
    for port_fn, jax_fn in ((seqpar.plan_seq_decode, jax_seqpar.plan_seq_decode),
                            (seqpar.plan_seq_reencode, jax_seqpar.plan_seq_reencode)):
        got, want = port_fn(t, n, (3, 5), 2), jax_fn(t, n, (3, 5), 2)
        for field in ("n", "t", "chunk", "t_pad", "halo_l", "halo_r", "window"):
            assert getattr(got, field) == getattr(want, field), field
        assert got.redundancy == pytest.approx(want.redundancy)
        for i in range(n):
            s, off = jax_seqpar._window_geometry(i, got.chunk, got.t_pad,
                                                 got.window, got.halo_l)
            assert got.geometry(i) == (int(s), int(off))


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("t,lengths", [
    (300, (300, 300)),  # full rows
    (513, (513, 200)),  # ragged: a row's mask crosses window boundaries
    (64, (64, 17)),  # short clip: windows degenerate to full decodes
])
def test_decode_matches_full_pass_and_jax(models, route, t, lengths):
    jgen, variables, model = models
    n = _n_devices()
    rng = np.random.default_rng(3)
    b = len(lengths)
    indices = rng.integers(0, 40, (b, t)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    got = seqpar.seq_parallel_decode(model, torch.from_numpy(indices),
                                     torch.from_numpy(lens), ["cpu"] * n,
                                     **ROUTES[route]).numpy()
    want_jax = np.asarray(jax_seqpar.seq_parallel_decode(
        jgen, variables, jnp.asarray(indices), jnp.asarray(lens),
        jax_seqpar.seq_mesh()))
    plan = seqpar.plan_seq_decode(t, n, TINY["kernel_sizes"], TINY["refiner_depth"])
    idx = torch.zeros((b, plan.t_pad), dtype=torch.int32)
    idx[:, :t] = torch.from_numpy(indices)
    pad = torch.arange(plan.t_pad)[None, :] >= torch.from_numpy(lens)[:, None]
    full = model.decode(idx, pad)[:, :t].numpy()
    for r in range(b):
        v = slice(0, lens[r])
        np.testing.assert_allclose(got[r, v], full[r, v], atol=FULL_TOL, rtol=FULL_TOL)
        np.testing.assert_allclose(got[r, v], want_jax[r, v], atol=JAX_TOL, rtol=JAX_TOL)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("t,lengths,windowed", [
    (512, (512, 512), True),  # full rows
    (512, (512, 300), True),  # ragged: one row's mask crosses windows
    (96, (96, 50), False),  # every window covers the whole padded clip
])
def test_reencode_matches_full_pass_and_jax(models, route, t, lengths, windowed):
    jgen, variables, model = models
    n = _n_devices()
    plan = seqpar.plan_seq_reencode(t, n, TINY["kernel_sizes"], TINY["refiner_depth"])
    assert (plan.window < plan.t_pad) == windowed
    mel = _clip(t, len(lengths), 11)
    lens = np.asarray(lengths, np.int32)
    idx, recon, post = (o.numpy() for o in seqpar.seq_parallel_reencode(
        model, torch.from_numpy(mel), torch.from_numpy(lens), ["cpu"] * n,
        return_recon=True, **ROUTES[route]))
    j_idx, j_recon, j_post = (np.asarray(o) for o in jax_seqpar.seq_parallel_reencode(
        jgen, variables, jnp.asarray(mel), jnp.asarray(lens), jax_seqpar.seq_mesh(),
        return_recon=True))
    f_idx, f_recon, f_post, near = _full(model, mel, lens, plan.t_pad)
    for r in range(len(lengths)):
        v = slice(0, lens[r])
        np.testing.assert_array_equal(idx[r, v], f_idx[r, v])
        np.testing.assert_allclose(post[r, v], f_post[r, v], atol=FULL_TOL, rtol=FULL_TOL)
        np.testing.assert_allclose(recon[r, v], f_recon[r, v], atol=FULL_TOL,
                                   rtol=FULL_TOL)
        far = ~near[r, v]
        np.testing.assert_array_equal(idx[r, v][far], j_idx[r, v][far])
        # this seeded input puts no token on a midpoint: the mels compare
        # everywhere
        assert far.all()
        np.testing.assert_allclose(post[r, v], j_post[r, v], atol=JAX_TOL, rtol=JAX_TOL)
        np.testing.assert_allclose(recon[r, v], j_recon[r, v], atol=JAX_TOL,
                                   rtol=JAX_TOL)


def test_the_windows_reduce_their_statistics(models):
    """The same windows with window-local CBAM statistics (no reduction)
    are not the full pass: the reduction is what makes them exact."""
    _, _, model = models
    t, lens = 512, np.asarray([512, 300], np.int32)
    mel = _clip(t, 2, 11)
    plan = seqpar.plan_seq_reencode(t, 8, TINY["kernel_sizes"], TINY["refiner_depth"])
    _, _, f_post, _ = _full(model, mel, lens, plan.t_pad)
    _, post = seqpar.seq_parallel_reencode(model, mel, lens, ["cpu"] * 8)
    local = seqpar._group_reduce
    try:
        seqpar._group_reduce = lambda *a: None
        _, post_local = seqpar.seq_parallel_reencode(model, mel, lens, ["cpu"] * 8)
    finally:
        seqpar._group_reduce = local
    assert np.abs(post.numpy()[0] - f_post[0]).max() <= FULL_TOL
    assert np.abs(post_local.numpy()[0] - f_post[0]).max() > 1e-3


@pytest.mark.parametrize("devices", [["cpu"], ["cpu"] * 3])
def test_one_device_or_mixed_groups_equal_the_full_pass(models, devices):
    _, _, model = models
    t, lens = 200, np.asarray([200, 77, 1], np.int32)
    mel = _clip(t, 3, 5)
    plan = seqpar.plan_seq_reencode(t, len(devices), TINY["kernel_sizes"],
                                    TINY["refiner_depth"])
    idx, post = seqpar.seq_parallel_reencode(model, mel, lens, devices)
    f_idx, _, f_post, _ = _full(model, mel, lens, plan.t_pad)
    for r in range(3):
        v = slice(0, lens[r])
        np.testing.assert_array_equal(idx.numpy()[r, v], f_idx[r, v])
        np.testing.assert_allclose(post.numpy()[r, v], f_post[r, v], atol=FULL_TOL,
                                   rtol=FULL_TOL)
    if len(devices) == 1:  # one window: the full pass itself
        np.testing.assert_array_equal(post.numpy(), f_post)


def test_poly_mixers_and_thread_errors_raise(models):
    _, _, model = models
    poly = PreEncoder(MEL, poly_mixers="decode", **TINY)
    with pytest.raises(ValueError, match="exact mixers"):
        seqpar.seq_parallel_decode(poly, np.zeros((1, 32), np.int32), [32], ["cpu"] * 2)

    def broken(*a, **kw):
        raise RuntimeError("a window failed")

    groups = [(torch.device("cpu"), [0]), (torch.device("cpu"), [1])]

    def fn(g, device, wins, meet):
        if g == 1:
            broken()
        return meet(g, torch.zeros(1, 2), torch.zeros(1, 2))

    with pytest.raises(RuntimeError, match="a window failed"):
        seqpar._run_groups(groups, fn)


def _block_case(cin, cout, k, seed):
    blk = seeded_init_(ResidualBlock1D(cin, cout, k), seed)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.endswith("bias") or name.endswith(".g"):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(seed)))
    return blk.eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,k", [(16, 16, 3), (16, 24, 5)])
def test_split_plain_block_with_no_reduction_is_the_block(cin, cout, k, dtype):
    blk = _block_case(cin, cout, k, 1)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((3, 37, cin), generator=g).to(dtype)
    lens = torch.tensor([37, 20, 1], dtype=torch.int32)
    w = blk.kernel_weights(dtype)
    want = residual_block_plain(x, lens, w, causal=False)
    res, z, part = residual_block_plain_begin(x, lens, w, torch.zeros_like(lens), lens)
    got = residual_block_plain_finish(x, lens, w, res, z, part, lens.float())
    assert torch.equal(got, want)
    split = split_residual_block(x, lens, w, torch.zeros_like(lens), lens, None)
    assert torch.equal(split, want)


@pytest.mark.parametrize("module_path", [False, True])
def test_split_block_over_windows_is_the_full_block(module_path):
    """A block over n halo'd windows of a clip, each pooling its interior's
    valid frames and the windows' statistics reduced, equals the block over
    the whole clip on the interiors: through the block's kernel entry (its
    plain version here) and through the CBAM modules (the training branch's
    composition)."""
    cin, cout, k, n, chunk, halo = 16, 24, 5, 4, 40, 16
    blk = _block_case(cin, cout, k, 3)
    t = n * chunk
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, t, cin), generator=g)
    x[:, t // 3:t // 3 + 20] += 3.0
    lens = torch.tensor([t, 97])
    pad = torch.arange(t)[None, :] >= lens[:, None]
    with torch.no_grad():
        want = blk(x, pad, deterministic=not module_path)
        wins, masks, stats = [], [], []
        w = chunk + 2 * halo
        starts = [min(max(i * chunk - halo, 0), t - w) for i in range(n)]
        local = torch.arange(w)
        for i, s in enumerate(starts):
            off = i * chunk - s
            wins.append(x[:, s:s + w])
            m = (s + local)[None, :] >= lens[:, None]
            masks.append(m)
            interior = (local >= off) & (local < off + chunk)
            stats.append(m | ~interior[None, :])
        got = blk(torch.cat(wins), torch.cat(masks), not module_path,
                  stats_mask=torch.cat(stats),
                  reduce=seqpar._group_reduce(n, 2, None, 0))
    for i, s in enumerate(starts):
        off = i * chunk - s
        keep = got[2 * i:2 * i + 2, off:off + chunk]
        ref = want[:, i * chunk:(i + 1) * chunk]
        valid = ~pad[:, i * chunk:(i + 1) * chunk]
        torch.testing.assert_close(keep[valid], ref[valid], atol=FULL_TOL,
                                   rtol=FULL_TOL)


def test_cam_stats_mask_matches_jax():
    """The channel gate with a stats mask (one window, no reduction) against
    JAX's CAM1D with the same stats_mask."""
    b, t, c = 2, 29, 16
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    pad = np.arange(t)[None, :] >= np.array([[t], [11]])
    stats = pad | (np.arange(t)[None, :] < 5)
    jmod = JaxCAM1D(channels=c)
    tree = perturb(to_numpy_tree(jmod.init(jax.random.key(1), jnp.asarray(x),
                                           jnp.asarray(pad))), rng)
    want = np.asarray(jmod.apply({"params": tree}, jnp.asarray(x), jnp.asarray(pad),
                                 jnp.asarray(stats)))
    mod = CAM1D(c)
    mod.load_state_dict(state_dict_from_jax(tree, mod))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(pad), torch.from_numpy(stats))
    np.testing.assert_allclose(got.numpy(), want, atol=FULL_TOL, rtol=FULL_TOL)


def test_causal_blocks_have_no_split():
    blk = ResidualBlock1D(8, 8, 3, causal=True)
    x = torch.zeros((1, 8, 8))
    stats = torch.zeros((1, 8), dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="causal CAM"):
        blk(x, stats_mask=stats)
