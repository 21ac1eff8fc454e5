"""PyTorch port: vocoder training against the JAX package on the CPU (fp32).

The general weight-normed convs (strided, grouped, (k, 1)), the
multi-resolution STFT loss and its gradient, the MPD/MSD discriminators and
their three losses on bridged weights, the generator's spectral-loss
gradients, three spectral and three adversarial steps against the JAX step
functions (and the NaN skip), the segment sampler, the trainer CLI and its
exported artifact. Tolerances are stated beside each check."""

import copy
import functools
import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mqgan_tpu.core.config import SpecConfig as JaxSpecConfig
from mqgan_tpu.losses import stft_loss as jloss
from mqgan_tpu.models.istft_vocoder import ISTFTNetGenerator as JaxGenerator
from mqgan_tpu.models import wave_discriminators as jwd
from mqgan_tpu.nn.conv import WNConv as JaxWNConv
from mqgan_tpu.signal.stft import istft as jax_istft
from mqgan_tpu.train import vocoder_trainer as jvt
from mqgan_tpu_torch.core.config import SpecConfig
from mqgan_tpu_torch.losses import stft_loss as ploss
from mqgan_tpu_torch.models import wave_discriminators as pwd
from mqgan_tpu_torch.models.istft_vocoder import ISTFTNetGenerator, build_vocoder_fe
from mqgan_tpu_torch.nn.conv import WNConv1d, WNConv2d
from mqgan_tpu_torch.signal.stft import istft, istft_ola
from mqgan_tpu_torch.signal.vocoder import ISTFTNetFE
from mqgan_tpu_torch.train import vocoder_trainer as pvt
from mqgan_tpu_torch.train.state import ClipAdamW
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import max_err, perturb, to_numpy_tree
from tests.test_torch_gan_step import _recording

# the CLI test's sizes (tests/test_istft_vocoder.py): 16 kHz, n_fft 256,
# hop 64, 16 mels; generator 4 x 4 upsampling from 16 channels, iSTFT n_fft 8
SR, HOP, N_MELS = 16000, 64, 16
SPEC = dict(sampling_rate=SR, filter_length=256, hop_length=HOP, win_length=256,
            n_mel_channels=N_MELS, mel_fmin=0.0, mel_fmax=8000.0)
GEN = dict(n_mels=N_MELS, upsample_rates=(4, 4), upsample_kernel_sizes=(9, 9),
           upsample_initial_channel=16, istft_n_fft=8)
ISTFT_HOP = HOP // 16
FRAMES = 16
TARGET = FRAMES * HOP
LR = 1e-4
PERIODS, SCALES = (2, 3), 2


def _tol(want, rel=1e-5):
    return rel * max(1.0, float(np.max(np.abs(want))))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- general weight-normed convs ------------------------------------------

CONV_CASES = {
    # name: (kernel, strides, padding, groups, in, out, x shape)
    "1d_strided": ((15,), (2,), [(7, 7)], 1, 3, 8, (2, 41, 3)),
    "1d_grouped": ((41,), (4,), [(20, 20)], 4, 8, 16, (2, 67, 8)),
    "1d_asymmetric": ((5,), (1,), [(3, 1)], 2, 4, 6, (1, 20, 4)),
    "2d_k1": ((5, 1), (3, 1), [(2, 2), (0, 0)], 1, 2, 5, (2, 31, 3, 2)),
    "2d_post": ((3, 1), (1, 1), [(1, 1), (0, 0)], 1, 4, 1, (2, 9, 5, 4)),
    "2d_asymmetric": ((3, 2), (2, 1), [(0, 2), (1, 0)], 2, 4, 6, (1, 11, 7, 4)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_wnconv_general_matches_jax(case, rng):
    """Stride, groups and explicit (lo, hi) padding against JAX's WNConv
    (jax.lax.conv_general_dilated): 1e-5 * max(1, max|y|)."""
    k, s, pad, g, cin, cout, shape = CONV_CASES[case]
    conv = JaxWNConv(cout, k, strides=s, padding=pad, feature_group_count=g,
                     use_weight_norm=True)
    x = rng.standard_normal(shape).astype(np.float32)
    params = perturb(to_numpy_tree(conv.init(jax.random.key(0), jnp.asarray(x))), rng)
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    if len(k) == 1:
        port = WNConv1d(cin, cout, k[0], stride=s[0], groups=g, padding=pad[0])
        port.load_state_dict(state_dict_from_jax(params, port))
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
            nct = port.conv_nct(torch.from_numpy(x).transpose(1, 2)).numpy()
        np.testing.assert_array_equal(nct.transpose(0, 2, 1), got)
    else:
        port = WNConv2d(cin, cout, k, stride=s, groups=g, padding=pad)
        port.load_state_dict(state_dict_from_jax(params, port))
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    print(f"{case}: {got.shape}, max err {max_err(got, want):.2e}")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=_tol(want), rtol=0)


# --- the multi-resolution STFT loss ----------------------------------------

def _signals(kind, rng, t=4096):
    pred = rng.standard_normal((2, t)).astype(np.float32)
    true = rng.standard_normal((2, t)).astype(np.float32)
    if kind == "silent_stretch":
        # silence in both over a stretch longer than the largest window:
        # |STFT| is exactly 0 on frames inside it
        pred[:, 1000:3600] = 0.0
        true[:, 1000:3600] = 0.0
    return pred, true


@pytest.mark.parametrize("kind", ["noise", "silent_stretch"])
def test_mr_stft_loss_matches_jax(kind, rng):
    """Each term at each resolution and the total: 1e-5 relative; the
    gradient with respect to the prediction: 1e-4 * max(1, max|g|)."""
    pred, true = _signals(kind, rng)
    jp, jt = jnp.asarray(pred), jnp.asarray(true)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(true)
    for n_fft, hop, win in ploss.DEFAULT_RESOLUTIONS:
        jmp, jmt = jloss._stft_mag(jp, n_fft, hop, win), jloss._stft_mag(jt, n_fft, hop, win)
        pmp, pmt = ploss._stft_mag(tp, n_fft, hop, win), ploss._stft_mag(tt, n_fft, hop, win)
        if kind == "silent_stretch":
            assert float((pmt == 0).sum()) > 0 and float((jmt == 0).sum()) > 0
        for name in ("spectral_convergence", "log_magnitude_l1"):
            want = float(getattr(jloss, name)(jmp, jmt))
            got = float(getattr(ploss, name)(pmp, pmt))
            assert abs(got - want) <= 1e-5 * abs(want), (name, n_fft, got, want)
    want = float(jloss.multi_resolution_stft_loss(jp, jt))
    got = float(ploss.multi_resolution_stft_loss(tp, tt))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    jg = np.asarray(jax.grad(lambda a: jloss.multi_resolution_stft_loss(a, jt))(jp))
    tp.requires_grad_(True)
    ploss.multi_resolution_stft_loss(tp, tt).backward()
    pg = tp.grad.numpy()
    print(f"{kind}: loss {got:.6f} vs {want:.6f}, grad max err {max_err(pg, jg):.2e}")
    np.testing.assert_allclose(pg, jg, atol=_tol(jg, 1e-4), rtol=0)
    if kind == "silent_stretch":
        # no NaN from |0|, and both frameworks agree where it is 0
        assert np.isfinite(pg).all()


def test_istft_ola_equals_torch_istft(rng):
    """The training path's overlap-add gives the inference wrapper's
    torch.istft output (1e-6 * max(1, max|x|)), also at the flagship
    iSTFT's n_fft 16 and hop 8."""
    for n_fft, hop, frames in ((8, 4, 33), (16, 8, 64), (2048, 512, 9)):
        mag = torch.from_numpy(rng.random((2, n_fft // 2 + 1, frames)).astype(np.float32))
        ph = torch.from_numpy(rng.standard_normal(mag.shape).astype(np.float32))
        want = istft(mag, ph, n_fft, hop, n_fft)[:, 0].numpy()
        got = istft_ola(mag, ph, n_fft, hop, n_fft).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=_tol(want, 1e-6), rtol=0)


# --- the discriminators -----------------------------------------------------

def _jax_discs(t, seed=0):
    """(MPD, its params, MSD, its params), initialised once per (t, seed)
    in this file's process; the trees are the caller's own copies."""
    mpd, mp, msd, sp = _jax_discs_once(t, seed)
    return mpd, copy.deepcopy(mp), msd, copy.deepcopy(sp)


@functools.lru_cache(maxsize=None)
def _jax_discs_once(t, seed):
    mpd = jwd.MultiPeriodDiscriminator(periods=PERIODS)
    msd = jwd.MultiScaleDiscriminator(n_scales=SCALES)
    wav = jnp.zeros((2, t))
    rng = np.random.default_rng(seed)
    mp = perturb(to_numpy_tree(jax.jit(mpd.init)(jax.random.key(1), wav)), rng)
    sp = perturb(to_numpy_tree(jax.jit(msd.init)(jax.random.key(2), wav)), rng)
    return mpd, mp, msd, sp


def _port_discs(mp, sp):
    mpd = pwd.MultiPeriodDiscriminator(periods=PERIODS)
    msd = pwd.MultiScaleDiscriminator(n_scales=SCALES)
    mpd.load_state_dict(state_dict_from_jax(mp, mpd))
    msd.load_state_dict(state_dict_from_jax(sp, msd))
    return mpd, msd


@pytest.mark.parametrize("t", [1001, 1023])
def test_discriminators_match_jax(t, rng):
    """T = 1001 and 1023: not divisible by 2 or 3 (1001 by 3 only through
    the reflection of 1 sample), odd for the MSD's pair means. Logits and
    every feature map 1e-4 * max(1, max|x|); the three losses 1e-6
    relative."""
    jmpd, mp, jmsd, sp = _jax_discs(t)
    mpd, msd = _port_discs(mp, sp)
    real = rng.standard_normal((2, t)).astype(np.float32)
    fake = (0.5 * rng.standard_normal((2, t))).astype(np.float32)
    jout, pout = {}, {}
    mpd_apply, msd_apply = jax.jit(jmpd.apply), jax.jit(jmsd.apply)  # one compile each
    for name, x in (("real", real), ("fake", fake)):
        jo, jf = mpd_apply({"params": mp}, jnp.asarray(x))
        jo2, jf2 = msd_apply({"params": sp}, jnp.asarray(x))
        with torch.no_grad():
            po, pf = mpd(torch.from_numpy(x))
            po2, pf2 = msd(torch.from_numpy(x))
        jout[name], pout[name] = (jo, jf, jo2, jf2), (po, pf, po2, pf2)
        worst = 0.0
        for jl, pl in ((jf, pf), (jf2, pf2)):
            for jlayers, players in zip(jl, pl):
                assert len(jlayers) == len(players)
                for a, b in zip(jlayers, players):
                    a = np.asarray(a)
                    b = b.numpy()
                    b = (b.transpose(0, 2, 3, 1) if b.ndim == 4 else b.transpose(0, 2, 1))
                    assert b.shape == a.shape
                    worst = max(worst, max_err(b, a))
                    np.testing.assert_allclose(b, a, atol=_tol(a, 1e-4), rtol=0)
        print(f"T={t} {name}: feature maps and logits max err {worst:.2e}")
    jr, pr = jout["real"], pout["real"]
    jfk, pfk = jout["fake"], pout["fake"]
    pairs = (
        (jwd.adversarial_d_loss([jr[0], jr[2]], [jfk[0], jfk[2]]),
         pwd.adversarial_d_loss([pr[0], pr[2]], [pfk[0], pfk[2]])),
        (jwd.adversarial_g_loss([jfk[0], jfk[2]]),
         pwd.adversarial_g_loss([pfk[0], pfk[2]])),
        (jwd.feature_matching_loss([*jr[1], *jr[3]], [*jfk[1], *jfk[3]]),
         pwd.feature_matching_loss([*pr[1], *pr[3]], [*pfk[1], *pfk[3]])),
    )
    for want, got in pairs:
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want)), (got, want)


# --- the generator's spectral-loss gradients --------------------------------

def _jax_gen(seed=0, **kw):
    """(JAX generator, its perturbed params), initialised once per (seed,
    kw) in this file's process; the tree is the caller's own copy."""
    gen, tree = _jax_gen_once(seed, tuple(sorted(kw.items())))
    return gen, copy.deepcopy(tree)


@functools.lru_cache(maxsize=None)
def _jax_gen_once(seed, kw):
    gen = JaxGenerator(**GEN, **dict(kw))
    params = jax.jit(gen.init)(jax.random.key(seed), jnp.zeros((2, N_MELS, FRAMES)))
    return gen, perturb(to_numpy_tree(params), np.random.default_rng(seed))


def _port_gen(tree):
    gen = ISTFTNetGenerator(**GEN)
    gen.load_state_dict(state_dict_from_jax(tree, gen))
    return gen


def _batch(rng, b=2):
    mel = rng.standard_normal((b, N_MELS, FRAMES)).astype(np.float32)
    t = np.arange(TARGET) / SR
    wav = np.stack([0.3 * np.sin(2 * np.pi * (220 + 110 * i) * t)
                    + 0.05 * rng.standard_normal(TARGET) for i in range(b)])
    return mel, wav.astype(np.float32)


def _jax_spectral(gen, tx, wav_l1_lambda=0.0):
    """The JAX trainer's spectral step (its main's loss_fn and step)."""
    def loss_fn(p, mel, wav):
        spec, phase = gen.apply(p, mel)
        pred = jax_istft(spec, phase, GEN["istft_n_fft"], ISTFT_HOP,
                         GEN["istft_n_fft"])[:, 0, :]
        n = min(pred.shape[1], TARGET)
        loss = jloss.multi_resolution_stft_loss(pred[:, :n], wav[:, :n])
        if wav_l1_lambda:
            loss = loss + wav_l1_lambda * jnp.mean(jnp.abs(pred[:, :n] - wav[:, :n]))
        return loss

    @jax.jit
    def step(p, o, mel, wav):
        loss, grads = jax.value_and_grad(loss_fn)(p, mel, wav)
        ok = jnp.isfinite(loss)
        grads = jax.tree.map(lambda g: jnp.where(ok, g, jnp.zeros_like(g)), grads)
        updates, o2 = tx.update(grads, o, p)
        p2 = optax.apply_updates(p, updates)
        keep = lambda new, old: jnp.where(ok, new, old)
        return jax.tree.map(keep, p2, p), jax.tree.map(keep, o2, o), loss

    return loss_fn, step


def test_generator_spectral_gradients_match_jax(rng):
    """The spectral loss on bridged weights within 1e-5 relative, and the
    generator + iSTFT backward (the chain of the loss's gradient) of a
    seeded normal cotangent within 1e-4 * max(1, max|g|) of JAX's vjp.
    The loss's own dL/dpred is held on noise in
    test_mr_stft_loss_matches_jax: at a generator's output it is
    ill-conditioned, because the log-magnitude term's gradient at a
    near-0 |STFT| bin is sign(.) / (N |X|) along X / |X|, a direction that
    rounding sets (ROADMAP.md Queue 3)."""
    jgen, tree = _jax_gen()
    gen = _port_gen(tree)
    mel, wav = _batch(rng)
    n_fft = GEN["istft_n_fft"]

    def jsynth(p):
        spec, phase = jgen.apply(p, jnp.asarray(mel))
        return jax_istft(spec, phase, n_fft, ISTFT_HOP, n_fft)[:, 0, :TARGET]

    jpred, vjp = jax.vjp(jsynth, {"params": tree})
    jl = jloss.multi_resolution_stft_loss(jpred, jnp.asarray(wav)[:, : jpred.shape[1]])
    cot = rng.standard_normal(jpred.shape).astype(np.float32)
    want = state_dict_from_jax(to_numpy_tree(vjp(jnp.asarray(cot))[0]), gen)
    pred = pvt.synth(gen, torch.from_numpy(mel), n_fft, ISTFT_HOP)[:, :TARGET]
    loss = ploss.multi_resolution_stft_loss(pred.detach(),
                                            torch.from_numpy(wav)[:, : pred.shape[1]])
    grads = dict(zip([k for k, _ in gen.named_parameters()],
                     torch.autograd.grad(pred, list(gen.parameters()),
                                         torch.from_numpy(cot))))
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    g_max = max(float(v.abs().max()) for v in want.values())
    worst = max(max_err(grads[k], v) for k, v in want.items())
    print(f"spectral loss {float(loss):.6f}; gradients max err {worst:.2e} "
          f"(max|g| {g_max:.2e})")
    assert set(grads) == set(want)
    assert worst <= 1e-4 * max(1.0, g_max)


class _RecordingAdamW(ClipAdamW):
    """ClipAdamW that keeps the gradients of its first update."""

    first = None

    def step_(self, params, grads, state, ok):
        if self.first is None:
            self.first = [g.detach().clone() for g in grads]
        super().step_(params, grads, state, ok)


# --- steps against the JAX step functions -----------------------------------

def _sync(models, trees, opt_pairs):
    """Give the port JAX's state before a step: each model's weights, and
    each optimizer's count and moments (optax's ScaleByAdamState)."""
    for m, tree in zip(models, trees):
        m.load_state_dict(state_dict_from_jax(to_numpy_tree(tree), m))
    for (port_state, sub_models), (jstate, sub_trees) in opt_pairs:
        adam = jstate[0]
        port_state["count"] = torch.tensor(int(adam.count), dtype=torch.int32)
        for key in ("mu", "nu"):
            flat = []
            for m, path in zip(sub_models, sub_trees):
                sd = state_dict_from_jax(to_numpy_tree(path(getattr(adam, key))), m)
                flat += [sd[k] for k, _ in m.named_parameters()]
            for dst, src in zip(port_state[key], flat):
                dst.copy_(src)


def _update_gate(model, before, want_after, jax_grads, port_grads, what):
    """One step's update (after - before) of each weight within LR / 10 of
    JAX's where the step's gradient is live: above 1e-4 * max(1, max|g|),
    and the two sides agree on it to 5% (else Adam's update of it can
    differ by more than LR / 10: the MR-STFT's gradient is set by rounding
    at near-0 |STFT| bins, test_generator_spectral_gradients_match_jax).
    Elsewhere within 2.01 LR (Adam's bias-corrected step is at most 1.0014
    LR in a run's first steps, plus the weight decay). Returns (largest
    live difference, contested count)."""
    port_grads = dict(zip([k for k, _ in model.named_parameters()], port_grads))
    g_max = max(float(g.abs().max()) for g in jax_grads.values())
    worst = rest = 0.0
    n_live = n_contested = 0
    for k, p in model.named_parameters():
        g = jax_grads[k]
        above = g.abs() > 1e-4 * max(1.0, g_max)
        contested = above & (g.abs() * 0.05 < (port_grads[k] - g).abs())
        live = above & ~contested
        n_live += int(live.sum())
        n_contested += int(contested.sum())
        d = ((p.detach() - before[k]) - (want_after[k] - before[k])).abs()
        if live.any():
            worst = max(worst, float(d[live].max()))
        if (~live).any():
            rest = max(rest, float(d[~live].max()))
    assert n_live > 0, what
    assert worst <= LR / 10, (what, worst)
    assert rest <= 2.01 * LR, (what, rest)
    return worst, n_contested


class _RecordingAdamW(ClipAdamW):
    """ClipAdamW that keeps the gradients of its last update."""

    last = None

    def step_(self, params, grads, state, ok):
        self.last = [g.detach().clone() for g in grads]
        super().step_(params, grads, state, ok)


def _weights(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("wav_l1_lambda", [0.0, 0.5])
def test_three_spectral_steps_match_jax(wav_l1_lambda, rng):
    """Three spectral steps at lr 1e-4, each from JAX's state (weights,
    count and moments given to the port before the step, so that no
    contested update carries into the next step's loss): the loss within
    1e-5 relative; the update within lr / 10 of JAX's where live
    (_update_gate)."""
    store = {}
    jgen, tree = _jax_gen()
    gen = _port_gen(tree)
    jtx = _recording(optax.adamw(LR), store, "gen")
    _, jstep = _jax_spectral(jgen, jtx, wav_l1_lambda)
    jp = {"params": jax.tree.map(jnp.asarray, tree)}
    jo = jtx.init(jp)
    tx = _RecordingAdamW(LR, float("inf"))
    st = tx.init(gen.parameters())
    step = pvt.make_spectral_step(gen, tx, st, n_fft=GEN["istft_n_fft"],
                                  istft_hop=ISTFT_HOP, target_len=TARGET,
                                  wav_l1_lambda=wav_l1_lambda)
    report = []
    for i in range(3):
        mel, wav = _batch(rng)
        _sync([gen], [jp["params"]], [((st, [gen]), (jo, [lambda t: t["params"]]))])
        before = _weights(gen)
        jp, jo, jl = jstep(jp, jo, jnp.asarray(mel), jnp.asarray(wav))
        jax.effects_barrier()
        pl = step(torch.from_numpy(mel), torch.from_numpy(wav))
        assert int(st["count"]) == i + 1
        assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl)), (i, float(pl), float(jl))
        report.append(_update_gate(
            gen, before, state_dict_from_jax(to_numpy_tree(jp["params"]), gen),
            state_dict_from_jax(to_numpy_tree(store["gen"]["params"]), gen),
            tx.last, f"generator, step {i + 1}"))
    print(f"three spectral steps (wav L1 {wav_l1_lambda}): per step live update "
          f"max|d| and contested weights {report} (lr/10 = {LR / 10:.1e})")


def test_three_adversarial_steps_match_jax(rng):
    """Three steps of JAX's make_adv_step against the port's at lr 1e-4,
    each from JAX's state (the generator's and both discriminators'
    weights, both optimizers' counts and moments): every loss within 1e-5
    relative; each model's update within lr / 10 of JAX's where live
    (_update_gate)."""
    store = {}
    jgen, tree = _jax_gen()
    jmpd, mp, jmsd, sp = _jax_discs(TARGET)
    gen = _port_gen(tree)
    mpd, msd = _port_discs(mp, sp)
    jtx, jdtx = (_recording(optax.adamw(LR), store, "gen"),
                 _recording(optax.adamw(LR), store, "disc"))
    jfn = jax.jit(jvt.make_adv_step(jgen, jmpd, jmsd, jtx, jdtx,
                                    n_fft=GEN["istft_n_fft"], istft_hop=ISTFT_HOP,
                                    target_len=TARGET))
    jp = {"params": jax.tree.map(jnp.asarray, tree)}
    jdp = {"mpd": jax.tree.map(jnp.asarray, mp), "msd": jax.tree.map(jnp.asarray, sp)}
    jo, jdo = jtx.init(jp), jdtx.init(jdp)
    tx, dtx = _RecordingAdamW(LR, float("inf")), _RecordingAdamW(LR, float("inf"))
    st = tx.init(gen.parameters())
    dst = dtx.init(list(mpd.parameters()) + list(msd.parameters()))
    step = pvt.make_adv_step(gen, mpd, msd, tx, dtx, st, dst, n_fft=GEN["istft_n_fft"],
                             istft_hop=ISTFT_HOP, target_len=TARGET)
    n_mpd = len(list(mpd.parameters()))
    report = []
    for i in range(3):
        mel, wav = _batch(rng)
        _sync([gen, mpd, msd], [jp["params"], jdp["mpd"], jdp["msd"]],
              [((st, [gen]), (jo, [lambda t: t["params"]])),
               ((dst, [mpd, msd]), (jdo, [lambda t: t["mpd"], lambda t: t["msd"]]))])
        before = {name: _weights(m) for name, m in (("gen", gen), ("mpd", mpd), ("msd", msd))}
        jp, jo, jdp, jdo, jm = jfn(jp, jo, jdp, jdo, jnp.asarray(mel), jnp.asarray(wav))
        jax.effects_barrier()
        pm = step(torch.from_numpy(mel), torch.from_numpy(wav))
        for k, v in jax.device_get(jm).items():
            assert abs(float(pm[k]) - float(v)) <= 1e-5 * abs(float(v)), (i, k, pm[k], v)
        row = {"gen": _update_gate(
            gen, before["gen"], state_dict_from_jax(to_numpy_tree(jp["params"]), gen),
            state_dict_from_jax(to_numpy_tree(store["gen"]["params"]), gen), tx.last,
            f"generator, step {i + 1}")}
        for name, m, port_g in (("mpd", mpd, dtx.last[:n_mpd]),
                                ("msd", msd, dtx.last[n_mpd:])):
            row[name] = _update_gate(
                m, before[name], state_dict_from_jax(to_numpy_tree(jdp[name]), m),
                state_dict_from_jax(to_numpy_tree(store["disc"][name]), m), port_g,
                f"{name}, step {i + 1}")
        report.append(row)
    print(f"three adversarial steps: per step live update max|d| and contested "
          f"weights {report} (lr/10 = {LR / 10:.1e})")


def test_nan_skip_keeps_params_and_moments(rng):
    """A non-finite loss leaves each model's parameters and both moments
    bit-equal (and the count), for the spectral and the adversarial step."""
    _, tree = _jax_gen()
    _, mp, _, sp = _jax_discs(TARGET)
    gen = _port_gen(tree)
    mpd, msd = _port_discs(mp, sp)
    tx, dtx = ClipAdamW(LR, float("inf")), ClipAdamW(LR, float("inf"))
    st = tx.init(gen.parameters())
    dst = dtx.init(list(mpd.parameters()) + list(msd.parameters()))
    kw = dict(n_fft=GEN["istft_n_fft"], istft_hop=ISTFT_HOP, target_len=TARGET)
    spectral = pvt.make_spectral_step(gen, tx, st, **kw)
    adv = pvt.make_adv_step(gen, mpd, msd, tx, dtx, st, dst, **kw)
    mel, wav = (torch.from_numpy(a) for a in _batch(rng))
    spectral(mel, wav)  # one good step: moments are not 0

    def snapshot():
        return ([p.detach().clone() for m in (gen, mpd, msd) for p in m.parameters()],
                [t.clone() for s in (st, dst) for t in s["mu"] + s["nu"]],
                (int(st["count"]), int(dst["count"])))

    before = snapshot()
    bad = wav.clone()
    bad[0, 5] = float("nan")
    assert not torch.isfinite(spectral(mel, bad))
    m = adv(mel, bad)
    assert not torch.isfinite(m["g_total"]) and not torch.isfinite(m["d_loss"])
    after = snapshot()
    assert after[2] == before[2] == (1, 0)
    for a, b in zip(before[0] + before[1], after[0] + after[1]):
        assert torch.equal(a, b)


# --- the data path and the CLI ----------------------------------------------

def _write_wavs(root, n=3, seconds=1.0, silent=False, noise=0.0):
    os.makedirs(root, exist_ok=True)
    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.default_rng(5)
    for i in range(n):
        x = 0.3 * np.sin(2 * np.pi * (200 + 100 * i) * t)
        x = x + noise * rng.standard_normal(t.shape)
        if silent and i == 0:
            x[: SR // 4] = 0.0
        with wave.open(os.path.join(root, f"c{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes((x * 32767).astype(np.int16).tobytes())
    return root


def test_segment_sampler_draws_jax_segments(tmp_path):
    """The same seed gives JAX's segments (bit-equal samples) and mels
    within 5e-4, trimmed to segment_frames, over three batches. The clips
    are sines with 5% noise and a silent start: a pure sine's high mel
    bands sit near fp32 rounding of its peak, where the log domain is
    ill-conditioned in either package (ROADMAP.md Queue 3)."""
    _write_wavs(str(tmp_path), n=3, silent=True, noise=0.05)
    files = pvt.find_wavs(str(tmp_path))
    assert files == jvt.find_wavs(str(tmp_path)) and len(files) == 3
    jcfg = JaxSpecConfig.from_dict({"spectrogram": SPEC})
    js = jvt.SegmentSampler(files, jcfg, FRAMES, seed=7)
    ps = pvt.SegmentSampler(files, SpecConfig.from_dict({"spectrogram": SPEC}),
                            FRAMES, seed=7, device="cpu")
    for _ in range(3):
        jmel, jwav = js.batch(4)
        pmel, pwav = ps.batch(4)
        np.testing.assert_array_equal(pwav.numpy(), np.asarray(jwav))
        assert pmel.shape == jmel.shape == (4, N_MELS, FRAMES)
        np.testing.assert_allclose(pmel.numpy(), np.asarray(jmel), atol=5e-4, rtol=0)


JAX_METRIC_KEYS = {"vocoder/loss", "steps_per_sec", "_time", "_step"}
JAX_ADV_KEYS = JAX_METRIC_KEYS | {f"vocoder/{k}" for k in
                                  ("g_total", "stft", "adv", "fm", "d_loss")}


def _cli(tmp_path, wav_dir, out, *extra):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"io": {"input_folder": "x", "output_folder": "y"},
                                "spectrogram": SPEC}))
    return pvt.main(["--wav_dir", wav_dir, "--spec_config", str(spec),
                     "--out_dir", str(out), "--batch_size", "2",
                     "--segment_frames", str(FRAMES), "--upsample_rates", "4", "4",
                     "--istft_n_fft", "8", "--upsample_initial_channel", "16",
                     "--device", "cpu", *extra])


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("bf16", [False, True])
def test_vocoder_trainer_cli_spectral_and_export(tmp_path, rng, bf16):
    """The JAX CLI test's spectral run: finite, falling losses, the JAX
    metric keys, the checkpoint; --export_dir -> ISTFTNetFE.load_ts vocodes
    10 and 23 frames as the in-memory wrapper does (1e-5 * max(1, max|x|))."""
    wav_dir = _write_wavs(str(tmp_path / "wavs"))
    out, exp = tmp_path / "run", tmp_path / "voc_export"
    gen = _cli(tmp_path, wav_dir, out, "--steps", "12", "--log_every", "4",
               "--save_every", "12", "--export_dir", str(exp),
               *(["--bf16"] if bf16 else []))
    recs = _records(out / "vocoder_metrics.jsonl")
    assert [r["_step"] for r in recs] == [1, 4, 8, 12]
    assert all(set(r) == JAX_METRIC_KEYS for r in recs)
    losses = [r["vocoder/loss"] for r in recs]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert sorted(os.listdir(out)) == ["vocoder_metrics.jsonl", "vocoder_step_12.pt"]
    saved = torch.load(out / "vocoder_step_12.pt", weights_only=True)
    assert set(saved) == set(gen.state_dict())
    fe = ISTFTNetFE.load_ts(str(exp), device="cpu")
    assert fe.sampling_rate == SR and fe.gen.dtype == (torch.bfloat16 if bf16 else None)
    mem = build_vocoder_fe(gen, ISTFT_HOP)
    for t_frames in (10, 23):
        mel = rng.standard_normal((1, N_MELS, t_frames)).astype(np.float32)
        got, want = fe(mel).numpy(), mem(mel).numpy()
        assert got.shape[:2] == (1, 1) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=_tol(want), rtol=0)


def test_vocoder_trainer_cli_adversarial(tmp_path):
    """The JAX CLI test's adversarial run: the discriminators join after
    step 3, every loss finite and logged under the JAX keys, both
    checkpoints written."""
    wav_dir = _write_wavs(str(tmp_path / "wavs"), n=1)
    out = tmp_path / "run_adv"
    _cli(tmp_path, wav_dir, out, "--steps", "6", "--log_every", "1",
         "--save_every", "6", "--adversarial", "--adv_start_step", "3",
         "--mpd_periods", "2", "3", "--msd_scales", "2")
    recs = _records(out / "vocoder_metrics.jsonl")
    assert [set(r) for r in recs] == [JAX_METRIC_KEYS] * 3 + [JAX_ADV_KEYS] * 3
    assert all(np.isfinite(v) for r in recs for v in r.values())
    spectral = [r["vocoder/loss"] for r in recs[:3]]
    assert spectral[-1] < spectral[0]
    assert sorted(os.listdir(out)) == ["vocoder_disc_step_6.pt",
                                       "vocoder_metrics.jsonl", "vocoder_step_6.pt"]
    disc = torch.load(out / "vocoder_disc_step_6.pt", weights_only=True)
    assert any(k.startswith("mpd.period_3.") for k in disc)
    assert any(k.startswith("msd.scale_1.") for k in disc)


def test_load_ts_refuses_a_jax_artifact(tmp_path):
    """A JAX artifact (config.json + istft_gen.shlo) names its program."""
    (tmp_path / "config.json").write_text(json.dumps({
        "gen_istft_n_fft": 16, "gen_istft_hop_size": 8, "gen_istft_win_length": 16,
        "sampling_rate": 44100, "mel_channels": 128}))
    (tmp_path / "istft_gen.shlo").write_bytes(b"\0")
    with pytest.raises(ValueError, match="istft_gen.shlo"):
        ISTFTNetFE.load_ts(str(tmp_path), device="cpu")


def test_generator_trains_and_infers_without_grad(rng):
    """The forward is differentiable; the wrapper's inference is not."""
    _, tree = _jax_gen()
    gen = _port_gen(tree)
    mel = torch.from_numpy(rng.standard_normal((1, N_MELS, 5)).astype(np.float32))
    spec, phase = gen(mel)
    assert spec.requires_grad and phase.requires_grad
    wav = build_vocoder_fe(gen, ISTFT_HOP)(mel)
    assert not wav.requires_grad
