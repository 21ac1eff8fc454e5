"""PyTorch port: the vocoders (iSTFTNet generator and its ISTFTNetFE
wrapper, Griffin-Lim), the dilated WNConv1d, and the whole audio slice
wav -> log-mel -> FSQ tokens -> refined mel -> wav, against the JAX package
on the CPU (fp32)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.config import SpectrogramConfig as JaxSpectrogramConfig
from mqgan_tpu.models.istft_vocoder import ISTFTNetGenerator as JaxGenerator
from mqgan_tpu.models.istft_vocoder import build_vocoder_fe as jax_build_vocoder_fe
from mqgan_tpu.models.preencoder import PreEncoder as JaxPreEncoder
from mqgan_tpu.nn.conv import conv1d as jax_conv1d
from mqgan_tpu.quant.fsq import bound
from mqgan_tpu.signal import griffin_lim as jax_gl
from mqgan_tpu.signal.mel import MelFrontend as JaxMelFrontend
from mqgan_tpu.signal.stft import stft as jax_stft
from mqgan_tpu_torch.core.config import SpectrogramConfig
from mqgan_tpu_torch.deploy.runtime import CodecRuntime
from mqgan_tpu_torch.models.istft_vocoder import ISTFTNetGenerator, build_vocoder_fe
from mqgan_tpu_torch.nn.conv import WNConv1d
from mqgan_tpu_torch.signal import griffin_lim as gl
from mqgan_tpu_torch.signal.mel import MelFrontend
from mqgan_tpu_torch.signal.vocoder import ISTFTNetFE
from mqgan_tpu_torch.signal.stft import stft
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import (MELS, max_err, narrow_jax_params, perturb,
                                     port_model, to_numpy_tree)

# the narrow generator of tests/test_istft_vocoder.py
NARROW_GEN = dict(n_mels=16, upsample_rates=(4, 4), upsample_kernel_sizes=(9, 9),
                  upsample_initial_channel=32, istft_n_fft=8,
                  resblock_kernel_sizes=(3,), resblock_dilations=(1, 2))
ISTFT_HOP = 2
GEN_TOL = 1e-4
# the narrow codec's audio spec: 16 mels, 16 kHz, n_fft 256, hop 64
SLICE_SPEC = dict(sampling_rate=16000, filter_length=256, hop_length=64,
                  win_length=256, n_mel_channels=MELS, mel_fmin=0.0,
                  mel_fmax=8000.0)
GL_SPEC = dict(sampling_rate=16000, filter_length=512, hop_length=128,
               win_length=512, n_mel_channels=80, mel_fmin=0.0, mel_fmax=8000.0)
SLICE_TOL = 1e-3
MIDPOINT_TOL = 1e-3


@functools.lru_cache(maxsize=None)
def _narrow_gen_tree():
    gen = JaxGenerator(**NARROW_GEN)
    params = jax.jit(gen.init)(jax.random.key(0), jnp.zeros((2, 16, 12)))
    return gen, perturb(to_numpy_tree(params), np.random.default_rng(0))


def _port_gen(tree, **kw):
    model = ISTFTNetGenerator(**NARROW_GEN, **kw)
    model.load_state_dict(state_dict_from_jax(tree, model))
    return model.eval()


def _mel(rng, b=2, t=12):
    return rng.standard_normal((b, NARROW_GEN["n_mels"], t)).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_dilated_conv_matches_jax(rng, causal):
    conv = jax_conv1d(6, 5, dilation=3, causal=causal, use_weight_norm=True)
    x = rng.standard_normal((2, 23, 4)).astype(np.float32)
    params = perturb(to_numpy_tree(conv.init(jax.random.key(1), jnp.asarray(x))), rng)
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    port = WNConv1d(4, 6, 5, dilation=3, causal=causal)
    port.load_state_dict(state_dict_from_jax(params, port))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    print(f"dilated conv causal={causal}: max err {max_err(got, want):.2e}")
    assert got.shape == want.shape == (2, 23, 6)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_generator_matches_jax(rng):
    gen, tree = _narrow_gen_tree()
    mel = _mel(rng)
    j_spec, j_phase = (np.asarray(a) for a in jax.jit(gen.apply)(
        {"params": tree}, jnp.asarray(mel)))
    with torch.no_grad():  # the forward is differentiable (training)
        spec, phase = _port_gen(tree)(torch.from_numpy(mel))
    print(f"generator: spec max err {max_err(spec, j_spec):.2e}, phase "
          f"{max_err(phase, j_phase):.2e}")
    assert spec.shape == j_spec.shape == (2, 5, 12 * 16)
    np.testing.assert_allclose(spec.numpy(), j_spec, atol=GEN_TOL, rtol=GEN_TOL)
    np.testing.assert_allclose(phase.numpy(), j_phase, atol=GEN_TOL, rtol=GEN_TOL)


def test_vocoder_fe_matches_jax(rng, tmp_path):
    gen, tree = _narrow_gen_tree()
    mel = _mel(rng, b=1, t=15)
    want = np.asarray(jax_build_vocoder_fe(gen, {"params": tree}, ISTFT_HOP)(
        jnp.asarray(mel)))
    fe = build_vocoder_fe(_port_gen(tree), ISTFT_HOP)
    got = fe(mel).numpy()
    print(f"ISTFTNetFE waveform {got.shape}: max err {max_err(got, want):.2e}")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=GEN_TOL, rtol=0)
    pcm, pcm_cpu = fe.infer(mel), fe.infer_cpuistft(mel)
    assert pcm.dtype == pcm_cpu.dtype == np.int16
    assert np.abs(pcm.astype(np.int32) - pcm_cpu).max() <= 1
    # the artifact (config.json + weights.pt) vocodes as the wrapper does
    art = fe.export_ts(str(tmp_path / "voc"), 16000, mel_channels=16)
    again = ISTFTNetFE.load_ts(art, device="cpu")
    assert again.sampling_rate == 16000
    np.testing.assert_array_equal(again(mel).numpy(), got)


def test_generator_bf16_runs():
    _, tree = _narrow_gen_tree()
    spec, phase = _port_gen(tree, dtype=torch.bfloat16)(
        torch.from_numpy(_mel(np.random.default_rng(3))))
    assert spec.dtype == phase.dtype == torch.float32
    assert bool((spec > 0).all()) and float(phase.abs().max()) <= np.pi + 1e-5


def test_bridge_rejects_missing_or_extra_generator_key():
    _, tree = _narrow_gen_tree()
    missing = {k: dict(v) for k, v in tree.items()}
    missing["mrf_0"] = {k: dict(v) for k, v in tree["mrf_0"].items()}
    del missing["mrf_0"]["conv_k3_d2_post"]["g"]
    with pytest.raises(KeyError, match="mrf_0.conv_k3_d2_post.g"):
        state_dict_from_jax(missing, ISTFTNetGenerator(**NARROW_GEN))
    extra = dict(tree, up_2={"bias": np.zeros(4, np.float32)})
    with pytest.raises(KeyError, match="up_2"):
        state_dict_from_jax(extra, ISTFTNetGenerator(**NARROW_GEN))


def _gl_magnitude():
    t = np.arange(8000) / 16000
    x = (0.4 * np.sin(2 * np.pi * 300 * t)
         + 0.05 * np.random.default_rng(4).standard_normal(t.size))
    return np.abs(np.asarray(jax_stft(jnp.asarray(x[None].astype(np.float32)),
                                      512, 128, 512)))


def test_log_mel_to_linear_matches_jax(rng):
    jcfg = JaxSpectrogramConfig(**GL_SPEC)
    inv = gl.mel_pseudo_inverse(SpectrogramConfig(**GL_SPEC))
    np.testing.assert_array_equal(inv, jax_gl.mel_pseudo_inverse(jcfg))
    log_mel = rng.uniform(-6.0, 2.0, (2, 20, 80)).astype(np.float32)
    want = np.asarray(jax_gl.log_mel_to_linear(jnp.asarray(log_mel), jnp.asarray(inv)))
    got = gl.log_mel_to_linear(torch.from_numpy(log_mel), torch.from_numpy(inv)).numpy()
    print(f"log_mel_to_linear: max err {max_err(got, want):.2e}")
    assert got.shape == want.shape == (2, 257, 20)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n_iter", [1, 2])
def test_griffin_lim_matches_jax(n_iter):
    mag = _gl_magnitude()
    want = np.asarray(jax_gl.griffin_lim(jnp.asarray(mag), 512, 128, 512, n_iter=n_iter))
    got = gl.griffin_lim(torch.from_numpy(mag), 512, 128, 512, n_iter=n_iter).numpy()
    print(f"griffin_lim n_iter={n_iter}: max err {max_err(got, want):.2e}")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_griffin_lim_recovers_sine():
    sr = 16000
    t = np.arange(sr) / sr
    x = torch.from_numpy((0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)[None])
    wav = gl.griffin_lim(stft(x, 512, 128, 512).abs(), 512, 128, 512,
                         n_iter=16)[0, 0].numpy()
    spec = np.abs(np.fft.rfft(wav[2000:14000]))
    peak_hz = spec.argmax() * sr / 12000
    print(f"Griffin-Lim peak {peak_hz:.1f} Hz")
    assert abs(peak_hz - 440) < 8
    assert spec.max() > 10 * np.median(spec)


def _slice_audio():
    rng = np.random.default_rng(5)
    t = np.arange(16000) / 16000
    clips = [0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(t.size)
             for f in (220.0, 523.0)]
    return np.stack(clips).astype(np.float32)


def test_audio_slice_matches_jax():
    """wav -> MelFrontend -> CodecRuntime.reencode -> Griffin-Lim (2
    iterations) -> wav, in the port and in JAX, at the narrow codec."""
    wav = _slice_audio()
    gen, tree = narrow_jax_params()
    variables = {"params": tree}
    cfg, jcfg = SpectrogramConfig(**SLICE_SPEC), JaxSpectrogramConfig(**SLICE_SPEC)

    # JAX, at the port runtime's bucket (251 frames padded to 256)
    j_mel = np.asarray(JaxMelFrontend(jcfg)(jnp.asarray(wav)))
    t = j_mel.shape[1]
    tb = 256
    x = jnp.asarray(np.pad(j_mel, ((0, 0), (0, tb - t), (0, 0))))
    mask = jnp.broadcast_to(jnp.arange(tb)[None] >= t, (2, tb))
    j_tokens = np.asarray(jax.jit(functools.partial(
        gen.apply, method=JaxPreEncoder.encode))(variables, x, mask))
    z = jax.jit(lambda v, a, m: gen.apply(
        v, a, m, True, method=JaxPreEncoder._encode_trunk))(variables, x, mask)
    frac = np.asarray(bound(z, gen.fsq_levels))
    margin = np.abs(frac - np.floor(frac) - 0.5).min(axis=-1)[:, :t]
    j_post = np.asarray(jax.jit(functools.partial(
        gen.apply, method=JaxPreEncoder.decode))(
            variables, jnp.asarray(j_tokens), mask))[:, :t]
    j_wav = np.asarray(jax_gl.GriffinLimVocoder(jcfg, n_iter=2)(jnp.asarray(j_post)))
    j_tokens = j_tokens[:, :t]

    # the port, through its entry points on the CPU
    mel = MelFrontend(cfg, device="cpu")(wav)
    runtime = CodecRuntime(port_model(tree), buckets=(128, 256), device="cpu")
    tokens, _ = runtime.reencode(mel.numpy())
    far = margin > MIDPOINT_TOL
    print(f"front end max err {max_err(mel, j_mel):.2e}; "
          f"{int((tokens != j_tokens).sum())} token flips of {tokens.size}, "
          f"smallest midpoint margin {margin.min():.2e}, "
          f"{int((~far).sum())} positions within {MIDPOINT_TOL}")
    assert mel.shape == (2, 251, MELS) and tokens.shape == (2, 251)
    assert far.mean() > 0.95
    np.testing.assert_array_equal(tokens[far], j_tokens[far])

    # from JAX's tokens: refined mel and waveform
    post = runtime.decode(j_tokens)
    wav_out = gl.GriffinLimVocoder(cfg, n_iter=2)(torch.from_numpy(post)).numpy()
    close = np.isclose(wav_out, j_wav, atol=SLICE_TOL, rtol=SLICE_TOL)
    print(f"decode max err {max_err(post, j_post):.2e}, waveform "
          f"{wav_out.shape} max err {max_err(wav_out, j_wav):.2e}, "
          f"{int((~close).sum())} samples outside atol=rtol={SLICE_TOL}")
    assert wav_out.shape == j_wav.shape == (2, 1, 250 * 64)
    np.testing.assert_allclose(post, j_post, atol=SLICE_TOL, rtol=SLICE_TOL)
    # Griffin-Lim starts from zero phase: each frame's inverse is a pulse at
    # the frame's edge, where the Hann window is ~0, so at some bins the
    # re-analysed spectrum is rounding noise (~1e-9) and its angle is set by
    # the FFT's rounding, in JAX as in PyTorch. Fed the same mel, the two
    # agree to 1.5e-8 before the first iteration and differ by up to ~3e-3 on
    # a few samples after it. So: nearly every sample within the slice's
    # tolerance, and none far outside it.
    assert close.mean() >= 0.99
    assert max_err(wav_out, j_wav) <= 10 * SLICE_TOL
