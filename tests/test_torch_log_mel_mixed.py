"""PyTorch port: the mixed-radix log-mel kernel's plan and tables, and the
front end at odd n_fft, on the CPU.

The kernel (``csrc/log_mel_mixed.cu``) runs only on a card; what it reads is
built and checked here: the plan and twiddle table, the butterflies'
constant coefficients in its source, the way its threads walk the
butterflies (each visited once), and a numpy replay of its passes in fp32
(complex64) arithmetic (reflect index arithmetic, the first pass fused with
the load, Stockham passes of radix 4, 2, 3, 5 and 7, the real-FFT split, the
bands, the log) driven by these tables against ``np.fft.rfft``, the plain
version and the JAX package's two front ends. Then the repair of odd n_fft:
``MelFrontend`` at n_fft 1201 against the JAX package's."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.config import SpectrogramConfig as JaxSpectrogramConfig
from mqgan_tpu.ops.stft_kernels import PallasMelFrontend
from mqgan_tpu.signal.mel import MelFrontend as JaxMelFrontend
from mqgan_tpu_torch.core.config import SpectrogramConfig
from mqgan_tpu_torch.ops.stft_kernels import (log_mel, log_mel_plain, log_mel_route,
                                              log_mel_tables, mixed_frames,
                                              mixed_plan, mixed_radices)
from mqgan_tpu_torch.signal.mel import LOG_CLIP_VAL, MelFrontend
from mqgan_tpu_torch.signal.stft import frame_count

CU = Path(__file__).resolve().parents[1] / "mqgan_tpu_torch" / "csrc" / "fft_radix.cuh"
THREADS, MAX_POINTS = 256, 4096  # the kernel's kThreads, kMaxPoints
N_FFTS = (1200, 1000, 800, 480, 1764, 128, 8192)
ROOTS = {r: (np.cos(2 * np.pi * np.arange(r) / r).astype(np.float32),
             np.sin(2 * np.pi * np.arange(r) / r).astype(np.float32)) for r in (3, 5, 7)}


def _spec(n_fft, **kw):
    """(port, JAX) configs: 44.1 kHz for 1764 and 8192, else 16 kHz, hop
    n_fft / 4, 80 mels."""
    rate = 44100 if n_fft in (1764, 8192) else 16000
    spec = dict(sampling_rate=rate, filter_length=n_fft, hop_length=n_fft // 4,
                win_length=n_fft, n_mel_channels=80, mel_fmin=0.0, mel_fmax=rate / 2)
    spec.update(kw)
    return SpectrogramConfig(**spec), JaxSpectrogramConfig(**spec)


def _wav(b, n, seed, quiet=0):
    wav = np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32) * 0.3
    wav[0, :quiet] = 0.0
    return wav


def _dft(a, r):
    """The kernel's r-point butterfly on a list of r complex64 arrays."""
    if r == 2:
        return [a[0] + a[1], a[0] - a[1]]
    if r == 4:
        v0, v1, v2, d = a[0] + a[2], a[0] - a[2], a[1] + a[3], a[1] - a[3]
        v3 = np.complex64(-1j) * d
        return [v0 + v2, v1 + v3, v0 - v2, v1 - v3]
    c, s = ROOTS[r]
    t = {j: a[j] + a[r - j] for j in range(1, r // 2 + 1)}
    d = {j: a[j] - a[r - j] for j in range(1, r // 2 + 1)}
    out = [None] * r
    out[0] = a[0]
    for j in t:
        out[0] = out[0] + t[j]
    for q in range(1, r // 2 + 1):
        re, im = a[0], np.zeros_like(a[0])
        for j in t:
            re = re + c[(j * q) % r] * t[j]
            im = im + s[(j * q) % r] * d[j]
        out[q], out[r - q] = re - np.complex64(1j) * im, re + np.complex64(1j) * im
    return out


def _replay(wav: np.ndarray, tables) -> tuple[np.ndarray, np.ndarray]:
    """(X (frames, M + 1) complex, log-mel (B, T, n_mels)) as the kernel
    computes them, pass by pass, from its tables, in complex64."""
    n_fft, hop = tables.n_fft, tables.hop
    m = n_fft // 2
    plan = tables.plan.numpy()
    tw = tables.twiddles.numpy()
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    b, samples = wav.shape
    t = frame_count(samples, n_fft, hop)
    # load: reflect padding as index arithmetic, the window as it loads
    pos = np.abs(np.arange(t)[:, None] * hop + np.arange(n_fft)[None, :] - n_fft // 2)
    pos = np.where(pos >= samples, 2 * (samples - 1) - pos, pos)
    x = wav[:, pos] * tables.window.numpy()
    y = (x[..., 0::2] + np.complex64(1j) * x[..., 1::2]).reshape(b * t, m)
    for n, (r, p, off) in enumerate(plan):
        mr = m // r
        i = np.arange(mr)
        k = i % p
        a = [y[:, i + q * mr] * (tw[off + (q - 1) * p + k] if n and q else np.complex64(1))
             for q in range(r)]
        out = np.empty_like(y)
        for s, v in enumerate(_dft(a, r)):
            out[:, r * (i - k) + k + s * p] = v
        y = out
    k = np.arange(m + 1)
    za, zb = y[:, k % m], np.conj(y[:, (m - k) % m])
    off = tw.shape[0] - (m + 1)
    even = np.complex64(0.5) * (za + zb)
    odd = np.complex64(-0.5j) * (za - zb)
    spec = even + tw[off + k] * odd
    mag = np.abs(spec)
    bands, weights = tables.bands.numpy(), tables.weights.numpy()
    mel = np.stack([mag[:, lo:hi] @ weights[o:o + hi - lo] for lo, hi, o in bands], axis=1)
    return spec, np.log(np.maximum(mel, np.float32(LOG_CLIP_VAL))).reshape(b, t, -1)


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_mixed_plan_and_twiddles(n_fft):
    m = n_fft // 2
    plan, tw = mixed_plan(n_fft)
    assert plan.dtype == np.int32 and plan.shape[1] == 3
    assert tw.dtype == np.float32 and tw.shape[1] == 2
    assert int(np.prod(plan[:, 0])) == m and set(plan[:, 0]) <= {2, 3, 4, 5, 7}
    assert (plan[:, 0] == 2).sum() <= 1
    p = 1
    for r, pp, off in plan:  # p is the product of the radices before
        assert pp == p
        p *= r
    z = tw[:, 0] + 1j * tw[:, 1].astype(np.float64)
    np.testing.assert_allclose(z[-(m + 1):], np.exp(-2j * np.pi * np.arange(m + 1) / n_fft),
                               atol=1e-7, rtol=0)
    for r, p, off in plan[1:]:  # W_rp^qk at (q - 1) p + k
        for q in range(1, r):
            want = np.exp(-2j * np.pi * q * np.arange(p) / (r * p))
            np.testing.assert_allclose(z[off + (q - 1) * p: off + q * p], want,
                                       atol=1e-7, rtol=0)
    assert tw.shape[0] == sum((r - 1) * p for r, p, _ in plan[1:]) + m + 1


def test_butterfly_constants_in_the_source():
    """The kernel's kRoot3/5/7 are (cos, sin) of 2 pi m / r as float32."""
    src = CU.read_text()
    for r, (c, s) in ROOTS.items():
        body = re.search(rf"kRoot{r}\[{r}\] = \{{(.*?)\}};", src, re.S).group(1)
        vals = np.array([float(v.rstrip("f")) for v in re.findall(r"-?[\d.]+f", body)],
                        dtype=np.float32).reshape(r, 2)
        np.testing.assert_array_equal(vals[:, 0], c)
        np.testing.assert_array_equal(vals[:, 1], s)


def _walk2(tid, rows, width):
    """The kernel's (row, i) counter of one thread stepped by THREADS."""
    f, i = tid // width, tid % width
    df, di = THREADS // width, THREADS - (THREADS // width) * width
    seen = []
    while f < rows:
        seen.append((f, i))
        i, f = i + di, f + df
        if i >= width:
            i, f = i - width, f + 1
    return seen


def _walk3(tid, rows, mr, p):
    """fft_pass's (frame, j, k) counter of one thread stepped by THREADS."""
    jn = mr // p
    f = tid // mr
    j = (tid - f * mr) // p
    k = tid - f * mr - j * p
    df = THREADS // mr
    dj = (THREADS - df * mr) // p
    dk = THREADS - df * mr - dj * p
    seen = []
    while f < rows:
        seen.append((f, j * p + k))
        k, j, f = k + dk, j + dj, f + df
        if k >= p:
            k, j = k - p, j + 1
        if j >= jn:
            j, f = j - jn, f + 1
    return seen


@pytest.mark.parametrize("n_fft", N_FFTS + (4, 14, 750))
def test_every_butterfly_is_walked_once(n_fft):
    """Each pass, the split and the mel stage visit every (frame, index) of
    the block exactly once across the 256 threads, in the kernel's
    order."""
    m = n_fft // 2
    frames = mixed_frames(n_fft)
    assert frames * m <= MAX_POINTS and (frames == 1 or frames * m <= 2048)
    plan, _ = mixed_plan(n_fft)
    walks = [(_walk2, (frames, m // plan[0, 0]))]
    walks += [(_walk3, (frames, m // r, p)) for r, p, _ in plan[1:]]
    walks += [(_walk2, (frames, m + 1)), (_walk2, (frames, 80)),
              (_walk2, (frames - 1, 80))]
    for walk, args in walks:
        seen = [item for tid in range(THREADS) for item in walk(tid, *args)]
        assert len(seen) == len(set(seen)) == args[0] * args[1], (walk.__name__, args)


@pytest.mark.parametrize("n_fft,samples", [(1200, 4001), (1000, 2000), (800, 3000),
                                           (480, 2401), (1764, 5000), (128, 65),
                                           (8192, 9000)])
def test_replay_of_the_kernel_matches_rfft_and_plain(n_fft, samples):
    """The kernel's passes in fp32, replayed from its tables, give
    np.fft.rfft of the reflect-padded windowed frames within fp32 rounding,
    and the plain version's log-mel within 1e-4. samples = n_fft / 2 + 1
    (128: 65) puts every frame on a reflected edge."""
    cfg, _ = _spec(n_fft, win_length=n_fft * 3 // 4)
    tables = log_mel_tables(cfg, "cpu")
    assert tables.route == "mixed"
    wav = _wav(2, samples, n_fft)
    wav[1, :samples // 2] = 0.0
    spec, got = _replay(wav, tables)
    frames = torch.nn.functional.pad(torch.from_numpy(wav).double(),
                                     (n_fft // 2, n_fft // 2), mode="reflect")
    frames = frames.unfold(-1, n_fft, cfg.hop_length) * tables.window.double()
    want = np.fft.rfft(frames.numpy(), axis=-1).reshape(spec.shape)
    err = np.abs(spec - want).max()
    # fp32 rounding of an M-point FFT: ~eps * log2(M) * rms |X| per bin
    limit = 4 * np.finfo(np.float32).eps * np.log2(n_fft) * np.sqrt(
        (np.abs(want) ** 2).mean())
    print(f"n_fft {n_fft}: replay vs rfft max err {err:.2e} (limit {limit:.2e}, "
          f"max |X| {np.abs(want).max():.1f})")
    assert err <= limit
    plain = log_mel_plain(torch.from_numpy(wav), tables.cos, tables.sin,
                          tables.fbank, cfg.hop_length).numpy()
    assert got.shape == plain.shape
    np.testing.assert_allclose(got, plain, atol=1e-4, rtol=0)
    np.testing.assert_allclose(log_mel(torch.from_numpy(wav), tables).numpy(), plain,
                               atol=0, rtol=0)


@pytest.mark.parametrize("n_fft,samples", [(1200, 16000), (1764, 16017)])
def test_replay_matches_both_jax_front_ends(n_fft, samples):
    """The replay's log-mel of 2 seeded clips (0.25 s of leading silence in
    clip 0) against the JAX package's MelFrontend and PallasMelFrontend in
    interpret mode, within 1e-4; silent frames exactly log(1e-5)."""
    cfg, jcfg = _spec(n_fft)
    quiet = cfg.sampling_rate // 4
    wav = _wav(2, samples, n_fft + 1, quiet)
    _, got = _replay(wav, log_mel_tables(cfg, "cpu"))
    silent = (quiet - n_fft // 2) // cfg.hop_length + 1
    for name, fe in (("MelFrontend", JaxMelFrontend(jcfg)),
                     ("PallasMelFrontend", PallasMelFrontend(jcfg, interpret=True))):
        want = np.asarray(fe(jnp.asarray(wav)))
        err = np.abs(got - want).max()
        print(f"n_fft {n_fft}: replay vs JAX {name} {want.shape}: max err {err:.2e}")
        assert got.shape == want.shape
        assert err <= 1e-4
    np.testing.assert_array_equal(got[0, :silent], np.float32(np.log(np.float32(1e-5))))


@pytest.mark.parametrize("samples", [16000, 15000])
def test_mel_frontend_at_odd_n_fft_matches_jax(samples):
    """n_fft 1201, hop 300: JAX frames (samples - 1) // hop + 1, one fewer
    than samples // hop + 1 where hop divides the samples (50 at 15,000).
    The port's MelFrontend gives JAX's shape and values; frames_for keeps
    JAX's formula."""
    cfg, jcfg = _spec(1201, hop_length=300, win_length=1201)
    assert log_mel_route(1201, 80, 300) == "bluestein"
    wav = _wav(1, samples, 1201)
    fe, jfe = MelFrontend(cfg, device="cpu"), JaxMelFrontend(jcfg)
    got = fe(wav).numpy()
    want = np.asarray(jfe(jnp.asarray(wav)))
    print(f"n_fft 1201, {samples} samples: {got.shape} vs JAX {want.shape}, "
          f"max err {np.abs(got - want).max():.2e}")
    assert got.shape == want.shape == (1, (samples - 1) // 300 + 1, 80)
    assert got.shape[1] == frame_count(samples, 1201, 300)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert fe.frames_for(samples) == jfe.frames_for(samples) == samples // 300 + 1


@pytest.mark.parametrize("m,radices", [(600, (4, 2, 3, 5, 5)), (882, (2, 3, 3, 7, 7)),
                                       (4096, (4,) * 6), (1025, None), (1, ())])
def test_mixed_radices(m, radices):
    assert mixed_radices(m) == radices


def test_kernel_wrapper_launches_or_raises():
    """The mixed route's wrapper takes CUDA tensors only (no quiet fallback
    to the plain version); the entry point gives a CPU tensor the plain
    version through the op."""
    from mqgan_tpu_torch.ops.stft_kernels import log_mel_mixed, log_mel_mixed_kernel

    cfg, _ = _spec(1200)
    t = log_mel_tables(cfg, "cpu")
    args = (t.fbank, t.cos, t.sin, t.window, t.plan, t.twiddles, t.bands, t.weights,
            t.hop, t.n_fft)
    wav = torch.from_numpy(_wav(1, 4000, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        log_mel_mixed_kernel(wav, *args)
    with pytest.raises(ValueError, match="unsupported device"):
        log_mel_mixed(wav.to("meta"), *args)
    assert torch.equal(log_mel_mixed(wav, *args),
                       log_mel_plain(wav, t.cos, t.sin, t.fbank, t.hop))
