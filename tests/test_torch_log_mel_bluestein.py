"""PyTorch port: the Bluestein (chirp-z) log-mel kernel's plan and tables, a
replay of its arithmetic, and the route table, on the CPU.

The kernel (``csrc/log_mel_bluestein.cu``) runs only on a card; what it
reads is built and checked here: the L-point plan, the chirp, the filter's
spectrum, the premultiply with the window folded in, the split twiddles,
its fp64 butterfly constants in the shared pass header, the way its threads
walk the work (each item once), and a numpy replay of the kernel: the
premultiply, the forward FFT, the filter product, the inverse FFT as a
forward one on conjugates and the post-multiply in complex128 (the kernel's
fp64 stage), then the real-FFT split, the magnitudes, the bands and the log
in fp32, driven by these tables, against ``np.fft.rfft``, the plain version
in float64 and the JAX package's two front ends."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.ops.stft_kernels import PallasMelFrontend
from mqgan_tpu.signal.mel import MelFrontend as JaxMelFrontend
from mqgan_tpu_torch.ops.stft_kernels import (BLUESTEIN_MAX_POINTS, bluestein_frames,
                                              bluestein_length, bluestein_plan,
                                              bluestein_sizes, dft_mel_tables,
                                              digit_reversed, log_mel,
                                              log_mel_plain, log_mel_route,
                                              log_mel_tables, mixed_radices)
from mqgan_tpu_torch.signal.mel import LOG_CLIP_VAL
from mqgan_tpu_torch.signal.stft import _padded_window, frame_count
from tests.test_torch_log_mel_mixed import THREADS, _walk2, _walk3
from tests.test_torch_log_mel_mixed import _spec as _mixed_spec

CUH = Path(__file__).resolve().parents[1] / "mqgan_tpu_torch" / "csrc" / "fft_radix.cuh"
N_FFTS = (88, 201, 1144, 2050)  # 8 * 11, odd, 8 * 11 * 13, 2 * 5^2 * 41
ROOTS = {r: np.exp(2j * np.pi * np.arange(r) / r) for r in (3, 5, 7)}


def _spec(n_fft, **kw):
    """(port, JAX) configs: 44.1 kHz and 128 mels from n_fft 1000, else 16
    kHz and 40 mels; hop n_fft // 4 (1 at least)."""
    big = n_fft >= 1000
    rate = 44100 if big else 16000
    spec = dict(sampling_rate=rate, filter_length=n_fft, hop_length=max(1, n_fft // 4),
                win_length=n_fft, n_mel_channels=128 if big else 40, mel_fmin=0.0,
                mel_fmax=rate / 2)
    spec.update(kw)
    return _mixed_spec(n_fft, **spec)


def _clips(b, n, noise, seed):
    """Clips like chip_smoke.py phase 8's: three sines of random frequency
    (80 to 4000 Hz at 44.1 kHz) and level plus noise, peak 0.3."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    freq = 80.0 + 3920.0 * rng.random((b, 3, 1))
    x = (rng.random((b, 3, 1)) * np.sin(2 * np.pi * freq * t)).sum(axis=1)
    x = x + noise * rng.standard_normal((b, n))
    return (0.3 * x / np.abs(x).max(axis=1, keepdims=True)).astype(np.float32)


def _butterfly(a, r):
    """The kernel's r-point butterfly (fft_radix.cuh dft) in complex128."""
    if r == 2:
        return [a[0] + a[1], a[0] - a[1]]
    if r == 4:
        v0, v1, v2, d = a[0] + a[2], a[0] - a[2], a[1] + a[3], a[1] - a[3]
        j = np.asarray(1j, dtype=d.dtype)
        return [v0 + v2, v1 - j * d, v0 - v2, v1 + j * d]
    w = ROOTS[r].astype(a[0].dtype)
    h = r // 2
    t = {j: a[j] + a[r - j] for j in range(1, h + 1)}
    d = {j: a[j] - a[r - j] for j in range(1, h + 1)}
    out = [a[0] + sum(t.values())] + [None] * (r - 1)
    for s in range(1, h + 1):
        re = a[0] + sum(w[(j * s) % r].real * t[j] for j in t)
        im = sum(w[(j * s) % r].imag * d[j] for j in d)
        j = np.asarray(1j, dtype=im.dtype)
        out[s], out[r - s] = re - j * im, re + j * im
    return out


def _pass(y, r, n, w, forward):
    """One in-place pass over the rows of y (N, L), as the kernel's
    ``pass``: radix r over sub-transforms of r n points, points base + k +
    q n twiddled by w[k]^q (powers by repeated products) after the
    butterfly (forward) or before it."""
    length = y.shape[1]
    at = (np.arange(length // (r * n))[:, None] * r * n + np.arange(n)).ravel()
    wq, powers = np.tile(w, length // (r * n)), [1]
    for _ in range(1, r):
        powers.append(wq if len(powers) == 1 else powers[-1] * wq)
    a = [y[:, at + q * n] for q in range(r)]
    if not forward:
        a = [v * pw for v, pw in zip(a, powers)]
    a = _butterfly(a, r)
    if forward:
        a = [v * pw for v, pw in zip(a, powers)]
    y = y.copy()
    for q in range(r):
        y[:, at + q * n] = a[q]
    return y


def _convolve(a, plan, tw, spectrum):
    """u = conj(L y) of the kernel's passes: the forward FFT (decimation in
    frequency), the filter product and conjugate around its last pass, the
    inverse (decimation in time) backwards."""
    for r, n, off in plan[:-1]:
        a = _pass(a, r, n, tw[off:off + n], True)
    r = plan[-1, 0]
    a = _pass(a, r, 1, np.ones(1), True)
    a = np.conj(a * spectrum)
    a = _pass(a, r, 1, np.ones(1), False)
    for r, n, off in plan[-2::-1]:
        a = _pass(a, r, n, tw[off:off + n], False)
    return a


def _complex(t):
    t = t.numpy()
    return t[..., 0] + 1j * t[..., 1]


def _replay(wav: np.ndarray, tables, stage=np.complex128) -> tuple[np.ndarray, np.ndarray]:
    """(X (frames, n_fft // 2 + 1) complex64, log-mel (B, T, n_mels)) as the
    kernel computes them from its tables: the chirp-z stage in complex128,
    the split, magnitudes, bands and log in fp32 (at an odd n_fft X is
    post-multiplied for the checks only). ``stage=np.complex64`` replays
    the same kernel with an fp32 stage, the design it did not take."""
    n_fft, hop = tables.n_fft, tables.hop
    m, _, _ = bluestein_sizes(n_fft)
    length = tables.spectrum.shape[0]
    plan, tw = tables.plan.numpy(), _complex(tables.twiddles).astype(stage)
    premul = _complex(tables.premul.reshape(m, -1, 2)).astype(stage)
    b, samples = wav.shape
    t = frame_count(samples, n_fft, hop)
    # load: reflect padding as index arithmetic; the L - M inputs past M are 0
    pos = np.abs(np.arange(t)[:, None] * hop + np.arange(n_fft)[None, :] - n_fft // 2)
    pos = np.where(pos >= samples, 2 * (samples - 1) - pos, pos)
    x = wav[:, pos].reshape(b * t, n_fft).astype(np.real(stage(0)).dtype)
    a = np.zeros((b * t, length), dtype=stage)
    if n_fft % 2:
        a[:, :m] = x * premul[:, 0]
    else:
        a[:, :m] = x[:, 0::2] * premul[:, 0] + x[:, 1::2] * premul[:, 1]
    u = _convolve(a, plan, tw, _complex(tables.spectrum).astype(stage))
    chirp = _complex(tables.chirp).astype(stage)
    if n_fft % 2:  # |X[k]| = |u[k]|: the kernel skips the post-multiply
        k = np.arange(n_fft // 2 + 1)
        spec = (chirp[k] * np.conj(u[:, k])).astype(np.complex64)
        mag = np.abs(u[:, k].astype(np.complex64))
    else:
        k = np.arange(m + 1)
        za = (chirp[k % m] * np.conj(u[:, k % m])).astype(np.complex64)
        zb = (chirp[(m - k) % m] * np.conj(u[:, (m - k) % m])).astype(np.complex64)
        even = np.complex64(0.5) * (za + np.conj(zb))
        odd = np.complex64(-0.5j) * (za - np.conj(zb))
        spec = even + _complex(tables.split).astype(np.complex64) * odd
        mag = np.abs(spec)
    bands, weights = tables.bands.numpy(), tables.weights.numpy()
    mel = np.stack([mag[:, lo:hi] @ weights[o:o + hi - lo] for lo, hi, o in bands], axis=1)
    return spec, np.log(np.maximum(mel, np.float32(LOG_CLIP_VAL))).reshape(b, t, -1)


def _plain(wav, cfg, dtype):
    return log_mel_plain(torch.from_numpy(wav), *dft_mel_tables(cfg, dtype),
                         cfg.hop_length).numpy()


def _old_route(n_fft):
    """The route table before the Bluestein kernel."""
    if n_fft & (n_fft - 1) == 0 and 256 <= n_fft <= 4096:
        return "fft"
    if n_fft % 2 == 0 and 4 <= n_fft <= 8192 and mixed_radices(n_fft // 2) is not None:
        return "mixed"
    return "dft"


@pytest.mark.parametrize("n_fft", N_FFTS + (1201, 3, 5, 9603, 14406))
def test_plan_and_tables(n_fft):
    """L is 7-smooth and at least M + K - 1; the plan's passes multiply to
    L with their twiddles W_rN^n'; the chirp is exp(-i pi n^2 / M) (n^2
    reduced mod 2M in int64: exact at n near the limit too); the spectrum is
    np.fft.fft of the chirp filter over L, in the digit-reversed order the
    forward FFT leaves its bins in; premul folds the window in."""
    m, k_out, least = bluestein_sizes(n_fft)
    assert (m, k_out) == ((n_fft, n_fft // 2 + 1) if n_fft % 2 else (n_fft // 2,) * 2)
    win = _padded_window(n_fft * 3 // 4, n_fft).numpy()
    bp = bluestein_plan(n_fft, win)
    length = bp.length
    assert length == bluestein_length(n_fft) and least <= length <= BLUESTEIN_MAX_POINTS
    assert mixed_radices(length) is not None
    smooth = [n for n in range(least, max(length, int(1.25 * least)) + 1)
              if mixed_radices(n) is not None and n <= BLUESTEIN_MAX_POINTS]
    assert length <= max(1.25 * least, smooth[0])
    assert length * len(mixed_radices(length)) == min(n * len(mixed_radices(n))
                                                      for n in smooth)
    assert int(np.prod(bp.plan[:, 0])) == length and bp.plan[-1, 1] == 1
    tw = bp.twiddles[:, 0] + 1j * bp.twiddles[:, 1]
    n_before = length
    for r, n, off in bp.plan:  # N = L / (r_1 ... r_s); W_rN^n' for n' < N
        assert n * r == n_before
        n_before = n
        if n > 1:
            np.testing.assert_allclose(tw[off:off + n],
                                       np.exp(-2j * np.pi * np.arange(n) / (r * n)),
                                       atol=1e-15, rtol=0)
    assert len(tw) == sum(n for _, n, _ in bp.plan if n > 1)
    n = np.arange(m)
    chirp = bp.chirp[:, 0] + 1j * bp.chirp[:, 1]
    np.testing.assert_allclose(chirp, np.exp(-1j * np.pi * n.astype(np.float64) ** 2 / m),
                               atol=1e-9, rtol=0)
    filt = np.zeros(length, dtype=np.complex128)
    filt[:k_out] = np.exp(1j * np.pi * np.arange(k_out) ** 2 / m)
    filt[length - np.arange(1, m)] = np.exp(1j * np.pi * np.arange(1, m) ** 2 / m)
    pos = digit_reversed(length)
    assert sorted(pos) == list(range(length))
    np.testing.assert_allclose((bp.spectrum[:, 0] + 1j * bp.spectrum[:, 1])[pos],
                               np.fft.fft(filt) / length, atol=1e-9, rtol=0)
    pre = bp.premul.reshape(m, -1, 2)
    pre = pre[..., 0] + 1j * pre[..., 1]
    if n_fft % 2:
        np.testing.assert_allclose(pre[:, 0], win * chirp, atol=1e-15, rtol=0)
        assert bp.split.shape == (0, 2)
    else:
        np.testing.assert_allclose(pre[:, 0], win[0::2] * chirp, atol=1e-15, rtol=0)
        np.testing.assert_allclose(pre[:, 1], 1j * win[1::2] * chirp, atol=1e-15, rtol=0)
        assert bp.split.dtype == np.float32 and bp.split.shape == (m + 1, 2)
        np.testing.assert_allclose(bp.split[:, 0] + 1j * bp.split[:, 1],
                                   np.exp(-2j * np.pi * np.arange(m + 1) / n_fft),
                                   atol=1e-7, rtol=0)
    assert bp.twiddles.dtype == bp.chirp.dtype == bp.spectrum.dtype == np.float64
    with pytest.raises(ValueError):
        bluestein_plan(n_fft, length=least - 1)


def test_butterfly_constants_in_the_source():
    """The header's fp64 kRoot3d/5d/7d are (cos, sin) of 2 pi m / r to a
    few units in the last place of a double."""
    src = CUH.read_text()
    for r, w in ROOTS.items():
        body = re.search(rf"kRoot{r}d\[{r}\] = \{{(.*?)\}};", src, re.S).group(1)
        vals = np.array([float(v) for v in re.findall(r"-?\d+\.\d+", body)]).reshape(r, 2)
        np.testing.assert_allclose(vals[:, 0] + 1j * vals[:, 1], w, atol=1e-15, rtol=0)


@pytest.mark.parametrize("n_fft", N_FFTS + (1201, 3, 22, 9603))
def test_every_work_item_is_walked_once(n_fft):
    """The load pass, the middle pass, each pass between (forward and
    inverse), the post-multiply and the mel stage visit every (frame,
    index) of the block exactly once across the 256 threads, in the
    kernel's order."""
    bp = bluestein_plan(n_fft)
    length, frames = bp.length, bluestein_frames(bp.length)
    assert frames * length <= BLUESTEIN_MAX_POINTS
    assert frames == 1 or frames * length <= 2048
    r0, r_last = bp.plan[0, 0], bp.plan[-1, 0]
    walks = [(_walk2, (frames, length // r0)), (_walk2, (frames, length // r_last))]
    walks += [(_walk3, (frames, length // r, n)) for r, n, _ in bp.plan[1:-1]]
    walks += [(_walk2, (frames, n_fft // 2 + 1)), (_walk2, (frames, 40)),
              (_walk2, (frames - 1, 40))]
    for walk, args in walks:
        seen = [item for tid in range(THREADS) for item in walk(tid, *args)]
        assert len(seen) == len(set(seen)) == args[0] * args[1], (walk.__name__, args)


@pytest.mark.parametrize("n_fft,samples", [(88, 3001), (201, 4000), (1144, 9000),
                                           (2050, 20000), (88, 45), (201, 101),
                                           (3, 50), (5, 3)])
def test_replay_matches_rfft_and_plain(n_fft, samples):
    """The replay gives np.fft.rfft of the reflect-padded windowed frames
    within the fp32 rounding of the split (the fp64 stage adds ~1e-13 of
    the magnitude), and the plain version's log-mel within 1e-4; the entry
    point on the CPU is the plain version. samples = n_fft // 2 + 1 puts
    every frame on a reflected edge."""
    cfg, _ = _spec(n_fft, win_length=n_fft * 3 // 4)
    tables = log_mel_tables(cfg, "cpu")
    assert tables.route == "bluestein"
    wav = 0.3 * np.random.default_rng(n_fft).standard_normal((2, samples)).astype(np.float32)
    wav[1, :samples // 2] = 0.0
    spec, got = _replay(wav, tables)
    frames = torch.nn.functional.pad(torch.from_numpy(wav).double(),
                                     (n_fft // 2, n_fft // 2), mode="reflect")
    frames = frames.unfold(-1, n_fft, cfg.hop_length) * _padded_window(
        cfg.win_length, n_fft).double()
    want = np.fft.rfft(frames.numpy(), axis=-1).reshape(spec.shape)
    err = np.abs(spec - want).max()
    # fp32 rounding of the cast and the split: a few eps of the largest |X|
    limit = 8 * np.finfo(np.float32).eps * np.abs(want).max()
    print(f"n_fft {n_fft}: replay vs rfft max err {err:.2e} (limit {limit:.2e})")
    assert err <= limit
    plain = _plain(wav, cfg, np.float32)
    assert got.shape == plain.shape
    np.testing.assert_allclose(got, plain, atol=1e-4, rtol=0)
    np.testing.assert_allclose(log_mel(torch.from_numpy(wav), tables).numpy(), plain,
                               atol=0, rtol=0)


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_replay_matches_both_jax_front_ends(n_fft):
    """The replay's log-mel of 2 clips of white noise (0.25 s of leading
    silence in clip 0) against the JAX package's MelFrontend and
    PallasMelFrontend in interpret mode, within 1e-4; silent frames exactly
    log(1e-5)."""
    cfg, jcfg = _spec(n_fft)
    quiet = cfg.sampling_rate // 4
    samples = quiet + 4 * n_fft + 7
    wav = 0.3 * np.random.default_rng(n_fft + 1).standard_normal(
        (2, samples)).astype(np.float32)
    wav[0, :quiet] = 0.0
    _, got = _replay(wav, log_mel_tables(cfg, "cpu"))
    silent = (quiet - (n_fft - n_fft // 2)) // cfg.hop_length + 1
    for name, fe in (("MelFrontend", JaxMelFrontend(jcfg)),
                     ("PallasMelFrontend", PallasMelFrontend(jcfg, interpret=True))):
        want = np.asarray(fe(jnp.asarray(wav)))
        err = np.abs(got - want).max()
        print(f"n_fft {n_fft}: replay vs JAX {name} {want.shape}: max err {err:.2e}")
        assert got.shape == want.shape
        assert err <= 1e-4
    assert silent > 0
    np.testing.assert_array_equal(got[0, :silent], np.float32(np.log(np.float32(1e-5))))


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_replay_on_clips_like_phase_8(n_fft):
    """On 2 clips of three sines and noise (0.1), the replay is within
    max(1e-4, the fp32 plain version's own error) of the plain version in
    float64; on quieter clips (noise 0.01, ill-conditioned in the log
    domain for every route) both errors are printed, not gated. Printed
    beside them: the same kernel with an fp32 chirp-z stage."""
    cfg, _ = _spec(n_fft)
    tables = log_mel_tables(cfg, "cpu")
    for noise, gated in ((0.1, True), (0.01, False)):
        wav = _clips(2, 44100, noise, n_fft)
        ref = _plain(wav, cfg, np.float64)
        err = np.abs(_replay(wav, tables)[1] - ref).max()
        fp32_err = np.abs(_replay(wav, tables, np.complex64)[1] - ref).max()
        plain_err = np.abs(_plain(wav, cfg, np.float32) - ref).max()
        limit = max(1e-4, plain_err)
        print(f"n_fft {n_fft} noise {noise}: replay vs float64 plain {err:.2e}, the fp32 "
              f"plain's {plain_err:.2e}" + (f" (limit {limit:.2e})" if gated else
                                              " (not gated)")
              + f"; with an fp32 stage {fp32_err:.2e}")
        assert err <= limit or not gated


def test_route_table():
    """Every n_fft that took "fft" or "mixed" before the Bluestein kernel
    still does; of the rest, n_fft from 3 whose L fits in the kernel's
    14406 points (odd to 9603, even to 14406) take "bluestein", the others
    (n_fft 1 and 2, odd from 9605, even from 14408) "dft"."""
    for n_fft in range(1, 15001):
        old, new = _old_route(n_fft), log_mel_route(n_fft, 80, 300)
        if old != "dft":
            assert new == old, n_fft
        else:
            fits = n_fft >= 3 and bluestein_sizes(n_fft)[2] <= BLUESTEIN_MAX_POINTS
            assert new == ("bluestein" if fits else "dft"), n_fft
    assert [log_mel_route(n, 80, 300) for n in (1201, 2050, 1144, 88, 9603, 14406, 10000)] \
        == ["bluestein"] * 7
    assert [log_mel_route(n, 80, 300) for n in (2, 9605, 14408, 16384)] == ["dft"] * 4
    # the planner's L at the shapes phase 8 times (2401 = 7^4, 1875 = 3 5^4)
    assert (bluestein_length(2050), bluestein_length(1201)) == (2401, 1875)


def test_fake_gives_jax_frame_count_at_odd_n_fft():
    """The op's fake implementation (what a traced program records) gives
    JAX's frames at n_fft 1201, hop 300: 15,000 samples -> 50, not 51."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t = log_mel_tables(_spec(1201, hop_length=300)[0], "cpu")
    wav = torch.zeros((2, 15000))
    args = (wav, t.fbank, t.cos, t.sin, t.premul, t.chirp, t.plan, t.twiddles,
            t.spectrum, t.split, t.bands, t.weights, t.hop, t.n_fft)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if torch.is_tensor(a) else a for a in args]
        assert torch.ops.mqgan.log_mel_bluestein(*fake).shape == (2, 50, 128)


def test_kernel_wrapper_launches_or_raises():
    """The Bluestein route's wrapper takes CUDA tensors only (no quiet
    fallback to the plain version or the DFT kernel); the entry point gives
    a CPU tensor the plain version through the op."""
    from mqgan_tpu_torch.ops.stft_kernels import (log_mel_bluestein,
                                                  log_mel_bluestein_kernel)

    cfg, _ = _spec(2050)
    t = log_mel_tables(cfg, "cpu")
    args = (t.fbank, t.cos, t.sin, t.premul, t.chirp, t.plan, t.twiddles, t.spectrum,
            t.split, t.bands, t.weights, t.hop, t.n_fft)
    wav = torch.from_numpy(_clips(1, 4000, 0.1, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        log_mel_bluestein_kernel(wav, *args)
    with pytest.raises(ValueError, match="unsupported device"):
        log_mel_bluestein(wav.to("meta"), *args)
    assert torch.equal(log_mel_bluestein(wav, *args),
                       log_mel_plain(wav, t.cos, t.sin, t.fbank, t.hop))
