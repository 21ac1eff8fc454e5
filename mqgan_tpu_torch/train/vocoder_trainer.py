"""Vocoder pretraining CLI, mel -> waveform (counterpart of
``mqgan_tpu/train/vocoder_trainer.py``).

Trains the iSTFTNet-style generator (``models/istft_vocoder.py``) with the
multi-resolution STFT objective (plus an optional waveform L1). With
``--adversarial`` the HiFi-GAN MPD/MSD discriminators
(``models/wave_discriminators.py``) join after ``--adv_start_step`` with
LSGAN and feature-matching terms.

The data path: wav files -> ``SegmentSampler`` (random segments drawn from
``np.random.default_rng(seed)`` in the JAX trainer's order, so both pick the
same segments; their log-mels through ``signal/mel.py`` ``MelFrontend``, one
log-mel kernel launch a batch on the card) -> generator -> ``istft_ola``
(the JAX package's overlap-add, with no host read) -> loss. Each update is
``optax.adamw(lr)`` with optax's defaults (``train/state.py`` ``ClipAdamW``
with no clip: weight decay 1e-4) and the JAX trainer's NaN skip: a
non-finite loss leaves that model's parameters and moments as they were,
with no host synchronisation. Metrics are fetched from the card only at log
points. ``torch.profiler`` ranges ``voc/sample``, ``voc/g_forward``,
``voc/stft_loss``, ``voc/d_forward``, ``voc/d_backward``, ``voc/g_backward``
and ``voc/optim`` name the parts of a step.

Constraint: prod(upsample_rates) * istft_hop must equal the mel hop length.

Usage: python -m mqgan_tpu_torch.train.vocoder_trainer --wav_dir D
       --spec_config spec.yaml|spec.json --out_dir RUN [--steps N] [...]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List

import numpy as np
import torch
from torch.profiler import record_function

from mqgan_tpu_torch.core.config import SpecConfig
from mqgan_tpu_torch.core.device import resolve_device
from mqgan_tpu_torch.losses.stft_loss import multi_resolution_stft_loss
from mqgan_tpu_torch.models.istft_vocoder import ISTFTNetGenerator
from mqgan_tpu_torch.models.wave_discriminators import (
    MultiPeriodDiscriminator, MultiScaleDiscriminator, adversarial_d_loss,
    adversarial_g_loss, feature_matching_loss)
from mqgan_tpu_torch.signal.audio import load_audio, resample, to_mono
from mqgan_tpu_torch.signal.mel import MelFrontend
from mqgan_tpu_torch.signal.stft import istft_ola
from mqgan_tpu_torch.train.state import ClipAdamW
from mqgan_tpu_torch.utils.logging import MetricsLogger


def find_wavs(wav_dir: str) -> List[str]:
    out = []
    for root, _, files in os.walk(wav_dir):
        for fn in files:
            if fn.lower().endswith((".wav", ".wave", ".npy")):
                out.append(os.path.join(root, fn))
    return sorted(out)


class SegmentSampler:
    """Random fixed-length waveform segments and their log-mels, on
    ``device`` (None: CUDA)."""

    def __init__(self, files, spec_cfg, segment_frames: int, seed: int = 0,
                 device=None):
        self.spec = spec_cfg.spectrogram
        self.frontend = MelFrontend(self.spec, device)
        self.device = self.frontend.device
        self.segment_frames = segment_frames
        self.segment_samples = segment_frames * self.spec.hop_length
        self.rng = np.random.default_rng(seed)
        self.wavs = []
        for path in files:
            try:
                wav, sr = load_audio(path)
                if sr and sr != self.spec.sampling_rate:
                    wav = resample(wav, sr, self.spec.sampling_rate)
                wav = to_mono(wav)[0]
                if wav.shape[0] >= self.segment_samples:
                    self.wavs.append(wav.astype(np.float32))
            except Exception as e:  # noqa: BLE001
                print(f"skipping {path}: {e}")
        if not self.wavs:
            raise ValueError("no usable wav files (need >= segment length)")
        print(f"{len(self.wavs)} usable clips")

    def batch(self, batch_size: int):
        """(mel (B, n_mels, segment_frames), wav (B, segment_samples)) on
        the device; one log-mel launch."""
        with record_function("voc/sample"):
            segs = np.zeros((batch_size, self.segment_samples), np.float32)
            for i in range(batch_size):
                w = self.wavs[self.rng.integers(len(self.wavs))]
                start = self.rng.integers(0, w.shape[0] - self.segment_samples + 1)
                segs[i] = w[start: start + self.segment_samples]
            wav = torch.from_numpy(segs).to(self.device)
            mel = self.frontend(wav)  # (B, F + 1, M)
            # trim to exactly segment_frames (the centred stft gives +1)
            return mel[:, : self.segment_frames].transpose(1, 2), wav


def synth(gen: ISTFTNetGenerator, mel: torch.Tensor, n_fft: int,
          istft_hop: int) -> torch.Tensor:
    """mel (B, n_mels, T) -> waveform (B, samples), differentiable."""
    spec, phase = gen(mel)
    return istft_ola(spec, phase, n_fft, istft_hop, n_fft)


def common_length(gen: ISTFTNetGenerator, frames: int, n_fft: int,
                  istft_hop: int, target_len: int) -> int:
    """The samples both prediction and target keep: the iSTFT output is a
    few samples shorter than frames * hop."""
    return min(n_fft + istft_hop * (frames * gen.total_upsample - 1)
               - 2 * (n_fft // 2), target_len)


def make_spectral_step(gen, tx: ClipAdamW, opt_state: dict, *, n_fft: int,
                       istft_hop: int, target_len: int,
                       wav_l1_lambda: float = 0.0):
    """The spectral step ``step(mel, wav) -> loss``: MR-STFT (plus
    ``wav_l1_lambda`` x L1) over the common length, one AdamW update of the
    generator in place, skipped where the loss is not finite."""
    params = list(gen.parameters())

    def step(mel, wav):
        with record_function("voc/g_forward"):
            pred = synth(gen, mel, n_fft, istft_hop)
        n = min(pred.shape[1], target_len)
        with record_function("voc/stft_loss"):
            loss = multi_resolution_stft_loss(pred[:, :n], wav[:, :n])
            if wav_l1_lambda:
                loss = loss + wav_l1_lambda * torch.mean(
                    torch.abs(pred[:, :n] - wav[:, :n]))
        with record_function("voc/g_backward"):
            grads = torch.autograd.grad(loss, params)
        with record_function("voc/optim"):
            tx.step_(params, grads, opt_state, torch.isfinite(loss))
        return loss.detach()

    return step


def make_adv_step(gen, mpd, msd, tx: ClipAdamW, d_tx: ClipAdamW,
                  opt_state: dict, d_opt_state: dict, *, n_fft: int,
                  istft_hop: int, target_len: int, stft_lambda: float = 45.0,
                  adv_lambda: float = 1.0, fm_lambda: float = 2.0):
    """The adversarial step ``step(mel, wav) -> metrics`` (device scalars):
    first the D update on a fake made without gradient, then the G update
    (stft_lambda * MR-STFT + adv_lambda * LSGAN + fm_lambda * FM) through
    the updated D, with the real feature maps detached. Each update is
    skipped where its own loss is not finite."""
    g_params = list(gen.parameters())
    d_params = list(mpd.parameters()) + list(msd.parameters())

    def step(mel, wav):
        n = common_length(gen, mel.shape[2], n_fft, istft_hop, target_len)
        wav = wav[:, :n]
        with record_function("voc/g_forward"), torch.no_grad():
            fake = synth(gen, mel, n_fft, istft_hop)[:, :n]
        with record_function("voc/d_forward"):
            ro, _ = mpd(wav)
            fo, _ = mpd(fake)
            ro2, _ = msd(wav)
            fo2, _ = msd(fake)
            d_loss = adversarial_d_loss([ro, ro2], [fo, fo2])
        with record_function("voc/d_backward"):
            d_grads = torch.autograd.grad(d_loss, d_params)
        with record_function("voc/optim"):
            d_tx.step_(d_params, d_grads, d_opt_state, torch.isfinite(d_loss))

        with record_function("voc/g_forward"):
            pred = synth(gen, mel, n_fft, istft_hop)[:, :n]
        with record_function("voc/d_forward"):
            with torch.no_grad():
                _, rf = mpd(wav)
                _, rf2 = msd(wav)
            fo, ff = mpd(pred)
            fo2, ff2 = msd(pred)
            g_adv = adversarial_g_loss([fo, fo2])
            fm = feature_matching_loss([*rf, *rf2], [*ff, *ff2])
        with record_function("voc/stft_loss"):
            stft_l = multi_resolution_stft_loss(pred, wav)
        total = stft_lambda * stft_l + adv_lambda * g_adv + fm_lambda * fm
        with record_function("voc/g_backward"):
            g_grads = torch.autograd.grad(total, g_params)
        with record_function("voc/optim"):
            tx.step_(g_params, g_grads, opt_state, torch.isfinite(total))
        return {"g_total": total.detach(), "stft": stft_l.detach(),
                "adv": g_adv.detach(), "fm": fm.detach(),
                "d_loss": d_loss.detach()}

    return step


def load_spec_config(path: str) -> SpecConfig:
    """A spec config from YAML (needs PyYAML) or from JSON of the same
    shape."""
    if path.endswith(".json"):
        with open(path) as f:
            return SpecConfig.from_dict(json.load(f))
    return SpecConfig.from_yaml(path)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Pretrain the iSTFTNet-style vocoder.")
    p.add_argument("--wav_dir", required=True)
    p.add_argument("--spec_config", required=True,
                   help="spec YAML (needs PyYAML) or JSON of the same keys")
    p.add_argument("--out_dir", default="logs/vocoder-run1")
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--segment_frames", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--save_every", type=int, default=5000)
    p.add_argument("--upsample_rates", type=int, nargs="+", default=[8, 8])
    p.add_argument("--istft_n_fft", type=int, default=16)
    p.add_argument("--upsample_initial_channel", type=int, default=512)
    p.add_argument("--wav_l1_lambda", type=float, default=0.0)
    p.add_argument("--adversarial", action="store_true")
    p.add_argument("--adv_start_step", type=int, default=0)
    p.add_argument("--adv_lambda", type=float, default=1.0)
    p.add_argument("--fm_lambda", type=float, default=2.0)
    p.add_argument("--stft_lambda", type=float, default=45.0,
                   help="MR-STFT weight when adversarial terms are active")
    p.add_argument("--d_lr", type=float, default=2e-4)
    p.add_argument("--mpd_periods", type=int, nargs="+", default=[2, 3, 5, 7, 11])
    p.add_argument("--msd_scales", type=int, default=3)
    p.add_argument("--export_dir", default=None,
                   help="after training, export the ISTFTNetFE artifact "
                        "(signal/vocoder.py load_ts format) here")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute, fp32 params: the conv stack runs in "
                        "bf16; the generator's spec/phase heads, the "
                        "discriminators and the MR-STFT loss stay fp32")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    return p.parse_args(argv)


def build_generator(n_mels: int, upsample_rates, upsample_initial_channel: int,
                    istft_n_fft: int, bf16: bool = False) -> ISTFTNetGenerator:
    """The CLI's generator: upsample kernels 2r + 1, as the JAX CLI builds
    them."""
    return ISTFTNetGenerator(
        n_mels=n_mels, upsample_rates=tuple(upsample_rates),
        upsample_kernel_sizes=tuple(2 * r + 1 for r in upsample_rates),
        upsample_initial_channel=upsample_initial_channel,
        istft_n_fft=istft_n_fft, dtype=torch.bfloat16 if bf16 else None)


def main(argv=None):
    from mqgan_tpu_torch.utils.checkpoint import save_generator_only
    from mqgan_tpu_torch.utils.init import seeded_init_

    args = parse_args(argv)
    device = resolve_device(args.device)
    spec_cfg = load_spec_config(args.spec_config)
    hop = spec_cfg.spectrogram.hop_length
    total_up = int(np.prod(args.upsample_rates))
    assert hop % total_up == 0, (
        f"prod(upsample_rates)={total_up} must divide hop_length={hop}")
    istft_hop = hop // total_up
    assert istft_hop * 2 <= args.istft_n_fft, (
        f"istft_hop={istft_hop} needs istft_n_fft >= {2 * istft_hop} for "
        f"overlap-add coverage (increase --istft_n_fft or add upsampling)")

    gen = build_generator(spec_cfg.spectrogram.n_mel_channels,
                          args.upsample_rates, args.upsample_initial_channel,
                          args.istft_n_fft, args.bf16)
    seeded_init_(gen, args.seed).to(device).train()
    sampler = SegmentSampler(find_wavs(args.wav_dir), spec_cfg,
                             args.segment_frames, args.seed, device)
    # the JAX trainer draws a batch to trace its init: drawn here too, so
    # that both trainers go on with the same segments
    sampler.batch(args.batch_size)
    n_params = sum(p.numel() for p in gen.parameters())
    print(f"Generator parameters: {n_params / 1e6:.2f} M; "
          f"istft hop {istft_hop}, total upsample {total_up}")

    tx = ClipAdamW(args.lr, float("inf"))
    opt = tx.init(gen.parameters())
    os.makedirs(args.out_dir, exist_ok=True)
    logger = MetricsLogger(args.out_dir, run_name="vocoder")

    n_fft = args.istft_n_fft
    target_len = args.segment_frames * hop
    step = make_spectral_step(gen, tx, opt, n_fft=n_fft, istft_hop=istft_hop,
                              target_len=target_len,
                              wav_l1_lambda=args.wav_l1_lambda)

    adv_step = mpd = msd = None
    if args.adversarial:
        mpd = seeded_init_(MultiPeriodDiscriminator(periods=tuple(args.mpd_periods)),
                           1).to(device).train()
        msd = seeded_init_(MultiScaleDiscriminator(n_scales=args.msd_scales),
                           2).to(device).train()
        d_tx = ClipAdamW(args.d_lr, float("inf"))
        d_opt = d_tx.init(list(mpd.parameters()) + list(msd.parameters()))
        adv_step = make_adv_step(
            gen, mpd, msd, tx, d_tx, opt, d_opt, n_fft=n_fft,
            istft_hop=istft_hop, target_len=target_len,
            stft_lambda=args.stft_lambda, adv_lambda=args.adv_lambda,
            fm_lambda=args.fm_lambda)

    t0 = time.time()
    for i in range(1, args.steps + 1):
        mel, wav = sampler.batch(args.batch_size)
        m = None
        if adv_step is not None and i > args.adv_start_step:
            m = adv_step(mel, wav)
            loss = m["g_total"]
        else:
            loss = step(mel, wav)
        if i % args.log_every == 0 or i == 1:
            # the only device fetches: at log points
            extra = ({f"vocoder/{k}": float(v) for k, v in m.items()}
                     if m is not None else {})
            logger.log({"vocoder/loss": float(loss), **extra,
                        "steps_per_sec": i / (time.time() - t0)}, step=i)
            print(f"step {i}: loss {float(loss):.4f}")
        if i % args.save_every == 0 or i == args.steps:
            path = save_generator_only(args.out_dir, gen.state_dict(),
                                       f"vocoder_step_{i}")
            if mpd is not None:
                save_generator_only(
                    args.out_dir,
                    {**{f"mpd.{k}": v for k, v in mpd.state_dict().items()},
                     **{f"msd.{k}": v for k, v in msd.state_dict().items()}},
                    f"vocoder_disc_step_{i}")
            print(f"saved {path}")

    if args.export_dir:
        from mqgan_tpu_torch.models.istft_vocoder import build_vocoder_fe

        fe = build_vocoder_fe(gen, istft_hop=istft_hop)
        fe.export_ts(args.export_dir,
                     sampling_rate=spec_cfg.spectrogram.sampling_rate,
                     mel_channels=spec_cfg.spectrogram.n_mel_channels,
                     example_frames=args.segment_frames)
        print(f"exported deployable vocoder to {args.export_dir}")

    logger.close()
    print("Vocoder training finished.")
    return gen


if __name__ == "__main__":
    main()
