"""End-to-end audio reconstruction demo on the PyTorch port.

The counterpart of examples/audio_reconstruction_demo.py (the script
equivalent of the reference audio_reconstruction_demo.ipynb): load a wav,
extract log-mels with the port's front end (signal/mel.py, the log-mel
kernel on a card), encode to FSQ tokens, decode back to a refined mel,
vocode to a waveform, and write the result — with the notebook's
config-consistency assertions (mel channels / sample rate, demo cell 2).
Runs on the card unless --device cpu is given.

Vocoder options:
  --vocoder_dir  an ISTFTNetFE artifact of this package (signal/vocoder.py
                 export_ts, or train/vocoder_trainer.py --export_dir)
  (default)      Griffin-Lim (signal/griffin_lim.py) — no external weights
                 needed

Codec options:
  --model_dir    an artifact of mqgan_tpu_torch.deploy.export
  --checkpoint + --config   raw checkpoint
  --random      untrained seeded weights (pipeline smoke demo)

Usage:
  python examples/audio_reconstruction_demo_torch.py --wav in.wav --out out.wav \
      --spec_config spec.yaml [--model_dir EXPORT | --random --config m.yaml]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import wave

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_wav(path: str, wav_f32: np.ndarray, sr: int):
    pcm = (np.clip(wav_f32, -1, 1) * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--wav", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--spec_config", required=True)
    p.add_argument("--model_dir")
    p.add_argument("--checkpoint")
    p.add_argument("--config")
    p.add_argument("--random", action="store_true",
                   help="random untrained codec weights (smoke demo)")
    p.add_argument("--vocoder_dir", help="ISTFTNetFE artifact of this package")
    p.add_argument("--gl_iters", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card is an error) or cpu")
    args = p.parse_args(argv)

    import torch

    from mqgan_tpu_torch.core.config import SpecConfig, load_model_config
    from mqgan_tpu_torch.core.device import resolve_device
    from mqgan_tpu_torch.signal.audio import load_audio, resample, to_mono
    from mqgan_tpu_torch.signal.mel import MelFrontend

    device = resolve_device(args.device)
    spec_cfg = SpecConfig.from_yaml(args.spec_config)
    s = spec_cfg.spectrogram

    # ---- 1. wav -> log-mel --------------------------------------------
    wav, sr = load_audio(args.wav)
    if sr and sr != s.sampling_rate:
        wav = resample(wav, sr, s.sampling_rate)
    wav = to_mono(wav)
    frontend = MelFrontend(s, device=device)
    mel = frontend(wav[0]).cpu().numpy()  # (T, n_mels)
    print(f"mel: {mel.shape}, range [{mel.min():.2f}, {mel.max():.2f}]")

    # ---- 2. codec ------------------------------------------------------
    if args.model_dir:
        from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder

        codec = ExportedPreEncoder(args.model_dir, device=device)
        # notebook cell-2 consistency assertions
        assert codec.mel_channels == s.n_mel_channels, (
            f"model expects {codec.mel_channels} mels, spec config produces "
            f"{s.n_mel_channels}"
        )
    elif args.checkpoint and args.config:
        from mqgan_tpu_torch.deploy.reencode import CheckpointReencoder

        codec = CheckpointReencoder(args.config, args.checkpoint, device=device)
        assert codec.mel_channels == s.n_mel_channels
    elif args.random and args.config:
        from mqgan_tpu_torch.deploy.runtime import CodecRuntime
        from mqgan_tpu_torch.models.preencoder import PreEncoder
        from mqgan_tpu_torch.utils.init import seeded_init_

        cfg = load_model_config(args.config)
        assert cfg.model.mel_channels == s.n_mel_channels
        gen = seeded_init_(PreEncoder.from_config(cfg.model.mel_channels,
                                                  cfg.model.generator), 0)
        # one bucket of the clip's own length: the whole clip, as the JAX
        # demo's raw model takes it
        codec = CodecRuntime(gen, buckets=(mel.shape[0],), device=device)
    else:
        p.error("provide --model_dir, --checkpoint+--config, or --random+--config")

    max_t = codec.buckets[-1]
    if mel.shape[0] > max_t:
        print(f"clip is {mel.shape[0]} frames; demo truncates to the largest "
              f"exported bucket ({max_t}) — use deploy.reencode for chunked "
              f"full-length processing")
        mel = mel[:max_t]

    tokens = codec.encode(mel[None].astype(np.float32))
    print(f"tokens: {tokens.shape}, vocab range [{tokens.min()}, {tokens.max()}]")
    recon = codec.decode(tokens)[0]  # (T, n_mels)
    mse = float(np.mean((recon - mel) ** 2))
    print(f"recon mel: {recon.shape}, MSE vs original {mse:.4f}")

    # ---- 3. vocode -----------------------------------------------------
    with torch.no_grad():
        if args.vocoder_dir:
            from mqgan_tpu_torch.signal.vocoder import ISTFTNetFE

            fe = ISTFTNetFE.load_ts(args.vocoder_dir, device=device)
            # iSTFTNet consumes (B, n_mels, T)
            wav_out = fe(torch.as_tensor(recon.T[None].copy(), device=device))
        else:
            from mqgan_tpu_torch.signal.griffin_lim import GriffinLimVocoder

            voc = GriffinLimVocoder(s, n_iter=args.gl_iters)
            wav_out = voc(torch.as_tensor(recon[None], device=device))
    wav_out = wav_out.cpu().numpy()[0, 0]

    peak = np.abs(wav_out).max()
    if peak > 0:
        wav_out = wav_out / peak * s.target_amplitude
    write_wav(args.out, wav_out, s.sampling_rate)
    print(f"wrote {args.out}: {wav_out.shape[0] / s.sampling_rate:.2f}s "
          f"@ {s.sampling_rate} Hz")


if __name__ == "__main__":
    main()
