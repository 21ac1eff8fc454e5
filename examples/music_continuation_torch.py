"""Genre-conditioned music continuation on the PyTorch port: sample FSQ
tokens from the trained LM, decode them through the codec, optionally vocode
to audio.

The counterpart of examples/music_continuation.py:
  tokens ~ LM(genre [, prompt])  ->  PreEncoder.decode  ->  mel  ->  wav,
with the LM a run dir of mqgan_tpu_torch.train.lstm_trainer and the codec an
artifact of mqgan_tpu_torch.deploy.export (or a checkpoint and its config).
Runs on the card unless --device cpu is given. The sampler draws from the
port's own key chain (models/lm_sampling.py), so a seed gives other tokens
than under JAX.

Usage:
  python examples/music_continuation_torch.py --model_dir CODEC_EXPORT \
      --lm_run LM_OUT_DIR --genre 0 --length 256 --out cont.npy \
      [--prompt_mel some_mel.npy] [--wav_out cont.wav --spec_config spec.yaml]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import wave

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_dir", help="exported codec artifact")
    p.add_argument("--codec_checkpoint", default=None,
                   help="raw codec checkpoint (alternative to --model_dir; "
                        "needs --codec_config)")
    p.add_argument("--codec_config", default=None,
                   help="codec model yaml (with --codec_checkpoint)")
    p.add_argument("--seq_parallel", action="store_true",
                   help="checkpoint codec only: decode the sampled clip with "
                        "its time axis cut into windows over every visible "
                        "card (parallel/seqpar.py)")
    p.add_argument("--lm_run", required=True,
                   help="lstm_trainer out_dir (reads best.json + checkpoint)")
    p.add_argument("--genre", type=int, default=0)
    p.add_argument("--length", type=int, default=256, help="tokens to sample")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=0.0,
                   help="nucleus sampling mass (0 disables)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prompt_mel", default=None,
                   help=".npy mel to encode and continue from")
    p.add_argument("--out", required=True, help="output mel .npy")
    p.add_argument("--wav_out", default=None)
    p.add_argument("--spec_config", default=None,
                   help="needed with --wav_out (Griffin-Lim vocoding)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card is an error) or cpu")
    args = p.parse_args(argv)

    import torch

    from mqgan_tpu_torch.deploy.export_lm import load_lm_from_run
    from mqgan_tpu_torch.models.lm_sampling import (generate_tokens,
                                                    generate_tokens_transformer)
    from mqgan_tpu_torch.models.token_lm import lm_arch

    if args.model_dir:
        if args.seq_parallel:
            p.error("--seq_parallel needs --codec_checkpoint/--codec_config")
        from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder

        codec = ExportedPreEncoder(args.model_dir, device=args.device)
    elif args.codec_checkpoint and args.codec_config:
        from mqgan_tpu_torch.deploy.reencode import CheckpointReencoder

        codec = CheckpointReencoder(args.codec_config, args.codec_checkpoint,
                                    seq_parallel=args.seq_parallel, device=args.device)
    else:
        p.error("provide --model_dir, or --codec_checkpoint with "
                "--codec_config")

    # the trainer embeds its run args in best.json, so the LM architecture
    # (lstm_trainer --arch) is read from there
    model, lm_args = load_lm_from_run(args.lm_run, args.device)
    device = next(model.parameters()).device

    prompt = None
    if args.prompt_mel:
        mel = np.load(args.prompt_mel).astype(np.float32)[None]  # (1, T, M)
        max_t = codec.buckets[-1]
        if mel.shape[1] > max_t:
            mel = mel[:, -max_t:]  # keep the most recent frames as prompt
            print(f"prompt truncated to the last {max_t} frames")
        prompt = torch.as_tensor(codec.encode(mel), dtype=torch.long, device=device)
        print(f"prompt: {prompt.shape[1]} tokens from {args.prompt_mel}")

    # specials (pad/BOS and anything past the codec codebook) are masked
    # out of the sampling distribution so every token decodes meaningfully
    forbidden = tuple(
        {lm_args["pad_id"], lm_args["bos_id"]}
        | set(range(codec.codebook_size, lm_args["vocab_size"]))
    )
    sampler = (generate_tokens_transformer if lm_arch(model) == "transformer"
               else generate_tokens)
    with torch.no_grad():
        tokens = sampler(
            model, torch.tensor([args.genre], device=device), args.seed,
            max_len=args.length, temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, bos_id=lm_args["bos_id"], prompt=prompt,
            forbidden_tokens=forbidden,
        )
    tokens_np = tokens.cpu().numpy()
    print(f"sampled tokens: {tokens_np.shape}, "
          f"range [{tokens_np.min()}, {tokens_np.max()}], "
          f"{len(np.unique(tokens_np))} unique")

    mel_out = codec.decode(tokens_np)  # (1, L, mel)
    np.save(args.out, mel_out[0])
    print(f"wrote {args.out}: {mel_out[0].shape}")

    if args.wav_out:
        assert args.spec_config, "--wav_out needs --spec_config"
        from mqgan_tpu_torch.core.config import SpecConfig
        from mqgan_tpu_torch.signal.griffin_lim import GriffinLimVocoder

        spec_cfg = SpecConfig.from_yaml(args.spec_config)
        voc = GriffinLimVocoder(spec_cfg.spectrogram, n_iter=32)
        wav = voc(torch.as_tensor(mel_out, device=device)).cpu().numpy()[0, 0]
        peak = np.abs(wav).max()
        if peak > 0:
            wav = wav / peak * spec_cfg.spectrogram.target_amplitude
        with wave.open(args.wav_out, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(spec_cfg.spectrogram.sampling_rate)
            w.writeframes((np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes())
        print(f"wrote {args.wav_out}: "
              f"{len(wav) / spec_cfg.spectrogram.sampling_rate:.2f}s")


if __name__ == "__main__":
    main()
