"""PyTorch port: the three example scripts (``examples/*_torch.py``) run to
their end on the CPU at a tiny config: the serving demo against an artifact
that the port's ``deploy/export.py`` writes, the music continuation from a
run dir of the port's LM trainer's format through that artifact (with a
prompt and Griffin-Lim audio), and the audio reconstruction demo on a short
synthetic wav through seeded codec weights and Griffin-Lim."""

import importlib.util
import json
import os
import wave

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.core.config import GeneratorConfig
from mqgan_tpu_torch.deploy.export import export_preencoder
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.models.token_lm import build_token_lm
from mqgan_tpu_torch.utils.init import seeded_init_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MELS = 16
NARROW = dict(channels=(16, 24), kernel_sizes=(3,), refiner_base_channels=4,
              refiner_depth=1)
SPEC = {"spectrogram": {"sampling_rate": 16000, "filter_length": 256,
                        "hop_length": 64, "win_length": 256, "n_mel_channels": MELS,
                        "mel_fmax": 8000.0}}
LM = dict(arch="transformer", vocab_size=1003, num_genres=3, emb_dim=16, n_layers=1,
          n_heads=2, mlp_ratio=2, pad_id=0, bos_id=1)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A codec artifact (buckets 16, 32, 64), its model config, a spec
    config, an LM run dir, a prompt mel and a 0.4 s wav."""
    root = tmp_path_factory.mktemp("examples")
    gen = GeneratorConfig(**NARROW)
    model = seeded_init_(PreEncoder.from_config(MELS, gen), 0)
    art = export_preencoder(model, gen, str(root / "codec"), buckets=(16, 32, 64),
                            verify=False, device="cpu")
    with open(root / "model.json", "w") as f:
        json.dump({"model": {"mel_channels": MELS, "generator": NARROW}}, f)
    with open(root / "spec.yaml", "w") as f:
        json.dump(SPEC, f)  # JSON is YAML
    run = root / "lm"
    run.mkdir()
    lm = seeded_init_(build_token_lm(LM), 0)
    torch.save(lm.state_dict(), run / "model.pt")
    with open(run / "best.json", "w") as f:
        json.dump({"epoch": 1, "val_loss": 1.0, "path": str(run / "model.pt"),
                   "args": LM}, f)
    rng = np.random.default_rng(0)
    np.save(root / "prompt.npy", rng.standard_normal((40, MELS)).astype(np.float32))
    t = np.arange(6400) / 16000.0
    pcm = 0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(t.shape)
    with wave.open(str(root / "in.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((pcm * 32767).astype(np.int16).tobytes())
    return root, art


def _read_wav(path):
    with wave.open(str(path)) as w:
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), np.int16)


@pytest.mark.parametrize("name", ["serving_demo_torch", "music_continuation_torch",
                                  "audio_reconstruction_demo_torch"])
def test_example_runs_on_the_cpu(files, name, capsys):
    root, art = files
    cpu = ["--device", "cpu"]
    if name == "serving_demo_torch":
        _example(name).main(["--model_dir", art, "--clips", "6", "--max_delay_ms", "50",
                             *cpu])
        out = capsys.readouterr().out
        assert "6 clips served; stats: {" in out and "mean_batch_size" in out
    elif name == "music_continuation_torch":
        _example(name).main(["--model_dir", art, "--lm_run", str(root / "lm"),
                             "--genre", "2", "--length", "20", "--top_k", "5",
                             "--prompt_mel", str(root / "prompt.npy"),
                             "--out", str(root / "cont.npy"),
                             "--wav_out", str(root / "cont.wav"),
                             "--spec_config", str(root / "spec.yaml"), *cpu])
        out = capsys.readouterr().out
        assert "prompt: 40 tokens" in out and "sampled tokens: (1, 20)" in out
        mel = np.load(root / "cont.npy")
        assert mel.shape == (20, MELS) and np.isfinite(mel).all()
        rate, pcm = _read_wav(root / "cont.wav")
        assert rate == 16000 and pcm.size >= 19 * 64 and pcm.any()
    else:
        _example(name).main(["--wav", str(root / "in.wav"), "--out",
                             str(root / "out.wav"), "--spec_config",
                             str(root / "spec.yaml"), "--random", "--config",
                             str(root / "model.json"), "--gl_iters", "4", *cpu])
        out = capsys.readouterr().out
        assert "mel: (101, 16)" in out and "recon mel: (101, 16)" in out
        rate, pcm = _read_wav(root / "out.wav")
        assert rate == 16000 and pcm.size > 6000 and pcm.any()
