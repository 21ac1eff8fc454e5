"""PyTorch port: the wav -> log-mel conversion CLI against the JAX one on
the same wav tree (the port with ``--device cpu``)."""

import os
import wave

import numpy as np
import pytest
import torch

from mqgan_tpu.signal.convert import main as jax_convert_main
from mqgan_tpu_torch.signal.convert import main as convert_main
from tests.test_torch_bridge import max_err

SR = 16000
N_MELS = 40
TOL = 5e-4  # the front end's gate (tests/test_pallas_kernels.py)


def _write_wav(path, data, sr):
    pcm = (np.clip(data, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def _config(tmp_path, out):
    cfg = tmp_path / f"{out}.yaml"
    cfg.write_text(f"""
io:
  input_folder: {tmp_path / 'audio'}
  output_folder: {tmp_path / out}
  audio_extensions: [".wav"]
spectrogram:
  sampling_rate: {SR}
  filter_length: 512
  hop_length: 128
  win_length: 512
  n_mel_channels: {N_MELS}
  mel_fmin: 0.0
  mel_fmax: 8000.0
""")
    return str(cfg)


def _outputs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.fixture
def wav_tree(tmp_path):
    rng = np.random.default_rng(0)
    genre = tmp_path / "audio" / "genre"
    other = tmp_path / "audio" / "other"
    genre.mkdir(parents=True)
    other.mkdir(parents=True)
    _write_wav(genre / "good.wav", rng.standard_normal(SR * 2) * 0.2, SR)
    _write_wav(genre / "short.wav", rng.standard_normal(SR // 2) * 0.2, SR)  # gated
    _write_wav(genre / "rate.wav", rng.standard_normal(44100) * 0.2, 22050)  # resampled
    _write_wav(other / "two.wav", rng.standard_normal(int(SR * 1.3)) * 0.2, SR)
    return tmp_path


@pytest.fixture
def one_thread(monkeypatch):
    """One BLAS thread here and in spawned workers, so that the sums of the
    plain front end run in one order whatever the load on the host."""
    threads = torch.get_num_threads()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_convert_cli_matches_jax(wav_tree, one_thread):
    jax_convert_main(["--config", _config(wav_tree, "mels_jax"), "--num_workers", "1"])
    port_cfg = _config(wav_tree, "mels")
    convert_main(["--config", port_cfg, "--num_workers", "1", "--device", "cpu"])

    want = ["genre/good_mel.npy", "genre/rate_mel.npy", "other/two_mel.npy"]
    assert _outputs(wav_tree / "mels") == _outputs(wav_tree / "mels_jax") == want
    for rel in want:
        got, ref = np.load(wav_tree / "mels" / rel), np.load(wav_tree / "mels_jax" / rel)
        print(f"{rel} {got.shape}: max err {max_err(got, ref):.2e}")
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    assert np.load(wav_tree / "mels" / want[0]).shape == (SR * 2 // 128 + 1, N_MELS)

    # resume-skip: a rerun leaves every output untouched
    mtimes = {rel: os.path.getmtime(wav_tree / "mels" / rel) for rel in want}
    convert_main(["--config", port_cfg, "--num_workers", "1", "--device", "cpu"])
    assert {rel: os.path.getmtime(wav_tree / "mels" / rel) for rel in want} == mtimes

    # two spawned workers write the same files
    convert_main(["--config", port_cfg, "--num_workers", "2", "--device", "cpu",
                  "--output_folder", str(wav_tree / "mels_2w")])
    assert _outputs(wav_tree / "mels_2w") == want
    for rel in want:
        np.testing.assert_allclose(np.load(wav_tree / "mels_2w" / rel),
                                   np.load(wav_tree / "mels" / rel), atol=1e-6, rtol=0)


def test_convert_on_cuda_without_a_card_raises(wav_tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert_main(["--config", _config(wav_tree, "mels"), "--num_workers", "1"])
    assert not (wav_tree / "mels").exists()


def test_convert_propagates_front_end_errors(wav_tree, monkeypatch, capsys):
    """A kernel or front-end failure stops the run; an unreadable file is
    skipped with a message."""
    (wav_tree / "audio" / "genre" / "broken.wav").write_bytes(b"not a wav")

    def failing_log_mel(*args):
        raise RuntimeError("log_mel launch failed")

    monkeypatch.setattr("mqgan_tpu_torch.ops.stft_kernels.log_mel", failing_log_mel)
    with pytest.raises(RuntimeError, match="log_mel launch failed"):
        convert_main(["--config", _config(wav_tree, "mels"), "--num_workers", "1",
                      "--device", "cpu"])
    monkeypatch.undo()
    convert_main(["--config", _config(wav_tree, "mels"), "--num_workers", "1",
                  "--device", "cpu"])
    assert "Error reading" in capsys.readouterr().out
    assert _outputs(wav_tree / "mels") == ["genre/good_mel.npy", "genre/rate_mel.npy",
                                           "other/two_mel.npy"]
