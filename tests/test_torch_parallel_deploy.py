"""PyTorch port: parallel codec serving on the CPU (the devices a list that
repeats "cpu"): the data-parallel runtime and re-encode against one
device, sequence-parallel re-encode against a full-length pass, the
re-encode and HTTP CLIs' flags, and the trainer's exact sequence-parallel
eval against a full-length pass; the narrow config with weights from the
JAX package's init (tests/test_torch_bridge.py)."""

import io
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.core.config import GeneratorConfig, TrainConfig
from mqgan_tpu_torch.deploy import export, http_server, reencode
from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.parallel.mesh import repeat_pad_rows, split_rows
from mqgan_tpu_torch.parallel.seqpar import plan_seq_reencode
from mqgan_tpu_torch.train import trainer as trainer_mod
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import MELS, NARROW, narrow_jax_params
from tests.test_torch_gan_trainer import run  # noqa: F401 - the fixture
from tests.test_torch_gan_step import MEL as GAN_MEL

TOL = 1e-5


def _model(**kw):
    _, tree = narrow_jax_params()
    model = PreEncoder(MELS, **NARROW, **kw)
    model.load_state_dict(state_dict_from_jax(tree, model))
    return model.eval()


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp") / "exp")
    return export.export_preencoder(_model(), GeneratorConfig(**NARROW), out,
                                    buckets=(32, 64), verify=False)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    cfg = str(root / "model.json")
    with open(cfg, "w") as f:
        json.dump({"model": {"mel_channels": MELS, "generator": NARROW}}, f)
    path = str(root / "gen.pt")
    torch.save(_model().state_dict(), path)
    return cfg, path


def _full_pass(model, x, lengths, t_pad):
    b, t = x.shape[0], x.shape[1]
    xp = torch.zeros((b, t_pad, MELS))
    xp[:, :t] = torch.from_numpy(x)
    pad = torch.arange(t_pad)[None, :] >= torch.from_numpy(np.asarray(lengths))[:, None]
    idx = model.encode(xp, pad)
    return idx[:, :t].numpy(), model.decode(idx, pad)[:, :t].numpy()


def test_rows_pad_and_split():
    a = np.arange(5)[:, None] * np.ones((1, 3))
    (padded,) = repeat_pad_rows((a,), 3)
    np.testing.assert_array_equal(padded[:, 0], [0, 1, 2, 3, 4, 0])
    parts = split_rows((padded,), 3)
    assert [p[0][:, 0].tolist() for p in parts] == [[0, 1], [2, 3], [4, 0]]
    with pytest.raises(ValueError, match="divide"):
        split_rows((a,), 2)


def test_data_parallel_runtime_equals_one_device(artifact):
    one = ExportedPreEncoder(artifact, device="cpu")
    three = ExportedPreEncoder(artifact, device="cpu", data_parallel=True,
                               devices=["cpu"] * 3)
    assert (one.n_devices, three.n_devices) == (1, 3)
    assert ExportedPreEncoder(artifact, device="cpu", data_parallel=True).n_devices == 1
    rng = np.random.default_rng(0)
    lengths = np.array([50, 50, 31, 7, 1], np.int32)
    x = rng.standard_normal((5, 50, MELS)).astype(np.float32)
    tok1, mel1 = one.reencode(x, lengths)
    tok3, mel3 = three.reencode(x, lengths)
    assert tok3.shape == (5, 50) and mel3.shape == (5, 50, MELS)
    np.testing.assert_array_equal(tok3, tok1)
    np.testing.assert_allclose(mel3, mel1, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(three.encode(x, lengths), one.encode(x, lengths))
    np.testing.assert_allclose(three.decode(tok1, lengths), one.decode(tok1, lengths),
                               atol=TOL, rtol=TOL)


def test_seq_parallel_reencoder_equals_a_full_length_pass(checkpoint):
    cfg, path = checkpoint
    codec = reencode.CheckpointReencoder(cfg, path, seq_parallel=True,
                                         poly_mixers="decode", device="cpu",
                                         devices=["cpu"] * 4)
    assert codec.unbounded_length and codec.model.poly_mixers is False
    rng = np.random.default_rng(1)
    t = 300  # beyond the largest bucket: one call, no host chunking
    lengths = np.array([300, 129], np.int32)
    x = rng.standard_normal((2, t, MELS)).astype(np.float32)
    tokens, mel = codec.reencode(x, lengths)
    t_pad = plan_seq_reencode(512, 4, NARROW["kernel_sizes"],
                              NARROW["refiner_depth"]).t_pad
    want_tokens, want = _full_pass(codec.model, x, lengths, t_pad)
    for r, n in enumerate(lengths):
        np.testing.assert_array_equal(tokens[r, :n], want_tokens[r, :n])
        np.testing.assert_allclose(mel[r, :n], want[r, :n], atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(codec.encode(x, lengths)[r, :n], want_tokens[r, :n])
    dec = codec.decode(want_tokens, lengths)
    for r, n in enumerate(lengths):
        np.testing.assert_allclose(dec[r, :n], want[r, :n], atol=TOL, rtol=TOL)


def test_data_parallel_reencoder_and_the_exclusive_modes(checkpoint):
    cfg, path = checkpoint
    with pytest.raises(ValueError, match="mutually exclusive"):
        reencode.CheckpointReencoder(cfg, path, data_parallel=True, seq_parallel=True,
                                     device="cpu")
    with pytest.raises(ValueError, match="device list"):
        reencode.CheckpointReencoder(cfg, path, device="cpu", devices=["cpu"])
    one = reencode.CheckpointReencoder(cfg, path, device="cpu")
    two = reencode.CheckpointReencoder(cfg, path, data_parallel=True, device="cpu",
                                       devices=["cpu", "cpu"])
    assert two.n_devices == 2 and not two.unbounded_length
    x = np.random.default_rng(2).standard_normal((3, 40, MELS)).astype(np.float32)
    lengths = np.array([40, 12, 3], np.int32)
    for got, want in zip(two.reencode(x, lengths), one.reencode(x, lengths)):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _mels(root, lengths, seed):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    mels = {}
    for i, n in enumerate(lengths):
        mels[f"m{i}.npy"] = rng.standard_normal((n, MELS)).astype(np.float32)
        np.save(os.path.join(root, f"m{i}.npy"), mels[f"m{i}.npy"])
    return mels


def test_reencode_cli_parallel_flags(tmp_path, artifact, checkpoint):
    cfg, path = checkpoint
    src = str(tmp_path / "mels")
    mels = _mels(src, (20, 64, 150, 7), 3)
    common = ["--input_dir", src, "--device", "cpu", "--save_tokens"]
    dp = reencode.main(common + ["--output_dir", str(tmp_path / "dp"), "--tokens_dir",
                                 str(tmp_path / "dp_t"), "--model_dir", artifact,
                                 "--data_parallel"])
    base = reencode.main(common + ["--output_dir", str(tmp_path / "one"), "--tokens_dir",
                                   str(tmp_path / "one_t"), "--model_dir", artifact])
    assert dp == base == {"processed": 4, "failed": 0, "frames": 241}
    seq = reencode.main(common + ["--output_dir", str(tmp_path / "seq"), "--tokens_dir",
                                  str(tmp_path / "seq_t"), "--checkpoint", path,
                                  "--config", cfg, "--seq_parallel"])
    assert seq["processed"] == 4
    model = _model()
    for name, m in mels.items():
        np.testing.assert_array_equal(np.load(tmp_path / "dp_t" / name),
                                      np.load(tmp_path / "one_t" / name))
        grid = reencode.CheckpointReencoder.SEQ_LEN_GRID
        tp = -(-len(m) // grid) * grid
        want_tokens, want = _full_pass(model, m[None], [len(m)], tp)
        np.testing.assert_array_equal(np.load(tmp_path / "seq_t" / name), want_tokens[0])
        np.testing.assert_allclose(np.load(tmp_path / "seq" / name), want[0], atol=TOL,
                                   rtol=TOL)
    out = ["--output_dir", str(tmp_path / "x")]
    with pytest.raises(SystemExit):  # an artifact has no sequence-parallel mode
        reencode.main(common + out + ["--model_dir", artifact, "--seq_parallel"])
    with pytest.raises(SystemExit):
        reencode.main(common + out + ["--checkpoint", path, "--config", cfg,
                                      "--seq_parallel", "--data_parallel"])


def test_http_server_data_parallel_serves(artifact, monkeypatch):
    served = {}

    def one_request(server):
        try:
            with urllib.request.urlopen(server.url + "/healthz", timeout=30) as r:
                served["health"] = json.loads(r.read())
            buf = http_server._npy_bytes(np.zeros((20, MELS), np.float32))
            req = urllib.request.Request(server.url + "/encode", data=buf,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                served["tokens"] = np.load(io.BytesIO(r.read()))
        finally:
            server.close()

    monkeypatch.setattr(http_server, "serve_until_interrupted",
                        lambda server: one_request(server.start()))
    http_server.main(["--model_dir", artifact, "--port", "0", "--device", "cpu",
                      "--data_parallel", "--max_delay_ms", "1"])
    assert served["health"]["n_devices"] == 1 and served["tokens"].shape == (20,)


def test_trainer_seq_parallel_eval_equals_a_full_length_pass(run):
    cfg_path, _ = run
    cfg = TrainConfig.from_dict(json.loads(open(cfg_path).read()))
    trainer = trainer_mod.Trainer(cfg, device="cpu", use_wandb=False,
                                  dtype=torch.float32)
    try:
        mel = np.random.default_rng(4).standard_normal((300, GAN_MEL)).astype(np.float32)
        assert trainer._eval_clip_seq_parallel(mel, trainer._eval_gen(), 512) is None
        trainer.eval_devices = ["cpu"] * 2
        pre, post, metrics = trainer._eval_clip(mel)
        gen = trainer._eval_gen()
        t_pad = 512  # 300 on the 256-frame grid
        x = torch.zeros((1, t_pad, GAN_MEL))
        x[0, :300] = torch.from_numpy(mel)
        pad = torch.arange(t_pad)[None, :] >= 300
        want_post, want_pre = gen.decode(gen.encode(x, pad), pad, return_recon=True)
        np.testing.assert_allclose(pre, want_pre[0, :300].numpy(), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(post, want_post[0, :300].numpy(), atol=TOL, rtol=TOL)
        assert metrics["eval_recon_post_mse"] == pytest.approx(
            float(np.mean((want_post[0, :300].numpy() - mel) ** 2)), rel=1e-5)
    finally:
        trainer.logger.close()
