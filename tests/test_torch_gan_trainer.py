"""The port's GAN trainer CLI on the CPU at a tiny config, on a temp dir of
seeded .npy mels: two epochs (the discriminator from epoch 2, so both
phases run) write finite metrics, plots and checkpoints; a rerun with more
epochs resumes; SIGTERM mid-epoch leaves a loadable checkpoint; the
generator saved by ``save_generator_only`` exports through
``deploy/export.py`` and ``ExportedPreEncoder`` reproduces the trained
model's eval output; the CLI's refusals."""

import json
import math
import os
import signal

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.core.config import TrainConfig
from mqgan_tpu_torch.deploy import export
from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder
from mqgan_tpu_torch.train import trainer as trainer_mod
from mqgan_tpu_torch.train.state import create_train_state
from mqgan_tpu_torch.train.step import build_models
from mqgan_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_discriminators import _synthetic_patch_sd
from tests.test_torch_gan_step import (  # noqa: F401 - the fixture
    MEL, one_torch_thread, tiny_config_dict)


@pytest.fixture
def run(tmp_path):
    """(config path, output dir): 14 mels of 20-90 frames, batch 4, crops
    32/24, eval and save every epoch, one plot."""
    mels = tmp_path / "mels"
    mels.mkdir()
    rng = np.random.default_rng(0)
    for i in range(14):
        np.save(mels / f"m{i:02d}.npy", rng.standard_normal(
            (int(rng.integers(20, 90)), MEL)).astype(np.float32))
    cfg = tiny_config_dict(use_fm=True, dropout=0.1, fsq_noise_dropout=0.5)
    cfg["data"] = {"data_dir": str(mels), "output_dir": str(tmp_path / "run"),
                   "validation_split": 0.15, "crop_len": [32, 24], "batch_size": 4}
    cfg["training"].update(num_epochs=2, discriminator_train_start_epoch=2)
    cfg["logging"] = {"eval_interval": 1, "save_interval": 1, "num_plot_examples": 1}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path), str(tmp_path / "run")


def _cli(cfg_path, *extra):
    return trainer_mod.main(["--config", cfg_path, "--device", "cpu", "--fp32",
                             "--no_wandb", *extra])


def _records(out):
    with open(os.path.join(out, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_epochs_then_resume(run):
    cfg_path, out = run
    trainer = _cli(cfg_path, "--ema", "0.9", "--keep_best")
    recs = _records(out)
    train = [r for r in recs if "loss_g_total" in r]
    assert {r["epoch"] for r in train} == {1.0, 2.0}
    for r in recs:
        assert all(math.isfinite(v) for v in r.values() if isinstance(v, float)), r
    assert all(r["loss_d"] == 0.0 for r in train if r["epoch"] == 1.0)
    assert all(r["loss_d"] > 0.0 and r["loss_fm"] > 0.0
               for r in train if r["epoch"] == 2.0)
    assert [r["epoch"] for r in recs if "eval_recon_post_mse" in r] == [1.0, 2.0]
    assert ckpt.latest_checkpoint(out)[1] == 2
    assert os.path.isfile(os.path.join(out, "generator_best.pt"))
    assert os.path.isdir(os.path.join(out, "plots"))
    steps = trainer.state.step

    more = json.loads(open(cfg_path).read())
    more["training"]["num_epochs"] = 3
    with open(cfg_path, "w") as f:
        json.dump(more, f)
    resumed = _cli(cfg_path, "--ema", "0.9")
    assert resumed.start_epoch == 3
    assert resumed.state.step == steps + steps // 2  # epoch 3 continued the count
    assert ckpt.latest_checkpoint(out)[1] == 3
    epochs = [r["epoch"] for r in _records(out) if "loss_g_total" in r]
    assert epochs.count(1.0) == epochs.count(3.0)  # epoch 1 not rerun


def test_sigterm_mid_epoch_leaves_a_loadable_checkpoint(run, monkeypatch):
    cfg_path, out = run
    make_step = trainer_mod.make_train_step

    def stepping_then_signal(*a, **kw):
        step = make_step(*a, **kw)

        def wrapped(state, mel, lengths):
            metrics = step(state, mel, lengths)
            if state.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return metrics
        return wrapped

    monkeypatch.setattr(trainer_mod, "make_train_step", stepping_then_signal)
    trainer = _cli(cfg_path)
    assert trainer.state.step == 2  # stopped at the step boundary
    path, epoch = ckpt.latest_checkpoint(out)
    assert epoch == 1
    cfg = TrainConfig.from_dict(json.loads(open(cfg_path).read()))
    fresh = create_train_state(*build_models(cfg), cfg.training, torch.device("cpu"))
    assert ckpt.restore_checkpoint(path, fresh) == 1
    assert fresh.step == 2
    for k, v in trainer.state.gen.state_dict().items():
        assert torch.equal(fresh.gen.state_dict()[k], v), k
    assert torch.equal(fresh.dropout_rng.get_state(),
                       trainer.state.dropout_rng.get_state())
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_saved_generator_exports_and_reproduces_eval(run, tmp_path):
    cfg_path, out = run
    trainer = _cli(cfg_path)
    gen_path = ckpt.save_generator_only(str(tmp_path), trainer.state.gen.state_dict())
    art = str(tmp_path / "artifact")
    export.main(["--config", cfg_path, "--checkpoint", gen_path, "--output", art,
                 "--buckets", "64", "--exact_mixers", "--device", "cpu"])
    rt = ExportedPreEncoder(art, device="cpu")
    mel = np.random.default_rng(9).standard_normal((2, 64, MEL)).astype(np.float32)
    lengths = np.array([64, 64], np.int32)
    tokens = rt.encode(mel, lengths)
    got = rt.decode(tokens, lengths)
    _, want, want_tokens, _ = trainer._eval_step(
        trainer.state.gen, torch.from_numpy(mel), torch.from_numpy(lengths))
    np.testing.assert_array_equal(tokens, want_tokens.numpy())
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=1e-5)


def test_pretrained_takes_generator_and_discriminators(run, tmp_path):
    cfg_path, _ = run
    cfg = TrainConfig.from_dict(json.loads(open(cfg_path).read()))
    gen, _, _ = build_models(cfg)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    dp, dm = cfg.model.discriminator_patch, cfg.model.discriminator_multibin
    mb_sd = {}
    for i in range(dm.n_bins):
        mb_sd.update(_synthetic_patch_sd(rng, f"discriminators.{i}.", dm.hidden_channels,
                                         tuple((3, k) for k in dm.kernel_sizes)))
    path = str(tmp_path / "ref.pth")
    torch.save({"model_state_dict": gen.state_dict(),
                "discriminator_patch_state_dict": _synthetic_patch_sd(
                    rng, "", dp.hidden_channels, dp.kernel_sizes),
                "discriminator_multibin_state_dict": mb_sd}, path)
    cfg_d = json.loads(open(cfg_path).read())
    cfg_d["training"]["pretrained"] = path
    t = trainer_mod.Trainer(TrainConfig.from_dict(cfg_d), device="cpu",
                            use_wandb=False, dtype=torch.float32)
    for k, v in gen.state_dict().items():
        assert torch.equal(t.state.gen.state_dict()[k], v), k
    want = ckpt.load_pretrained_discriminators(path, cfg.model)
    for mod, sd in zip((t.state.patch, t.state.multibin), want):
        for k, v in sd.items():
            assert torch.equal(mod.state_dict()[k], v), k
    w = mb_sd["discriminators.1.convs.2.weight_orig"]
    assert torch.equal(t.state.multibin.discriminators[1].convs[2].weight, w)
    t.logger.close()


def test_cli_refusals(run):
    cfg_path, _ = run
    with pytest.raises(SystemExit):
        _cli(cfg_path, "--fast_dropout", "--exact_dropout")
    with pytest.raises(SystemExit, match="Queue 1 item 8"):
        _cli(cfg_path, "--seq_par", "2")
    with pytest.raises(SystemExit):
        _cli(cfg_path, "--rng_impl", "rbg")  # a JAX knob: not accepted
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer_mod.main(["--config", cfg_path, "--no_wandb"])
