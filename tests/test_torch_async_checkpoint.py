"""PyTorch port: the codec trainer's ``--async_checkpoint``
(``utils/checkpoint.py`` ``CheckpointWriter``) on the CPU, at the tiny
config of ``test_torch_gan_trainer.py``: an async run writes the state a
synchronous run writes and resumes from it; a save waits for the one
before; a failed write raises; the host copy is taken before the caller
goes on; a SIGTERM stop leaves one complete checkpoint."""

import json
import os
import signal
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from mqgan_tpu_torch.core.config import TrainConfig
from mqgan_tpu_torch.train import trainer as trainer_mod
from mqgan_tpu_torch.train.state import create_train_state
from mqgan_tpu_torch.train.step import build_models
from mqgan_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_gan_step import one_torch_thread  # noqa: F401 - the fixture
from tests.test_torch_gan_trainer import _cli, run  # noqa: F401 - the fixture

JOIN_S = 60


def _same(a, b, where="") -> None:
    """Two loaded checkpoints hold equal values (tensors bit for bit)."""
    assert type(a) is type(b), where
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_async_run_writes_the_sync_state_and_resumes(run, tmp_path):
    cfg_path, out = run
    _cli(cfg_path)
    async_out = str(tmp_path / "async_run")
    trainer = _cli(cfg_path, "--async_checkpoint", "--output_dir", async_out)
    assert trainer.config.logging.async_save
    for epoch in (1, 2):
        name = f"checkpoint_epoch_{epoch:03d}.pt"
        _same(_load(os.path.join(out, name)), _load(os.path.join(async_out, name)))
    assert not [f for f in os.listdir(async_out) if ".tmp" in f]
    more = json.loads(open(cfg_path).read())
    more["training"]["num_epochs"] = 3
    with open(cfg_path, "w") as f:
        json.dump(more, f)
    resumed = _cli(cfg_path, "--async_checkpoint", "--output_dir", async_out)
    assert resumed.start_epoch == 3
    assert ckpt.latest_checkpoint(async_out)[1] == 3
    assert _load(ckpt.latest_checkpoint(async_out)[0])["state"]["step"] == resumed.state.step


def test_a_save_waits_for_the_one_before():
    writer = ckpt.CheckpointWriter()
    release, order = threading.Event(), []

    def slow(tag):
        assert release.wait(JOIN_S)
        order.append(tag)

    writer.submit(slow, "first")
    second = threading.Thread(target=writer.submit, args=(order.append, "second"))
    second.start()
    time.sleep(0.2)
    assert order == [] and second.is_alive()  # blocked behind the first
    release.set()
    second.join(JOIN_S)
    assert not second.is_alive()
    writer.wait()
    assert order == ["first", "second"]


def test_a_failed_write_raises_at_the_next_save_or_wait():
    writer = ckpt.CheckpointWriter()

    def broken():
        raise OSError("disk full")

    writer.submit(broken)
    with pytest.raises(RuntimeError, match="background checkpoint") as err:
        writer.wait()
    assert isinstance(err.value.__cause__, OSError)
    writer.wait()  # raised once
    writer.submit(broken)
    with pytest.raises(RuntimeError, match="background checkpoint"):
        writer.submit(lambda: None)


def test_the_host_copy_is_taken_before_save_returns(tmp_path):
    """20 background saves of a state changed in place right after each:
    every file holds the values at its save (a shortened switch interval
    lets the writer thread interleave with the changes)."""
    weight = torch.zeros(64)
    state = SimpleNamespace(
        state_dict=lambda: {"step": int(weight[0]), "w": weight, "nested": [weight]},
        lecam=SimpleNamespace(ema_real=torch.zeros(())))
    writer = ckpt.CheckpointWriter()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for epoch in range(1, 21):
            weight.fill_(epoch)
            ckpt.save_checkpoint(str(tmp_path), state, epoch, writer=writer)
            weight.fill_(-1.0)
        writer.wait()
    finally:
        sys.setswitchinterval(interval)
    for epoch in range(1, 21):
        saved = _load(tmp_path / f"checkpoint_epoch_{epoch:03d}.pt")
        assert saved["epoch"] == epoch and saved["state"]["step"] == epoch
        assert torch.equal(saved["state"]["w"], torch.full((64,), float(epoch)))
        assert torch.equal(saved["state"]["nested"][0], saved["state"]["w"])


def test_sigterm_stop_leaves_one_complete_checkpoint(run, monkeypatch):
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
    trainer = _cli(cfg_path, "--async_checkpoint")
    assert trainer.state.step == 2
    names = os.listdir(out)
    assert [n for n in names if n.startswith("checkpoint")] == ["checkpoint_epoch_001.pt"]
    assert "config.json" in names and not [n for n in names if ".tmp" in n]
    path, epoch = ckpt.latest_checkpoint(out)
    cfg = TrainConfig.from_dict(json.loads(open(cfg_path).read()))
    fresh = create_train_state(*build_models(cfg), cfg.training, torch.device("cpu"))
    assert epoch == 1 and ckpt.restore_checkpoint(path, fresh) == 1
    for k, v in trainer.state.gen.state_dict().items():
        assert torch.equal(fresh.gen.state_dict()[k], v), k
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
