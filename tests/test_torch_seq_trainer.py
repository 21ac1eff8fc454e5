"""The codec trainer CLI with ``--seq_par`` on CPU ranks (gloo), on
tests/test_torch_multihost_trainer.py's uneven dataset and tiny config
(crops of 24 and 32 frames): two ``--multihost --seq_par 2`` processes
equal one process (final parameters within JAX's own gate, rtol 1e-3 and
atol 5e-5, and the same metric records; the random streams inert), and
their checkpoint resumes in one process as the one-process checkpoint
does. The refusals: a crop that N does not divide (before any rank
starts), a seq group that spans hosts (on every rank), ``--seq_par`` on a
missing card. And the grid the trainer spawns for itself."""

import os

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.parallel import multihost
from mqgan_tpu_torch.parallel.mesh import check_seq_hosts, train_devices, train_grid
from mqgan_tpu_torch.train import trainer
from tests.test_torch_multihost_trainer import (_Run, _config, _final_params, _records,
                                                _start)


def _seq_ranks(cfg_path, n=2):
    port = multihost.free_port()
    return _Run([_start(cfg_path, "--multihost", "--coordinator", f"127.0.0.1:{port}",
                        "--num_processes", str(n), "--process_id", str(i),
                        "--seq_par", str(n), inert=True)
                 for i in range(n)])


def _resume(monkeypatch, tmp_path, out):
    """One more epoch of the run in ``out``, in this process, streams inert."""
    make = trainer.create_train_state

    def inert(*args, **kwargs):
        state = make(*args, **kwargs)
        state.dropout_rng = state.fsq_rng = None
        return state

    monkeypatch.setattr(trainer, "create_train_state", inert)
    t = trainer.main(["--config", _config(tmp_path, out, num_epochs=3, save_interval=1),
                      "--device", "cpu", "--fp32", "--no_wandb"])
    return t


def test_seq_par_2_equals_one_process_and_resumes_at_seq_1(tmp_path, monkeypatch):
    one_out, seq_out = tmp_path / "one", tmp_path / "seq"
    one = _Run([_start(_config(tmp_path, one_out), inert=True)])
    seq = _seq_ranks(_config(tmp_path, seq_out))
    one.join()
    log = seq.join()
    assert "seq rank 1 of 2" in log and "backend gloo" in log
    want, got = _final_params(one_out), _final_params(seq_out)
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-3, atol=5e-5,
                                   err_msg=f"{k} differs between seq 2 and one process")
    # rank 0 alone writes: the same files, each metric record once
    assert sorted(os.listdir(seq_out)) == sorted(os.listdir(one_out))
    rec_one, rec_seq = _records(one_out), _records(seq_out)
    assert len(rec_seq) == len(rec_one) > 0
    for a, b in zip(rec_one, rec_seq):
        assert a.keys() == b.keys() and a.get("_step") == b.get("_step")
        for k in ("loss_g_total", "loss_d", "loss_recon_post", "eval_recon_post_mse"):
            if k in a:
                assert abs(a[k] - b[k]) <= 1e-4 * max(1.0, abs(a[k])), (k, a[k], b[k])
        if "frames_per_sec" in a:  # the global batch's frames
            assert b["frames_per_sec"] == a["frames_per_sec"] > 0
    # the seq-2 checkpoint is a one-process checkpoint: resumed at seq 1
    # it trains on as the one-process run's does
    resumed = [_resume(monkeypatch, tmp_path, out) for out in (one_out, seq_out)]
    assert [t.start_epoch for t in resumed] == [3, 3]
    assert resumed[0].state.step == resumed[1].state.step > 0
    for (k, v), w in zip(resumed[1].state.gen.state_dict().items(),
                         resumed[0].state.gen.state_dict().values()):
        np.testing.assert_allclose(v.numpy(), w.numpy(), rtol=1e-3, atol=5e-5,
                                   err_msg=f"resumed gen.{k}")


def test_a_crop_that_seq_par_does_not_divide_raises_before_any_rank(tmp_path,
                                                                     monkeypatch):
    spawned = []
    monkeypatch.setattr(trainer, "spawn_ranks", lambda *a: spawned.append(a))
    cfg = _config(tmp_path, tmp_path / "odd")
    with pytest.raises(ValueError, match=r"crop buckets \[32\] do not divide by the "
                                         r"sequence-parallel factor 3"):
        trainer.main(["--config", cfg, "--device", "cpu", "--seq_par", "3"])
    assert not spawned


def _host_rank(rank, world, device, cfg_path):
    """A rank that reports a host of its own, then joins --seq_par 2."""
    multihost.host_name = lambda: f"host{rank}"
    trainer.main(["--config", cfg_path, "--device", "cpu", "--fp32", "--no_wandb",
                  "--multihost", "--seq_par", "2"])


def test_a_seq_group_across_hosts_raises_on_every_rank(tmp_path):
    with pytest.raises(RuntimeError, match="spans hosts") as err:
        multihost.launch(_host_rank, ["cpu", "cpu"], (_config(tmp_path, tmp_path / "h"),),
                         timeout_s=90, group_timeout_s=60)
    assert "['host0', 'host1']" in str(err.value)
    with pytest.raises(ValueError, match="group 1 .* spans hosts"):
        check_seq_hosts(["a", "a", "b", "c"], 2)
    check_seq_hosts(["a", "a", "b", "b"], 2)  # data across hosts is fine


def test_the_grid_the_trainer_spawns(tmp_path, monkeypatch):
    assert train_devices(["c0", "c1", "c2", "c3"], 2) == ["c0", "c1", "c2", "c3"]
    assert train_devices(["c0"], 2) == ["c0", "c0"]
    assert train_devices(["c0", "c1"], 4) == ["c0", "c1", "c0", "c1"]
    with pytest.raises(ValueError, match="one must divide the other"):
        train_devices(["c0", "c1", "c2"], 2)
    assert [train_grid(r, 4, 2) for r in range(4)] == [
        (0, 2, 0), (0, 2, 1), (1, 2, 0), (1, 2, 1)]
    spawned = []
    monkeypatch.setattr(trainer, "spawn_ranks", lambda d, argv: spawned.append(d))
    argv = ["--config", _config(tmp_path, tmp_path / "g"), "--seq_par", "2"]
    assert trainer.main(argv + ["--device", "cpu"]) is None
    assert [str(d) for d in spawned[0]] == ["cpu", "cpu"]
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError):
            trainer.main(argv + ["--device", "cuda"])
