"""The codec trainer CLI as two ``--multihost`` processes (gloo, CPU) on
tests/test_parallel.py's uneven 13-file dataset (11 train files, batch 8:
rank 1's rows of the second batch are all fill rows), two epochs (warmup,
then the discriminators), fp32: the final parameters equal a
one-process run's (rtol 1e-3, atol 5e-5: JAX's own gate,
tests/test_parallel.py:286-292), and rank 0 alone writes (the metrics file
holds the one-process run's records, once). The equality runs hold the
random streams inert (each rank draws its own dropout masks). SIGTERM to
both ranks mid-run, rank 1's after rank 0 has seen its own: one
checkpoint, both exit 0, and a two-process rerun resumes from it; the same
from a SIGTERM to a parent that spawned its ranks; a rank killed mid-run
fails the other, which does not hang. Then the LM trainer's ``--pipe``: its refusals, and a tiny run that
trains."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.parallel.multihost import free_port
from mqgan_tpu_torch.train import lstm_trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 120


def _dataset(root, n=13, mel=12):
    """tests/test_parallel.py's ``_make_uneven_dataset``."""
    host = np.random.default_rng(123)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        t = int(host.integers(16, 60))
        np.save(os.path.join(root, f"clip_{i:03d}.npy"),
                host.standard_normal((t, mel)).astype(np.float32))
    return root


def _config(tmp_path, out, num_epochs=2, save_interval=2):
    """tests/multihost_worker.py's tiny config, as the port's JSON."""
    cfg = {
        "data": {"data_dir": _dataset(str(tmp_path / "mels")), "output_dir": str(out),
                 "validation_split": 0.2, "crop_len": [24, 32], "batch_size": 8},
        "model": {
            "mel_channels": 12,
            "generator": {"channels": [8, 12], "kernel_sizes": [3], "dropout": 0.0,
                          "fsq_levels": [8, 5, 5, 5], "fsq_noise_dropout": 0.0,
                          "refiner_base_channels": 4, "refiner_depth": 2},
            "discriminator_patch": {"hidden_channels": [4, 8], "kernel_sizes": [3, 3, 3],
                                    "strides": [[1, 2], [2, 2], [1, 1]]},
            "discriminator_multibin": {"hidden_channels": [4, 4],
                                       "kernel_sizes": [3, 3, 3], "n_bins": 2,
                                       "n_no_strides": 1}},
        "training": {"num_epochs": num_epochs, "warmup_steps": 3,
                     "discriminator_train_start_epoch": 2, "seed": 0},
        "logging": {"eval_interval": 1, "save_interval": save_interval,
                    "num_plot_examples": 0},
    }
    path = tmp_path / f"cfg_{os.path.basename(str(out))}_{num_epochs}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env.update(PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")
    return env


# the trainer CLI with its random streams inert (the parity tests' mode:
# the mixers' and the refiner's dropout is 0.1 whatever the config says, and
# each rank draws its own masks, so runs of 1 and 2 processes are equal only
# without draws), and its clock stopped, so that frames_per_sec is the
# frames counted over the floor of 1e-9 s and equal in runs of 1 and 2
# processes when both count the global batch
_INERT_CLI = """
import sys
import types
from mqgan_tpu_torch.train import trainer

trainer.time = types.SimpleNamespace(time=lambda: 0.0)

make = trainer.create_train_state

def inert(*args, **kwargs):
    state = make(*args, **kwargs)
    state.dropout_rng = state.fsq_rng = None
    return state

trainer.create_train_state = inert
trainer.main(sys.argv[1:])
"""


def _start(cfg_path, *extra, inert=False):
    cli = ["-c", _INERT_CLI] if inert else ["-m", "mqgan_tpu_torch.train.trainer"]
    return subprocess.Popen(
        [sys.executable, *cli, "--config", cfg_path, "--device", "cpu", "--fp32",
         "--no_wandb", *extra],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


class _Run:
    """Processes whose output is read by threads (so a full pipe never
    blocks them), killed when the run outlives its timeout."""

    def __init__(self, procs):
        self.procs = procs
        self.logs = [[] for _ in procs]
        self.threads = [threading.Thread(target=self._read, args=(p, log), daemon=True)
                        for p, log in zip(procs, self.logs)]
        for t in self.threads:
            t.start()

    @staticmethod
    def _read(proc, log):
        for line in proc.stdout:
            log.append(line)

    def wait_for(self, text, rank=0, timeout=RUN_TIMEOUT_S):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if any(text in line for line in self.logs[rank]):
                return
            if any(p.poll() is not None for p in self.procs):
                break
            time.sleep(0.05)
        self.kill()
        raise AssertionError(f"no {text!r} from rank {rank}:\n{self.text()}")

    def join(self, timeout=RUN_TIMEOUT_S):
        deadline = time.monotonic() + timeout
        for p in self.procs:
            try:
                p.wait(max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                self.kill()
                raise AssertionError(f"the run hung:\n{self.text()}")
        for t in self.threads:
            t.join(10)
        codes = [p.returncode for p in self.procs]
        assert codes == [0] * len(codes), f"exit codes {codes}:\n{self.text()}"
        return self.text()

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()

    def text(self):
        return "\n----\n".join("".join(log) for log in self.logs)


def _two_ranks(cfg_path, *extra, inert=False):
    port = free_port()
    return _Run([_start(cfg_path, "--multihost", "--coordinator", f"127.0.0.1:{port}",
                        "--num_processes", "2", "--process_id", str(i), *extra,
                        inert=inert)
                 for i in range(2)])


def _final_params(out):
    path = os.path.join(out, "checkpoint_epoch_002.pt")
    state = torch.load(path, map_location="cpu", weights_only=True)["state"]
    return {f"{m}.{k}": v for m in ("gen", "patch", "multibin")
            for k, v in state[m].items()}


def _records(out):
    with open(os.path.join(out, "train_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_processes_equal_one_process(tmp_path):
    one_out, two_out = tmp_path / "one", tmp_path / "two"
    one = _Run([_start(_config(tmp_path, one_out), "--keep_best", inert=True)])
    two = _two_ranks(_config(tmp_path, two_out), "--keep_best", inert=True)
    one.join()
    log = two.join()
    assert "backend gloo" in log and "rank 1 of 2" in log
    want, got = _final_params(one_out), _final_params(two_out)
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-3, atol=5e-5,
                                   err_msg=f"{k} differs between 1 and 2 processes")
    # rank 0 alone writes: the same files, and each metric record once
    assert sorted(os.listdir(two_out)) == sorted(os.listdir(one_out))
    rec_one, rec_two = _records(one_out), _records(two_out)
    assert len(rec_two) == len(rec_one) > 0
    for a, b in zip(rec_one, rec_two):
        assert a.keys() == b.keys() and a.get("_step") == b.get("_step")
        for k in ("loss_g_total", "loss_d", "eval_recon_post_mse"):
            if k in a:
                assert abs(a[k] - b[k]) <= 1e-4 * max(1.0, abs(a[k])), (k, a[k], b[k])
        if "frames_per_sec" in a:  # the global batch's frames, on rank 0 too
            assert b["frames_per_sec"] == a["frames_per_sec"] > 0, (
                a["frames_per_sec"], b["frames_per_sec"])


def test_sigterm_stops_both_ranks_once_and_a_rerun_resumes(tmp_path):
    out = tmp_path / "pre"
    run = _two_ranks(_config(tmp_path, out, num_epochs=50, save_interval=99))
    run.wait_for("Epoch 1:")
    # a preemption signals every rank, not at once: rank 1's may come after
    # the ranks have agreed to stop (then it is not a second signal)
    run.procs[0].send_signal(signal.SIGTERM)
    run.wait_for("signal 15")
    run.procs[1].send_signal(signal.SIGTERM)
    log = run.join()
    assert log.count("checkpoint written") == 2  # each rank says so
    ckpts = [f for f in os.listdir(out) if f.startswith("checkpoint_epoch_")]
    assert len(ckpts) == 1, ckpts
    epoch = int(ckpts[0][len("checkpoint_epoch_"):-3])
    resumed = _two_ranks(_config(tmp_path, out, num_epochs=epoch + 1,
                                 save_interval=99)).join()
    assert resumed.count(f"Resuming from") == 2 and "Training finished." in resumed


_SPAWN_CLI = """
import sys
from mqgan_tpu_torch.train import trainer

trainer.spawn_ranks(["cpu", "cpu"], sys.argv[1:])
"""


def test_sigterm_to_the_spawning_parent_stops_its_ranks_once(tmp_path):
    """The default over several cards: one process spawns the ranks
    (``spawn_ranks``, here over two CPU ranks). A SIGTERM to that process
    alone reaches the ranks as a request to stop: one checkpoint, and the
    parent exits 0 after its ranks."""
    out = tmp_path / "spawned"
    cfg_path = _config(tmp_path, out, num_epochs=50, save_interval=99)
    run = _Run([subprocess.Popen(
        [sys.executable, "-c", _SPAWN_CLI, "--config", cfg_path, "--fp32",
         "--no_wandb"], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)])
    run.wait_for("Epoch 1:")
    run.procs[0].send_signal(signal.SIGTERM)
    log = run.join()
    assert "asking the ranks to stop" in log and "rank 1 of 2" in log
    assert log.count("checkpoint written") == 2  # each rank says so
    ckpts = [f for f in os.listdir(out) if f.startswith("checkpoint_epoch_")]
    assert len(ckpts) == 1, ckpts


def test_a_dead_rank_fails_the_run(tmp_path):
    """Rank 1 killed mid-run: rank 0 fails in its next collective (the
    peer's closed connection), it does not hang."""
    run = _two_ranks(_config(tmp_path, tmp_path / "dead", num_epochs=50,
                             save_interval=99))
    run.wait_for("Epoch 1:")
    run.procs[1].kill()
    try:
        code = run.procs[0].wait(60)
    except subprocess.TimeoutExpired:
        run.kill()
        raise AssertionError(f"rank 0 hung after its peer died:\n{run.text()}")
    assert code != 0


def _lm_data(root, n=12, length=20, vocab=50, genres=3):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    mapping = {}
    for i in range(n):
        name = f"c{i:02d}.npy"
        np.save(os.path.join(root, name), rng.integers(2, vocab, length).astype(np.int32))
        mapping[name] = int(rng.integers(genres))
    path = os.path.join(root, "map.json")
    with open(path, "w") as f:
        json.dump(mapping, f)
    return root, path


def test_lm_trainer_pipe(tmp_path, one_torch_thread):
    chunks, mapping = _lm_data(str(tmp_path / "chunks"))
    common = ["--chunks_dir", chunks, "--mapping_json", mapping, "--device", "cpu",
              "--vocab_size", "50", "--num_genres", "3", "--emb_dim", "16",
              "--lstm_hid", "32", "--lstm_layers", "2", "--batch_size", "4",
              "--epochs", "1", "--log_every", "1", "--out_dir", str(tmp_path / "run")]
    with pytest.raises(SystemExit, match="must equal --lstm_layers"):
        lstm_trainer.main(common + ["--pipe", "3"])
    with pytest.raises(SystemExit, match="not divisible by --pipe_micro"):
        lstm_trainer.main(common + ["--pipe", "2", "--pipe_micro", "3"])
    with pytest.raises(SystemExit, match="transformer is not pipelined"):
        lstm_trainer.main(common + ["--pipe", "2", "--arch", "transformer"])
    lstm_trainer.main(common + ["--pipe", "2", "--pipe_micro", "2"])
    with open(tmp_path / "run" / "lstm_metrics.jsonl") as f:
        losses = [r["train/loss_step"] for r in map(json.loads, f) if "train/loss_step" in r]
    assert losses and all(np.isfinite(losses))
    with open(tmp_path / "run" / "best.json") as f:
        assert json.load(f)["args"]["pipe"] == 2


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
