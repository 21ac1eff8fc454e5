"""Process groups on the CPU (gloo): ``parallel/multihost.py``'s
``initialize`` (single-process without a coordinator or a launcher's
environment; explicit arguments that fail raise), the backend rule,
``host_info`` / ``shard_files_for_host`` / ``replicate_`` and the
reductions of ``parallel/dp.py`` over two ranks, ``save_checkpoint``
written by rank 0 alone, ``launch`` failing (not hanging) when a rank fails
or hangs, and ``MelLoader``'s rows over two processes against the
single-process batches and the JAX loader's (tests/test_parallel.py's
uneven 11-file case)."""

import os
import time

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.parallel import dp, multihost
from mqgan_tpu_torch.train.data import MelDataset, MelLoader, find_npy_files

LAUNCH_TIMEOUT_S = 60


def test_initialize_without_a_group_is_single_process(capsys, monkeypatch):
    for key in multihost.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert multihost.initialize() is False
    assert "single-process mode" in capsys.readouterr().out
    assert multihost.host_info() == (0, 1)
    files = [f"f{i}" for i in range(10)]
    assert multihost.shard_files_for_host(files) == files
    t = torch.arange(4.0)
    assert dp.all_reduce_([t]) == 0 and torch.equal(t, torch.arange(4.0))
    assert dp.any_flag(True, "cpu") and not dp.any_flag(False, "cpu")
    lengths = torch.tensor([3, 0])
    assert dp.global_lengths(lengths) is lengths


def test_explicit_arguments_that_fail_raise():
    with pytest.raises(ValueError, match="go together"):
        multihost.initialize("127.0.0.1:1234", 2)
    with pytest.raises(ValueError, match="not in"):
        multihost.initialize("127.0.0.1:1234", 2, 2)
    # rank 1 of 2 with nobody listening at the coordinator: an error after
    # the group's timeout, not a single-process fallback
    t0 = time.monotonic()
    with pytest.raises(Exception):
        multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 2, 1,
                             device="cpu", timeout_s=2)
    assert time.monotonic() - t0 < 30
    assert not torch.distributed.is_initialized()


def test_backend_follows_the_devices():
    assert multihost.choose_backend(["cpu", "cpu"]) == "gloo"
    assert multihost.choose_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert multihost.choose_backend(["cuda:0", "cpu"]) == "gloo"
    assert multihost.choose_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert multihost.rank_device("cpu", 3) == torch.device("cpu")
    assert multihost.rank_device("cuda:1", 0) == torch.device("cuda", 1)


def _group_checks(rank, world, device, out_root):
    """Each collective helper on two ranks; returns what each rank saw."""
    from mqgan_tpu_torch.losses.gan import LeCamState
    from mqgan_tpu_torch.utils.checkpoint import save_checkpoint

    torch.set_num_threads(1)
    files = [f"f{i}" for i in range(7)]
    mine = torch.full((3,), float(rank + 1))
    multihost.replicate_([mine])
    lengths = torch.tensor([5, 0, 7]) + 10 * rank
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.full((2,), float(rank + 1))
    q = torch.nn.Parameter(torch.zeros(1))  # no gradient on any rank
    nbytes = dp.all_reduce_grads_([p, q])
    flags = (dp.any_flag(rank == 1, device), dp.any_flag(False, device))

    class State:  # what save_checkpoint reads of a TrainState
        lecam = LeCamState.create()

        def state_dict(self):
            return {"rank": rank}

    out = os.path.join(out_root, f"rank{rank}")
    save_checkpoint(out, State(), 1)
    return {"info": multihost.host_info(), "files": multihost.shard_files_for_host(files),
            "replicated": mine.tolist(), "lengths": dp.global_lengths(lengths).tolist(),
            "grad": p.grad.tolist(), "q_grad": q.grad.tolist(), "bytes": nbytes,
            "flags": flags, "written": sorted(os.listdir(out)) if os.path.isdir(out) else []}


def test_two_ranks_collectives(tmp_path):
    t0 = time.monotonic()
    r0, r1 = multihost.launch(_group_checks, ["cpu", "cpu"], (str(tmp_path),),
                              timeout_s=LAUNCH_TIMEOUT_S)
    assert time.monotonic() - t0 < LAUNCH_TIMEOUT_S
    assert (r0["info"], r1["info"]) == ((0, 2), (1, 2))
    assert r0["files"] == ["f0", "f2", "f4", "f6"] and r1["files"] == ["f1", "f3", "f5"]
    assert r0["replicated"] == r1["replicated"] == [1.0, 1.0, 1.0]
    assert r0["lengths"] == r1["lengths"] == [5, 0, 7, 15, 10, 17]
    assert r0["grad"] == r1["grad"] == [3.0, 3.0]
    assert r0["q_grad"] == [0.0] and r0["bytes"] == 12
    assert r0["flags"] == r1["flags"] == (True, False)
    # rank 0 writes the checkpoint, rank 1 nothing
    assert r0["written"] == ["checkpoint_epoch_001.pt"] and r1["written"] == []


def _one_rank_fails(rank, world, device):
    if rank == 1:
        raise RuntimeError("rank 1 gives up")
    dp.all_reduce_([torch.zeros(1)])  # blocks: its peer never joins
    return "unreachable"


def _one_rank_hangs(rank, world, device):
    time.sleep(600 if rank == 0 else 0)
    return rank


@pytest.mark.parametrize("fn,error,timeout_s", [
    (_one_rank_fails, "rank 1 gives up", LAUNCH_TIMEOUT_S),
    (_one_rank_hangs, "did not finish", 5)], ids=["fails", "hangs"])
def test_a_failing_rank_fails_the_launch_within_its_timeout(fn, error, timeout_s):
    """A rank that raises fails the launch with its error (its peer, blocked
    in a collective, is killed); a rank that hangs fails it at the
    timeout."""
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError), match=error):
        multihost.launch(fn, ["cpu", "cpu"], timeout_s=timeout_s, group_timeout_s=600)
    assert time.monotonic() - t0 < timeout_s + 25


def _uneven_dataset(root, n=11, mel=6):
    """tests/test_parallel.py's ``_make_uneven_dataset``."""
    host = np.random.default_rng(123)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        t = int(host.integers(16, 60))
        np.save(os.path.join(root, f"clip_{i:03d}.npy"),
                host.standard_normal((t, mel)).astype(np.float32))
    return root


def test_loader_rows_over_two_processes(tmp_path):
    """Concatenating the two processes' rows gives the single-process
    global batches and the JAX MelLoader's, batch for batch."""
    from mqgan_tpu.train import data as jdata

    files = find_npy_files(_uneven_dataset(str(tmp_path / "mels")))

    def port(idx, cnt):
        return MelLoader(MelDataset(files), batch_size=8, crop_lens=(16, 24), seed=5,
                         process_index=idx, process_count=cnt, mel_channels=6)

    def jax_loader(idx, cnt):
        return jdata.MelLoader(jdata.MelDataset(files), batch_size=8,
                               crop_lens=(16, 24), seed=5, process_index=idx,
                               process_count=cnt, mel_channels=6)

    for epoch in (0, 1):
        whole = list(port(0, 1).epoch(epoch))
        parts = [list(port(i, 2).epoch(epoch)) for i in range(2)]
        jparts = [list(jax_loader(i, 2).epoch(epoch)) for i in range(2)]
        assert len(whole) == len(parts[0]) == len(parts[1]) == 2  # 11 / 8
        for w, p0, p1, j0, j1 in zip(whole, *parts, *jparts):
            np.testing.assert_array_equal(w.mel, np.concatenate([p0.mel, p1.mel]))
            np.testing.assert_array_equal(w.lengths, np.concatenate([p0.lengths,
                                                                     p1.lengths]))
            assert w.filenames == p0.filenames + p1.filenames
            for p, j in ((p0, j0), (p1, j1)):
                np.testing.assert_array_equal(p.mel, j.mel)
                np.testing.assert_array_equal(p.lengths, j.lengths)
                assert p.filenames == j.filenames
    # process 1's slice of the final batch is all fill rows
    assert (parts[1][-1].lengths == 0).all()
    with pytest.raises(ValueError, match="mel_channels"):
        MelLoader(MelDataset(files), 8, (16,), process_index=0, process_count=2)
    with pytest.raises(ValueError, match="does not divide"):
        MelLoader(MelDataset(files), 7, (16,), process_index=0, process_count=2,
                  mel_channels=6)
