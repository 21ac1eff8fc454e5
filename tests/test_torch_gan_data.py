"""The port's mel data pipeline against the JAX package's: the seeded
train/eval split, ``collate``, and ``MelLoader``'s plan (file order, crop
length per batch, crop start per row, fill rows) over two epochs, batch for
batch; and the prefetcher."""

import random

import numpy as np
import pytest
import torch

from mqgan_tpu.train import data as jdata
from mqgan_tpu_torch.train import data as tdata
from tests.test_torch_gan_step import one_torch_thread  # noqa: F401 - autouse


@pytest.fixture(scope="module")
def mel_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("mels")
    rng = np.random.default_rng(0)
    (root / "sub").mkdir()
    for i in range(23):
        t = int(rng.integers(5, 90))
        np.save(root / ("sub" if i % 3 else ".") / f"m{i:02d}.npy",
                rng.standard_normal((t, 8)).astype(np.float32))
    np.save(root / "broken.npy", np.zeros((3,), np.float32))  # 1-D: dropped
    (root / "notes.txt").write_text("not a mel")
    return str(root)


def test_files_and_split_match_jax(mel_dir):
    files = tdata.find_npy_files(mel_dir)
    assert files == jdata.find_npy_files(mel_dir)
    for split, seed in ((0.2, 42), (0.0, 1), (0.5, 7)):
        assert tdata.split_train_eval(files, split, seed) == \
            jdata.split_train_eval(files, split, seed)


def test_collate_matches_jax(mel_dir):
    ds = tdata.MelDataset(tdata.find_npy_files(mel_dir))
    items = [(ds.load(i), f"f{i}") for i in range(1, 7)] + [None]  # 0: broken
    a = tdata.collate(items, (16, 32, 64), random.Random(3))
    b = jdata.collate(items, (16, 32, 64), random.Random(3))
    np.testing.assert_array_equal(a.mel, b.mel)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    assert a.filenames == b.filenames


@pytest.mark.parametrize("batch,drop_last", [(4, False), (5, True)])
def test_loader_plan_matches_jax_for_two_epochs(mel_dir, batch, drop_last):
    files = tdata.find_npy_files(mel_dir)
    kw = dict(batch_size=batch, crop_lens=(16, 24, 40), seed=123,
              drop_last=drop_last, num_threads=2)
    ours = tdata.MelLoader(tdata.MelDataset(files), **kw)
    theirs = jdata.MelLoader(jdata.MelDataset(files, use_native=False), **kw)
    assert len(ours) == len(theirs)
    for epoch in (1, 2):
        got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.mel, b.mel)
            np.testing.assert_array_equal(a.lengths, b.lengths)
            assert a.filenames == b.filenames


def test_prefetcher_yields_tensors_and_closes_early(mel_dir):
    files = tdata.find_npy_files(mel_dir)
    loader = tdata.MelLoader(tdata.MelDataset(files), 4, (16,), seed=0)
    it = tdata.DevicePrefetcher(loader.epoch(1), "cpu", depth=1)
    seen = 0
    for mel, lengths, host in it:
        assert isinstance(mel, torch.Tensor) and mel.shape == (4, 16, 8)
        np.testing.assert_array_equal(lengths.numpy(), host.lengths)
        seen += 1
        if seen == 2:
            break
    it.close()
    assert not it._thread.is_alive()
