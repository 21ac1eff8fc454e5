"""PyTorch port: the codec runtime and the micro-batching server on the CPU
(plain versions)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.deploy.runtime import CodecRuntime
from mqgan_tpu_torch.deploy.server import CodecServer
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.utils.init import seeded_init_

MELS = 16
BUCKETS = (16, 32, 64)
CLIP_LENGTHS = (5, 16, 20, 31, 32, 40, 57, 64)


@pytest.fixture(scope="module")
def runtime():
    model = PreEncoder(MELS, channels=(16, 24, 32), kernel_sizes=(3, 5),
                       refiner_base_channels=4, refiner_depth=2)
    return CodecRuntime(seeded_init_(model, 0), buckets=BUCKETS, device="cpu")


def test_runtime_pads_to_bucket_and_trims(runtime):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 20, MELS)).astype(np.float32)
    idx, mel = runtime.reencode(x, [20, 7])
    assert idx.shape == (2, 20) and idx.dtype == np.int32
    assert mel.shape == (2, 20, MELS) and mel.dtype == np.float32
    # the runtime pads to the 32 bucket: the same as a caller padding by hand
    padded = np.concatenate([x, np.zeros((2, 12, MELS), np.float32)], axis=1)
    idx32, mel32 = runtime.reencode(padded, [20, 7])
    np.testing.assert_array_equal(idx32[:, :20], idx)
    np.testing.assert_allclose(mel32[:, :20], mel, atol=1e-6)
    np.testing.assert_array_equal(runtime.encode(x, [20, 7]), idx)
    np.testing.assert_allclose(runtime.decode(idx, [20, 7]), mel, atol=1e-6)
    assert runtime.bucket_for(20) == 32
    assert runtime.mel_channels == MELS and runtime.codebook_size == 1000


def test_runtime_rejects_too_long(runtime):
    with pytest.raises(ValueError, match="largest bucket"):
        runtime.encode(np.zeros((1, 65, MELS), np.float32))


def test_server_micro_batches_concurrent_clips(runtime):
    rng = np.random.default_rng(1)
    clips = [rng.standard_normal((n, MELS)).astype(np.float32)
             for n in CLIP_LENGTHS]
    with CodecServer(runtime, max_batch=8, max_delay_ms=500.0) as srv:
        with ThreadPoolExecutor(len(clips)) as pool:
            futures = list(pool.map(srv.submit, clips))
        results = [f.result(timeout=120) for f in futures]
        stats = srv.stats.summary()
    assert stats["requests"] == len(clips)
    assert stats["mean_batch_size"] > 1
    for clip, (idx, mel) in zip(clips, results):
        n = clip.shape[0]
        assert idx.shape == (n,) and mel.shape == (n, MELS)
        # exact mixers: every row is computed independently of its batch
        want_idx, want_mel = runtime.reencode(clip[None], [n])
        np.testing.assert_array_equal(idx, want_idx[0])
        np.testing.assert_allclose(mel, want_mel[0], atol=1e-5, rtol=1e-5)


def test_server_rejects_when_full(runtime):
    srv = CodecServer(runtime, max_batch=8, max_delay_ms=10_000.0, max_queue=1)
    try:
        first = srv.submit(np.zeros((8, MELS), np.float32))
        from mqgan_tpu_torch.deploy.server import ServerOverloadedError
        with pytest.raises(ServerOverloadedError):
            srv.submit(np.zeros((8, MELS), np.float32))
    finally:
        srv.close()
    assert first.result(timeout=60)[0].shape == (8,)
    assert srv.stats.rejected == 1


def test_runtime_on_cpu_needs_no_card(runtime):
    assert runtime.device == torch.device("cpu")
