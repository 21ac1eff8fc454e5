"""PyTorch port: the token-LM HTTP server (``deploy/http_lm.py``) on the
CPU, over run dirs written by the port's own trainer: concurrent requests
coalesce and each response equals the same request served alone, the
health and stats endpoints, client errors, the warm-up grid, the listen
backlog kept off the stdlib class, and the constructor's errors (the
artifact backends are served in tests/test_torch_lm_export.py)."""

import json
import os
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from io import BytesIO

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.deploy.http_lm import LMHTTPServer, LMHTTPService
from mqgan_tpu_torch.train import lstm_trainer

VOCAB, GENRES = 40, 3
TINY = {"transformer": ["--arch", "transformer", "--emb_dim", "32", "--n_layers",
                        "2", "--n_heads", "4"],
        "lstm": ["--arch", "lstm", "--emb_dim", "32", "--lstm_hid", "48"]}
GRID = 16  # generation lengths round up to this


@pytest.fixture(scope="module", params=["transformer", "lstm"])
def run_dir(request, tmp_path_factory):
    """A one-epoch run of the port's trainer CLI on the CPU."""
    root = tmp_path_factory.mktemp(f"lm_{request.param}")
    rng = np.random.default_rng(3)
    os.makedirs(root / "chunks")
    mapping = {}
    for i in range(12):
        np.save(root / "chunks" / f"c{i}.npy",
                rng.integers(2, VOCAB, 40).astype(np.int32))
        mapping[f"c{i}.npy"] = i % GENRES
    (root / "map.json").write_text(json.dumps(mapping))
    lstm_trainer.main(["--chunks_dir", str(root / "chunks"), "--mapping_json",
                       str(root / "map.json"), "--vocab_size", str(VOCAB),
                       "--num_genres", str(GENRES), *TINY[request.param],
                       "--batch_size", "4", "--epochs", "1", "--log_every", "1",
                       "--out_dir", str(root / "run"), "--device", "cpu"])
    return str(root / "run")


def _post(url, body: bytes):
    req = urllib.request.Request(url + "/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        assert resp.headers["Content-Type"] == "application/x-npy"
        return np.load(BytesIO(resp.read()), allow_pickle=False)


def _generate(url, spec: dict):
    return _post(url, json.dumps(spec).encode())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return json.loads(resp.read())


def _status(url, body: bytes) -> int:
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, body)
    return ei.value.code


REQUESTS = [
    dict(genre=0, length=12, seed=1),
    dict(genre=1, length=16, seed=2, n=3),
    dict(genre=2, length=9, seed=3, prompt_tokens=[5, 6, 7]),
    dict(genre=1, length=14, seed=4, prompt_tokens=list(range(2, 18))),
    dict(genre=0, length=16, seed=2**32 - 1, n=2, prompt_tokens=[9]),
    dict(genre=2, length=5, seed=77),
]
KNOBS = dict(temperature=1.2, top_k=10, top_p=0.95)


def test_concurrent_requests_coalesce_and_equal_solo(run_dir):
    service = LMHTTPService(run_dir, length_grid=GRID, max_batch=8,
                            max_delay_ms=400, device="cpu")
    with LMHTTPServer(service) as srv:
        health = _get(srv.url, "/healthz")
        assert health["ok"] and health["vocab_size"] == VOCAB
        assert health["device"] == "cpu"
        specs = [dict(r, **KNOBS) for r in REQUESTS]
        with ThreadPoolExecutor(len(specs)) as pool:
            outs = list(pool.map(lambda s: _generate(srv.url, s), specs))
        stats = _get(srv.url, "/statz")
        assert stats["requests"] == len(specs)
        assert stats["mean_batch_size"] > 1
    for spec, out in zip(specs, outs):
        assert out.shape == (spec.get("n", 1), spec["length"])
        assert out.dtype == np.int32
        assert out.min() >= 2 and out.max() < VOCAB  # pad and BOS never drawn
    solo_service = LMHTTPService(run_dir, length_grid=GRID, max_batch=8,
                                 max_delay_ms=0, device="cpu")
    with LMHTTPServer(solo_service) as srv:
        for spec, out in zip(specs, outs):
            np.testing.assert_array_equal(_generate(srv.url, spec), out)
        assert _get(srv.url, "/statz")["mean_batch_size"] < 2


def test_client_errors(run_dir):
    service = LMHTTPService(run_dir, length_grid=GRID, max_length=64,
                            max_delay_ms=0, device="cpu")
    with LMHTTPServer(service) as srv:
        assert _status(srv.url, b"not json") == 400
        assert _status(srv.url, b"[1, 2]") == 400
        for spec, code in [({"length": 4}, 400), ({"genre": 0}, 400),
                           ({"genre": GENRES, "length": 4}, 400),
                           ({"genre": 0, "length": 65}, 413),
                           ({"genre": 0, "length": 4, "n": 17}, 400),
                           ({"genre": 0, "length": 4, "top_k": "x"}, 400),
                           ({"genre": 0, "length": 4, "prompt_tokens": [[1]]}, 400),
                           ({"genre": 0, "length": 4, "prompt_tokens": [VOCAB]}, 400),
                           ({"genre": 0, "length": 4, "decode": True}, 400)]:
            assert _status(srv.url, json.dumps(spec).encode()) == code, spec
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/nope", timeout=60)
        assert ei.value.code == 404
        # the server still answers after the errors
        assert _generate(srv.url, {"genre": 0, "length": 4, "seed": 0}).shape == (1, 4)


def test_warmup_reaches_the_padded_width(run_dir):
    """max_batch = 12 coalesces up to 12 rows, which pad to a dispatch of
    16: the warm-up grid runs widths 1 to 16 before any traffic."""
    service = LMHTTPService(run_dir, length_grid=GRID, max_batch=12,
                            device="cpu")
    try:
        assert service.warmup(prompt_lens=(0, 3)) == 10
        widths = {w for _, _, w in service.batcher._seen_shapes}
        assert widths == {1, 2, 4, 8, 16}
        assert {p for p, _, _ in service.batcher._seen_shapes} == {1, 16}
        assert service.warmup(prompt_lens=(0, 3)) == 0  # nothing left cold
    finally:
        service.close()


def test_listen_backlog_is_set_per_server(run_dir):
    before = ThreadingHTTPServer.request_queue_size
    service = LMHTTPService(run_dir, device="cpu")
    with LMHTTPServer(service) as srv:
        assert srv._httpd.request_queue_size == 128
        assert ThreadingHTTPServer.request_queue_size == before == 5


def test_unported_backends_and_missing_card_raise(run_dir):
    """The artifact backends are ported (tests/test_torch_lm_export.py
    serves them): one backend must be named, a run dir is not an artifact
    of either kind, and without a card the default device raises."""
    with pytest.raises(ValueError, match="exactly one"):
        LMHTTPService(run_dir, lm_export=run_dir, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        LMHTTPService(device="cpu")
    with pytest.raises(FileNotFoundError, match="lm_manifest.json"):
        LMHTTPService(lm_export=run_dir, device="cpu")
    with pytest.raises(FileNotFoundError, match="manifest.json"):
        LMHTTPService(run_dir, codec_dir=run_dir, device="cpu")
    if torch.cuda.is_available():
        service = LMHTTPService(run_dir)
        assert service.device.type == "cuda"
        service.close()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LMHTTPService(run_dir)
