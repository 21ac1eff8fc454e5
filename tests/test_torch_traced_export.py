"""PyTorch port: the codec artifact's traced programs (``deploy/export.py``,
``torch.export`` per bucket with a symbolic batch) and the runtime that
serves them (``deploy/runtime.py`` ``ExportedPreEncoder``) on the CPU:
file and manifest names as the JAX package's export writes them (with
``.pt2`` for its ``.shlo``), a fresh runtime equal to the in-memory model,
batches of 1, 2 and 3 rows through one program, the verification at a
length that is no bucket, a missing platform refused, and the streaming
HTTP CLI's ``--data_parallel`` reaching the runtime. Narrow widths, buckets
(16, 32); the CUDA graphs are held against the eager calls on the card by
``chip_smoke.py`` phase 20c."""

import json
import os

import numpy as np
import pytest
import torch

from mqgan_tpu.deploy.export import MANIFEST_NAME as JAX_MANIFEST_NAME
from mqgan_tpu_torch.core.config import GeneratorConfig
from mqgan_tpu_torch.deploy import export, http_streaming
from mqgan_tpu_torch.deploy.runtime import (ExportedPreEncoder, graph_rows,
                                            read_manifest)
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.utils.init import seeded_init_
from tests.test_torch_bridge import MELS, NARROW

BUCKETS = (16, 32)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    model = seeded_init_(PreEncoder(MELS, **NARROW), 7).eval()
    out = str(tmp_path_factory.mktemp("traced"))
    export.export_preencoder(model, GeneratorConfig(**NARROW), out,
                             buckets=BUCKETS, device="cpu")
    return model, out, ExportedPreEncoder(out, device="cpu")


def _model_reencode(model, x, lengths, bucket):
    """The in-memory model at the runtime's padding: (tokens, mel)."""
    b, t = x.shape[:2]
    xp = np.zeros((b, bucket, MELS), np.float32)
    xp[:, :t] = x
    pad = torch.from_numpy(np.arange(bucket)[None, :] >= np.asarray(lengths)[:, None])
    tokens = model.encode(torch.from_numpy(xp), pad)
    return tokens[:, :t].numpy(), model.decode(tokens, pad)[:, :t].float().numpy()


def test_file_and_manifest_names_as_jax(artifact):
    _, out, rt = artifact
    assert JAX_MANIFEST_NAME == "manifest.json"
    assert sorted(os.listdir(out)) == ["cpu", JAX_MANIFEST_NAME, "weights.pt"]
    manifest = read_manifest(out)
    # the JAX export names encode_T{t}.shlo etc. (mqgan_tpu/deploy/export.py)
    assert manifest["files"] == {
        str(t): {op: f"{op}_T{t}.pt2" for op in ("encode", "decode", "reencode")}
        for t in BUCKETS}
    assert manifest["platforms"] == ["cpu"]
    assert sorted(os.listdir(os.path.join(out, "cpu"))) == sorted(
        name for files in manifest["files"].values() for name in files.values())
    assert rt.platform == "cpu"


def test_fresh_runtime_equals_the_in_memory_model(artifact):
    model, out, _ = artifact
    rt = ExportedPreEncoder(out, device="cpu")
    x = np.random.default_rng(1).standard_normal((3, 27, MELS)).astype(np.float32)
    lengths = [27, 20, 1]
    want_tokens, want_mel = _model_reencode(model, x, lengths, rt.bucket_for(27))
    tokens, mel = rt.reencode(x, lengths)
    np.testing.assert_array_equal(tokens, want_tokens)
    np.testing.assert_array_equal(mel, want_mel)
    np.testing.assert_array_equal(rt.encode(x, lengths), tokens)
    np.testing.assert_array_equal(rt.decode(tokens, lengths), mel)


@pytest.mark.parametrize("rows", [1, 2, 3])
def test_one_program_takes_any_batch(artifact, rows):
    """The program was traced at 2 rows; its batch is symbolic."""
    model, _, rt = artifact
    program = rt.program("encode", 16, torch.device("cpu"))
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((rows, 16, MELS)).astype(np.float32))
    pad = torch.from_numpy(np.arange(16)[None, :] >= rng.integers(1, 17, (rows, 1)))
    with torch.no_grad():
        got = program(x, pad)
    assert got.shape == (rows, 16) and got.dtype == torch.int32
    assert torch.equal(got, model.encode(x, pad))


def test_verify_runs_at_a_length_that_is_no_bucket(artifact, monkeypatch):
    _, out, _ = artifact
    seen = []
    encode = ExportedPreEncoder.encode

    def spy(self, spec, lengths=None):
        seen.append(np.asarray(spec).shape[1])
        return encode(self, spec, lengths)

    monkeypatch.setattr(ExportedPreEncoder, "encode", spy)
    export.verify_export(out, device="cpu")
    assert seen and all(t not in BUCKETS for t in seen)


def test_runtime_refuses_an_artifact_without_its_platform(artifact, tmp_path):
    _, out, _ = artifact
    bad = tmp_path / "cuda_only"
    bad.mkdir()
    manifest = read_manifest(out)
    manifest["platforms"] = ["cuda"]
    (bad / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(RuntimeError, match="no cpu programs"):
        ExportedPreEncoder(str(bad), device="cpu")


def test_graph_rows_are_powers_of_two():
    assert [graph_rows(b) for b in (1, 2, 3, 5, 8, 9, 64)] == [1, 2, 4, 8, 8, 16, 64]


def test_http_streaming_data_parallel_reaches_the_runtime(artifact, monkeypatch):
    _, out, _ = artifact
    made = {}

    class Recording(ExportedPreEncoder):
        def __init__(self, *args, **kw):
            made.update(kw)
            super().__init__(*args, **kw)

    served = []
    monkeypatch.setattr(http_streaming, "ExportedPreEncoder", Recording)
    monkeypatch.setattr(http_streaming, "serve_until_interrupted",
                        lambda server: served.append(server.start().service.runtime)
                        or server.close())
    http_streaming.main(["--model_dir", out, "--port", "0", "--device", "cpu",
                         "--data_parallel"])
    assert made == {"device": "cpu", "data_parallel": True}
    assert served and served[0].n_devices == 1
