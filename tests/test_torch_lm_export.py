"""PyTorch port: the token-LM artifact (``deploy/export_lm.py``) and the LM
HTTP server's artifact backend and codec attach (``deploy/http_lm.py``),
on the CPU, for both archs.

The port's artifact is held against the JAX package's (StableHLO programs
exported from the same bridged weights): at top_k = 1 their tokens are
equal, unconditional and with mixed prompt lengths, and their scores agree
within 1e-5 (rtol and atol). Sampled tokens come from the port's own key
chain (ROADMAP.md Queue 3), so away from top_k = 1 the artifact is held to
the in-process served sampler at the same padded bucket and seeds: equal
tokens. Served with a codec artifact, ``"decode": true`` answers are
``ExportedPreEncoder.decode`` of the returned tokens, and no id the codec
cannot decode is ever sampled."""

import json
import os
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from io import BytesIO

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.deploy import export_lm as jexport_lm
from mqgan_tpu.models.music_lstm import MusicLSTM as JaxLSTM
from mqgan_tpu.models.token_lm import arch_config as jax_arch_config
from mqgan_tpu.models.token_transformer import MusicTransformer as JaxTransformer
from mqgan_tpu_torch.core.config import GeneratorConfig
from mqgan_tpu_torch.deploy import export_lm
from mqgan_tpu_torch.deploy.export import export_preencoder
from mqgan_tpu_torch.deploy.http_lm import LMHTTPServer, LMHTTPService
from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder
from mqgan_tpu_torch.models.music_lstm import MusicLSTM
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.models.token_lm import served_sampler
from mqgan_tpu_torch.models.token_transformer import MusicTransformer
from mqgan_tpu_torch.train import lstm_trainer
from mqgan_tpu_torch.utils.init import seeded_init_
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_token_lm import LSTM, TF, _jax_tree

SCORE_TOL = 1e-5
VOCAB = TF["vocab_size"]
GEN_BUCKETS, PROMPT_BUCKETS, SCORE_BUCKETS = (8, 16), (1, 4), (12,)
# the codec attached to the server: 16 codes (FSQ [4, 4]), fewer than the
# LM's vocab, so that ids 16.. must never be sampled
CODEC_GEN = GeneratorConfig(channels=(16, 24), kernel_sizes=(3,),
                            fsq_levels=(4, 4), refiner_base_channels=4,
                            refiner_depth=1)
CODEC_MELS, CODEC_BUCKETS = 8, (8, 16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["lstm", "transformer"])
def artifacts(request, tmp_path_factory):
    """(arch, port model, port artifact dir, JAX artifact dir) of one set of
    bridged weights."""
    root = tmp_path_factory.mktemp(f"lm_export_{request.param}")
    if request.param == "lstm":
        jm, cls, cfg, seed = JaxLSTM(**LSTM, dropout=0.0), MusicLSTM, LSTM, 51
    else:
        jm, cls, cfg, seed = (JaxTransformer(**TF, dropout=0.0), MusicTransformer,
                              TF, 52)
    tree = _jax_tree(jm, np.random.default_rng(seed))
    model = cls(**cfg, dropout=0.0)
    model.load_state_dict(state_dict_from_jax(tree, model))
    model.eval()
    kw = dict(gen_buckets=GEN_BUCKETS, prompt_buckets=PROMPT_BUCKETS,
              score_buckets=SCORE_BUCKETS, bos_id=1)
    port_dir = export_lm.export_music_lm(model, str(root / "port"), device="cpu",
                                         lm_args={"arch": request.param}, **kw)
    jax_dir = jexport_lm.export_music_lm(
        jm, jax.tree_util.tree_map(jnp.asarray, tree), str(root / "jax"),
        verify=False, **kw)
    return request.param, jm, model, port_dir, jax_dir


def _rows(rng, b=4):
    genres = rng.integers(0, TF["num_genres"], b)
    seeds = rng.integers(0, 2 ** 31, b)
    lens = [0, 3, 1, 4][:b]
    prompts = [None if n == 0 else rng.integers(2, VOCAB, n) for n in lens]
    return genres, seeds, prompts


def test_manifest_has_the_jax_keys(artifacts):
    """Every key of the JAX manifest but its program list and platforms,
    with the same values, and the same arch_config as JAX's arch_config."""
    arch, jm, model, port_dir, jax_dir = artifacts
    with open(os.path.join(port_dir, export_lm.LM_MANIFEST_NAME)) as f:
        port = json.load(f)
    with open(os.path.join(jax_dir, jexport_lm.LM_MANIFEST_NAME)) as f:
        want = json.load(f)
    for key in set(want) - {"files", "platforms", "lm_args"}:
        assert port[key] == want[key], key
    assert port["arch_config"] == jax_arch_config(jm)
    assert port["lm_args"] == {"arch": arch} and port["weights"] == "weights.pt"


@pytest.mark.parametrize("prompted", [False, True])
def test_greedy_tokens_and_scores_match_the_jax_artifact(artifacts, prompted):
    """top_k = 1 through both artifacts at a length between buckets (each
    pads to L = 16 and trims), per-row seeds, mixed prompt lengths: equal
    tokens; score within 1e-5."""
    arch, _, _, port_dir, jax_dir = artifacts
    port, jrt = export_lm.ExportedMusicLM(port_dir, device="cpu"), \
        jexport_lm.ExportedMusicLM(jax_dir)
    assert port.arch == jrt.arch == arch
    genres, seeds, prompts = _rows(np.random.default_rng(61 + prompted))
    if not prompted:
        prompts = None
    kw = dict(prompts=prompts, temperature=0.8, top_k=1, forbidden=(0, 1))
    got = port.generate_rows(genres, seeds, 11, **kw)
    want = jrt.generate_rows(genres, seeds.astype(np.int32), 11,
                             **dict(kw, prompts=None if prompts is None else
                                    [None if p is None else p.astype(np.int32)
                                     for p in prompts]))
    assert got.shape == want.shape == (4, 11)
    np.testing.assert_array_equal(got, want)
    body = np.concatenate([np.ones((4, 1), np.int64), got[:, :9]], axis=1)
    body[2, 6:] = 0  # a right-padded row
    pn, pv = port.score(body, genres)
    jn, jv = jrt.score(body.astype(np.int32), genres.astype(np.int32))
    np.testing.assert_allclose(pn, jn, rtol=SCORE_TOL, atol=SCORE_TOL)
    np.testing.assert_array_equal(pv, jv)


def test_generate_equals_the_in_process_sampler(artifacts):
    """Sampling (temperature 0.9, top-k 7, top-p 0.9) through the artifact
    at a length between buckets equals the model's served sampler at the
    padded bucket with the same seeds and prompts, trimmed; a scalar seed
    is seed + row."""
    arch, _, model, port_dir, _ = artifacts
    rt = export_lm.ExportedMusicLM(port_dir, device="cpu")
    genres, seeds, prompts = _rows(np.random.default_rng(71))
    got = rt.generate_rows(genres, seeds, 13, prompts=prompts, temperature=0.9,
                           top_k=7, top_p=0.9, forbidden=(0, 1, 5))
    prompt = np.zeros((4, 4), np.int64)
    lens = np.asarray([0 if p is None else len(p) for p in prompts])
    for i, p in enumerate(prompts):
        if p is not None:
            prompt[i, : len(p)] = p
    mask = torch.ones(VOCAB, dtype=torch.bool)
    mask[[0, 1, 5]] = False
    want = served_sampler(model)(
        model, torch.from_numpy(genres), torch.from_numpy(seeds),
        torch.from_numpy(prompt), torch.from_numpy(lens), 0.9, 7, 0.9, mask,
        max_len=16, bos_id=1)[:, :13].numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.isin(got, [0, 1, 5]).any()
    one = rt.generate(genres[:2], 5, seed=9, temperature=0.9)
    two = rt.generate_rows(genres[:2], np.asarray([9, 10]), 5, temperature=0.9)
    np.testing.assert_array_equal(one, two)


def test_score_equals_score_tokens(artifacts):
    """The artifact's score pads to its bucket with pad_id: equal to
    score_tokens on the unpadded rows within 1e-5."""
    from mqgan_tpu_torch.models.lm_sampling import score_tokens

    _, _, model, port_dir, _ = artifacts
    rt = export_lm.ExportedMusicLM(port_dir, device="cpu")
    rng = np.random.default_rng(81)
    tokens = rng.integers(2, VOCAB, (3, 7))
    tokens[:, 0] = 1
    tokens[1, 5:] = 0
    genres = np.asarray([0, 2, 1])
    nll, n = rt.score(tokens, genres)
    wn, wv = score_tokens(model, torch.from_numpy(tokens), torch.from_numpy(genres))
    np.testing.assert_allclose(nll, wn.numpy(), rtol=SCORE_TOL, atol=SCORE_TOL)
    np.testing.assert_array_equal(n, wv.numpy())
    with pytest.raises(ValueError, match="largest exported bucket"):
        rt.score(np.ones((1, 13), np.int64), genres[:1])


def test_runtime_refuses_a_jax_artifact(artifacts):
    _, _, _, _, jax_dir = artifacts
    with pytest.raises(ValueError, match="StableHLO"):
        export_lm.ExportedMusicLM(jax_dir, device="cpu")


@pytest.fixture(scope="module")
def lm_run(tmp_path_factory):
    """A one-epoch transformer run of the port's trainer CLI."""
    root = tmp_path_factory.mktemp("lm_run")
    rng = np.random.default_rng(3)
    os.makedirs(root / "chunks")
    mapping = {}
    for i in range(8):
        np.save(root / "chunks" / f"c{i}.npy",
                rng.integers(2, VOCAB, 30).astype(np.int32))
        mapping[f"c{i}.npy"] = i % TF["num_genres"]
    (root / "map.json").write_text(json.dumps(mapping))
    lstm_trainer.main(["--chunks_dir", str(root / "chunks"), "--mapping_json",
                       str(root / "map.json"), "--vocab_size", str(VOCAB),
                       "--num_genres", str(TF["num_genres"]), "--arch",
                       "transformer", "--emb_dim", "32", "--n_layers", "2",
                       "--n_heads", "4", "--batch_size", "4", "--epochs", "1",
                       "--out_dir", str(root / "run"), "--device", "cpu"])
    return str(root / "run")


@pytest.mark.parametrize("kv_bf16", [False, True])
def test_export_cli_verifies_and_records_the_run(lm_run, tmp_path, kv_bf16):
    """The CLI exports a trainer run (verify included), records its args
    and the cache dtype; the bf16-cache artifact generates as the model's
    sampler does with a bf16 cache."""
    out = str(tmp_path / "exp")
    export_lm.main(["--lm_run", lm_run, "--output", out, "--gen_buckets", "8",
                    "--prompt_buckets", "1", "4", "--score_buckets", "12",
                    "--device", "cpu", *(["--kv_bf16"] if kv_bf16 else [])])
    rt = export_lm.ExportedMusicLM(out, device="cpu")
    with open(os.path.join(lm_run, "best.json")) as f:
        assert rt.lm_args == json.load(f)["args"]
    assert ("kv_dtype" in rt.manifest) == kv_bf16
    model, _ = export_lm.load_lm_from_run(lm_run, "cpu")
    genres = np.asarray([0, 1])
    got = rt.generate(genres, 6, seed=3)
    want = served_sampler(model)(
        model, torch.from_numpy(genres), torch.tensor([3, 4]),
        torch.zeros((2, 1), dtype=torch.long), torch.zeros(2, dtype=torch.long),
        1.0, 0, 0.0, torch.ones(VOCAB, dtype=torch.bool), max_len=8, bos_id=1,
        **({"kv_dtype": torch.bfloat16} if kv_bf16 else {}))[:, :6].numpy()
    np.testing.assert_array_equal(got, want)


def test_kv_dtype_is_transformer_only(tmp_path):
    model = MusicLSTM(**LSTM, dropout=0.0)
    with pytest.raises(ValueError, match="transformer arch only"):
        export_lm.export_music_lm(model, str(tmp_path), kv_dtype="bfloat16",
                                  verify=False)


# --- the HTTP server over the artifacts ------------------------------------

@pytest.fixture(scope="module")
def codec_dir(tmp_path_factory):
    model = PreEncoder(CODEC_MELS, channels=CODEC_GEN.channels,
                       kernel_sizes=CODEC_GEN.kernel_sizes,
                       fsq_levels=CODEC_GEN.fsq_levels,
                       refiner_base_channels=CODEC_GEN.refiner_base_channels,
                       refiner_depth=CODEC_GEN.refiner_depth, dropout=0.0)
    seeded_init_(model, 4)
    return export_preencoder(model.eval(), CODEC_GEN,
                             str(tmp_path_factory.mktemp("codec")),
                             buckets=CODEC_BUCKETS, device="cpu")


def _post(url, spec):
    req = urllib.request.Request(url + "/generate", data=json.dumps(spec).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        ctype = resp.headers["Content-Type"]
        body = resp.read()
    if ctype == "application/x-npz":
        with np.load(BytesIO(body), allow_pickle=False) as z:
            return dict(z)
    return np.load(BytesIO(body), allow_pickle=False)


def test_artifact_backend_with_codec_decode(artifacts, codec_dir):
    """LMHTTPService(lm_export=..., codec_dir=...): /healthz reports the
    codec; concurrent requests (mixed prompts, n 1-3, decode true and
    false) answer with tokens below the codebook size, decode answers
    carry ExportedPreEncoder.decode of their tokens, and a request's tokens
    equal the artifact's own generate_rows at its bucket."""
    arch, _, _, port_dir, _ = artifacts
    codec = ExportedPreEncoder(codec_dir, device="cpu")
    service = LMHTTPService(lm_export=port_dir, codec_dir=codec_dir,
                            max_delay_ms=200, device="cpu")
    assert service.warmup(lengths=(8,), prompt_lens=(0,)) == 5
    specs = [{"genre": i % 3, "length": 6 + (i % 3) * 4, "n": 1 + i % 3,
              "seed": 100 + i, "temperature": 1.0, "decode": i % 2 == 0,
              **({"prompt_tokens": [2, 3, 4][: 1 + i % 3]} if i % 4 == 1 else {})}
             for i in range(8)]
    with LMHTTPServer(service) as srv:
        with urllib.request.urlopen(srv.url + "/healthz", timeout=60) as resp:
            health = json.load(resp)
        with ThreadPoolExecutor(len(specs)) as pool:
            answers = list(pool.map(lambda s: _post(srv.url, s), specs))
        stats = service.stats()
    assert health["has_codec"] and health["backend"] == "exported"
    assert health["arch"] == arch
    assert health["codebook_size"] == codec.codebook_size == 16
    assert health["mel_channels"] == CODEC_MELS
    assert stats["batches"] < len(specs)  # coalesced
    rt = service.exported
    for spec, ans in zip(specs, answers):
        tokens = ans["tokens"] if spec["decode"] else ans
        assert tokens.shape == (spec["n"], spec["length"])
        assert tokens.min() >= 2 and tokens.max() < codec.codebook_size
        prompt = spec.get("prompt_tokens")
        want = rt.generate_rows(
            np.full(spec["n"], spec["genre"]), spec["seed"] + np.arange(spec["n"]),
            spec["length"], prompts=None if prompt is None else
            [np.asarray(prompt)] * spec["n"], temperature=1.0,
            forbidden=service.forbidden)
        np.testing.assert_array_equal(tokens, want)
        if spec["decode"]:
            assert ans["mel"].shape == (spec["n"], spec["length"], CODEC_MELS)
            np.testing.assert_array_equal(ans["mel"], codec.decode(tokens))


def test_run_dir_backend_with_codec_decode(lm_run, codec_dir):
    """The run-dir backend with a codec: ids >= 16 forbidden, decode equal
    to ExportedPreEncoder.decode of the tokens."""
    service = LMHTTPService(lm_run, codec_dir=codec_dir, length_grid=8,
                            device="cpu")
    try:
        assert set(range(16, VOCAB)) <= set(service.forbidden)
        body, ctype = service.generate({"genre": 1, "length": 7, "n": 2,
                                        "seed": 5, "decode": True})
        assert ctype == "application/x-npz"
        with np.load(BytesIO(body), allow_pickle=False) as z:
            tokens, mel = z["tokens"], z["mel"]
        assert tokens.shape == (2, 7) and tokens.max() < 16
        np.testing.assert_array_equal(
            mel, ExportedPreEncoder(codec_dir, device="cpu").decode(tokens))
        assert service.health()["backend"] == "checkpoint"
    finally:
        service.close()


def test_artifact_backend_caps_lengths_and_prompts(artifacts):
    """Lengths cap at the largest generation bucket and prompts at the
    largest prompt bucket (413)."""
    from mqgan_tpu_torch.deploy.http_server import _HTTPError

    _, _, _, port_dir, _ = artifacts
    service = LMHTTPService(lm_export=port_dir, device="cpu")
    try:
        assert service.max_length == GEN_BUCKETS[-1]
        for spec in ({"genre": 0, "length": 17},
                     {"genre": 0, "length": 4, "prompt_tokens": [2] * 5}):
            with pytest.raises(_HTTPError) as err:
                service.generate(spec)
            assert err.value.status == 413
        with pytest.raises(_HTTPError) as err:
            service.generate({"genre": 0, "length": 4, "decode": True})
        assert err.value.status == 400
    finally:
        service.close()
