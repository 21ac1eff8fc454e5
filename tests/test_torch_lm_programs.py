"""PyTorch port: the token-LM artifact's traced programs
(``deploy/export_lm.py``) on the CPU, for a narrow transformer and LSTM.

The artifact's tokens equal the in-process served sampler's
(``models/lm_sampling.py``), sampled and greedy, at every prompt length of
its bucket; the programs keep their state writes in place on the inputs (no
whole cache is copied); the step counter is an input of the step programs,
not a constant baked into them; an artifact of weights without programs is
refused."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.deploy import export_lm
from mqgan_tpu_torch.models import lm_sampling
from mqgan_tpu_torch.models.music_lstm import MusicLSTM
from mqgan_tpu_torch.models.token_lm import served_sampler
from mqgan_tpu_torch.models.token_transformer import MusicTransformer
from mqgan_tpu_torch.utils.init import seeded_init_
from tests.test_torch_token_lm import LSTM, TF

VOCAB = TF["vocab_size"]
GEN_BUCKETS, PROMPT_BUCKETS, SCORE_BUCKETS = (6, 12), (1, 5), (9,)
P = PROMPT_BUCKETS[-1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["lstm", "transformer"])
def artifact(request, tmp_path_factory):
    """(arch, seeded model, artifact dir, its CPU runtime)."""
    cls, cfg = ((MusicLSTM, LSTM) if request.param == "lstm"
                else (MusicTransformer, TF))
    model = seeded_init_(cls(**cfg, dropout=0.0), 91).eval()
    out = export_lm.export_music_lm(
        model, str(tmp_path_factory.mktemp(f"lm_programs_{request.param}")),
        gen_buckets=GEN_BUCKETS, prompt_buckets=PROMPT_BUCKETS,
        score_buckets=SCORE_BUCKETS, verify=False, device="cpu")
    return request.param, model, out, export_lm.ExportedMusicLM(out, device="cpu")


def _rows(seed, n=P + 1):
    """n rows with prompt lengths 0..n-1 (every length of the P bucket)."""
    rng = np.random.default_rng(seed)
    prompts = [None if k == 0 else rng.integers(2, VOCAB, k) for k in range(n)]
    return (rng.integers(0, TF["num_genres"], n), rng.integers(0, 2 ** 32, n),
            prompts)


@pytest.mark.parametrize("knobs", [(0.9, 7, 0.9), (1.0, 1, 0.0)],
                         ids=["sampled", "greedy"])
def test_tokens_equal_the_served_sampler(artifact, knobs):
    """Through the programs at a length between buckets (padded to 12,
    trimmed) == the model's served sampler at the padded bucket, each row
    with its own seed and prompt length 0..P."""
    _, model, _, rt = artifact
    genres, seeds, prompts = _rows(7)
    got = rt.generate_rows(genres, seeds, 10, prompts=prompts, temperature=knobs[0],
                           top_k=knobs[1], top_p=knobs[2], forbidden=(0, 1))
    prompt = np.zeros((len(prompts), P), np.int64)
    for i, p in enumerate(prompts):
        if p is not None:
            prompt[i, : len(p)] = p
    mask = torch.ones(VOCAB, dtype=torch.bool)
    mask[[0, 1]] = False
    want = served_sampler(model)(
        model, torch.from_numpy(genres), torch.from_numpy(seeds),
        torch.from_numpy(prompt), torch.arange(len(prompts)), *knobs, mask,
        max_len=12, bos_id=1)[:, :10].numpy()
    assert got.shape == (len(prompts), 10)
    np.testing.assert_array_equal(got, want)


def _writes(program_path: str, state_names) -> dict:
    """{op: [state inputs]} of every op that takes one of the program's
    state inputs first, or the result of an in-place op on one (its
    alias)."""
    ep = torch.export.load(program_path)
    assert ep.graph_signature.user_inputs_to_mutate == {}  # not functionalised
    names = {n.name: n for n in ep.graph.nodes if n.op == "placeholder"}
    state = {names[k]: k for k in state_names}
    found: dict = {}
    for node in ep.graph.nodes:
        if node.op == "call_function" and node.args and node.args[0] in state:
            target = str(node.target)
            found.setdefault(target, []).append(state[node.args[0]])
            if target.split(".")[1].endswith("_"):  # returns its input
                state[node] = state[node.args[0]]
    return found


def test_programs_write_their_state_in_place(artifact):
    """The layer's step program index_puts its token's k/v into the cache
    inputs and its prefill index_copies the prefix's; nothing copies,
    clones or casts a whole cache (fp32 cache). The LSTM step overwrites
    its carries with copy_."""
    arch, _, out, _ = artifact
    cpu = os.path.join(out, "cpu")
    if arch == "lstm":
        names = [f"state_{i}" for i in range(2 * LSTM["lstm_layers"])]
        found = _writes(os.path.join(cpu, "step.pt2"), names)
        assert sorted(found["aten.copy_.default"]) == sorted(names)
        return
    step = _writes(os.path.join(cpu, "step_block.pt2"), ("k", "v"))
    assert sorted(step["aten.index_put_.default"]) == ["k", "v"]
    prefill = _writes(os.path.join(cpu, "prefill_block.pt2"), ("k", "v"))
    assert sorted(prefill["aten.index_copy_.default"]) == ["k", "v"]
    whole = {f"aten.{op}.default" for op in ("copy_", "copy", "clone", "_to_copy",
                                              "index_put", "slice_scatter")}
    for found in (step, prefill):
        assert not whole & set(found), found


def test_step_counter_is_an_input(artifact):
    """One step through the programs at counters 3 and 7, from the same
    state and inputs, == the eager piece at each counter (tokens, draws and
    the state written); the two steps draw differently."""
    arch, model, _, rt = artifact
    genres, seeds, prompts = _rows(11, 4)
    b, l = 4, GEN_BUCKETS[-1]
    gen = torch.Generator().manual_seed(5)
    state = [torch.randn(s, generator=gen) for s, _ in export_lm.state_shapes(
        rt.manifest["arch_config"], b, rt._cache_len(P, l), torch.float32)]
    chain = lm_sampling.KeyChain(torch.from_numpy(seeds), VOCAB)
    inputs = dict(
        prompt=torch.randint(2, VOCAB, (b, P), generator=gen),
        prompt_lens=torch.tensor([0, 2, 5, 1]), genre_ids=torch.from_numpy(genres),
        seed_keys=chain.seed_keys, vocab_keys=chain.vocab_keys,
        temperature=torch.tensor(0.9), top_k=torch.tensor(7),
        top_p=torch.tensor(0.9), vocab_mask=torch.ones(VOCAB, dtype=torch.bool))
    token = torch.randint(2, VOCAB, (b,), generator=gen)
    drawn = {}
    for t in (3, 7):
        d = rt._dispatch(b, P, l, [x.clone() for x in state])
        for k, v in inputs.items():
            setattr(d, k, v)
        d.token.copy_(token)
        d.t.fill_(t - 1 if arch == "transformer" else t)
        with torch.no_grad():
            rt._step(d)
        mine = [x.clone() for x in state]
        rows = (inputs["prompt_lens"], inputs["genre_ids"], inputs["seed_keys"],
                inputs["vocab_keys"])
        controls = (inputs["temperature"], inputs["top_k"], inputs["top_p"],
                    inputs["vocab_mask"])
        with torch.no_grad():
            if arch == "transformer":
                want = lm_sampling.transformer_step(
                    model, token, torch.tensor(t), *rows, *controls,
                    [{"k": k, "v": v} for k, v in zip(mine[::2], mine[1::2])])
                drawn[t] = d.out[:, t]
            else:
                carries, nxt, want = lm_sampling.lstm_step(
                    model, model.step_weights(), token, t,
                    inputs["prompt"][:, min(t, P - 1)], inputs["prompt_lens"],
                    model.genre_vectors(inputs["genre_ids"]), *rows[2:], *controls,
                    list(zip(mine[::2], mine[1::2])))
                mine = [x for pair in carries for x in pair]
                drawn[t] = d.out[:, t]
                assert torch.equal(drawn[t], nxt)
        assert torch.equal(d.token, want)
        for got, ref in zip(d.state, mine):
            assert torch.equal(got, ref)
        assert int(d.t) == t + (arch == "lstm")
    assert not torch.equal(drawn[3], drawn[7])


def test_artifact_without_programs_is_refused(artifact, tmp_path):
    """A manifest without ``files`` (an export of weights alone) asks for a
    re-export; the runtime needs the platform's programs."""
    _, _, out, _ = artifact
    old = str(tmp_path / "old")
    shutil.copytree(out, old)
    path = os.path.join(old, export_lm.LM_MANIFEST_NAME)
    with open(path) as f:
        manifest = json.load(f)
    assert manifest["platforms"] == ["cpu"]
    assert set(manifest["files"]["generate"]) == {
        f"{p}:{l}" for p in PROMPT_BUCKETS for l in GEN_BUCKETS}
    del manifest["files"]
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="re-export"):
        export_lm.ExportedMusicLM(old, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export_lm.ExportedMusicLM(out)


@pytest.mark.parametrize("buckets", [dict(gen_buckets=(1, 6)), dict(score_buckets=(2,))],
                         ids=["generation", "score"])
def test_transformer_buckets_too_short_are_refused(buckets, tmp_path):
    """A transformer's generation bucket below 2 (a dispatch runs its step
    program at least once) and score bucket below 3 are refused before
    anything is traced."""
    model = seeded_init_(MusicTransformer(**TF, dropout=0.0), 91).eval()
    kw = dict(gen_buckets=GEN_BUCKETS, prompt_buckets=PROMPT_BUCKETS,
              score_buckets=SCORE_BUCKETS, verify=False, device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        export_lm.export_music_lm(model, str(tmp_path / "lm"), **{**kw, **buckets})
    assert not os.listdir(tmp_path)
