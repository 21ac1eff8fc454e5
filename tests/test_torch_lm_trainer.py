"""PyTorch port: the token-LM trainer against the JAX trainer on the CPU —
three optimizer steps from the same parameters and batches (dropout 0),
the in-graph NaN skip, and the CLI end to end with the JAX trainer's batch
order."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mqgan_tpu.models.token_lm import build_token_lm as jax_build
from mqgan_tpu.train import lstm_trainer as jax_trainer
from mqgan_tpu_torch.models.token_lm import build_token_lm
from mqgan_tpu_torch.train import lstm_trainer
from mqgan_tpu_torch.utils.init import seeded_init_
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import to_numpy_tree
from tests.test_torch_token_lm import _perturb

TOL = 1e-5  # fp32 on the CPU, after three AdamW steps
# Adam's first steps move each parameter by about lr whatever its gradient's
# size, so a coordinate whose gradient is 0 up to rounding takes a step set
# by the rounding: the key bias (a bias shared by all keys adds the same
# score to every key of a query; only RoPE's rotation leaves it a small
# gradient) moved apart by more than TOL at lr 1e-3. At lr 1e-4 every
# coordinate stays within TOL.
LR = 1e-4
VOCAB, GENRES = 40, 3
ARGS = {
    "transformer": dict(arch="transformer", vocab_size=VOCAB, num_genres=GENRES,
                        emb_dim=32, n_layers=2, n_heads=4, mlp_ratio=4, pad_id=0),
    "lstm": dict(arch="lstm", vocab_size=VOCAB, num_genres=GENRES, emb_dim=32,
                 lstm_hid=48, lstm_layers=2, pad_id=0),
}


def _batches(rng, n=3, b=4):
    out = []
    for _ in range(n):
        seqs = [np.concatenate([[1], rng.integers(2, VOCAB, rng.integers(5, 40))])
                for _ in range(b - 1)] + [np.zeros((0,), np.int64)]  # a fill row
        out.append(lstm_trainer.collate_music(seqs, rng.integers(0, GENRES, b)))
    return out


@pytest.mark.parametrize("arch", ["transformer", "lstm"])
def test_three_steps_match_the_jax_trainer(rng, arch):
    args = ARGS[arch]
    data = _batches(rng)
    jmodel = jax_build(args, dropout=0.0)
    tok0 = jnp.asarray(data[0][0][:, :-1])
    params = jax.tree.map(jnp.asarray, _perturb(to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), tok0, jnp.asarray(data[0][1]))), rng))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    opt = tx.init(params)
    jstep = jax_trainer.make_lstm_step(jmodel, tx, 0, train=True)
    model = build_token_lm(args, dropout=0.0)
    model.load_state_dict(state_dict_from_jax(to_numpy_tree(params), model))
    ptx = lstm_trainer.ClipAdamW(LR, 1.0)
    state = ptx.init(model.parameters())
    step = lstm_trainer.make_lstm_step(model, ptx, 0, train=True)
    key, gen = jax.random.key(1), torch.Generator().manual_seed(1)
    for tokens, genres, lengths in data:
        params, opt, jloss, key = jstep(params, opt, jnp.asarray(tokens),
                                        jnp.asarray(genres), jnp.asarray(lengths), key)
        loss = step(state, *map(torch.from_numpy, (tokens, genres, lengths)), gen)
        assert float(loss) == pytest.approx(float(jloss), abs=TOL, rel=TOL)
    assert int(state["count"]) == 3
    want = state_dict_from_jax(to_numpy_tree(params), model)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_nan_batch_leaves_params_moments_and_count_unchanged(rng):
    model = seeded_init_(build_token_lm(ARGS["transformer"], dropout=0.1), 0)
    tx = lstm_trainer.ClipAdamW(1e-3)
    state = tx.init(model.parameters())
    step = lstm_trainer.make_lstm_step(model, tx, 0, train=True)
    gen = torch.Generator().manual_seed(0)
    good, bad, after = (tuple(map(torch.from_numpy, b)) for b in _batches(rng))
    step(state, *good, gen)

    def snapshot():
        return ([p.detach().clone() for p in model.parameters()],
                [m.clone() for m in state["mu"]], [v.clone() for v in state["nu"]],
                int(state["count"]))

    before = snapshot()
    hook = model.proj.register_forward_hook(lambda m, i, out: out * float("nan"))
    loss = step(state, *bad, gen)
    hook.remove()
    assert not bool(torch.isfinite(loss))
    now = snapshot()
    for a, b in zip(before[:3], now[:3]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert now[3] == before[3] == 1
    assert bool(torch.isfinite(step(state, *after, gen)))
    assert int(state["count"]) == 2


def _chunks_dir(tmp_path, rng, n=14):
    root = tmp_path / "chunks"
    os.makedirs(root / "g")
    mapping = {}
    for i in range(n):
        name = f"g/c{i:02d}.npy"
        np.save(root / name, rng.integers(2, VOCAB, rng.integers(8, 70)).astype(np.int32))
        mapping[name] = int(i % GENRES)
    with open(tmp_path / "map.json", "w") as f:
        json.dump(mapping, f)
    return str(root), str(tmp_path / "map.json")


def test_cli_trains_writes_best_json_and_follows_the_jax_batch_order(
        tmp_path, rng, monkeypatch):
    chunks, mapping = _chunks_dir(tmp_path, rng)
    seen = []
    orig = lstm_trainer.batches

    def recording(*a, **kw):
        for batch in orig(*a, **kw):
            seen.append(batch[0])
            yield batch

    monkeypatch.setattr(lstm_trainer, "batches", recording)
    out = tmp_path / "run"
    common = ["--chunks_dir", chunks, "--mapping_json", mapping, "--device", "cpu",
              "--vocab_size", str(VOCAB), "--num_genres", str(GENRES),
              "--arch", "transformer", "--emb_dim", "32", "--n_layers", "2",
              "--n_heads", "4", "--batch_size", "4", "--log_every", "1",
              "--flash_lm", "--flash_blocks", "64", "64", "--out_dir", str(out)]
    lstm_trainer.main(common + ["--epochs", "2"])

    best = json.load(open(out / "best.json"))
    assert set(best) == {"epoch", "val_loss", "path", "args"}
    assert best["args"]["flash_blocks"] == [64, 64] and best["args"]["device"] == "cpu"
    assert np.isfinite(best["val_loss"]) and os.path.isfile(best["path"])
    recs = [json.loads(line) for line in open(out / "lstm_metrics.jsonl")]
    assert all("_time" in r and "_step" in r for r in recs)
    assert sum("val/loss" in r for r in recs) == 2

    # the JAX trainer's split and shuffles, batch for batch
    ds = jax_trainer.MusicChunkDataset(chunks, mapping)
    perm = np.random.default_rng(42).permutation(len(ds))
    val_idx, train_idx = perm[:1].tolist(), perm[1:].tolist()
    want = []
    for epoch in (1, 2):
        want += [b[0] for b in jax_trainer.batches(
            ds, train_idx, 4, 0, np.random.default_rng(42 + epoch))]
        want += [b[0] for b in jax_trainer.batches(ds, val_idx, 4, 0, None)]
    assert len(seen) == len(want) == 2 * (4 + 1)
    for got, exp in zip(seen, want):
        np.testing.assert_array_equal(got, exp)

    # warm start from the port's own checkpoint; an orbax dir raises, naming
    # the converter
    lstm_trainer.main(common + ["--epochs", "1", "--pretrained", best["path"],
                                "--out_dir", str(tmp_path / "warm")])
    assert os.path.isfile(tmp_path / "warm" / "best.json")
    with pytest.raises(SystemExit, match="jax_generator_to_npz"):
        lstm_trainer.main(common + ["--pretrained", str(tmp_path / "orbax_dir")])
    with pytest.raises(SystemExit, match="transformer is not pipelined"):
        lstm_trainer.main(common + ["--pipe", "2"])
