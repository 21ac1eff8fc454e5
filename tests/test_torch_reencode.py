"""PyTorch port: dataset re-encode (``deploy/reencode.py``) and token stats
(``deploy/token_stats.py``) against the JAX package's on the same tree of
mels, one of them longer than the largest bucket (chunked); the JAX side
runs its ``reencode_spectrograms`` over a codec that calls the JAX model
with the same weights. Plus the failure rules: an unreadable file is
counted and the CLI exits non-zero; a kernel's error propagates."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.chunking import generator_halos, halo_align
from mqgan_tpu.deploy import reencode as jax_reencode
from mqgan_tpu.deploy import token_stats as jax_token_stats
from mqgan_tpu.models.preencoder import PreEncoder as JaxPreEncoder
from mqgan_tpu.quant.fsq import bound
from mqgan_tpu_torch.core.config import GeneratorConfig
from mqgan_tpu_torch.deploy import export, reencode, token_stats
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import MELS, NARROW, narrow_jax_params
from tools.jax_generator_to_npz import flatten_tree

DECODE_TOL = 2e-4
MIDPOINT_TOL = 1e-4
BUCKETS = (32, 64, 128)
LENGTHS = (5, 40, 64, 100, 300, 17)  # 300 > 128: chunked
KS, DEPTH = NARROW["kernel_sizes"], NARROW["refiner_depth"]


class JaxCodec:
    """The codec interface reencode_spectrograms uses, over the JAX model.
    Tokens whose pre-round value lies within 1e-4 of a rounding midpoint
    come back as -1, so the comparison can skip them."""

    def __init__(self, gen, tree):
        self.mel_channels, self.codebook_size = MELS, 1000
        self.buckets = list(BUCKETS)
        self.halos, self.halo_align = generator_halos(KS, DEPTH), halo_align(DEPTH)
        v = {"params": tree}

        def run(x, m):
            z = gen.apply(v, x, m, True, method=JaxPreEncoder._encode_trunk)
            idx = gen.apply(v, x, m, method=JaxPreEncoder.encode)
            return idx, gen.apply(v, idx, m, method=JaxPreEncoder.decode), \
                bound(z, gen.fsq_levels)

        self._run = jax.jit(run)

    def reencode(self, spec, lengths):
        t = spec.shape[1]
        tb = next(b for b in self.buckets if b >= t)
        x = np.zeros((spec.shape[0], tb, MELS), np.float32)
        x[:, :t] = spec
        mask = jnp.asarray(np.arange(tb)[None, :] >= np.asarray(lengths)[:, None])
        idx, out, b = (np.asarray(a) for a in self._run(jnp.asarray(x), mask))
        near = (np.abs(b - np.floor(b) - 0.5) <= MIDPOINT_TOL).any(axis=-1)
        return np.where(near, -1, idx)[:, :t], out[:, :t]


@pytest.fixture(scope="module")
def tree_of_mels(tmp_path_factory):
    root = tmp_path_factory.mktemp("mels")
    rng = np.random.default_rng(0)
    for i, n in enumerate(LENGTHS):
        d = root / ("a" if i % 2 else "b/c")
        os.makedirs(d, exist_ok=True)
        np.save(d / f"m{i}.npy", rng.standard_normal((n, MELS)).astype(np.float32))
    return str(root)


def _read_tree(root):
    return {os.path.relpath(os.path.join(d, f), root): np.load(os.path.join(d, f))
            for d, _, fs in os.walk(root) for f in fs}


def test_reencode_matches_jax(tree_of_mels, tmp_path):
    gen, tree = narrow_jax_params()
    jax_out, jax_toks = str(tmp_path / "jo"), str(tmp_path / "jt")
    want = jax_reencode.reencode_spectrograms(
        JaxCodec(gen, tree), tree_of_mels, jax_out, batch_size=8,
        save_tokens=True, tokens_dir=jax_toks)
    # the port's checkpoint source: config JSON + an .npz JAX tree
    cfg = str(tmp_path / "model.json")
    with open(cfg, "w") as f:
        json.dump({"model": {"mel_channels": MELS, "generator": NARROW}}, f)
    npz = str(tmp_path / "gen.npz")
    np.savez(npz, **flatten_tree(tree))
    codec = reencode.CheckpointReencoder(cfg, npz, buckets=BUCKETS, device="cpu")
    assert (codec.halos, codec.halo_align) == (generator_halos(KS, DEPTH), halo_align(DEPTH))
    port_out, port_toks = str(tmp_path / "po"), str(tmp_path / "pt")
    got = reencode.reencode_spectrograms(
        codec, tree_of_mels, port_out, batch_size=8, save_tokens=True,
        tokens_dir=port_toks)
    assert got == {"processed": len(LENGTHS), "failed": 0, "frames": sum(LENGTHS)}
    assert want == {"processed": len(LENGTHS), "failed": 0}
    j_mels, p_mels = _read_tree(jax_out), _read_tree(port_out)
    j_toks, p_toks = _read_tree(jax_toks), _read_tree(port_toks)
    assert set(j_mels) == set(p_mels) == set(j_toks) == set(p_toks)
    compared = 0
    for name in j_mels:
        far = j_toks[name] >= 0
        assert far.mean() > 0.9 and p_toks[name].dtype == np.int64
        np.testing.assert_array_equal(p_toks[name][far], j_toks[name][far])
        if (p_toks[name] == j_toks[name]).all():
            np.testing.assert_allclose(p_mels[name], j_mels[name],
                                       atol=DECODE_TOL, rtol=DECODE_TOL)
            compared += 1
    assert compared >= len(LENGTHS) - 1
    assert (p_toks["b/c/m4.npy"] == j_toks["b/c/m4.npy"]).all()  # the chunked file

    # token stats over both dumps (JAX's flagged tokens replaced by the port's)
    for name, toks in p_toks.items():
        np.save(os.path.join(jax_toks, name), np.where(j_toks[name] < 0, toks, j_toks[name]))
    w = jax_token_stats.compute_token_stats(jax_toks, 1000)
    s = token_stats.compute_token_stats(port_toks, 1000)
    assert dataclasses.asdict(s) | {"files_failed": []} == \
        dataclasses.asdict(w) | {"files_failed": []}
    assert s.n_tokens == sum(LENGTHS) and s.n_files == len(LENGTHS)


def _export(tmp_path):
    _, tree = narrow_jax_params()
    model = PreEncoder(MELS, **NARROW)
    model.load_state_dict(state_dict_from_jax(tree, model))
    return export.export_preencoder(model, GeneratorConfig(**NARROW),
                                    str(tmp_path / "exp"), buckets=BUCKETS,
                                    verify=False)


def test_bad_file_is_counted_and_the_cli_exits_nonzero(tmp_path):
    root = tmp_path / "mels"
    os.makedirs(root)
    rng = np.random.default_rng(1)
    np.save(root / "ok.npy", rng.standard_normal((20, MELS)).astype(np.float32))
    np.save(root / "wide.npy", rng.standard_normal((20, MELS + 1)).astype(np.float32))
    with open(root / "broken.npy", "wb") as f:
        f.write(b"not an npy")
    out = str(tmp_path / "out")
    with pytest.raises(SystemExit, match="2 file"):
        reencode.main(["--input_dir", str(root), "--output_dir", out,
                       "--model_dir", _export(tmp_path), "--device", "cpu"])
    assert os.listdir(out) == ["ok.npy"]
    stats = token_stats.main(["--tokens_dir", str(root), "--no_bigram"])
    assert stats.n_failed == 1  # broken.npy; the mels read as tokens


def test_kernel_error_propagates(tree_of_mels, tmp_path, monkeypatch):
    def failing_kernel(*args, **kw):
        raise RuntimeError("mqgan_residual_block: CUDA error 700 at launch")

    monkeypatch.setattr(PreEncoder, "decode", failing_kernel)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        reencode.main(["--input_dir", tree_of_mels, "--output_dir", out,
                       "--model_dir", _export(tmp_path), "--device", "cpu"])
    assert os.listdir(out) == []


def test_parallel_modes_and_the_cuda_default(tmp_path):
    cfg = str(tmp_path / "model.json")
    with open(cfg, "w") as f:
        json.dump({"model": {"mel_channels": MELS, "generator": NARROW}}, f)
    for kw in ({"data_parallel": True}, {"seq_parallel": True}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            reencode.CheckpointReencoder(cfg, "unused.pt", **kw)
    if not torch.cuda.is_available():
        _, tree = narrow_jax_params()
        model = PreEncoder(MELS, **NARROW)
        path = str(tmp_path / "gen.pt")
        torch.save(state_dict_from_jax(tree, model), path)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            reencode.CheckpointReencoder(cfg, path)
