"""PyTorch port: the codec artifact (``deploy/export.py``) and its runtime
(``ExportedPreEncoder``) on the CPU: round trip against the model, manifest
fields equal to the JAX package's export of the same config, the CLI's
mixer modes, ``decode(return_hidden / return_recon)`` and the "encode" /
True poly modes against the JAX package."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core import chunking as jc
from mqgan_tpu.deploy.export import export_preencoder as jax_export
from mqgan_tpu.models.preencoder import PreEncoder as JaxPreEncoder
from mqgan_tpu.quant.fsq import bound
from mqgan_tpu_torch.core.config import GeneratorConfig
from mqgan_tpu_torch.deploy import export
from mqgan_tpu_torch.deploy.runtime import CodecRuntime, ExportedPreEncoder
from mqgan_tpu_torch.models.preencoder import PreEncoder
from tests.test_torch_bridge import MELS, NARROW, max_err, narrow_jax_params, port_model

DECODE_TOL = 2e-4
MIDPOINT_TOL = 1e-4
BUCKETS = (16, 32, 64)
GEN = GeneratorConfig(**NARROW)


def _write_config(path):
    cfg = {"model": {"mel_channels": MELS, "generator": NARROW}}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _tokens_far(gen, tree, x, mask):
    """JAX tokens and where each sits away from a rounding midpoint."""
    variables, jx, jm = {"params": tree}, jnp.asarray(x), jnp.asarray(mask)
    tokens = np.asarray(jax.jit(functools.partial(
        gen.apply, method=JaxPreEncoder.encode))(variables, jx, jm))
    z = jax.jit(lambda v, a, m: gen.apply(
        v, a, m, True, method=JaxPreEncoder._encode_trunk))(variables, jx, jm)
    b = np.asarray(bound(z, gen.fsq_levels))
    far = (np.abs(b - np.floor(b) - 0.5) > MIDPOINT_TOL).all(axis=-1)
    return tokens, far


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    _, tree = narrow_jax_params()
    model = port_model(tree)
    out = str(tmp_path_factory.mktemp("export"))
    export.export_preencoder(model, GEN, out, buckets=BUCKETS, device="cpu")
    return model, out


@pytest.mark.parametrize("kernel_sizes,depth", [((3,), 1), ((3, 5), 2), ((7, 5, 3), 3)])
def test_runtime_halos_follow_its_model(kernel_sizes, depth):
    """A CodecRuntime over any generator chunks with that generator's
    halos, as the JAX package's functions give them."""
    channels = (16,) + (24,) * len(kernel_sizes)
    model = PreEncoder(MELS, channels=channels, kernel_sizes=kernel_sizes,
                       refiner_base_channels=4, refiner_depth=depth)
    rt = CodecRuntime(model, buckets=BUCKETS, device="cpu")
    assert rt.halos == jc.generator_halos(kernel_sizes, depth)
    assert rt.decoder_halos == jc.decoder_halos(kernel_sizes, depth)
    assert rt.encoder_halo == jc.encoder_halo(kernel_sizes)
    assert rt.halo_align == jc.halo_align(depth)


def test_artifact_round_trip_equals_the_model(exported):
    model, out = exported
    assert sorted(os.listdir(out)) == ["manifest.json", "weights.pt"]
    rt = ExportedPreEncoder(out, device="cpu")
    assert rt.buckets == list(BUCKETS) and rt.mel_channels == MELS
    assert rt.fsq_levels == [8, 5, 5, 5] and rt.codebook_size == 1000
    assert (rt.bos_token_id, rt.eos_token_id) == (1001, 1002)
    ks, depth = NARROW["kernel_sizes"], NARROW["refiner_depth"]
    assert rt.halos == jc.generator_halos(ks, depth)
    assert rt.decoder_halos == jc.decoder_halos(ks, depth)
    assert rt.encoder_halo == jc.encoder_halo(ks)
    assert rt.halo_align == jc.halo_align(depth)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 27, MELS)).astype(np.float32)
    lengths = np.array([27, 20, 1], np.int32)
    tokens, mel = rt.reencode(x, lengths)
    mask = torch.from_numpy(np.arange(32)[None, :] >= lengths[:, None])
    xp = torch.from_numpy(np.concatenate([x, np.zeros((3, 5, MELS), np.float32)], 1))
    want_tokens = model.encode(xp, mask)[:, :27].numpy()
    np.testing.assert_array_equal(tokens, want_tokens)
    want = model.decode(torch.from_numpy(np.pad(tokens, ((0, 0), (0, 5)))), mask)
    np.testing.assert_array_equal(mel, want[:, :27].numpy())
    np.testing.assert_array_equal(rt.encode(x, lengths), tokens)
    np.testing.assert_array_equal(rt.decode(tokens, lengths), mel)
    with pytest.raises(ValueError, match="largest bucket"):
        rt.encode(np.zeros((1, 65, MELS), np.float32))


def test_manifest_fields_equal_jax(tmp_path):
    gen, tree = narrow_jax_params(poly_mixers="decode")
    jax_dir = str(tmp_path / "jax")
    jax_export(gen, {"params": tree}, jax_dir, buckets=BUCKETS, verify=False)
    with open(os.path.join(jax_dir, "manifest.json")) as f:
        want = json.load(f)
    model = port_model(tree, poly_mixers="decode")
    port_dir = export.export_preencoder(model, GEN, str(tmp_path / "port"),
                                        buckets=BUCKETS, verify=False)
    got = export.read_manifest(port_dir)
    for key in ("files", "platforms"):
        want.pop(key)
    assert {k: got[k] for k in want} == want
    assert got["dtype"] == "float32" and got["generator"]["channels"] == [16, 24, 32]


def test_verify_export_raises_on_a_broken_artifact(exported, tmp_path):
    _, out = exported
    export.verify_export(out, device="cpu")
    weights = torch.load(os.path.join(out, "weights.pt"), weights_only=True)
    del weights["proj.bias"]
    bad = str(tmp_path / "bad")
    os.makedirs(bad)
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = f.read()
    with open(os.path.join(bad, "manifest.json"), "w") as f:
        f.write(manifest)
    torch.save(weights, os.path.join(bad, "weights.pt"))
    with pytest.raises(RuntimeError, match="proj.bias"):
        export.verify_export(bad, device="cpu")


@pytest.mark.parametrize("flags,poly,dtype", [
    ([], "decode", "float32"),
    (["--exact_mixers"], False, "float32"),
    (["--poly_mixers"], True, "float32"),
    (["--poly_mixers", "encode", "--bf16"], "encode", "bfloat16"),
])
def test_cli_mixer_modes(tmp_path, flags, poly, dtype):
    cfg = _write_config(str(tmp_path / "model.json"))
    out = export.main(["--config", cfg, "--seed", "1", "--output",
                       str(tmp_path / "exp"), "--buckets", "16", "32",
                       "--device", "cpu"] + flags)
    rt = ExportedPreEncoder(out, device="cpu")
    assert rt.manifest["poly_mixers"] == poly and rt.manifest["dtype"] == dtype
    assert rt.model.poly_mixers == poly and rt.model.dtype == getattr(torch, dtype)
    # a re-export from the manifest with the artifact's own weights
    again = export.main(["--manifest", out, "--checkpoint",
                         os.path.join(out, "weights.pt"), "--output",
                         str(tmp_path / "again"), "--exact_mixers", "--device", "cpu"])
    for k, v in ExportedPreEncoder(again, device="cpu").model.state_dict().items():
        torch.testing.assert_close(v, rt.model.state_dict()[k], rtol=0, atol=0)


def test_cli_errors_and_cuda_default(tmp_path):
    cfg = _write_config(str(tmp_path / "model.json"))
    base = ["--config", cfg, "--seed", "0", "--output", str(tmp_path / "e")]
    with pytest.raises(SystemExit):
        export.main(base + ["--exact_mixers", "--poly_mixers", "encode"])
    with pytest.raises(SystemExit):
        export.main(base + ["--checkpoint", "x.pt"])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export.main(base)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ExportedPreEncoder(str(tmp_path / "e"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        ExportedPreEncoder(str(tmp_path / "e"), device="cpu", data_parallel=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        PreEncoder(MELS, **NARROW, int8_refiner=True)


def test_decode_returns_hidden_and_recon_like_jax():
    gen, tree = narrow_jax_params()
    model = port_model(tree)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 1000, (2, 24)).astype(np.int32)
    mask = np.arange(24)[None, :] >= np.array([[24], [17]])
    decode = jax.jit(functools.partial(gen.apply, method=JaxPreEncoder.decode),
                     static_argnames=("return_hidden", "return_recon"))
    args = ({"params": tree}, jnp.asarray(tokens), jnp.asarray(mask))
    for kw in ({"return_hidden": True}, {"return_recon": True}):
        want = [np.asarray(a) for a in decode(*args, **kw)]
        got = model.decode(torch.from_numpy(tokens), torch.from_numpy(mask), **kw)
        for g, w in zip(got, want):
            # padded rows of the hidden are the trunk's, unmasked in both
            np.testing.assert_allclose(g.numpy(), w, atol=DECODE_TOL, rtol=DECODE_TOL)


@pytest.mark.parametrize("poly_mixers", ["encode", True])
def test_poly_pre_mixer_modes_match_jax(poly_mixers):
    """The pre mixer through the Chebyshev mode: tokens equal the JAX
    package's in the same mode away from midpoints, the decode within 2e-4;
    flips against the exact export are counted, not gated."""
    gen, tree = narrow_jax_params(poly_mixers=poly_mixers)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 40, MELS)).astype(np.float32)
    mask = np.arange(40)[None, :] >= np.array([[40], [29], [1]])
    j_tokens, far = _tokens_far(gen, tree, x, mask)
    model = port_model(tree, poly_mixers=poly_mixers)
    tokens = model.encode(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert far.mean() > 0.95
    np.testing.assert_array_equal(tokens[far], j_tokens[far])
    j_out = np.asarray(jax.jit(functools.partial(
        gen.apply, method=JaxPreEncoder.decode))(
            {"params": tree}, jnp.asarray(j_tokens), jnp.asarray(mask)))
    out = model.decode(torch.tensor(j_tokens), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, j_out, atol=DECODE_TOL, rtol=DECODE_TOL)
    exact = port_model(tree).encode(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    valid = ~mask
    print(f"poly_mixers={poly_mixers!r}: {int((exact != tokens)[valid].sum())} of "
          f"{int(valid.sum())} tokens differ from the exact mixers; decode max err "
          f"{max_err(out, j_out):.3e}")
