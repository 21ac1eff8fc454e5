"""PyTorch port: the vocoder artifact's program (``ISTFTNetFE.export_ts`` /
``load_ts``), a ``torch.export`` program of the generator with a symbolic
batch and frame count, on the CPU: at two (b, t) shapes it equals the eager
generator within 1e-5 * max(1, max|x|), and both equal the JAX generator on
the same bridged weights as ``test_torch_vocoder.py::test_generator_matches_jax``
holds the eager one (1e-4); the wrapper vocodes through it."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu_torch.models.istft_vocoder import build_vocoder_fe
from mqgan_tpu_torch.signal import vocoder as voc
from mqgan_tpu_torch.signal.vocoder import ISTFTNetFE
from tests.test_torch_vocoder import (GEN_TOL, ISTFT_HOP, _mel, _narrow_gen_tree,
                                      _port_gen)

PROGRAM_TOL = 1e-5
SHAPES = ((1, 1), (3, 23))  # (b, t): the least frame count, and a batch


def _tol(x) -> float:
    return PROGRAM_TOL * max(1.0, float(np.abs(x).max()))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(eager generator, the JAX generator and tree, the loaded wrapper)."""
    gen, tree = _narrow_gen_tree()
    model = _port_gen(tree)
    out = str(tmp_path_factory.mktemp("voc_program"))
    build_vocoder_fe(model, ISTFT_HOP).export_ts(out, 16000, mel_channels=16)
    return model, gen, tree, out, ISTFTNetFE.load_ts(out, device="cpu")


@pytest.mark.parametrize("b,t", SHAPES)
def test_program_equals_the_generator_and_jax(artifact, b, t):
    model, gen, tree, _, fe = artifact
    mel = _mel(np.random.default_rng(b * 100 + t), b=b, t=t)
    with torch.no_grad():
        got = [x.numpy() for x in fe.program(torch.from_numpy(mel))]
        eager = [x.numpy() for x in model(torch.from_numpy(mel))]
    want = [np.asarray(a) for a in jax.jit(gen.apply)({"params": tree},
                                                      jnp.asarray(mel))]
    for g, e, w in zip(got, eager, want):
        assert g.shape == e.shape == w.shape == (b, 5, t * 16)
        np.testing.assert_allclose(g, e, atol=_tol(e), rtol=0)
        np.testing.assert_allclose(g, w, atol=GEN_TOL, rtol=GEN_TOL)
        np.testing.assert_allclose(e, w, atol=GEN_TOL, rtol=GEN_TOL)
    wav = fe(mel).numpy()
    ref = build_vocoder_fe(model, ISTFT_HOP)(mel).numpy()
    assert wav.shape == ref.shape
    np.testing.assert_allclose(wav, ref, atol=_tol(ref), rtol=0)


def test_artifact_files_and_refusals(artifact, tmp_path):
    """The config names the program and its platform; a config without a
    program (weights only) is refused, and a card is required by default
    where there is none."""
    _, _, _, out, fe = artifact
    with open(os.path.join(out, voc.CONFIG_NAME)) as f:
        cfg = json.load(f)
    assert cfg["program"] == voc.PROGRAM_NAME and cfg["platforms"] == ["cpu"]
    assert os.path.isfile(os.path.join(out, "cpu", voc.PROGRAM_NAME))
    assert fe.sampling_rate == 16000 and fe.program is not None
    del cfg["program"]
    (tmp_path / voc.CONFIG_NAME).write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="re-export"):
        ISTFTNetFE.load_ts(str(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ISTFTNetFE.load_ts(out)
