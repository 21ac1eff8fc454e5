"""PyTorch port: the package imports no JAX, no flax and nothing of the JAX
package, and its entry points never fall back to the CPU by themselves."""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import torch
import mqgan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mqgan_tpu_torch.__path__,
                                               "mqgan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "mqgan_tpu"))
result = {"modules": names, "bad": bad, "cuda": torch.cuda.is_available()}
from mqgan_tpu_torch.deploy.runtime import CodecRuntime
from mqgan_tpu_torch.models.preencoder import PreEncoder
model = PreEncoder(16, channels=(16, 24), kernel_sizes=(3,),
                   refiner_base_channels=4, refiner_depth=1)
try:
    rt = CodecRuntime(model)
    result["default_device"] = str(rt.device)
except RuntimeError as e:
    result["default_device_error"] = str(e)
from mqgan_tpu_torch.core.config import SpectrogramConfig
from mqgan_tpu_torch.signal.mel import MelFrontend
try:
    result["mel_device"] = str(MelFrontend(SpectrogramConfig()).device)
except RuntimeError as e:
    result["mel_device_error"] = str(e)
from mqgan_tpu_torch.train import lstm_trainer
lm_args = ["--vocab_size", "8", "--num_genres", "2", "--arch", "transformer",
           "--flash_lm", "--chunks_dir", "no_such_dir"]
result["trainer_device"] = lstm_trainer.parse_args(lm_args).device
if not result["cuda"]:
    try:
        lstm_trainer.main(lm_args)
    except RuntimeError as e:
        result["trainer_device_error"] = str(e)
from mqgan_tpu_torch.train import trainer as gan_trainer
gan_args = ["--config", "no_such_config.json", "--no_wandb"]
result["gan_trainer_device"] = gan_trainer.parse_args(gan_args)[1].device
if not result["cuda"]:
    try:
        gan_trainer.main(gan_args)
    except RuntimeError as e:
        result["gan_trainer_device_error"] = str(e)
from mqgan_tpu_torch.train import vocoder_trainer
voc_args = ["--wav_dir", "no_such_dir", "--spec_config", "no_such_spec.json"]
result["vocoder_trainer_device"] = vocoder_trainer.parse_args(voc_args).device
if not result["cuda"]:
    try:
        vocoder_trainer.main(voc_args)
    except RuntimeError as e:
        result["vocoder_trainer_device_error"] = str(e)
import shutil, tempfile
from mqgan_tpu_torch.core.config import GeneratorConfig
from mqgan_tpu_torch.deploy import (export, http_server, http_streaming,
                                    reencode, runtime)
art = export.export_preencoder(model, GeneratorConfig(channels=(16, 24),
                               kernel_sizes=(3,), refiner_base_channels=4,
                               refiner_depth=1), tempfile.mkdtemp(),
                               buckets=(16,), verify=False)
cfg = art + "/model.json"
with open(cfg, "w") as f:
    json.dump({"model": {"mel_channels": 16, "generator": {
        "channels": [16, 24], "kernel_sizes": [3], "refiner_base_channels": 4,
        "refiner_depth": 1}}}, f)
from mqgan_tpu_torch.deploy import export_lm, http_lm
from mqgan_tpu_torch.models.istft_vocoder import ISTFTNetGenerator, build_vocoder_fe
from mqgan_tpu_torch.models.music_lstm import MusicLSTM
from mqgan_tpu_torch.signal.vocoder import ISTFTNetFE
voc = build_vocoder_fe(ISTFTNetGenerator(n_mels=16, upsample_initial_channel=8,
                                         resblock_kernel_sizes=(3,),
                                         resblock_dilations=(1,)), 8)
voc_art = voc.export_ts(art + "/vocoder", 16000, mel_channels=16)
lm_art = export_lm.export_music_lm(
    MusicLSTM(vocab_size=8, num_genres=2, emb_dim=4, lstm_hid=4, lstm_layers=1),
    art + "/lm", gen_buckets=(4,), prompt_buckets=(1,), score_buckets=(4,),
    verify=False)
import importlib.util


def example(name):
    # the port's example script examples/<name>.py as a module
    spec = importlib.util.spec_from_file_location(name, f"examples/{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


entries = {
    "exported": lambda: runtime.ExportedPreEncoder(art),
    "vocoder_artifact": lambda: ISTFTNetFE.load_ts(voc_art).gen,
    "lm_artifact": lambda: export_lm.ExportedMusicLM(lm_art),
    "http_lm_export": lambda: http_lm.LMHTTPService(lm_export=lm_art),
    "checkpoint_reencoder": lambda: reencode.CheckpointReencoder(
        cfg, art + "/weights.pt"),
    "exported_data_parallel": lambda: runtime.ExportedPreEncoder(
        art, data_parallel=True),
    "seq_parallel_reencoder": lambda: reencode.CheckpointReencoder(
        cfg, art + "/weights.pt", seq_parallel=True),
    "http_server_main": lambda: http_server.main(["--model_dir", art]),
    "http_streaming_main": lambda: http_streaming.main(["--model_dir", art]),
    "reencode_main": lambda: reencode.main(["--input_dir", art, "--output_dir",
                                            art + "/out", "--model_dir", art]),
    "export_main": lambda: export.main(["--manifest", art, "--seed", "0",
                                        "--output", art + "/again"]),
    "serving_demo_torch": lambda: example("serving_demo_torch").main(
        ["--model_dir", art]),
    "music_continuation_torch": lambda: example("music_continuation_torch").main(
        ["--model_dir", art, "--lm_run", art, "--out", art + "/cont.npy"]),
    "audio_reconstruction_demo_torch": lambda: example(
        "audio_reconstruction_demo_torch").main(
        ["--wav", art + "/in.wav", "--out", art + "/out.wav", "--spec_config",
         art + "/spec.yaml", "--model_dir", art]),
}
result["entries"] = {}
for name, entry in entries.items():
    if result["cuda"]:
        made = entry()
        if name == "vocoder_artifact":
            dev = next(made.parameters()).device
        elif name in ("exported", "checkpoint_reencoder", "lm_artifact",
                      "http_lm_export", "exported_data_parallel",
                      "seq_parallel_reencoder"):
            dev = made.device
        else:
            dev = "cuda"
        if name == "http_lm_export":
            made.close()
        result["entries"][name] = str(dev)
        continue
    try:
        entry()
        result["entries"][name] = "ran on the CPU"
    except RuntimeError as e:
        result["entries"][name] = str(e)
result["bad_after_entries"] = sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "mqgan_tpu"))
shutil.rmtree(art, ignore_errors=True)
print(json.dumps(result))
"""


def test_port_imports_nothing_of_jax_and_does_not_fall_back():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "mqgan_tpu_torch.models.preencoder" in result["modules"]
    assert "mqgan_tpu_torch.ops.block_kernels" in result["modules"]
    for name in ("ops.stft_kernels", "signal.mel", "signal.convert",
                 "models.istft_vocoder", "ops.flash_attention",
                 "models.token_transformer", "models.music_lstm",
                 "models.token_lm", "train.lstm_trainer", "utils.logging",
                 "utils.npy", "nn.layers", "models.lm_sampling",
                 "deploy.http_lm", "deploy.http_server", "deploy.export_lm",
                 "core.chunking", "utils.torch_import", "utils.checkpoint",
                 "deploy.export", "deploy.reencode", "deploy.token_stats",
                 "deploy.streaming", "deploy.streaming_server",
                 "deploy.http_streaming", "deploy.http_client", "nn.se",
                 "models.discriminators", "losses.gan", "losses.recon",
                 "quant.fsq", "train.state", "train.step", "train.data",
                 "train.trainer", "utils.plotting", "losses.stft_loss",
                 "models.wave_discriminators", "train.vocoder_trainer",
                 "signal.vocoder", "parallel.mesh", "parallel.seqpar",
                 "nn.norm", "nn.pooling", "signal.qc", "parallel.dp",
                 "parallel.multihost", "parallel.pipeline"):
        assert f"mqgan_tpu_torch.{name}" in result["modules"]
    assert result["bad"] == [] and result["bad_after_entries"] == []
    assert result["trainer_device"] == "cuda"
    assert result["gan_trainer_device"] == "cuda"
    assert result["vocoder_trainer_device"] == "cuda"
    assert len(result["entries"]) == 14
    if result["cuda"]:
        assert result["default_device"].startswith("cuda")
        assert result["mel_device"].startswith("cuda")
        assert all(d.startswith("cuda") for d in result["entries"].values())
    else:
        for name, error in result["entries"].items():
            assert "CUDA is not available" in error, name
        assert "CUDA is not available" in result["default_device_error"]
        assert "CUDA is not available" in result["mel_device_error"]
        assert "CUDA is not available" in result["trainer_device_error"]
        assert "CUDA is not available" in result["gan_trainer_device_error"]
        assert "CUDA is not available" in result["vocoder_trainer_device_error"]


def _imported_names(path: str) -> list:
    """Every module an import statement of the file names, at any depth."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return names


def _jax_names(names: list) -> list:
    return [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "mqgan_tpu")]


def test_chip_smoke_imports_nothing_of_jax():
    """Every import statement of chip_smoke.py, at any depth (it imports
    the port inside its functions), names no JAX module and nothing of the
    JAX package."""
    names = _imported_names("chip_smoke.py")
    assert "mqgan_tpu_torch.ops" in names  # it does import the port
    assert _jax_names(names) == []


def test_port_examples_import_nothing_of_jax():
    """The same for the port's examples (examples/*_torch.py), which the
    probe above also runs to their first device check."""
    for name in ("serving_demo_torch", "music_continuation_torch",
                 "audio_reconstruction_demo_torch"):
        names = _imported_names(f"examples/{name}.py")
        assert any(n.startswith("mqgan_tpu_torch.") for n in names), name
        assert _jax_names(names) == [], name
