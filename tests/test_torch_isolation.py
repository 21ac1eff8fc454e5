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
                 "deploy.http_lm", "deploy.http_server", "deploy.export_lm"):
        assert f"mqgan_tpu_torch.{name}" in result["modules"]
    assert result["bad"] == []
    assert result["trainer_device"] == "cuda"
    if result["cuda"]:
        assert result["default_device"].startswith("cuda")
        assert result["mel_device"].startswith("cuda")
    else:
        assert "CUDA is not available" in result["default_device_error"]
        assert "CUDA is not available" in result["mel_device_error"]
        assert "CUDA is not available" in result["trainer_device_error"]


def test_chip_smoke_imports_nothing_of_jax():
    """Every import statement of chip_smoke.py, at any depth (it imports
    the port inside its functions), names no JAX module and nothing of the
    JAX package."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "mqgan_tpu_torch.ops" in names  # it does import the port
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "flax", "mqgan_tpu")]
    assert bad == []
