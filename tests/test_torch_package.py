"""Package rules of the port (``paddle_tpu_torch``).

- Importing the package, every one of its modules and ``chip_smoke``
  loads neither JAX nor anything of ``paddle_tpu`` (checked in a fresh
  interpreter), and builds nothing.
- Without a CUDA device, an entry point called without device="cpu"
  raises instead of running on the CPU, and ``chip_smoke.py`` exits
  non-zero without printing a result, as it does in a directory that
  holds nothing else of the repository.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                               "paddle_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                    "paddle_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _python(code_or_args, cwd):
    env = dict(os.environ, PYTHONPATH=str(cwd))
    env.pop("JAX_PLATFORMS", None)
    args = ["-c", code_or_args] if isinstance(code_or_args, str) \
        else code_or_args
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_imports_load_no_jax_and_build_nothing():
    build = ROOT / "paddle_tpu_torch" / "_build"
    before = sorted(build.iterdir()) if build.exists() else []
    res = _python(_IMPORT_ALL, ROOT)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == [], f"port imports pulled in {out['bad']}"
    assert "paddle_tpu_torch.ops.cuda.decode_matmul" in out["modules"]
    assert "paddle_tpu_torch.inference.serving" in out["modules"]
    for name in ("ops.cuda.flash_attention", "ops.flash_attention",
                 "ops.cuda.paged_attention_decode",
                 "nn.functional.attention", "optimizer.optimizer", "jit",
                 "models.llama", "distributed.ring_attention",
                 "distributed.fleet.topology", "distributed.mesh"):
        assert f"paddle_tpu_torch.{name}" in out["modules"]
    after = sorted(build.iterdir()) if build.exists() else []
    assert after == before


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")


def _entry_points():
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.inference import PagedLlamaDecoder
    from paddle_tpu_torch.inference.weights import weights_from_numpy
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.ops.paged_attention import PagedKVCache
    tree = {"embed": np.zeros((4, 2), np.float32), "layers": [],
            "norm": np.ones(2, np.float32), "head": np.zeros((2, 4),
                                                             np.float32)}
    return {
        "resolve_device": lambda: resolve_device(),
        "from_config": lambda: PagedLlamaDecoder.from_config(llama_tiny()),
        "from_numpy_weights": lambda: PagedLlamaDecoder.from_numpy_weights(
            llama_tiny(num_hidden_layers=0), tree),
        "weights_from_numpy": lambda: weights_from_numpy(
            tree, weight_dtype=None),
        "PagedKVCache": lambda: PagedKVCache(1, 4, 2, 1, 8),
        "LlamaForCausalLM": lambda: LlamaForCausalLM(llama_tiny()),
        "Linear": lambda: Linear(4, 4),
    }


@pytest.mark.parametrize("name", ["resolve_device", "from_config",
                                  "from_numpy_weights",
                                  "weights_from_numpy", "PagedKVCache",
                                  "LlamaForCausalLM", "Linear"])
def test_default_device_without_cuda_raises(name):
    _no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_cpu_device_is_explicit():
    from paddle_tpu_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_fails_without_cuda(tmp_path):
    _no_cuda()
    res = _python(["chip_smoke.py"], ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    res = _python(["chip_smoke.py"], alone)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
