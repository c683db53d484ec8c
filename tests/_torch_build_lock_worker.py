"""A spawned process of ``test_torch_transport.py``'s build-lock test: it
points the port's kernel build at a scratch directory, stubs ``nvcc``
with a script and the library loader with the path, waits for a common
start time and calls ``load_library``. Module level, so a spawned
process can import it."""
import json
import time
from pathlib import Path


def build(build_dir, src_dir, fake_nvcc, out_path, start_at):
    from paddle_tpu_torch.ops.cuda import _build
    _build.BUILD_DIR = Path(build_dir)
    _build.SRC_DIR = Path(src_dir)
    _build._nvcc = lambda: fake_nvcc
    _build._open = lambda target: str(target)
    while time.time() < start_at:
        time.sleep(0.001)
    lib = _build.load_library()
    with open(out_path, "w") as f:
        json.dump({"lib": lib, "built": _build.build_info["built"],
                   "ptxas": _build.build_info["ptxas"]}, f)
