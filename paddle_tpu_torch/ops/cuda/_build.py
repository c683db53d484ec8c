"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``paddle_tpu_torch/csrc/*.cu`` for ``sm_90a``
into one shared library with a plain C interface, loaded with
``ctypes`` (pointers from ``Tensor.data_ptr()``, the stream from
``torch.cuda.current_stream().cuda_stream``). The sources compile in
parallel, one ``nvcc`` each, and link once. The library goes into
``paddle_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads at
once. Nothing happens at import: the first kernel launch calls
``load_library``. A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["load_library", "build_info", "check", "sm_count",
           "SHORT_REGISTERS", "SRC_DIR", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# filled by load_library: seconds spent compiling (0.0 when the library
# was already built) and the ptxas resource report per source (kept
# beside the library, so a process that only loads it has it too)
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (no CUDA toolkit on PATH or "
                       "CUDA_HOME): the port's kernels cannot be built")


def _digest(paths) -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources, target: Path) -> dict:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp_"))
    try:
        procs = []
        for src in sources:
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *CFLAGS, "-I", str(SRC_DIR), "-c", str(src), "-o",
                 str(obj)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        report, failed = {}, []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            report[src.name] = out
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib_tmp = tmp / target.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(lib_tmp)]
            + [str(obj) for _s, obj, _p in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib_tmp, target)
        return report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ptt_ragged_paged_attention.argtypes = [p] * 11 + [i] * 13 + [f, p]
    lib.ptt_ragged_paged_attention.restype = i
    lib.ptt_paged_attention_decode.argtypes = [p] * 8 + [i] * 11 + [f, p]
    lib.ptt_paged_attention_decode.restype = i
    lib.ptt_paged_attention_smem.argtypes = [i, i, i]
    lib.ptt_paged_attention_smem.restype = i
    lib.ptt_decode_matmul.argtypes = [p] * 5 + [i] * 7 + [p]
    lib.ptt_decode_matmul.restype = i
    lib.ptt_flash_fwd.argtypes = [p] * 8 + [i] * 11 + [f, p]
    lib.ptt_flash_fwd.restype = i
    lib.ptt_flash_bwd_dq.argtypes = [p] * 11 + [i] * 11 + [f, p]
    lib.ptt_flash_bwd_dq.restype = i
    lib.ptt_flash_bwd_dkv.argtypes = [p] * 13 + [i] * 12 + [f, p]
    lib.ptt_flash_bwd_dkv.restype = i
    lib.ptt_flash_regs.argtypes = [i, i]
    lib.ptt_flash_regs.restype = i
    lib.ptt_flash_smem_bytes.argtypes = [i, i, i]
    lib.ptt_flash_smem_bytes.restype = i
    lib.ptt_error_string.argtypes = [i]
    lib.ptt_error_string.restype = ctypes.c_char_p


def load_library():
    """The loaded kernel library, building it first when needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(SRC_DIR.glob("*.cu"))
        target = BUILD_DIR / (
            "libpaddle_tpu_torch_"
            + _digest(sorted(SRC_DIR.glob("*.cuh")) + sources) + ".so")
        t0 = time.perf_counter()
        notes = target.with_suffix(".ptxas.json")
        if not target.exists():
            notes.write_text(json.dumps(_compile(sources, target)))
        report = json.loads(notes.read_text()) if notes.exists() else {}
        build_info["seconds"] = time.perf_counter() - t0
        build_info["ptxas"] = report
        build_info["library"] = target.name
        lib = ctypes.CDLL(str(target))
        _declare(lib)
        _lib = lib
        return lib


_sm_count = {}


def sm_count(device) -> int:
    """SMs of a CUDA device (cached): the kernels' host-side plans size
    their grids by it."""
    import torch
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


# status of a launch refused because the kernel's build holds fewer
# registers a thread than its setmaxnreg split needs (csrc/common.cuh)
SHORT_REGISTERS = -2


def check(lib, code: int, what: str, regs=None):
    """Raise on a non-zero status from a launch. ``regs``, a callable
    giving the kernel's registers a thread, names them when the launch
    was refused for too few."""
    if code != 0:
        msg = lib.ptt_error_string(code).decode()
        if code == SHORT_REGISTERS and regs is not None:
            msg += f" ({what} was built with {regs()} registers a thread)"
        raise RuntimeError(f"{what} kernel launch failed ({code}): {msg}")
