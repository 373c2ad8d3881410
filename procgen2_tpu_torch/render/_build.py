"""Build the port's CUDA kernels from the sources in this checkout.

Each `csrc/*.cu` file has a plain C entry point. It is compiled with
`nvcc` for sm_90a into a shared library under `<checkout>/.torch_ext_build/`
(listed in .gitignore) at first use, named by a hash of the source, of
every local header it includes and of the flags, and loaded with ctypes:
no PyTorch headers are compiled, so a build takes seconds. Nothing here runs at import time, and a failed build
raises with the compiler's output.

`check_tensor` is the launch wrappers' shared check of their arguments.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / ".torch_ext_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# --fmad=false: the kernels round every bf16 op on its own (see the sources)
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "--fmad=false", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.is_file():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                           "the port's CUDA kernels are built from source")
    return str(path)


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(src: pathlib.Path) -> list:
    """`src` and every header it includes with `#include "..."`, found
    next to the file that includes it, recursively (each once, in order)."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            inc = path.parent / name
            if not inc.is_file():
                raise FileNotFoundError(f"{path} includes {name}, not found")
            todo.append(inc)
    return seen


@functools.lru_cache(maxsize=None)
def load(name: str):
    """Build (if needed) and load `csrc/<name>.cu`. Returns
    (ctypes.CDLL, build record dict with seconds and compiler output)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(src):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    lib_path = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    record = {"name": name, "library": str(lib_path), "seconds": 0.0,
              "log": "", "cached": lib_path.is_file()}
    if not lib_path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        record["seconds"] = time.perf_counter() - t0
        record["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n"
                               f"{record['log']}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path)), record


def check_tensor(t, dtype, shape, device, name):
    """Raise ValueError unless t has this dtype, shape and device."""
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
