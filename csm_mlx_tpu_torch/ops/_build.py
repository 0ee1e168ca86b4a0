"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` into one shared
library with a plain C interface, loaded with `ctypes`. The build happens at
the first kernel launch of a process (never at import), from the sources in
this checkout only, into `csm_mlx_tpu_torch/_build/` (listed in
`.gitignore`). The library's file name carries a hash of the sources, so an
edited source is rebuilt and a stale library is never loaded.

Each C entry point returns `cudaGetLastError()`; `check` raises on a nonzero
code, so a launch the GPU refused (too many threads, too much shared
memory) is reported where it happened.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # x, qx, aux, w, s, z, out, rows, in_dim, out_dim, dtype, stream
    "csm_w8a8_matvec": (_VP,) * 7 + (_I,) * 4 + (_VP,),
    # q, k, v, pad_len, out, 9 strides, batch, n_heads, n_kv, seq, head_dim,
    # scale, dtype, stream
    "csm_flash_prefill": (_VP,) * 5 + (_LL,) * 9 + (_I,) * 5
    + (ctypes.c_float, _I, _VP),
}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False) -> Path:
    """Compile the kernels (once per source hash); return the library path."""
    digest = hashlib.sha256()
    for path in _sources():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib_path = BUILD_DIR / f"libcsm_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           *[str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {code}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
