"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` for `sm_90a`, all of
them at once, and the objects are linked into one shared library with a
plain C interface, loaded with `ctypes`. The build happens at
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
_F = ctypes.c_float
_SIGNATURES = {
    # x, qx, aux, w, s, z, out, rows, in_dim, out_dim, dtype, stream
    "csm_w8a8_matvec": (_VP,) * 7 + (_I,) * 4 + (_VP,),
    # x, qx, aux, rows, in_dim, dtype, stream
    "csm_w8a8_quant_rows": (_VP,) * 3 + (_I,) * 3 + (_VP,),
    # qx (at its first column), ldx, w, out, rows, in_dim, out_dim, stream
    "csm_w8a8_partial": (_VP, _I, _VP, _VP) + (_I,) * 3 + (_VP,),
    # p, aux, s, z, out, rows, out_dim, dtype, stream
    "csm_w8a8_fixup": (_VP,) * 5 + (_I,) * 3 + (_VP,),
    # q, k, v, pad_len, out, 9 strides, batch, n_heads, n_kv, seq, head_dim,
    # scale, dtype, stream
    "csm_flash_prefill": (_VP,) * 5 + (_LL,) * 9 + (_I,) * 5
    + (ctypes.c_float, _I, _VP),
    # layer pointers, n_layers, norm, rope_cs, head_q, head_s, embed,
    # proj01, x, q, ao, act, xq, aux, kc, vc, part, tokens, logits, rows,
    # heads, n_kv, hd, d, f, n_cb, v, v_pad, eps, scale, inv_t, seed (an
    # int32 in device memory), grid, stamps, stamp_cap, stream
    "csm_resident_frame": (ctypes.POINTER(_VP), _I) + (_VP,) * 17
    + (_I,) * 9 + (_F,) * 3 + (_VP, _I, _VP, _I, _VP),
    # q, k, v, out, lse, 9 strides, batch, n_heads, n_kv, seq, head_dim,
    # scale, dtype, stream
    "csm_flash_train_fwd": (_VP,) * 5 + (_LL,) * 9 + (_I,) * 5
    + (_F, _I, _VP),
    # q, k, v, o, lse, dout, delta, partial, dq, dk, dv, 12 strides, batch,
    # n_heads, n_kv, seq, head_dim, scale, dtype, stream
    "csm_flash_train_bwd": (_VP,) * 11 + (_LL,) * 12 + (_I,) * 5
    + (_F, _I, _VP),
    # x, w, scales, biases, out, rows, in_dim, out_dim, group, bits, dtype,
    # stream
    "csm_affine_matvec": (_VP,) * 5 + (_I,) * 6 + (_VP,),
    # kernel 5's bf16 route edge: rows up to it on the CUDA cores
    "csm_affine_core_rows": (),
    # q, k, v, pad_len, out, scratch, 8 strides, batch, n_heads, n_kv, cap,
    # index (an int32 in device memory), splits, chunk, head_dim, scale,
    # dtype, stream
    "csm_flash_decode": (_VP,) * 6 + (_LL,) * 8 + (_I,) * 4 + (_VP,)
    + (_I,) * 3 + (_F, _I, _VP),
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
    obj_dir = BUILD_DIR / f"obj_{digest.hexdigest()[:16]}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = obj_dir / f"{src.stem}.o"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log = []
    for src, _, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            for _, _, other in procs:
                other.kill()
                other.wait()
            raise RuntimeError(
                f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
        log.append(err)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *[str(obj) for _, obj, _ in procs]],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    if verbose:
        print("".join(log), end="")
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
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
