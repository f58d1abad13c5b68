"""Build and bind the hand-written Hopper kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc -gencode
arch=compute_90a,code=sm_90a -c``, all started together, and the objects
link into one shared library with a plain C interface under
``latentsync_tpu_torch/_build/``, named by a hash of the sources and
flags, at first use (never at import). The library is loaded with
``ctypes``: pointers and the stream travel as ``c_void_p``. Every entry
point returns ``cudaGetLastError()`` and :func:`call` raises on any
nonzero code, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# entry point -> argtypes (all return int: a cudaError_t, or for the
# queries that launch nothing, what :func:`query` returns)
_SIGNATURES = {
    "ls_geglu_ffn": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _F, _I, _P, _P, _P, _P],
    "ls_attn_block_max_c": [_I, _I],
    "ls_attn_block": [_P, _I, _I, _I, _I, _I, _P, _P, _F, _P, _P, _P, _P, _P,
                      _F, _P, _P, _P, _P, _P],
    "ls_temporal_block": [_P, _I, _I, _I, _I, _I, _P, _P, _F, _P, _P, _P, _P, _P, _P, _F,
                          _P, _P, _P],
    "ls_temporal_attention": [_P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _F, _P],
    "ls_spatial_attention": [_P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _F,
                             _I, _P],
    "ls_flash_attention": [_P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _F, _P],
    "ls_cross_attn_block": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _F, _P, _P,
                            _P, _P, _F, _P, _P, _P, _P, _P, _P],
    "ls_group_norm_silu": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "ls_group_norm_silu_streaming": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    "ls_quantized_matmul": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    "ls_qkv_proj": [*[_P] * 7, _I, _I, _I, _P],
    "ls_geglu_ffn_int8io": [_P, _P, _I, _I, *[_P] * 8],
    "ls_oneshot_attention": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "ls_flash_kernel": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# called as observer(entry point, args) before each launch when set (the
# kernel probe counts the operations of a model forward this way)
observer = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"liblatentsync_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for these sources is missing:
    one ``nvcc -c`` per source, all at once, then one link. The
    compiler's register/spill report is kept beside it as ``.log``."""
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    objdir = so.with_suffix(f".{os.getpid()}.obj")
    objdir.mkdir(exist_ok=True)
    objs = [objdir / (src.stem + ".o") for src in cu]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(cu, objs)]
    log, failed = [], []
    for src, proc in zip(cu, procs):
        out = proc.communicate()[0]
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out[-4000:]}")
    if not failed:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log.append(f"== link\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    so.with_suffix(".log").write_text("\n".join(log))
    shutil.rmtree(objdir, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:  # bound already: no lock on the launch path
        return _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            cdll.ls_error_string.argtypes = [ctypes.c_int]
            cdll.ls_error_string.restype = ctypes.c_char_p
            _lib = cdll
        return _lib


def call(name: str, *args) -> None:
    """Launch entry point `name` on the current stream (the caller passes
    `stream()` last) and raise if CUDA refused or failed the launch."""
    cdll = lib()
    if observer is not None:
        observer(name, args)
    code = getattr(cdll, name)(*args)
    if code != 0:
        msg = cdll.ls_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def query(name: str, *args) -> int:
    """What entry point `name` answers about the kernels (a shape limit); it
    launches nothing."""
    return getattr(lib(), name)(*args)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_cuda(name: str, *tensors: torch.Tensor,
               dtypes: Optional[Sequence[torch.dtype]] = None) -> None:
    """The kernels take CUDA tensors on one device, 16-byte aligned, of the
    given per-tensor dtypes (bf16 for all when `dtypes` is None)."""
    dev = tensors[0].device
    if dtypes is None:
        dtypes = (torch.bfloat16,) * len(tensors)
    if len(dtypes) != len(tensors):
        raise ValueError(f"{name}: {len(tensors)} tensors, {len(dtypes)} dtypes")
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data is not 16-byte aligned")
