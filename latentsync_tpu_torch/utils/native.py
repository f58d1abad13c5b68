"""The port's ctypes binding of the host paste-back library
``native/restore.cpp`` (the C++ source and its ``Makefile`` are shared with
the JAX package; this binding is the port's own and imports nothing of it).

``restore_lib()`` builds ``native/librestore.so`` with ``make -C native`` at
first use and raises if it cannot: when the compiler named by ``$CXX`` fails
(a toolchain without OpenMP's ``libgomp``, as on some GPU hosts), it retries
with the ``g++`` on ``PATH``. Nothing here returns ``None`` for a missing
library: the port has no other paste-back path. ``restore_lib()`` returns
this module, so callers write ``restore_lib().resize_frames_native(...)``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "librestore.so")
_lock = threading.Lock()
_lib = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F64P = ctypes.POINTER(ctypes.c_double)


def _build() -> None:
    errors = []
    for extra in ([], ["CXX=g++"]):
        proc = subprocess.run(["make", "-C", _NATIVE_DIR, *extra], capture_output=True, text=True)
        if proc.returncode == 0 and os.path.isfile(_LIB_PATH):
            return
        errors.append(proc.stdout[-1000:] + proc.stderr[-2000:])
    raise RuntimeError("native/restore.cpp did not build:\n" + "\n".join(errors))


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if it is missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.isfile(_LIB_PATH):
            _build()
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            raise RuntimeError(f"cannot load {_LIB_PATH}: {e}") from e
        i = ctypes.c_int
        lib.restore_frames.argtypes = [_U8P, _U8P, _F64P, i, i, i, i, i, i]
        lib.resize_frames.argtypes = [_U8P, i, i, i, _U8P, i, i, i]
        lib.restore_plan_build.argtypes = [_F64P, i, i, i, i]
        lib.restore_plan_build.restype = ctypes.c_void_p
        lib.restore_plan_apply.argtypes = [ctypes.c_void_p, _U8P, _U8P, i, i, i, i]
        lib.restore_plan_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def restore_lib():
    """This module, with its library built and loaded (or an exception)."""
    get_lib()
    return sys.modules[__name__]


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def restore_frames_native(frames: np.ndarray, faces: np.ndarray, matrices: np.ndarray,
                          threads: int = 0, copy: bool = True) -> np.ndarray:
    """Fused inverse-warp + soft-mask paste-back over a frame batch.

    frames: (N, H, W, 3) uint8 (a modified copy is returned; pass
    copy=False when the caller owns a contiguous scratch batch to paste
    into); faces: (N, fh, fw, 3) uint8; matrices: (N, 2, 3) forward align
    matrices (inverted in native code)."""
    lib = get_lib()
    frames = np.ascontiguousarray(frames, np.uint8)
    if copy:
        frames = frames.copy()
    faces = np.ascontiguousarray(faces, np.uint8)
    mats = np.ascontiguousarray(matrices, np.float64)
    n, h, w, _ = frames.shape
    fh, fw = faces.shape[1:3]
    lib.restore_frames(_u8(frames), _u8(faces), mats.ctypes.data_as(_F64P), n, h, w, fh, fw,
                       threads)
    return frames


class _PlanCache:
    """Small keyed cache of native restore plans. A served clip shares one
    align matrix, so the inverse-warp coordinates and the eroded, blurred
    masks are computed once and every decode chunk's restore reuses them.
    Several requests restore at once under continuous batching: a plan
    evicted while another thread applies it is freed when that thread is
    done with it."""

    def __init__(self, cap: int = 8):
        self.cap = cap
        self.entries = {}  # key -> plan pointer
        self.order = []
        self.users = collections.Counter()  # plan -> threads applying it
        self.retired = set()  # evicted plans still in use
        self.lock = threading.Lock()

    @contextlib.contextmanager
    def use(self, lib, mat: np.ndarray, h: int, w: int, fh: int, fw: int):
        key = (mat.tobytes(), h, w, fh, fw)
        with self.lock:
            plan = self.entries.get(key)
            if plan is None:
                plan = lib.restore_plan_build(mat.ctypes.data_as(_F64P), h, w, fh, fw)
                self.entries[key] = plan
                self.order.append(key)
                if len(self.order) > self.cap:
                    old = self.entries.pop(self.order.pop(0))
                    if self.users[old]:
                        self.retired.add(old)
                    else:
                        lib.restore_plan_free(old)
            self.users[plan] += 1
        try:
            yield plan
        finally:
            with self.lock:
                self.users[plan] -= 1
                if not self.users[plan]:
                    del self.users[plan]
                    if plan in self.retired:
                        self.retired.discard(plan)
                        lib.restore_plan_free(plan)


_plan_cache = _PlanCache()


def restore_frames_const_native(frames: np.ndarray, faces: np.ndarray, matrix: np.ndarray,
                                threads: int = 0, copy: bool = True) -> np.ndarray:
    """Constant-geometry restore: all frames share one (2, 3) align matrix.
    Bit-identical to ``restore_frames_native`` with that matrix repeated,
    but cheaper per frame (the plan is built once and cached)."""
    lib = get_lib()
    frames = np.ascontiguousarray(frames, np.uint8)
    if copy:
        frames = frames.copy()
    faces = np.ascontiguousarray(faces, np.uint8)
    mat = np.ascontiguousarray(matrix, np.float64)
    n, h, w, _ = frames.shape
    fh, fw = faces.shape[1:3]
    with _plan_cache.use(lib, mat, h, w, fh, fw) as plan:
        lib.restore_plan_apply(plan, _u8(frames), _u8(faces), n, fh, fw, threads)
    return frames


def resize_frames_native(src: np.ndarray, out_hw, threads: int = 0) -> np.ndarray:
    """(N, H, W, 3) uint8 → (N, h, w, 3) uint8, bilinear."""
    lib = get_lib()
    src = np.ascontiguousarray(src, np.uint8)
    n, sh, sw, _ = src.shape
    dh, dw = out_hw
    dst = np.empty((n, dh, dw, 3), np.uint8)
    lib.resize_frames(_u8(src), n, sh, sw, _u8(dst), dh, dw, threads)
    return dst
