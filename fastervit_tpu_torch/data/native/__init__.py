"""ctypes binding for the native (C++) decode and resample runtime, a copy
of fastervit_tpu/data/native/__init__.py.

Builds `fvt_native.cpp` with g++ against libjpeg on first use (~2 s) into
`fastervit_tpu_torch/_build/` (gitignored), the library named by a hash of
the source, so an edit rebuilds it. Every entry point degrades gracefully:
if the toolchain or libjpeg is missing, `available()` is False and callers
keep the PIL path. This is host decoding: nothing of it runs on a device.

The resampler is Pillow-bit-exact (see fvt_native.cpp's header), so
switching a loader to the native path cannot move measured accuracy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "fvt_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"

_lock = threading.Lock()
_lib = None
_tried = False

_u8p = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libfvt_native_{digest}.so"


def _build(lib: Path) -> bool:
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".so.{os.getpid()}.tmp")
    base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC),
            "-o", str(tmp), "-ljpeg", "-lpthread"]
    for extra in (["-march=native"], []):
        cmd = base[:1] + extra + base[1:]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib)
            return True
        except Exception:
            continue
    return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.fvt_jpeg_dims.restype = ctypes.c_int
        lib.fvt_jpeg_dims.argtypes = [_u8p, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.fvt_resize_bicubic.restype = ctypes.c_int
        lib.fvt_resize_bicubic.argtypes = [
            _u8p, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, _u8p]
        lib.fvt_eval_batch.restype = ctypes.c_int
        lib.fvt_eval_batch.argtypes = [
            ctypes.POINTER(_u8p), ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, _u8p]
        lib.fvt_rrc_batch.restype = ctypes.c_int
        lib.fvt_rrc_batch.argtypes = [
            ctypes.POINTER(_u8p), ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            _u8p, _u8p, ctypes.c_int, _u8p]
        lib.fvt_decode_jpeg.restype = ctypes.c_int
        lib.fvt_decode_jpeg.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                        ctypes.c_int64,
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library built and loaded (g++ and libjpeg present)."""
    return _load() is not None


def _buf_array(bufs: Sequence[bytes]):
    n = len(bufs)
    arrs = [np.frombuffer(b, np.uint8) for b in bufs]
    ptrs = (_u8p * n)(*[a.ctypes.data_as(_u8p) for a in arrs])
    lens = (ctypes.c_int64 * n)(*[len(b) for b in bufs])
    return arrs, ptrs, lens


def jpeg_dims(buf: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from the header, or None if not decodable natively."""
    lib = _load()
    if lib is None:
        return None
    a = np.frombuffer(buf, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    if not lib.fvt_jpeg_dims(a.ctypes.data_as(_u8p), len(buf),
                             ctypes.byref(w), ctypes.byref(h)):
        return None
    return w.value, h.value


def decode_jpeg(buf: bytes) -> Optional[np.ndarray]:
    """An encoded JPEG -> (H, W, 3) uint8 RGB, or None."""
    lib = _load()
    if lib is None:
        return None
    dims = jpeg_dims(buf)
    if dims is None:
        return None
    w, h = dims
    out = np.empty((h, w, 3), np.uint8)
    wo, ho = ctypes.c_int(), ctypes.c_int()
    a = np.frombuffer(buf, np.uint8)
    if not lib.fvt_decode_jpeg(a.ctypes.data_as(_u8p), len(buf),
                               out.ctypes.data_as(_u8p), out.nbytes,
                               ctypes.byref(wo), ctypes.byref(ho)):
        return None
    return out


def resize_bicubic(img: np.ndarray, size: Tuple[int, int],
                   box: Optional[Tuple[float, float, float, float]] = None
                   ) -> np.ndarray:
    """Pillow-exact bicubic resize of an (H, W, 3) uint8 array to
    size=(out_h, out_w), optionally from a float crop box (x0, y0, x1, y1)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is unavailable")
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    if box is None:
        box = (0.0, 0.0, float(w), float(h))
    oh, ow = size
    out = np.empty((oh, ow, 3), np.uint8)
    if not lib.fvt_resize_bicubic(
            img.ctypes.data_as(_u8p), h, w, box[0], box[1], box[2], box[3],
            oh, ow, out.ctypes.data_as(_u8p)):
        raise RuntimeError("native resize failed")
    return out


def eval_batch(bufs: Sequence[bytes], out_size: Tuple[int, int],
               crop_pct: float, squash: bool, mean, std,
               num_threads: int = 16
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode+resize+crop+normalize a batch of encoded JPEGs.

    Returns (batch float32 (N, H, W, 3), ok bool (N,)); images with
    ok=False must be redone through the PIL fallback."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is unavailable")
    n = len(bufs)
    oh, ow = out_size
    out = np.empty((n, oh, ow, 3), np.float32)
    ok = np.zeros((n,), np.uint8)
    arrs, ptrs, lens = _buf_array(bufs)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.fvt_eval_batch(ptrs, lens, n, oh, ow, crop_pct, int(squash),
                       mean_a.ctypes.data_as(fp), std_a.ctypes.data_as(fp),
                       out.ctypes.data_as(fp), num_threads,
                       ok.ctypes.data_as(_u8p))
    del arrs
    return out, ok.astype(bool)


def rrc_batch(bufs: Sequence[bytes], out_size: Tuple[int, int],
              boxes: np.ndarray, hflip: np.ndarray, num_threads: int = 16
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + random-resized-crop (boxes (N,4) float x0,y0,x1,y1 in source
    pixels) + per-image hflip. Returns (uint8 (N, H, W, 3), ok (N,))."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is unavailable")
    n = len(bufs)
    oh, ow = out_size
    out = np.empty((n, oh, ow, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    arrs, ptrs, lens = _buf_array(bufs)
    boxes_a = np.ascontiguousarray(boxes, np.float64)
    hflip_a = np.ascontiguousarray(hflip, np.uint8)
    lib.fvt_rrc_batch(ptrs, lens, n, oh, ow,
                      boxes_a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                      hflip_a.ctypes.data_as(_u8p), out.ctypes.data_as(_u8p),
                      num_threads, ok.ctypes.data_as(_u8p))
    del arrs
    return out, ok.astype(bool)
