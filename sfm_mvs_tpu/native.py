"""ctypes binding for the native host runtime (native/sfm_native.cc).

Auto-builds the shared library on first use when a toolchain is present;
every entry point has a pure-Python fallback so the package works without
it (image decode then needs PIL). `build_error()` says why the library is
missing. All native calls release the GIL, so the `ImageLoader` prefetcher
genuinely overlaps decode with device compute.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO_PATH = os.path.join(_HERE, "_native", "libsfm_native.so")
_NATIVE_DIR = os.path.join(os.path.dirname(_HERE), "native")

_lib = None
_build_error = ""
_lib_lock = threading.Lock()
_f32p = ctypes.POINTER(ctypes.c_float)


def _try_build() -> bool:
    global _build_error
    makefile = os.path.join(_NATIVE_DIR, "Makefile")
    if not os.path.exists(makefile):
        _build_error = f"{makefile} not found"
        return False
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True, capture_output=True, text=True, timeout=120,
        )
    except subprocess.CalledProcessError as e:
        _build_error = f"make failed (rc {e.returncode}): {e.stderr.strip()[-2000:]}"
        return False
    except (OSError, subprocess.TimeoutExpired) as e:
        _build_error = f"make could not run: {e}"
        return False
    if not os.path.exists(_SO_PATH):
        _build_error = f"make succeeded but {_SO_PATH} is missing"
        return False
    return True


def _load():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH) and not _try_build():
            _lib = False
            return _lib
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError as e:
            _build_error = f"cannot load {_SO_PATH}: {e}"
            _lib = False
            return _lib
        lib.sn_image_size.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)
        ]
        lib.sn_image_size.restype = ctypes.c_int
        lib.sn_decode_gray_f32.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int]
        lib.sn_decode_gray_f32.restype = ctypes.c_int
        lib.sn_decode_bgr_f32.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int]
        lib.sn_decode_bgr_f32.restype = ctypes.c_int
        lib.sn_pyr_down_f32.argtypes = [_f32p, ctypes.c_int, ctypes.c_int, _f32p]
        lib.sn_pyr_down_f32.restype = None
        lib.sn_write_ply.argtypes = [
            ctypes.c_char_p, _f32p, _f32p, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ]
        lib.sn_write_ply.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return bool(_load())


def build_error() -> str:
    """Why the native library is unavailable ("" when it loaded)."""
    _load()
    return _build_error


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def image_size(path: str) -> tuple[int, int]:
    lib = _load()
    if not lib:
        from PIL import Image

        with Image.open(path) as im:
            return im.size[1], im.size[0]
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.sn_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"cannot decode {path}")
    return h.value, w.value


def decode_gray(path: str) -> np.ndarray:
    """(H, W) float32 grayscale in [0, 1]."""
    lib = _load()
    if not lib:
        from sfm_mvs_tpu.utils import io

        return io.load_image_gray(path)
    h, w = image_size(path)
    out = np.empty((h, w), dtype=np.float32)
    rc = lib.sn_decode_gray_f32(path.encode(), _ptr(out), h * w)
    if rc != 0:
        raise IOError(f"decode failed ({rc}): {path}")
    return out


def decode_bgr(path: str) -> np.ndarray:
    """(H, W, 3) float32 BGR in [0, 255]."""
    lib = _load()
    if not lib:
        from sfm_mvs_tpu.utils import io

        return io.load_image_bgr(path)
    h, w = image_size(path)
    out = np.empty((h, w, 3), dtype=np.float32)
    rc = lib.sn_decode_bgr_f32(path.encode(), _ptr(out), h * w * 3)
    if rc != 0:
        raise IOError(f"decode failed ({rc}): {path}")
    return out


def pyr_down(img: np.ndarray) -> np.ndarray:
    """Host-side cv2.pyrDown-equivalent (5-tap binomial + 2x decimate)."""
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.float32)
    if img.ndim == 3:
        return np.stack([pyr_down(img[..., c]) for c in range(img.shape[-1])], -1)
    h, w = img.shape
    if not lib:
        import jax.numpy as jnp

        from sfm_mvs_tpu.ops.pyramid import pyr_down as jp

        return np.asarray(jp(jnp.asarray(img)))
    out = np.empty(((h + 1) // 2, (w + 1) // 2), dtype=np.float32)
    lib.sn_pyr_down_f32(_ptr(img), h, w, _ptr(out))
    return out


def write_ply(
    path: str,
    points: np.ndarray,
    colors_bgr: np.ndarray,
    scale: float = 200.0,
    outlier_offset: float = 300.0,
    binary: bool = False,
) -> int:
    """PLY export with reference cleaning semantics. Returns #vertices."""
    lib = _load()
    if not lib:
        from sfm_mvs_tpu.utils import io

        return io.to_ply(path, points, colors_bgr, scale, outlier_offset)
    pts = np.ascontiguousarray(points.reshape(-1, 3), dtype=np.float32)
    cols = np.ascontiguousarray(colors_bgr.reshape(-1, 3), dtype=np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rc = lib.sn_write_ply(
        path.encode(), _ptr(pts), _ptr(cols), len(pts),
        float(scale), float(outlier_offset), int(binary),
    )
    if rc < 0:
        raise IOError(f"ply write failed: {path}")
    return rc


class ImageLoader:
    """Threaded prefetching loader: decode (+ optional downscale) off the
    critical path. Native decode releases the GIL, so workers run truly
    in parallel with device dispatch."""

    def __init__(
        self,
        paths: Sequence[str],
        downscale: int = 1,
        load_color: bool = True,
        workers: int = 2,
        prefetch: int = 4,
    ):
        self.paths = list(paths)
        self.downscale = downscale
        self.load_color = load_color
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futures: dict[int, object] = {}
        self._prefetch = prefetch

    def _work(self, idx: int):
        g = decode_gray(self.paths[idx])
        b = decode_bgr(self.paths[idx]) if self.load_color else None
        d = self.downscale
        while d > 1:
            g = pyr_down(g)
            if b is not None:
                b = pyr_down(b)
            d //= 2
        return g, b

    def _ensure(self, idx: int):
        if idx < len(self.paths) and idx not in self._futures:
            self._futures[idx] = self._pool.submit(self._work, idx)

    def get(self, idx: int):
        """(gray, bgr_or_None) for frame idx; schedules prefetch ahead."""
        self._ensure(idx)
        for ahead in range(1, self._prefetch + 1):
            self._ensure(idx + ahead)
        fut = self._futures.pop(idx)
        return fut.result()

    def __len__(self):
        return len(self.paths)

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
