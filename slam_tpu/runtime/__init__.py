"""Native C++ runtime bindings (ctypes).

Compiles ``native.cpp`` into a shared library on first use (g++ -O3) and
exposes:

  * :func:`build_tracks` — sequential track-id chaining (C++ speed for the
    one unavoidably sequential frontend step);
  * :func:`load_png_gray` — libpng decode straight to float32;
  * :class:`StereoPrefetcher` — background threaded decode of stereo
    chunks, overlapping host IO with device compute.

Everything degrades gracefully: ``AVAILABLE`` is False when the toolchain
or libpng is missing, and callers fall back to the pure-numpy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "native.cpp"

AVAILABLE = False
_lib = None


def _lib_path() -> Path:
    """Build product keyed to the source text and the building host: a
    library copied along with the tree from another machine (or built
    from another revision of the source) has another name and is never
    loaded."""
    key = hashlib.sha256(_SRC.read_bytes())
    key.update(f"{platform.node()}|{platform.machine()}".encode())
    return _HERE / f"libslamtpu_native-{key.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    # build under a private name and rename: concurrent first imports
    # (test workers) never load a half-written library
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        str(_SRC), "-o", str(tmp), "-lpng", "-lz", "-pthread",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _load() -> bool:
    global _lib, AVAILABLE
    if _lib is not None:
        return AVAILABLE
    lib = _lib_path()
    if not lib.exists():
        for stale in _HERE.glob("libslamtpu_native*.so"):
            if stale != lib:
                stale.unlink(missing_ok=True)
        if not _build(lib):
            AVAILABLE = False
            return False
    try:
        _lib = ctypes.CDLL(str(lib))
    except OSError:
        AVAILABLE = False
        return False

    _lib.build_tracks.restype = ctypes.c_int32
    _lib.build_tracks.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib.load_png_gray.restype = ctypes.c_int
    _lib.load_png_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32,
    ]
    _lib.load_png_gray_padded.restype = ctypes.c_int
    _lib.load_png_gray_padded.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32, ctypes.c_int32,
    ]
    _lib.loader_create.restype = ctypes.c_void_p
    _lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
    ]
    _lib.loader_next.restype = ctypes.c_int32
    _lib.loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    _lib.loader_destroy.restype = None
    _lib.loader_destroy.argtypes = [ctypes.c_void_p]
    AVAILABLE = True
    return True


def build_tracks(match_prev: np.ndarray, inlier_prev: np.ndarray):
    """C++ track-id chaining. Returns (track_ids (F,K) int32, num_tracks).

    Semantics identical to TrackStore.from_frontend's python loop
    (see models/trackstore.py; reference tracking_database.py:273-337).
    """
    if not _load():
        raise RuntimeError("native runtime unavailable")
    F, K = match_prev.shape
    mp = np.ascontiguousarray(match_prev, np.int32)
    inl = np.ascontiguousarray(inlier_prev, np.uint8)
    tids = np.full((F, K), -1, np.int32)
    n = _lib.build_tracks(
        F, K,
        mp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        inl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        tids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return tids, int(n)


def load_png_gray(path: str | Path, max_h: int = 4096, max_w: int = 4096):
    """Decode a PNG to float32 [0,1] (libpng; no OpenCV dependency)."""
    if not _load():
        raise RuntimeError("native runtime unavailable")
    buf = np.zeros(max_h * max_w, np.float32)  # rows written packed at W
    h = ctypes.c_int32(0)
    w = ctypes.c_int32(0)
    rc = _lib.load_png_gray(
        str(path).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(h), ctypes.byref(w), max_h, max_w,
    )
    if rc != 0:
        raise IOError(f"load_png_gray({path}) failed rc={rc}")
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


def load_png_gray_padded(path: str | Path, hw: tuple[int, int]) -> np.ndarray:
    """Decode a PNG and edge-replicate-pad it bottom/right to ``hw``
    (utils.kitti.pad_to_bucket semantics; image must not exceed ``hw``)."""
    if not _load():
        raise RuntimeError("native runtime unavailable")
    H, W = hw
    buf = np.zeros((H, W), np.float32)
    rc = _lib.load_png_gray_padded(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), H, W,
    )
    if rc != 0:
        raise IOError(f"load_png_gray_padded({path}) failed rc={rc}")
    return buf


class StereoPrefetcher:
    """Background-threaded stereo chunk loader.

    Decodes chunk c+1 on host threads while the caller computes on chunk c
    — the host/IO half of the pipelined frontend. Images smaller than
    (H, W) are edge-replicate-padded bottom/right (bucket semantics), so
    multi-resolution sequence batches share one compiled shape.
    """

    def __init__(self, left_paths, right_paths, H, W, chunk, n_threads=3):
        if not _load():
            raise RuntimeError("native runtime unavailable")
        self.H, self.W, self.chunk = H, W, chunk
        n = len(left_paths)
        self._lp = (ctypes.c_char_p * n)(
            *[str(p).encode() for p in left_paths]
        )
        self._rp = (ctypes.c_char_p * n)(
            *[str(p).encode() for p in right_paths]
        )
        self._num = n
        self._served = 0
        self._handle = _lib.loader_create(
            self._lp, self._rp, n, H, W, chunk, n_threads
        )

    def __iter__(self):
        return self

    def __next__(self):
        if self._handle is None or self._served >= self._num:
            self.close()
            raise StopIteration
        L = np.zeros((self.chunk, self.H, self.W), np.float32)
        R = np.zeros((self.chunk, self.H, self.W), np.float32)
        got = _lib.loader_next(
            self._handle,
            L.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            R.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if got == 0:
            self.close()
            raise StopIteration
        # got is the chunk's valid-frame count (tail chunks are partial);
        # cross-check against our own serving counter
        n_valid = min(self.chunk, self._num - self._served)
        assert got == n_valid, (got, n_valid)
        self._served += n_valid
        return L[:n_valid], R[:n_valid]

    def close(self):
        if getattr(self, "_handle", None):
            _lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
