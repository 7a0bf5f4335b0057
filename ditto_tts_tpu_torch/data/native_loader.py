"""ctypes binding of the native C++ data loader (``native/dataloader.cc``,
``native/opus_codec.cc``), the port's own copy of the JAX package's
``data/native_loader.py``.

The library is built at first use with ``native/Makefile``'s compiler and
flags into ``.kernel_build/`` beside the package (named by a hash of the
sources and flags; nothing is written into ``native/``). It provides:
  * ``decode_audio`` / ``decode_wav``: WAV (PCM16/24/32, float32) or
    Ogg-Opus, by magic bytes, to mono float32 at a target rate through the
    library's resampler;
  * ``encode_opus`` and ``opus_available``: libopus is loaded with
    ``dlopen`` by the library, so a machine without it still decodes WAV;
  * ``resample``;
  * ``NativeLoader``: a threaded prefetching batch iterator giving the
    batch dict of ``data/mls.py``'s collate (audio, padding_mask) plus the
    items' indices.

``available()`` is False when the library cannot be built or loaded; the
callers then take the ffmpeg CLI, as in JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / ".kernel_build"
SOURCES = ("dataloader.cc", "opus_codec.cc")
# native/Makefile: CXX, CXXFLAGS, -shared, -ldl
CXX = "g++"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")

_lock = threading.Lock()
_lib = None
_failed = False


def _lib_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join((CXX,) + CXXFLAGS).encode())
    return BUILD_DIR / f"libditto_data_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    if shutil.which(CXX) is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXXFLAGS, "-shared", "-o", str(tmp),
           *(str(NATIVE_DIR / s) for s in SOURCES), "-ldl"]
    if subprocess.run(cmd, capture_output=True).returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _declare(lib) -> None:
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
        ctypes.c_int]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_int32),
                                ctypes.POINTER(ctypes.c_int32)]
    lib.loader_reset.restype = None
    lib.loader_reset.argtypes = [ctypes.c_void_p, ctypes.c_uint]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.decode_audio_file.restype = ctypes.c_int
    lib.decode_audio_file.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int]
    lib.encode_opus_file.restype = ctypes.c_int
    lib.encode_opus_file.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_long, ctypes.c_int]
    lib.opus_available.restype = ctypes.c_int
    lib.opus_available.argtypes = []
    lib.resample_f32.restype = ctypes.c_int
    lib.resample_f32.argtypes = [ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int]


def _load():
    """The loaded library, building it first if needed; None when it
    cannot be built or loaded (tried once per process)."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        out = _lib_path()
        try:
            if not out.exists() and not _build(out):
                _failed = True
                return None
            lib = ctypes.CDLL(str(out))
        except OSError:
            _failed = True
            return None
        _declare(lib)
        _lib = lib
        return lib


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native data loader could not be built or "
                           f"loaded ({CXX} {' '.join(CXXFLAGS)})")
    return lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def available() -> bool:
    return _load() is not None


def decode_wav(path: str, target_rate: int = 24000,
               max_seconds: float = 60.0) -> np.ndarray:
    return decode_audio(path, target_rate, max_seconds)


def decode_audio(path: str, target_rate: int = 24000,
                 max_seconds: float = 60.0) -> np.ndarray:
    """WAV or Ogg-Opus (by magic bytes) as mono float32 at target_rate."""
    lib = _require()
    buf = np.zeros(int(target_rate * max_seconds), np.float32)
    n = lib.decode_audio_file(path.encode(), target_rate, _f32p(buf),
                              len(buf))
    if n < 0:
        raise ValueError(f"decode_audio failed ({n}) for {path}")
    return buf[:n].copy()


def opus_available() -> bool:
    lib = _load()
    return lib is not None and bool(lib.opus_available())


def encode_opus(path: str, pcm: np.ndarray, sample_rate: int) -> None:
    """Write mono float pcm as an Ogg-Opus file through the system
    libopus."""
    lib = _require()
    pcm = np.ascontiguousarray(pcm, np.float32)
    rc = lib.encode_opus_file(path.encode(), _f32p(pcm), len(pcm),
                              sample_rate)
    if rc != 0:
        raise ValueError(f"encode_opus failed ({rc}) for {path}")


def resample(x: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    lib = _require()
    x = np.ascontiguousarray(x, np.float32)
    n_out = int(len(x) * rate_out / rate_in) + 16
    out = np.zeros(n_out, np.float32)
    n = lib.resample_f32(_f32p(x), len(x), rate_in, rate_out, _f32p(out),
                         n_out)
    return out[:n].copy()


class NativeLoader:
    """Threaded prefetching batch iterator over WAV / Ogg-Opus files:
    shuffles (seeded), pads each batch to its longest item's bucket."""

    def __init__(self, paths: Sequence[str], *, sample_rate: int = 24000,
                 batch_size: int = 4, buckets: Sequence[int],
                 workers: int = 4, queue_depth: int = 4, seed: int = 0,
                 shuffle: bool = True, drop_remainder: bool = True):
        lib = _require()
        self._lib = lib
        self.batch_size = batch_size
        self.buckets = sorted(buckets)
        # the library keeps pointers into these while the loader lives
        self._paths = [p.encode() for p in paths]
        self._path_arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._bucket_arr = (ctypes.c_int * len(self.buckets))(*self.buckets)
        self._h = lib.loader_create(
            self._path_arr, len(self._paths), sample_rate, batch_size,
            self._bucket_arr, len(self.buckets), workers, queue_depth, seed,
            int(shuffle), int(drop_remainder))
        self._audio = np.zeros((batch_size, self.buckets[-1]), np.float32)
        self._mask = np.zeros((batch_size, self.buckets[-1]), np.int32)
        self._idx = np.zeros((batch_size,), np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            bucket = self._lib.loader_next(
                self._h, _f32p(self._audio),
                self._mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                self._idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if bucket == 0:
                return
            rows = int((self._idx >= 0).sum())
            flat_a = self._audio.ravel()[:rows * bucket]
            flat_m = self._mask.ravel()[:rows * bucket]
            yield {
                "audio": flat_a.reshape(rows, 1, bucket).copy(),
                "padding_mask": flat_m.reshape(rows, bucket).copy(),
                "indices": self._idx[:rows].copy(),
            }

    def reset(self, seed: int = 0) -> None:
        self._lib.loader_reset(self._h, seed)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.loader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
