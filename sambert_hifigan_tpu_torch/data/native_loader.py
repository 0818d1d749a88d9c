"""ctypes bindings of the host-side WAV decoder, `csrc/dataloader.cpp` (the
port's copy of the JAX package's `native/dataloader.cpp`).

The library is compiled with `g++` at first use into `_build/`, keyed by a
hash of the source and the command as the CUDA kernels are
(`kernels.hashed_target`), and never next to its source.  It is a host
decode, not a kernel: `native_available()` is False where it does not
build, and `TTSDataset` then reads WAVs with the numpy reader
(`data/audio.load_wav`), which decodes to the same bits.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..kernels import BUILD_DIR, CSRC, hashed_target

_SRC = CSRC / "dataloader.cpp"

_lib = None
_lib_lock = threading.Lock()


def _gxx_cmd(out: Path) -> list:
    return ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread", str(_SRC),
            "-o", str(out)]


def library_path() -> Path:
    """Where the built library lives (`_build/dataloader-<sha>.so`)."""
    return hashed_target("dataloader", [_SRC], _gxx_cmd(Path("OUT")))


def _build() -> Optional[ctypes.CDLL]:
    target = library_path()
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)[1])
        try:
            subprocess.run(_gxx_cmd(tmp), check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError):
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, target)  # atomic: a concurrent build never loads half a file
    try:
        lib = ctypes.CDLL(str(target))
    except OSError:
        return None
    lib.wav_decode.restype = ctypes.c_int
    lib.wav_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.dl_create.restype = ctypes.c_void_p
    lib.dl_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ]
    lib.dl_next.restype = ctypes.c_int
    lib.dl_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dl_destroy.restype = None
    lib.dl_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _build() or False
    return _lib or None


def native_available() -> bool:
    return _get_lib() is not None


def _f32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode in-memory WAV bytes -> (waveform [channels, time] f32, sr)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    cap = max(len(data), 16)
    out = np.empty(cap, np.float32)
    out_len, sr, ch = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    rc = lib.wav_decode(data, len(data), _f32_ptr(out), cap,
                        ctypes.byref(out_len), ctypes.byref(sr), ctypes.byref(ch))
    if rc == -2:  # buffer too small (32-bit formats): retry exact
        out = np.empty(out_len.value, np.float32)
        rc = lib.wav_decode(data, len(data), _f32_ptr(out), out_len.value,
                            ctypes.byref(out_len), ctypes.byref(sr), ctypes.byref(ch))
    if rc != 0:
        raise ValueError(f"native wav decode failed (rc={rc})")
    x = out[: out_len.value].reshape(-1, ch.value).T
    return np.ascontiguousarray(x), sr.value


def load_wav_native(path) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return decode_wav_bytes(f.read())


class NativePrefetcher:
    """Background C++ decode of a list of WAV paths; iterate to get
    (index, waveform [channels, time], sr) in completion order.  Files that
    do not decode (missing, not a WAV) are skipped."""

    def __init__(self, paths: List[str], n_threads: int = 4, capacity: int = 16,
                 max_samples: int = 48000 * 60 * 5):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._paths = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
        self._handle = lib.dl_create(self._paths, len(paths), n_threads, capacity)
        self._cap = max_samples
        self._closed = False

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, int]]:
        out = np.empty(self._cap, np.float32)
        out_len, sr, ch, idx = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int64()
        while True:
            rc = self._lib.dl_next(self._handle, _f32_ptr(out), self._cap,
                                   ctypes.byref(out_len), ctypes.byref(sr), ctypes.byref(ch),
                                   ctypes.byref(idx))
            if rc == 1:
                break
            if rc == -1:
                continue  # undecodable file skipped
            if rc == -2:  # the item stays queued: grow the buffer and ask again
                self._cap = int(out_len.value)
                out = np.empty(self._cap, np.float32)
                continue
            wav = out[: out_len.value].reshape(-1, ch.value).T.copy()
            yield int(idx.value), wav, int(sr.value)

    def close(self):
        if not self._closed:
            self._lib.dl_destroy(self._handle)
            self._closed = True

    def __enter__(self) -> "NativePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
