"""Build and load the hand-written CUDA kernels, and the device rules.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded with `ctypes`.  The build is keyed by
a hash of the source, every `csrc/` file it includes and the `nvcc` command,
so a stale library is never loaded, and it happens at
the first CUDA call (or `build_all()`), never at import: the package imports
and its CPU tests run where there is no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("ar_decode", "mrf")
MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ar_decode": ("ar_decode_launch", [_P] * 19 + [_I] * 18 + [_P]),
    "mrf": ("mrf_launch", [_P] * 8 + [_I] * 5 + [_P] * 5),
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def kernel_dtype(device: torch.device) -> torch.dtype:
    """Weight dtype of the kernels' packed weights: bf16 on the card, f32 on
    the CPU, where the plain versions run as the f32 reference."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """`csrc/<name>.cu` and every file under `csrc/` that it includes,
    directly or not, in a fixed order."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen or not path.is_file() or not path.is_relative_to(CSRC):
            continue
        seen.append(path)
        todo.extend((path.parent / inc.decode()).resolve()
                    for inc in _INCLUDE.findall(path.read_bytes()))
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(str(path.relative_to(CSRC)).encode() + b"\0" + path.read_bytes() + b"\0")
    h.update("\0".join(_nvcc_cmd(name, Path("OUT"))).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc_cmd(name: str, out: Path) -> list:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build_all(names=KERNELS) -> Dict[str, str]:
    """Compile every missing library, one `nvcc` per source, all started
    together.  Returns {name: compiler log}; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = Path(tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)[1])
        procs[name] = (tmp, target, subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    logs = {}
    failed = []
    for name, (tmp, target, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
            target.with_suffix(".log").write_text(logs[name])
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _LIBS:
        target = _target(name)
        if not target.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(target))
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def raise_on_error(name: str, err: int, lib: Optional[ctypes.CDLL] = None) -> None:
    """Raise if a launch returned a non-zero cudaGetLastError()."""
    if err != 0:
        text = lib.error_string(err).decode() if lib is not None else ""
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} {text}")
