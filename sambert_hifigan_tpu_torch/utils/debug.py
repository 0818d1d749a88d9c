"""Shape observability: the JAX package's `utils/debug.py` for eager torch.

  * assert_shape / assert_rank: structural checks that raise AssertionError
    with the JAX package's messages;
  * trace_shape: prints `[trace-shape] name: (2, 3):float32, ...` when
    DEBUG_SHAPES=1, once per distinct (name, shapes, dtypes) signature.
    Eager torch has no trace, so a repeated signature prints nothing: one
    line per shape a surface sees, not one per step, as JAX's one line per
    compilation;
  * debug_value: prints values when DEBUG_SHAPES=2 (a host copy, so the
    caller waits for the device).

DEBUG_SHAPES defaults off.  `python -m sambert_hifigan_tpu_torch.utils.debug
--help` prints this text.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

Dim = Optional[int]

_SEEN = set()  # signatures trace_shape printed: once per process, as a jit cache is


def _level() -> int:
    try:
        return int(os.getenv("DEBUG_SHAPES", "0"))
    except ValueError:
        return 1


def _shape(x) -> tuple:
    return tuple(int(n) for n in x.shape)


def _dtype_name(dtype) -> str:
    """numpy's spelling of a dtype: torch.float32 -> 'float32'."""
    return str(dtype).removeprefix("torch.")


def assert_rank(x, rank: int, name: str = "tensor") -> None:
    if x.ndim != rank:
        raise AssertionError(f"{name}: expected rank {rank}, got shape {_shape(x)}")


def assert_shape(x, expected: Sequence[Dim], name: str = "tensor") -> None:
    """None entries are wildcards: assert_shape(h, (None, 128, 256), 'henc')."""
    shape = _shape(x)
    if x.ndim != len(expected):
        raise AssertionError(
            f"{name}: expected rank {len(expected)} {tuple(expected)}, got {shape}"
        )
    for i, (got, want) in enumerate(zip(shape, expected)):
        if want is not None and got != want:
            raise AssertionError(f"{name}: dim {i} expected {want}, got {got} (shape {shape})")


def trace_shape(name: str, *arrays) -> None:
    """Print the shapes once per signature when DEBUG_SHAPES >= 1."""
    if _level() >= 1:
        sig = (name,) + tuple((_shape(a), _dtype_name(a.dtype)) for a in arrays)
        if sig not in _SEEN:
            _SEEN.add(sig)
            shapes = ", ".join(f"{shape}:{dt}" for shape, dt in sig[1:])
            print(f"[trace-shape] {name}: {shapes}")


def debug_value(fmt: str, *values) -> None:
    """Print values with str.format when DEBUG_SHAPES >= 2."""
    if _level() >= 2:
        print(fmt.format(*(v.tolist() if hasattr(v, "tolist") else v for v in values)))


if __name__ == "__main__":
    import argparse

    argparse.ArgumentParser(description=__doc__,
                            formatter_class=argparse.RawDescriptionHelpFormatter).parse_args()
