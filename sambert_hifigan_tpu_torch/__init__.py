"""SAM-BERT + HiFi-GAN text-to-speech in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The PyTorch port of the JAX package `sambert_hifigan_tpu`, which stays the
reference.  This package imports `torch` and `numpy` only: never `jax`,
`flax`, or the JAX package.  The CUDA kernels under `csrc/` are compiled
with `nvcc` at their first use (`kernels.py`), never at import.
"""

from .config import TTSConfig, default_config, load_config  # noqa: F401

__version__ = "0.1.0"
