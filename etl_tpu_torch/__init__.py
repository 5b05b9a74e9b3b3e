"""etl_tpu_torch — the PyTorch and CUDA port of etl_tpu.

The JAX package `etl_tpu/` is the reference; this package mirrors its
layout (models/, config/, postgres/, native/, ops/, store/,
destinations/, telemetry/, runtime/) and keeps its own copies of what it
needs from it. It imports torch and numpy, never jax and nothing of
etl_tpu. The decode path runs on an NVIDIA H100 through hand-written
CUDA kernels (csrc/decode_pack.cu); `runtime.Pipeline` runs the initial
table copy and CDC through them into a destination.
"""

__version__ = "0.1.0"
