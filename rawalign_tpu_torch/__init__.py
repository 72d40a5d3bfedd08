"""rawalign-tpu-torch: the PyTorch + CUDA port of rawalign_tpu's mapping
engine.

The JAX package (``rawalign_tpu``) stays the reference. This package
shares its JAX-free host modules (options, index build, golden models,
native host library, PAF I/O) and re-implements the device side of a
mapping round in PyTorch, with a hand-written CUDA kernel for each of
the JAX package's TPU kernels: event detection
(``signal/events_cuda.py``), the sketch scan (``seeds/sketch_cuda.py``),
the chaining DP (``map/chain_cuda.py``) and the descriptor-indexed
banded DTW (``map/dtw_cuda.py``). It never imports ``jax``.
"""

__version__ = "0.1.0"
