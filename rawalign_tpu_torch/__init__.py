"""rawalign-tpu-torch: the PyTorch + CUDA port of the JAX package's
mapping engine.

The JAX package (rawalign_tpu/) stays the reference. This package keeps
its own copy of every host module it needs (options, pore model, index
build, golden models, ctypes bindings of the native host library, signal
and PAF I/O), laid out under the same names, and imports nothing of the
JAX package; the native C library in ``native/`` is the only thing the
two share. It re-implements the device side of a mapping round in
PyTorch, with a hand-written CUDA kernel for each of the JAX package's
TPU kernels: event detection (``signal/events_cuda.py``), the sketch
scan (``seeds/sketch_cuda.py``), the chaining DP (``map/chain_cuda.py``)
and the descriptor-indexed banded DTW (``map/dtw_cuda.py``).
``parallel/`` maps over a (data, shard) mesh of cards driven from one
process (``mesh.py``, ``dist_engine.py``) and joins hosts through
``torch.distributed`` (``distributed.py``). It never imports ``jax``.
"""

__version__ = "0.1.0"
