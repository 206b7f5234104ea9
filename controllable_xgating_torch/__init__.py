"""Controllable XGating in PyTorch, with hand-written Hopper kernels.

The PyTorch counterpart of `controllable_xgating_tpu`: module names mirror
the JAX package one for one, parameters keep its `[in, out]` layout
(`x @ W`), and every Pallas kernel of the ported paths (captioning and XE
training) is a CUDA C++ kernel under `csrc/`, built for `sm_90a` at first
use. A CPU tensor takes
each kernel's plain PyTorch version instead; a CUDA tensor launches the
kernel or raises.

This package imports `torch` and never `jax`, `flax`, `optax`, `orbax`,
`h5py` or anything of `controllable_xgating_tpu`. What it shares with the
JAX package without a framework (`data/vocab.py`, `data/tokenizer.py`,
`utils/config.py`, `metrics/`) it keeps as its own copies, which the tests
hold equal to the originals.
"""

__version__ = "0.1.0"
