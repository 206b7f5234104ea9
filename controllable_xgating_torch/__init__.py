"""Controllable XGating in PyTorch, with hand-written Hopper kernels.

The PyTorch counterpart of `controllable_xgating_tpu`: module names mirror
the JAX package one for one, parameters keep its `[in, out]` layout
(`x @ W`), and every Pallas kernel of the inference path is a CUDA C++
kernel under `csrc/`, built for `sm_90a` at first use. A CPU tensor takes
each kernel's plain PyTorch version instead; a CUDA tensor launches the
kernel or raises.

This package imports `torch` and never `jax`, `flax`, `optax`, `orbax` or
`h5py`. It reuses the JAX package's framework-free modules as they are:
`data.vocab` and `utils.config` through the port's own `data/vocab.py`
and `utils/config.py`, which re-export them, and `metrics.harness` from
`infer/evaluator.py`.
"""

__version__ = "0.1.0"
