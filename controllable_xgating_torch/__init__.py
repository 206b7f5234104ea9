"""Controllable XGating in PyTorch, with hand-written Hopper kernels.

The PyTorch counterpart of `controllable_xgating_tpu`: module names mirror
the JAX package one for one, parameters keep its `[in, out]` layout
(`x @ W`), and every Pallas kernel of the ported paths (captioning and XE
training) is a CUDA C++ kernel under `csrc/`, built for `sm_90a` at first
use. A CPU tensor takes
each kernel's plain PyTorch version instead; a CUDA tensor launches the
kernel or raises.

This package imports `torch` and never `jax`, `flax`, `optax`, `orbax`
or anything of `controllable_xgating_tpu`. It reads features from numpy
files (`data/features.py`); `h5py` is imported only inside that module's
`main`, which converts the JAX package's `features.h5` where that file
lives, so the machine with the card needs no h5py. What the package
shares with the JAX package without a framework (`data/vocab.py`,
`data/tokenizer.py`, `data/corpus.py`, `utils/config.py`, `metrics/`) it
keeps as its own copies, which the tests hold equal to the originals.

Entry points: `python -m controllable_xgating_torch.cli.{caption,eval,train}`
(`cxg-torch-caption`, `cxg-torch-eval`, `cxg-torch-train`), on the card
unless `--device cpu`.
"""

__version__ = "0.1.0"
