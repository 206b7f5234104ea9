"""Word vocabulary and special token ids.

The JAX package's `data/vocab.py` is framework-free (no jax, no h5py), so
the port re-exports it instead of keeping a copy: the ids here are the ids
the checkpoints and label arrays of both packages were written with.
"""

from controllable_xgating_tpu.data.vocab import BOS, EOS, PAD, UNK, Vocab

__all__ = ["BOS", "EOS", "PAD", "UNK", "Vocab"]
