"""Caption metrics: BLEU-1..4, METEOR, ROUGE-L, CIDEr and CIDEr-D.

The port's own copies of the JAX package's framework-free scorers and
harness (`metrics/{harness,bleu,rouge,cider,meteor,stemmer}.py`). As in
the JAX package, tokenization, METEOR and ROUGE-L run in the native C++
library (`utils/native.py`, the port's own build of `native/`) where it
is built, and fall back to their pure-Python golden references where it
is not. tests/test_torch_metrics.py holds `language_eval` equal to the
JAX package's on the same captions, tests/test_torch_native.py the two
paths equal.
"""
