"""Caption metrics: BLEU-1..4, METEOR, ROUGE-L, CIDEr and CIDEr-D.

The port's own copies of the JAX package's framework-free scorers and
harness (`metrics/{harness,bleu,rouge,cider,meteor,stemmer}.py`), on their
pure-Python paths: the JAX package's native C++ library is not used.
tests/test_torch_metrics.py holds `language_eval` equal to the JAX
package's on the same captions.
"""
