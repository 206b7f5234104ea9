"""Counterparts of the JAX package's `experiments/` modules that hold a
Pallas kernel: the weight-only int8 vocab projection (`int8_vocab_matmul`,
reached through `decode_step`'s `vocab_q` hook) and the logits top-k by
iterative extraction (`logits_topk`, reached from the tests only)."""
