"""Window mean of `encode_for_inference` per call (CUDA events): the
encoder, the POS rollout and the decode context."""


def read(rec: dict):
    spans = rec.get("spans_ms", {}).get("encode")
    return sum(spans) / len(spans) if spans else None
