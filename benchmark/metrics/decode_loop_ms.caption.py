"""Window mean of `beam_search` per call (CUDA events): the graphed
decode loop with its set-up and its finish."""


def read(rec: dict):
    spans = rec.get("spans_ms", {}).get("decode")
    return sum(spans) / len(spans) if spans else None
