"""Least time of the call's decode steps (cost.py: every step at B*K
rows of B videos, the larger of FLOPs over the bf16 peak and bytes over
HBM's) over the window mean of `beam_search`, in percent."""


def read(rec: dict):
    spans = rec.get("spans_ms", {}).get("decode")
    if not spans or "cost" not in rec:
        return None
    return 100.0 * rec["cost"]["decode_least_s"] * 1e3 / (sum(spans) / len(spans))
