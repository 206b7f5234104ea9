"""Model matmul FLOPs of the window's calls (cost.py) over the window's
seconds, against the bf16 peak, in percent."""


def read(rec: dict):
    if "cost" not in rec or not rec.get("calls"):
        return None
    return 100.0 * rec["cost"]["call_flops"] * rec["calls"] / rec["window_s"] / rec["cost"]["peak_flops"]
