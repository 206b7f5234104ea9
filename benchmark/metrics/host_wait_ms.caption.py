"""Window mean per call of the host milliseconds in the program's wait
spans, every `<kind>.wait` of `infer/graphs.py` (the host reading a
loop's early-exit flag from the card)."""


def read(rec: dict):
    win = rec.get("program", {}).get("window")
    if not win or not win["requests"]:
        return None
    return sum(s["host_ms"] for n, s in win["spans"].items()
               if n.endswith(".wait")) / win["requests"]
