"""Host seconds of the set-up in the program's capture spans, every
`<kind>.capture` of `infer/graphs.py::run` (a key's graphs captured at
its first sight, during the warm calls)."""


def read(rec: dict):
    setup = rec.get("program", {}).get("setup")
    if not setup:
        return None
    return sum(s["host_ms"] for n, s in setup["spans"].items()
               if n.endswith(".capture")) / 1e3
