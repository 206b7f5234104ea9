"""Window mean per call of the host milliseconds in the program's loop
set-up spans, every `<kind>.setup` of `infer/graphs.py::run` (`beam`,
`pos`, `bilstm`): from a loop's entry to its first step or chunk
launched."""


def read(rec: dict):
    win = rec.get("program", {}).get("window")
    if not win or not win["requests"]:
        return None
    return sum(s["host_ms"] for n, s in win["spans"].items()
               if n.endswith(".setup")) / win["requests"]
