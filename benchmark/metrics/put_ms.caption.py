"""Window mean per call of the host milliseconds in the program's
`caption.put` span (`infer/evaluator.py::batch_caller`): from the call's
host arrays to its tensors ready on the caption's stream. A program
without the span reads nothing."""


def read(rec: dict):
    win = rec.get("program", {}).get("window")
    if not win or not win["requests"] or "caption.put" not in win["spans"]:
        return None
    return win["spans"]["caption.put"]["host_ms"] / win["requests"]
