"""Window mean per call of the program's `pos.rollout` span, timed on
the card (its CUDA events): the greedy POS rollout of the encoder."""


def read(rec: dict):
    win = rec.get("program", {}).get("window")
    span = win["spans"].get("pos.rollout") if win and win["requests"] else None
    if not span or span["device_ms"] is None:
        return None
    return span["device_ms"] / win["requests"]
