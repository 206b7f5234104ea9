"""Window mean per call of the program's `encode.bilstm` span, timed on
the card (its CUDA events): the encoder's BiLSTM, its scan and summary."""


def read(rec: dict):
    win = rec.get("program", {}).get("window")
    span = win["spans"].get("encode.bilstm") if win and win["requests"] else None
    if not span or span["device_ms"] is None:
        return None
    return span["device_ms"] / win["requests"]
