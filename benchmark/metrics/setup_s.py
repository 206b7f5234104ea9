"""Set-up seconds: process start to the first timed call or step
(host clock; the kernel library, weights, traffic and warm-up)."""


def read(rec: dict):
    return rec.get("setup_s")
