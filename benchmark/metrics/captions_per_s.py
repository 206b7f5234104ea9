"""Videos captioned in the window over the window's seconds (host clock;
the window runs from handing over the first call's features to the last
call's tokens on the host)."""


def read(rec: dict):
    if rec.get("trace") or "calls" not in rec:
        return None
    return rec["videos"] / rec["window_s"]
