"""Share of a profiled sub-window of calls in which no operation ran on
the card, in percent; left out where the profile stayed incomplete."""


def read(rec: dict):
    prof = rec.get("profile")
    if not prof or not prof["complete"] or "calls" not in rec:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
