"""Device milliseconds of the host-to-card copies of one call, from a
profiled sub-window of calls (the trace's `Memcpy HtoD ...` operations,
over the calls profiled): the feature arrays that the program's batch
caller puts on the card, and whatever else a call copies there; left out
where the profile stayed incomplete."""


def read(rec: dict):
    prof = rec.get("profile")
    if not prof or not prof["complete"] or "copy_s" not in prof:
        return None
    return 1e3 * prof["copy_s"] / prof["reps"]
