"""95th percentile, over every call of the window, of a generation call's
time from submit to the numpy result in hand."""


def read(rec):
    if rec.get("kind") != "embed" or not rec.get("call_s"):
        return None
    return rec["call_ms_p95"]
