"""Nodes embedded (both views encoded and averaged) in the window, over
the window's length."""


def read(rec):
    if rec.get("kind") != "embed" or not rec.get("window_s"):
        return None
    return rec["embeddings"] / rec["window_s"]
