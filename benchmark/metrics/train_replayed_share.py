"""Encoder calls of the window's train steps replayed from CUDA graphs, over
replayed and eager ones (``models/step_graphs.py`` ``counts``), in %. The
graphs serve the card only: a run on the CPU has nothing to read."""


def read(rec):
    c = rec.get("step_graphs")
    if rec.get("kind") != "pretrain" or rec.get("device") != "cuda" or not c:
        return None
    calls = c["replays"] + c["eager"]
    return 100.0 * c["replays"] / calls if calls else None
