"""CUDA kernels launched in the traced stretch (the profiler's kernel
events) per training step in it."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "pretrain" or not tr or not tr["launches"]:
        return None
    return tr["launches"] / tr["steps"]
