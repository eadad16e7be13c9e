"""CUDA kernels launched in the traced stretch per generation call."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "embed" or not tr or not tr["launches"]:
        return None
    return tr["launches"] / tr["calls"]
