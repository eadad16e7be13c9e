"""Time the pipeline's ``__next__`` spent blocked on its queue (or
sampling), a get, over the window (``PretrainPipeline.stats()``
``wait_ns`` over ``gets``), in ms."""


def read(rec):
    p = rec.get("pipeline")
    if rec.get("kind") != "pretrain" or not p or not p["gets"]:
        return None
    return 1e-6 * p["wait_ns"] / p["gets"]
