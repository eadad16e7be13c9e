"""Items ready in the pipeline's queue when a dispatch asked for one,
mean over the window's gets (``PretrainPipeline.stats()`` ``ready_items``
over ``gets``)."""


def read(rec):
    p = rec.get("pipeline")
    if rec.get("kind") != "pretrain" or not p or not p["gets"]:
        return None
    return p["ready_items"] / p["gets"]
