"""Host time a dispatch waits for its item from the sampler pipeline
(``next`` on the pipeline, timed by the benchmark), averaged over the
window's dispatches."""


def read(rec):
    if rec.get("kind") != "pretrain" or not rec.get("dispatches"):
        return None
    return 1000.0 * rec["sampler_wait_s"] / rec["dispatches"]
