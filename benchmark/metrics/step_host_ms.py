"""Host time of one optimizer step (``gcc.train.step``: forward, backward,
optimizer, MoCo's momentum), a step, in the dispatch a traced run runs
with the program's spans on before its window."""

from benchmark.harness.probes import span_mean


def read(rec):
    return span_mean(rec, "pretrain", "gcc.train.step", "gcc.train.step")
