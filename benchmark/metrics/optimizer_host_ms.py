"""Host time of a step's optimizer (``gcc.train.optimizer``: the clip, the
rate, ``optimizer.step()``), a step, in the dispatch a traced run runs
with the program's spans on."""

from benchmark.harness.probes import span_mean


def read(rec):
    return span_mean(rec, "pretrain", "gcc.train.optimizer", "gcc.train.step")
