"""Host time of a step's backward (``gcc.train.backward``: ``zero_grad`` and
``loss.backward()``), a step, in the dispatch a traced run runs with the
program's spans on."""

from benchmark.harness.probes import span_mean


def read(rec):
    return span_mean(rec, "pretrain", "gcc.train.backward", "gcc.train.step")
