"""Host time of a step's forward (``gcc.train.forward``: the encoder calls,
logits and loss), a step, in the dispatch a traced run runs with the
program's spans on."""

from benchmark.harness.probes import span_mean


def read(rec):
    return span_mean(rec, "pretrain", "gcc.train.forward", "gcc.train.step")
