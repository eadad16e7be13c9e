"""Host time of ``batch_subgraphs`` (``gcc.generate.batch``), a generation
call, in the call a traced run runs with the program's spans on."""

from benchmark.harness.probes import span_mean


def read(rec):
    return span_mean(rec, "embed", "gcc.generate.batch", "gcc.generate.call")
