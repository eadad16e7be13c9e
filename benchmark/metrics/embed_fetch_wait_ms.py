"""Host time of a call's fetch (``gcc.generate.fetch``: the host waiting on
the card for the result), a generation call, in the call a traced run
runs with the program's spans on."""

from benchmark.harness.probes import span_mean


def read(rec):
    return span_mean(rec, "embed", "gcc.generate.fetch", "gcc.generate.call")
