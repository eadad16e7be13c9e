"""Host time of a dispatch's featurize (``gcc.train.featurize``: the upload
and Kernels 1-3, or the E2E size split), a dispatch, in the dispatch a
traced run runs with the program's spans on."""

from benchmark.harness.probes import span_mean


def read(rec):
    return span_mean(rec, "pretrain", "gcc.train.featurize",
                     "gcc.train.dispatch")
