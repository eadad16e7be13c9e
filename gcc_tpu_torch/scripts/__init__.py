"""The port's measurement scripts, counterparts of the repository's
``scripts/`` of the same names: ``giant_bench`` (the giant path's wall
time), ``refscale_bench`` (host sampler pairs/s at the reference's corpus
scale), ``hub_ab`` (the sampler's hub-row A/B) and ``bench_scaling``
(data-parallel weak scaling). Run each with ``python -m
gcc_tpu_torch.scripts.<name>``; each prints its JSON and writes it only to
its ``--out`` path (default under ``build/gcc_tpu_torch/``). The accuracy
A/Bs ``pe_ab`` (training PE arms), ``e2e_canonical`` (E2E at 100 epochs)
and ``graph_readout_ab`` (readout compositions) train or encode on the
card (``run`` / ``encode``) and score where scikit-learn is (``score``),
writing only under their ``--root`` / ``--out`` / ``--in``."""
