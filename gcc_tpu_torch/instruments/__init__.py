"""The downstream instruments: the port's copies of the reference's four
synthetic accuracy instruments (``scripts/role_benchmark.py``,
``graph_benchmark.py``, ``sim_benchmark.py``, ``finetune_benchmark.py``)
and of the pre-training recipe their checkpoint comes from
(``scripts/pe_ab.py``). Fixtures are generated byte for byte as the
reference's; the protocols call the port's own generate, tasks, baseline
embedders and finetuning. Run with ``python -m gcc_tpu_torch.instruments``.
"""
