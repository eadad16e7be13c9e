"""The benchmark of gcc_tpu_torch on NVIDIA cards (see ``run.py``)."""
