"""Where the port finds its native sources and puts what it builds.

The host sampler (``csrc/sampler.cpp``, shared with ``gcc_tpu``) and the
CUDA kernels (``gcc_tpu_torch/csrc/``) are compiled at first use into
``build/gcc_tpu_torch/`` under the repository root, a directory that
``.gitignore`` lists.
"""

from __future__ import annotations

import os

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "gcc_tpu_torch")
