"""What every run shares: the command line, the cell's files found by
name, the seeds, the cache directories, the device, the weights made
from the seed, and the result line."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np

from benchmark.reference.encoder import model_name

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# Modules whose presence in the process after the window refuses the run:
# the JAX stack and the JAX package the program was ported from, compared
# by whole top-level names.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gcc_tpu")


def process_start_time() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the benchmark) or cpu (the tests: the "
                         "kernels' plain versions, no look for a card)")
    ap.add_argument("--benchmark-json", default=os.path.join(
        ROOT, "BENCHMARK.json"), help="the benchmark definition")
    ap.add_argument("--override", default=None,
                    help="JSON object merged into the configuration and the "
                         "traffic (tests run tiny widths this way)")
    return ap.parse_args(argv)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str):
    """(cell, config entry) of workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def traffic_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", f"{name}.json")


def limits_path(workload: str) -> str:
    return os.path.join(BENCH_DIR, "limits", f"{workload}.json")


def require_model(config: dict) -> None:
    """Exit without a result, naming what is missing, where the
    configuration's model lacks its plain reference
    (``reference/models/<model>.py``) or its counts
    (``counts/models/<model>.py``)."""
    model = model_name(config)
    missing = [os.path.join("benchmark", part, "models", f"{model}.py")
               for part in ("reference", "counts")
               if not os.path.exists(os.path.join(BENCH_DIR, part, "models",
                                                  f"{model}.py"))]
    if missing:
        raise SystemExit(f"benchmark: configuration {config.get('name')!r} "
                         f"names model {model!r}, whose files are missing: "
                         + ", ".join(missing))


def metric_reader(name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, trace: int) -> list[dict]:
    """The metrics a run of ``workload`` reports: end-to-end ones with
    --trace 0, per-layer ones with --trace 1, each where its
    ``workloads`` list (if any) names the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def derived_seeds(seed: int, count: int = 6) -> list[int]:
    """``count`` independent 31-bit seeds from the run's seed (any
    integer: large ones too)."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return [int(x) & 0x7FFFFFFF for x in ss.generate_state(count, np.uint32)]


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the program builds its kernels and sampler under ``build/`` itself;
    these cover PyTorch's extension and Triton caches."""
    base = os.path.join(ROOT, "build", "benchmark", "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def device_check(device: str, chips: int):
    """The torch device, or exit without a result where the card is not
    there: a CUDA run needs ``chips`` cards."""
    import torch

    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        raise SystemExit(3)
    return torch.device("cuda", 0)


def device_info(device, chips: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_loaded() -> list[str]:
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN_MODULES})


def quantile(values, q: int) -> float:
    """The q-th percentile (1-99) by ``statistics.quantiles`` (exclusive
    method); a single value is its own percentile."""
    values = list(values)
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=100)[q - 1])


def finish(result: dict, checks: list[tuple[str, float, float]]) -> None:
    """Print every compared number beside its limit as the last lines of
    stderr, then the result line (``checks`` last in it) as the last line
    of stdout. Exits without a result if a forbidden module is loaded."""
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: the process holds {bad}: the run measured code "
              "outside the port", file=sys.stderr)
        raise SystemExit(4)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    for name, value, limit in checks:
        verdict = "ok" if value <= limit else "OVER"
        print(f"check {name}: {value!r} (limit {limit!r}) {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
