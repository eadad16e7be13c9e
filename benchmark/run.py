"""Run one cell of the benchmark of gcc_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
name: ``BENCHMARK.json`` at the checkout's root, ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``kind`` picks the driver in
``harness/``), ``metrics/<metric>.py``, ``limits/<workload>.json``, and
the configuration's model's ``reference/models/<model>.py`` and
``counts/models/<model>.py``. The
run loads and warms up (set-up), measures for ``--seconds``, checks the
timed path's output against the plain reference, and prints one JSON line
last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end
ones with ``--trace 0``, the per-layer ones with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of stderr).

Without a CUDA card (or fewer than the cell asks for) it exits non-zero
and prints no result. ``--device cpu`` is for the tests: the program's
plain PyTorch versions run in place of its kernels.
"""

from __future__ import annotations

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark.harness import common  # noqa: E402

DRIVERS = {"pretrain": "benchmark.harness.pretrain",
           "embed": "benchmark.harness.embed"}


def main(argv=None) -> int:
    t_start = common.process_start_time()
    args = common.parse_args(argv)
    common.set_cache_dirs()
    bench = common.load_json(args.benchmark_json)
    cell, cfg_entry = common.find_cell(bench, args.workload)
    config = common.load_json(os.path.join(_ROOT, cfg_entry["file"]))
    traffic = common.load_json(common.traffic_path(cell["traffic"]))
    limits = common.load_json(common.limits_path(cell["name"]))
    if args.override:
        import json

        extra = json.loads(args.override)
        config.update(extra.get("config", {}))
        traffic.update(extra.get("traffic", {}))
    common.require_model(config)
    device = common.device_check(args.device, cell["chips"])
    import importlib

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module(DRIVERS[traffic["kind"]])
    rec, checks = driver.run(args, config, traffic, device, t_start, limits)
    metrics = {}
    for m in common.cell_metrics(bench, cell["name"], args.trace):
        value = common.metric_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = common.device_info(device, cell["chips"])
    if "memory_peak_bytes" in rec:
        info["memory_peak_bytes"] = rec["memory_peak_bytes"]
    result = {"correct": rec["failed"] == 0 and all(v <= lim for _, v, lim
                                                    in checks),
              "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": info}
    if args.trace:
        tr = rec["trace"]
        info["busy_s"] = tr["busy_s"]
        info["window_s"] = tr["window_s"]
        result["breakdown"] = tr["breakdown"]
    common.finish(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
