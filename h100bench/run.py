"""One run of one cell of the benchmark of `izpi_tpu_torch` on an NVIDIA
card:

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads and warms up the cell (set-up), measures for `--seconds`, checks what
the timed path produced against the plain reference, and prints one JSON
line last on standard output. With `--trace 1` the metrics are the cell's
per-layer metrics, read from a traced slice run after the window.
"""

import time

T0 = time.perf_counter()  # set-up runs from here to the window's start

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build" / "h100bench"


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its kernels into `build/izpi_tpu_torch/` itself),
    the interpreter's bytecode among them: where the installed packages
    hold none, each process would compile PyTorch's modules from source
    again (some 6.6 s of the training step's first call, which imports
    `torch._dynamo`, `torch.distributed.fsdp` and sympy). One host thread
    for the host's array work, so that a run's host time does not swing
    with its neighbours' load."""
    sys.pycache_prefix = str(BUILD / "pycache")
    sys.dont_write_bytecode = False
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(BUILD / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell, seed: int, seconds: float, trace: bool, device="cuda",
            fault=None, t0=None) -> dict:
    """Set-up, the window, the traced slice (with `trace`) and the check.
    Returns the run's record: end-to-end metrics, per-layer metrics,
    attempted, failed, memory peak, the checks and whether they hold."""
    import torch

    from h100bench import harness

    t0 = time.perf_counter() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drv = cell.driver
    st = drv.setup(cell, seed, device=device, fault=fault)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    out = drv.window(st, seconds)
    out["metrics"]["setup_s"] = setup_s
    out["per_layer"], out["trace"] = {}, None
    if trace:
        fn, counters = drv.traced(st, cell.traffic["trace_items"])
        facts = harness.device_facts(torch) if cuda else {}
        wall, intervals, host = harness.device_intervals(torch, fn)
        tr = harness.Trace(intervals, wall, counters, facts, host)
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(tr)
            if value is not None:
                out["per_layer"][m["name"]] = {"value": value,
                                               "unit": m["unit"]}
        out["trace"] = tr
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if cuda else 0)
    drv.free(st)
    gc.collect()
    t_check = time.perf_counter()
    checks = drv.check(st, cell.limits)
    print(f"set-up {setup_s:.3f} s, window {out['wall']:.3f} s, "
          f"{out['attempted']} done; the check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr,
          flush=True)
    out["checks"] = {k: {"value": v, "limit": cell.limits["limits"][k]}
                     for k, v in checks.items()}
    out["correct"] = all(v <= cell.limits["limits"][k]
                         for k, v in checks.items())
    return out


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    sys.path.insert(0, str(ROOT))
    import torch

    from h100bench import harness

    torch.set_num_threads(1)
    bench = harness.benchmark()
    cell = harness.Cell(args.workload, bench)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} cards, the machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    facts = harness.device_facts(torch)
    print(f"card: {facts['kind']}, {facts['sm_count']} SMs; nvidia-smi: "
          f"{json.dumps(facts['smi'])}", file=sys.stderr, flush=True)
    run = execute(cell, args.seed, args.seconds, bool(args.trace), t0=T0)
    print(f"after the run, nvidia-smi: {json.dumps(harness.smi())}",
          file=sys.stderr, flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process, which the benchmark forbids: "
              f"{found}", file=sys.stderr)
        return 3
    if args.trace:
        metrics = run["per_layer"]
        tr = run["trace"]
        device = {"platform": "gpu", "kind": facts["kind"], "count": 1,
                  "memory_peak_bytes": run["memory_peak_bytes"],
                  "busy_s": tr.busy_s, "window_s": tr.window_s}
        extra = {"breakdown": harness.breakdown(tr.intervals, tr.host)}
    else:
        metrics = {m["name"]: {"value": run["metrics"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
        device = {"platform": "gpu", "kind": facts["kind"], "count": 1,
                  "memory_peak_bytes": run["memory_peak_bytes"]}
        extra = None
    for name, c in run["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {run['correct']}", file=sys.stderr, flush=True)
    print(harness.result_line(run["correct"], run["attempted"],
                              run["failed"], metrics, device, run["checks"],
                              extra), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
