"""The readings the check's limits are set from, on the card, for one cell:

    python3 h100bench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n>... [--control-seeds <n>...] [--faults]

- each of `--seeds`: a sound run (set-up, a window of `--seconds`, the
  check): the numbers compared, the lower readings;
- each of `--control-seeds`: the control (the reference in bfloat16 in
  the program's place, `faults.py`) after a window of `--seconds`: the
  upper readings; with `--faults`, each planted fault on those seeds too.

Prints one JSON line a run, and writes them all to `--out` if given. The
benchmark's own runs do not run this.
"""

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load_run():
    spec = importlib.util.spec_from_file_location(
        "h100bench_run", ROOT / "h100bench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readings(cell, seed: int, seconds: float, kind: str, device="cuda"):
    """One run's numbers: kind "sound", "control" or a fault's name."""
    import torch

    from h100bench import faults

    run = load_run()
    drv_name = cell.traffic["driver"]
    t0 = time.perf_counter()
    if kind == "sound":
        out = run.execute(cell, seed, seconds, False, device=device)
        return {"checks": {k: v["value"] for k, v in out["checks"].items()},
                "metrics": out["metrics"], "attempted": out["attempted"],
                "seconds": time.perf_counter() - t0}
    if kind == "control":
        drv = cell.driver
        st = drv.setup(cell, seed, device=device)
        drv.window(st, seconds)
        drv.free(st)
        checks = drv.check(st, cell.limits, control=faults.CONTROL_DTYPE)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        return {"checks": checks, "seconds": time.perf_counter() - t0}
    fault = faults.FAULTS[drv_name][kind]
    out = run.execute(cell, seed, seconds, False, device=device, fault=fault)
    return {"checks": {k: v["value"] for k, v in out["checks"].items()},
            "correct": out["correct"], "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run = load_run()
    run.cache_env()
    sys.path.insert(0, str(ROOT))
    from h100bench import faults, harness

    cell = harness.Cell(args.workload, harness.benchmark())
    kinds = ["control"] + (sorted(faults.FAULTS[cell.traffic["driver"]])
                           if args.faults else [])
    jobs = [("sound", s) for s in args.seeds]
    jobs += [(k, s) for k in kinds for s in args.control_seeds]
    lines = []
    for kind, seed in jobs:
        rec = {"workload": args.workload, "kind": kind, "seed": seed}
        rec.update(readings(cell, seed, args.seconds, kind))
        line = json.dumps(rec)
        print(line, flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    found = harness.forbidden_modules()
    if found:
        print(f"loaded, which the benchmark forbids: {found}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
