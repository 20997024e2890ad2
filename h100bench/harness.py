"""What every cell of the benchmark shares: finding a cell's files by name,
the card's facts, the profiler's device intervals and the result line.

Nothing here knows a configuration, a traffic mix or a metric by name: a
cell's configuration is `configs/<config>.json`, its traffic
`traffic/<traffic>.json` (which names its driver, `drivers/<driver>.py`),
its limits `limits/<cell>.json`, a per-layer metric `metrics/<name>.py`
and a kernel's count of work `counts/<kernel>.py`.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that may not be loaded in a run: JAX and the JAX
# package. Compared whole, so the port `izpi_tpu_torch` is not among them.
FORBIDDEN = ("jax", "jaxlib", "flax", "izpi_tpu")


_START = time.perf_counter()


def mark(what: str) -> None:
    """A line on standard error: seconds since this module loaded."""
    print(f"[{time.perf_counter() - _START:9.3f} s] {what}", file=sys.stderr,
          flush=True)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def load_module(path: Path, name: Optional[str] = None):
    """The Python file at `path` as a module (its name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        name or "h100bench_file_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of `workloads` with its configuration, traffic, limits and
    the metrics that it reports, each read from its own file."""

    def __init__(self, name: str, bench: dict, here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; the benchmark has "
                           f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = read_json(here.parent / self.config_entry["file"])
        self.traffic = read_json(here / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = read_json(here / "limits" / f"{name}.json")
        self.driver = load_module(here / "drivers"
                                  / f"{self.traffic['driver']}.py")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.here = here

    def metric_reader(self, name: str):
        return load_module(self.here / "metrics" / f"{name}.py")


def count_module(kernel: str, here: Path = HERE):
    """`counts/<kernel>.py`: the work a kernel's inputs need."""
    return load_module(here / "counts" / f"{kernel}.py")


def peaks(here: Path = HERE) -> dict:
    return read_json(here / "peaks.json")


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

SMI_FIELDS = ("name", "power.limit", "clocks.sm", "clocks.max.sm",
              "temperature.gpu", "power.draw")


def smi() -> Dict[str, str]:
    """nvidia-smi's reading of card 0 ({} where it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(SMI_FIELDS),
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    return dict(zip(SMI_FIELDS, (v.strip() for v in out.strip().split(","))))


def device_facts(torch) -> dict:
    """The facts the rooflines take from this run: the SM count and the
    largest SM clock (MHz) of card 0, and its power limit."""
    props = torch.cuda.get_device_properties(0)
    reading = smi()
    clock = reading.get("clocks.max.sm")
    return dict(kind=torch.cuda.get_device_name(0),
                sm_count=props.multi_processor_count,
                sm_clock_mhz=float(clock) if clock else None,
                power_limit_w=reading.get("power.limit"), smi=reading)


# ---------------------------------------------------------------------------
# The profiler's device intervals
# ---------------------------------------------------------------------------

# Kernels launched at each end of a trace (`torch.cuda._sleep`, whose kernel
# is `spin_kernel`): on the H100 a trace has lost device records at its
# ends, so what it loses there is padding, which the intervals leave out.
PAD_KERNELS = 4096
PAD_NAME = "spin_kernel"
SETTLE_S = 0.25
TRIES = 3


class Trace:
    """A traced slice of a run: its device intervals (start µs, end µs,
    name), the slice's host-clock seconds, what the driver counted in it
    (images or steps, rays, the program's counters), the card's facts
    (`device_facts`) and the host's operations meanwhile."""

    def __init__(self, intervals, window_s: float, counters: dict,
                 facts: dict, host=()):
        self.intervals = intervals
        self.host = host
        self.window_s = window_s
        self.counters = counters
        self.facts = facts

    @property
    def busy_s(self) -> float:
        return union_seconds(self.intervals)

    def kernel_calls(self, names) -> List[float]:
        """Device seconds of each launch of the kernels `names`, each a
        function's own name without its namespaces or arguments
        (`megakernel_rgb` for `izpi::megakernel_rgb(izpi::Scene, ...)`)."""
        return [(e - s) / 1e6 for s, e, name in self.intervals
                if kernel_name(name) in names]


def kernel_name(record: str) -> str:
    """A device record's function name without namespaces or arguments."""
    return record.split("(")[0].split("::")[-1].split(" ")[-1]


def prim_kinds(cs) -> dict:
    """The program's compiled scene's primitives counted by kind."""
    from izpi_tpu_torch.geometry import primitives as prim

    k = cs.prims.kind
    return {"triangle": int((k == prim.KIND_TRIANGLE).sum()),
            "rect": int((k == prim.KIND_RECT).sum()),
            "sphere": int((k == prim.KIND_SPHERE).sum())}


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start µs, end µs, ...) intervals:
    time in which at least one operation ran on the device."""
    total = 0.0
    cur_s = cur_e = None
    for s, e, *_ in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def device_intervals(torch, fn):
    """Run fn() under torch.profiler. Returns (wall seconds of fn(), the
    device records [(start µs, end µs, name)] between the padding, and the
    host's operations [(start µs, end µs, name)] meanwhile). If no padding
    kernel is left at an end, the trace is taken again with twice the wait
    and padding; after TRIES such traces this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def pad(n):
        for _ in range(n):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for attempt in range(TRIES):
        settle, n_pad = SETTLE_S * 2 ** attempt, PAD_KERNELS * 2 ** attempt
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            time.sleep(settle)
            pad(n_pad)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            pad(n_pad)
            time.sleep(settle)
        events = prof.events()
        # The host's annotations (record_function ranges) are mirrored on
        # the device's timeline; they are no device work.
        marks = {e.name for e in events if getattr(e, "is_user_annotation",
                                                   False)}
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in marks]
        pads = [e.time_range.start for e in device if PAD_NAME in e.name]
        run = [(e.time_range.start, e.time_range.end, e.name) for e in device
               if PAD_NAME not in e.name]
        starts = [s for s, _, _ in run]
        kept = ([sum(p < min(starts) for p in pads),
                 sum(p > max(starts) for p in pads)] if run else [0, 0])
        if all(kept):
            lo, hi = min(starts), max(e for _, e, _ in run)
            host = [(e.time_range.start, e.time_range.end, e.name)
                    for e in events if e.device_type == DeviceType.CPU
                    and e.time_range.end >= lo and e.time_range.start <= hi
                    and "_sleep" not in e.name]
            return wall, run, host
        print(f"trace: kept {kept[0]} and {kept[1]} of {n_pad} padding "
              f"kernels at its ends; try {attempt + 1} of {TRIES}",
              file=sys.stderr, flush=True)
    raise RuntimeError(f"the trace lost every padding kernel at one end in "
                       f"{TRIES} tries")


def breakdown(intervals, host=()) -> dict:
    """The device operations that took most time, and the longest idle
    gaps between device records, each named by the innermost host
    operation that spans its middle."""
    by_name: Dict[str, float] = {}
    for s, e, name in intervals:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    end = None
    for s, e, _ in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in gaps[:10]:
        mid = (g0 + g1) / 2
        spans = [(he - hs, name) for hs, he, name in host if hs <= mid <= he]
        out.append([f"host: {min(spans)[1][:100]}" if spans else "host: -",
                    (g1 - g0) / 1e6])
    return {"device_ops": [[n[:120], v] for n, v in ops], "idle_gaps": out}


# ---------------------------------------------------------------------------
# Statistics and the result
# ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linearly interpolated
    between the closest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, extra: Optional[dict] = None
                ) -> str:
    """The run's last line: `checks` (each number compared with its limit)
    comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if extra:
        out.update(extra)
    out["checks"] = checks
    return json.dumps(out)
