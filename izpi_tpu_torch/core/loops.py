"""Loops whose predicate is tested once per chunk of bodies.

Counterpart of `izpi_tpu/core/loops.py`, with its semantics:
- `chunked_while(cond, body, state, chunk)`: while cond holds, run `chunk`
  bodies; the predicate is tested once per chunk, before it.
- `guarded_fori(n_iters, cond, body, state, chunk=8)`: spans of `chunk`
  bodies (and one exact remainder span), each run only if cond holds
  before it; never more than n_iters bodies.
Either way the body MUST be a fixpoint once cond is false (every update
masked by its own live lanes), since a chunk runs on past the point where
cond turned false.

On the TPU these loops route around XLA's while-loop predicate syncs. On
an H100 the cost they cut is the host's: each test of the predicate reads
a device value (a sync), and each body is hundreds of small PyTorch
launches. A `runner` runs the bodies of a chunk:
- `Eager` (the default) calls the body, on any device;
- `Graphed` captures one body as a `torch.cuda.CUDAGraph` on first use (one
  eager body on a side stream first, the warm-up PyTorch's graph
  documentation asks for) and replays it for every later body, the state
  living in the graph's static buffers, each replay ending with the
  body's `copy_` of its results into them. A body in a graph launches no
  Python: a chunk of k bodies is k replays and one sync.
A failed capture or replay raises; nothing falls back to the eager loop.

A runner also runs one function (`call`), such as the training step: an
`Eager` runner calls it, a `Graphed` one captures it once (on static
copies of its arguments) and replays it for every later call of the same
shapes.
"""

from __future__ import annotations

import gc
import time

import torch
from torch.utils import _pytree as pytree

from izpi_tpu_torch import profiling


class Eager:
    """Runs each body as a call. `trips` counts the bodies run; it replays
    and captures nothing."""

    def __init__(self):
        self.trips = 0
        self.replays = 0
        self.capture_seconds = 0.0

    def run(self, body, state, n: int):
        for _ in range(n):
            state = body(state)
        self.trips += n
        return state

    def finish(self, state):
        return state

    def call(self, fn, *args):
        self.trips += 1
        return fn(*args)


class Graphed:
    """Runs the bodies of one loop, or the calls of one function, as replays
    of a CUDA graph.

    Loop (`run`): the first `run` runs one body eagerly on a side stream
    (the warm-up, which counts as a body), copies its result into static
    buffers and captures the body on them; every later body is a replay. A
    later call (the same loop again, e.g. the next render on the same
    context) copies its state into the static buffers and replays at once:
    the state must have the captured structure, shapes and dtypes, and the
    body must be the one captured, since the graph replays that one. The
    caller keys a kept `Graphed` by everything that shapes the captured
    work.

    Function (`call`): the first call, and any call whose arguments differ
    in structure, shape, dtype or device from the captured ones, runs fn
    once eagerly on a side stream (the warm-up), then captures fn on
    static copies of the arguments (detached: fn makes the leaves it
    differentiates in; the old graph freed first); every call copies its
    arguments into them and replays, and
    returns clones of fn's outputs, so that no later replay writes what
    the caller holds. fn must be the same function at every call, and must
    read nothing but its arguments and what stays alive and unchanged
    beside the runner.

    The kernels' launch counters (`ops.LAUNCH_COUNTED`) count executed
    launches: the capture's own ticks are taken back, and each replay adds
    the launches the capture recorded.

    The spans (`profiling.span`): "graph.capture" around a warm-up and its
    capture; a call's "graph.copy_in", "graph.replay" (the host's launch of
    the graph) and "graph.clone_out". A loop's replays carry none.

    `trips` counts the bodies or calls run (the warm-up and the replays),
    `replays` the replays, `capture_seconds` the host seconds of the
    captures, `capture_bytes` the bytes the last capture added to what
    PyTorch's caching allocator reserves (`torch.cuda.memory_reserved`: the
    static buffers and the graph's private pool, held while the runner
    lives), `deltas` the launches of one replay by counter."""

    def __init__(self):
        self.graph = None
        self.static = None
        self.spec = None
        self.key = None
        self.out = None
        self.deltas = {}
        self.trips = 0
        self.replays = 0
        self.capture_seconds = 0.0
        self.capture_bytes = 0

    def run(self, body, state, n: int):
        if n <= 0:
            return state
        if self.graph is None:
            state = self._capture(body, state)
            n -= 1
        else:
            state = self._load(state)
        for _ in range(n):
            self.graph.replay()
        from izpi_tpu_torch import ops

        ops.add_launch_counts(self.deltas, n)
        self.trips += n
        self.replays += n
        return state

    def finish(self, state):
        """The loop's result, copied out of the static buffers, so the
        graph can run again while the caller holds it."""
        leaves, spec = pytree.tree_flatten(state)
        if self.static is not None and all(
                a is b for a, b in zip(leaves, self.static)):
            return pytree.tree_unflatten([x.clone() for x in leaves], spec)
        return state

    def call(self, fn, *args):
        from izpi_tpu_torch import ops

        leaves, spec = pytree.tree_flatten(args)
        key = (spec, tuple((x.shape, x.dtype, x.device) for x in leaves))
        if self.graph is None or key != self.key:
            with profiling.span("graph.capture"):
                self.graph = self.static = self.out = None
                dev = _cuda_device(leaves)
                _warm_up(lambda: fn(*args), dev)
                self.trips += 1
                self.static, out = self._record(
                    dev, lambda: [x.detach().clone() for x in leaves],
                    lambda st: fn(*pytree.tree_unflatten(st, spec)))
                self.out = pytree.tree_flatten(out)
                self.key = key
        else:
            with profiling.span("graph.copy_in"), torch.no_grad():
                for dst, src in zip(self.static, leaves):
                    dst.copy_(src)
        with profiling.span("graph.replay"):
            self.graph.replay()
        ops.add_launch_counts(self.deltas, 1)
        self.trips += 1
        self.replays += 1
        out_leaves, out_spec = self.out
        with profiling.span("graph.clone_out"):
            return pytree.tree_unflatten([x.clone() for x in out_leaves],
                                         out_spec)

    def _load(self, state):
        leaves, spec = pytree.tree_flatten(state)
        if len(leaves) == len(self.static) and all(
                a is b for a, b in zip(leaves, self.static)):
            return state
        if spec != self.spec or any(
                a.shape != b.shape or a.dtype != b.dtype or a.device != b.device
                for a, b in zip(leaves, self.static)):
            raise ValueError("the state does not have the structure, shapes "
                             "and dtypes of the captured loop")
        for dst, src in zip(self.static, leaves):
            dst.copy_(src)
        return pytree.tree_unflatten(self.static, self.spec)

    def _capture(self, body, state):
        with profiling.span("graph.capture"):
            leaves, _ = pytree.tree_flatten(state)
            dev = _cuda_device(leaves)
            state = _warm_up(lambda: body(state), dev)
            self.trips += 1
            leaves, self.spec = pytree.tree_flatten(state)

            def record(static):
                out_leaves, out_spec = pytree.tree_flatten(
                    body(pytree.tree_unflatten(static, self.spec)))
                if out_spec != self.spec:
                    raise ValueError("the body changed the state's "
                                     "structure")
                for dst, src in zip(static, out_leaves):
                    if dst is not src:
                        dst.copy_(src)

            self.static, _ = self._record(
                dev, lambda: [x.clone() for x in leaves], record)
            return pytree.tree_unflatten(self.static, self.spec)

    def _record(self, dev, make_static, fn):
        """Capture fn(static) as this runner's graph, static =
        make_static() made after the allocator's cache is emptied (which
        torch.cuda.graph does on entry), so that capture_bytes counts the
        static buffers with the graph's private pool. Python's cyclic
        collector runs before the capture and is off during it. Takes the capture's
        ticks of the launch counters back into `deltas`. Returns (static,
        fn's output)."""
        from izpi_tpu_torch import ops

        # A CUDA graph (or event) that the cyclic collector frees during the
        # capture makes a call the capture forbids, and the capture fails:
        # collect first, and not at all while capturing.
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        static = make_static()
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                out = fn(static)
        finally:
            if collecting:
                gc.enable()
        self.capture_seconds += time.perf_counter() - t0
        self.capture_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = ops.launch_counts()
        self.deltas = {k: after[k] - before[k] for k in after}
        ops.add_launch_counts(self.deltas, -1)
        self.graph = graph
        return static, out


def _cuda_device(leaves):
    dev = leaves[0].device
    if dev.type != "cuda":
        raise ValueError(f"a CUDA graph needs CUDA tensors, not {dev}")
    return dev


def _warm_up(fn, dev):
    """fn() on a side stream, the warm-up PyTorch's graph documentation asks
    for before a capture; returns its output."""
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    return out


def chunked_while(cond, body, state, chunk: int, runner=None):
    """while cond(state): run `chunk` bodies — testing cond only once per
    chunk (chunk ≤ 1: before every body). `runner` (`Eager` by default, or a
    `Graphed`) runs them. The body must be a fixpoint once cond is false."""
    runner = runner or Eager()
    chunk = max(1, chunk)
    while bool(cond(state)):
        state = runner.run(body, state, chunk)
    return runner.finish(state)


def guarded_fori(n_iters: int, cond, body, state, chunk: int = 8,
                 runner=None):
    """Run `body` while `cond` holds, in floor(n_iters/chunk) spans of
    `chunk` bodies and one exact remainder span, each run only if cond
    holds before it: never more than n_iters bodies, so a body that is not
    a fixpoint past iteration n_iters (a bounce loop's depth cap) stays
    exact. Once a span is skipped the state no longer changes, so neither
    does cond, and the loop ends there."""
    runner = runner or Eager()
    chunk = max(1, min(chunk, n_iters))
    n_full, rem = divmod(n_iters, chunk)
    for span in [chunk] * n_full + ([rem] if rem else []):
        if not bool(cond(state)):
            break
        state = runner.run(body, state, span)
    return runner.finish(state)
