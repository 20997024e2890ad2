"""Command-line interface: `python -m izpi_tpu_torch`.

Counterpart of `izpi_tpu/cli.py`, with its flags, names and defaults (the
reference's flag surface, cmd/izpi/main.go:31-66): scene, x/y, samples,
sampler, max-depth, output mode and file, seed, background, ink, verbose,
checkpoint and preview, and --profile-dir, here a `torch.profiler` trace.
The scene is a built-in name (`scene.library`) or a `.pbtxt` or `.izpi`
file (`scene.pbtxt`). One flag is added: --device, "cuda" (the default;
without a card the run fails) or "cpu".

Multi-host rendering (izpi_tpu/cli.py:95-119,145-152): one process a rank,
`--role leader` (rank 0) and `--role worker --process-id <rank>`, each
with `--coordinator <leader host:port> --num-processes <n>` (without a
coordinator, torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK),
join one process group (`parallel.dist.initialize_multihost`; NCCL when
every host has a card for each of its ranks, else gloo, named in the
summary line) and render the frame sample-sharded (`parallel.dist.
render_distributed`), or primitive-sharded with --shard-prims, on the
first --num-workers ranks (0: all). Only rank 0 writes the image. A worker
with a coordinator but no rank exits with the fix, as the JAX CLI does.
The flags of a distributed run given without --role are ignored, as the
JAX CLI ignores them, and the render runs standalone; here a warning on
stderr names them. As in the JAX CLI, a distributed run takes no
checkpoint or preview.

An EXR of a spectral render (a spectral scene, or --sampler spectral) is
ACEScg and carries the ACES chromaticities; the JAX CLI stamps them only on
a spectral scene's.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m izpi_tpu_torch",
        description="differentiable spectral path tracer on one CUDA card",
    )
    p.add_argument("--scene", default="cornell_box_pyramid_spectral",
                   help="built-in scene name, or a .pbtxt or .izpi file")
    p.add_argument("-x", type=int, default=500, help="output width")
    p.add_argument("-y", type=int, default=500, help="output height")
    p.add_argument("--samples", type=int, default=1000,
                   help="samples per pixel")
    p.add_argument("--sampler", default="spectral",
                   choices=["spectral", "colour", "albedo", "normal",
                            "wireframe"])
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--output-mode", default="png",
                   choices=["png", "exr", "hdr", "pfm"])
    p.add_argument("--output-file", default="output.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--background", default="0,0,0",
                   help="background colour r,g,b")
    p.add_argument("--ink", default="0,0,0", help="wireframe ink colour")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--role", default="standalone",
                   choices=["standalone", "leader", "worker"],
                   help="multi-host role: leader (rank 0) or worker")
    p.add_argument("--coordinator", default=None,
                   help="the leader's host:port, where the ranks meet")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host process (rank) count")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (the leader is 0)")
    p.add_argument("--shard-prims", action="store_true",
                   help="shard the primitives over the ranks")
    p.add_argument("--num-workers", type=int, default=0,
                   help="ranks to render on (0 = all)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (trace.json) here")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for resumable renders")
    p.add_argument("--checkpoint-interval", type=int, default=0,
                   help="samples between checkpoint writes (0 = off)")
    p.add_argument("--preview", default=None,
                   help="write a progressive preview PNG to this path")
    p.add_argument("--preview-serve", type=int, default=None, metavar="PORT",
                   help="serve the live preview at http://localhost:PORT "
                        "(implies --preview)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def _multihost_flags(args) -> list:
    """The flags of a distributed run given besides --role."""
    given = []
    for flag, value in (("--coordinator", args.coordinator),
                        ("--num-processes", args.num_processes),
                        ("--process-id", args.process_id)):
        if value is not None:
            given.append(flag)
    if args.shard_prims:
        given.append("--shard-prims")
    if args.num_workers:
        given.append("--num-workers")
    return given


def _join_cluster(args, device):
    """Join the process group of a leader or worker (cli.py:95-119).
    Returns (world size, backend)."""
    import torch.distributed

    from izpi_tpu_torch.parallel import dist

    pid = args.process_id
    if pid is None and args.role == "leader":
        pid = 0
    if args.coordinator:
        if pid is None and "RANK" not in os.environ:
            raise SystemExit(
                "--role worker with --coordinator on a bare host needs an "
                "explicit rank: pass --process-id <rank> (1..N-1; the leader "
                "is 0), or set RANK")
        if args.num_processes is None and "WORLD_SIZE" not in os.environ:
            raise SystemExit("--coordinator needs --num-processes <n>")
        pid = int(os.environ["RANK"]) if pid is None else pid
        n = (int(os.environ["WORLD_SIZE"]) if args.num_processes is None
             else args.num_processes)
    elif not all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT")):
        raise SystemExit(
            f"--role {args.role} needs --coordinator <leader host:port> and "
            f"--num-processes <n> (or torchrun's MASTER_ADDR, MASTER_PORT, "
            f"WORLD_SIZE and RANK)")
    else:
        n = args.num_processes
    n_proc = dist.initialize_multihost(
        coordinator=args.coordinator, num_processes=n, process_id=pid,
        device=device)
    backend = torch.distributed.get_backend()
    if args.verbose:
        print(f"joined cluster: rank {torch.distributed.get_rank()} of "
              f"{n_proc}, backend {backend}", file=sys.stderr)
    return n_proc, backend


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    distributed = args.role in ("leader", "worker")
    given = _multihost_flags(args)
    if given and not distributed:
        # As the JAX CLI (izpi_tpu/cli.py:95), --role alone decides: without
        # it the flags do nothing and the render runs standalone.
        print(f"warning: {' '.join(given)} ignored: multi-host rendering "
              f"needs --role leader or --role worker; rendering standalone",
              file=sys.stderr)

    from izpi_tpu_torch.integrator import path as path_mod
    from izpi_tpu_torch.io import output as output_mod
    from izpi_tpu_torch.render import renderer
    from izpi_tpu_torch.scene.library import get_scene

    device = renderer._device(args.device)
    aspect = args.x / args.y
    if args.scene.endswith((".pbtxt", ".izpi")):
        from izpi_tpu_torch.scene import pbtxt

        scene = pbtxt.load_scene(args.scene, aspect=aspect)
    else:
        scene = get_scene(args.scene, aspect=aspect)

    bg = tuple(float(v) for v in args.background.split(","))
    ink = tuple(float(v) for v in args.ink.split(","))
    settings = path_mod.RenderSettings(max_depth=args.max_depth,
                                       background=bg)

    preview_server = None
    if args.preview_serve is not None:
        from izpi_tpu_torch.io import display as display_mod

        if not args.preview:
            args.preview = os.path.join(
                os.path.dirname(os.path.abspath(args.output_file)) or ".",
                ".izpi_preview.png")
        preview_server = display_mod.PreviewServer(
            args.preview, port=args.preview_serve).start()
        print(f"live preview: http://localhost:{preview_server.port}/",
              file=sys.stderr)

    profiler = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.profile_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()

    t0 = time.time()
    try:
        if distributed:
            import torch.distributed

            from izpi_tpu_torch.parallel import dist

            try:
                n_proc, backend = _join_cluster(args, device)
                res = dist.render_distributed(
                    scene, args.x, args.y, args.samples,
                    group=dist.make_group(args.num_workers or None),
                    settings=settings, seed=args.seed,
                    sampler_type=args.sampler, shard_prims=args.shard_prims,
                    device=device)
            finally:
                if torch.distributed.is_initialized():
                    torch.distributed.destroy_process_group()
        else:
            res = renderer.render(
                scene, args.x, args.y, args.samples, settings=settings,
                seed=args.seed, sampler_type=args.sampler, ink=ink,
                checkpoint_path=args.checkpoint,
                checkpoint_interval=args.checkpoint_interval,
                preview_path=args.preview, verbose=args.verbose,
                device=device)
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
            profiler.export_chrome_trace(
                os.path.join(args.profile_dir, "trace.json"))
        if preview_server is not None:
            preview_server.stop()

    if res is None:  # a worker: rank 0 writes the image
        return 0
    aces = res.xyz is not None and args.output_mode == "exr"
    output_mod.write(args.output_file, res.image, mode=args.output_mode,
                     aces=aces)
    where = res.device
    if distributed:
        where += f" x {args.num_workers or n_proc} ranks ({backend})"
    # End-of-render summary (renderer.go:213).
    print(f"Rendering completed in {time.time() - t0:.1f}s using "
          f"{res.rays_traced} rays ({res.mrays_per_sec:.2f} Mrays/s) on "
          f"{where}; wrote {args.output_file}")
    return 0
