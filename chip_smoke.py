#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (izpi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from izpi_tpu_torch/csrc (one nvcc process
per source, all at once, sm_90a) and then, in phases, each reporting on a
line of its own:
  1. the card: `nvidia-smi --query-gpu=name,power.limit` (fails without CUDA);
  2. the build, and its seconds;
  3. cipher: the cipher entry (csrc/cipher.cu) on 1M random keys equals
     the PyTorch twin bit for bit: its bounce form (`izpi_threefry_uniforms`)
     for the bounce, camera, λ and media (two media, the count drawn at run
     time) draws, and its new-sample form (`izpi_threefry_new_sample`: a
     path key from the base key, the pixel and the sample id, alone, with
     the camera's 5 uniforms, and with λ's too; per-ray sample ids and one
     for all); then every form timed at 262,144 and 1M keys (CUDA events
     around a CUDA graph of 50 launches) beside its bound counted from the
     SASS `cuobjdump -sass` shows (its integer ALU instructions a key over
     the INT32 pipe's rate, all its instructions over the issue rate, or
     its bytes over the memory rate, whichever is larger; a width counted
     at run time scales the 12-uniform form's instructions a cipher call),
     and the plain version's time;
  4. kernel vs twin, both on the card, the twin on the card's layout
     (`megakernel.card_min_slots`: SLOTS_PER_THREAD slots per resident
     thread of the persistent grid), within stated tolerances:
     - the RGB megakernel: Cornell 64×64 at 4 spp, depth 8, seed 3; 64×64
       at 64 spp, depth 8, seed 5 (every thread of the grid serves several
       slots, and the slots are no multiple of the grid); 128×128 at 128
       spp, depth 8, seed 7 (likewise, and every slot serves two samples,
       as the main paths' slots serve 64); and the RGB main path's frame,
       256×256 at depth 50, seed 0, for samples [0, 2) and [1022, 1024);
     - the spectral megakernel: the spectral pyramid at the same three
       small layouts, and the spectral main path's frame, 500×500 at depth
       50, seed 0, for samples [0, 2) and [254, 256);
     each kernel and its twin timed at its main path's frame at 2 spp, with
     the kernel's draw counts (its counter buffer) and its bound there;
  5. RGB main path: `render(cornell_box(), 256, 256, 1024, max_depth=50,
     seed=0, mode="wavefront", device="cuda")`, one warm-up and one timed
     run, the launch inside the timed run between CUDA events (the
     kernel's time of record); the RGB megakernel's launch counter must
     read 2, the two runs must agree bit for bit, the image must be finite,
     green on the left, red on the right, with the ceiling light at 15;
     then one more launch of the same render with the draw counter buffer,
     which must repeat the image and rays, for the bound;
  6. spectral main path: `render(cornell_box_pyramid_spectral(), 500, 500,
     256, max_depth=50, seed=0, mode="wavefront", device="cuda")`, likewise;
     the spectral megakernel's counter must read 2, the runs must agree, XYZ
     and ACEScg must be finite, green on the left and red on the right, and
     the light patch's Y must be 15·21.3768;
  7. the BVH4 traversal kernel against its plain version
     (`accel.traverse.closest_bvh`), both on the card, at two scales: the
     tree of `cornell_box_obj` (20,007 primitives) and the dragon stand-in
     (`bumpy_blob(871_414)` as the dragon scene places it, 871,200
     triangles); 262,144 rays each, half camera rays and half incoherent
     rays from their hit points (directions from a seeded
     torch.Generator); equal hit masks, t within 1e-6 relative, equal
     primitives but on exact-t ties (at most 1e-5 of the rays), per-ray
     (nodes popped, primitives tested) equal to the plain version's; build
     seconds, nodes, kernel and plain times and the bound;
  8. the queue pool through the kernel against the queue pool through the
     plain traversal, both on the card: `cornell_box_obj` 32×32 at 4 spp,
     depth 50, within phase 4's tolerances, one traversal launch a pool
     body run (its CUDA graph's replays and its warm-up body); then the
     RGB megakernel's BVH form (`izpi_megakernel_rgb_bvh`: the traversal
     of csrc/bvh4.cuh inside the megakernel's loop) against its plain
     version (`megakernel.render_slots_reference` through the plain
     traversal), both on the card, the plain version on the card's
     layout, on `cornell_box_obj` at 32×32@4 and 64×64@64 (every thread
     several slots), depth 8: rays equal and phase 4's pixel tolerances,
     with the launch's nodes popped and primitives tested a ray; both
     timed at 256×256@2, depth 50, with the kernel's bound there;
  9. BVH main path: `render(cornell_box_obj(), 256, 256, 128,
     max_depth=50, seed=0, mode="wavefront", device="cuda")` through the
     RGB megakernel's BVH form, one warm-up and one timed run, the timed
     run's launch between CUDA events; every counter zeroed before the
     warm-up: the BVH form's must read 2 and every other 0 (no traversal
     launch, no pool replay), the runs must agree bit for bit, the image
     must be finite, green on the left, red on the right, with the ceiling
     light at 15; one more launch with the draw and traversal counter
     buffers must repeat the image and rays, and gives the bound and the
     nodes and tests a ray beside phase 7's. Then the same render in mode
     "pool" (the graphed queue pool through the BVH4 kernel): one warm-up
     run (which captures the pool's iteration as a CUDA graph) and one
     timed run (which replays it: no capture, every pool body a replay);
     the traversal kernel's counter (executed launches: the capture's
     launches times the replays) must equal the replays, with the pool
     iterations beside them, the new-sample form must have launched and
     the megakernels' counters must not move; its image passes the same
     checks, and against the BVH form's its rays must be equal and its
     pixels within phase 4's tolerances, both seconds and Mrays/s on one
     line; the cipher entry at each (form, keys, uniforms) shape the timed
     pool render launched it with (the captured body's calls once a
     replay): its launches, its time per launch alone, its bound and its
     plain version's time; then L (below) on its frame, whose plain loop
     gives the traversal kernel's time per launch (CUDA events) and so its
     share of `render()`, and whose profile at 16 spp the device's idle
     share;
 10. the row-stack traversal kernel (`ops.bvh_rowkernel`, one warp per 32
     rays) against its plain version (`bvh_rowkernel.closest_rows`), both
     on the card, on the leaf-64 trees of `cornell_box_obj`, of the dragon
     stand-in (phase 7's rays) and of the dragon scene its main path runs
     (262,144 rays on phase 7's recipe from the dragon's camera), the rays
     in their order, as its intersector hands them over: equal hit masks,
     t within 1e-6 relative, equal block slots but on exact-t ties (at most
     1e-5 of the rays), equal per-warp counters (nodes popped, leaf blocks
     tested, (ray, primitive) pairs tested); and against the BVH4
     traversal kernel's hits on the same rays (equal hit masks, t within
     1e-6 relative); build seconds, nodes and blocks, the kernel's time and
     the warps' work (totals, 99th percentile and longest warp) on these
     rays and on the same rays sorted by the JAX intersector's coherence
     key, the plain time, the bound (from the work each ray alone needs on
     the tree: the per-ray traversal's counts) and the warps' own work
     beside it;
 11. the dragon (`cornell_box_pbr_stanford_dragon_spectral()`: the
     871,200-triangle stand-in, the walls, the light and a glass sphere,
     porcelain PBR) through the queue pool at 32×32, 4 spp, depth 16, once
     with the row-stack pair (`bvh_rowkernel.attach`) and once with the
     BVH4 kernel, both on the card, within phase 4's ray and XYZ
     tolerances;
 12. the dragon main path: `render(dragon, 256, 256, 8, max_depth=16,
     seed=0, mode="wavefront", device="cuda")`, a warm-up and a timed run
     through the BVH4 kernel (the default intersector), then a warm-up and a
     timed run through the row-stack pair in a RenderContext; each
     traversal kernel's counter must equal its run's pool bodies (the
     timed run's: its replays) and nothing else may launch; L (below)
     through each; XYZ and ACEScg finite, the red wall (x =
     100, on the image's left: the camera's horizontal axis points to -x)
     red and the green wall (x = 0, right) green, the mesh region not
     black (mean Y above 1e-3); the two renders agree within phase 4's tolerances; rays,
     seconds, Mrays/s, iterations, each kernel's share of `render()` (its
     time per launch from L's plain loop) and the device's idle share (L's
     profile at 8 spp). The mesh region is the pixels whose centre's camera
     ray first hits the porcelain; the stand-in's triangles face inward, so
     only its rim and what the glass sphere throws on it are lit. The
     dragon's meta must flag its stand-in mesh (`placeholder_assets`),
     which the phase prints;
 13. Shirley's `random_scene` (485 spheres, moving ones among them, a
     checker ground of radius 1000, a thin lens) through the RGB
     megakernel: the kernel against its plain version (the card's layout)
     under the sky (0.7, 0.8, 1.0) at 64×64@4 depth 8 seed 3 and at phase
     4's multi-sample layout (128×128@128 depth 8 seed 7, every slot
     regenerating its thin-lens ray and time for a next sample), rays
     equal and phase 4's pixel tolerances; then
     bench.py's `shirley`, `render(random_scene(1.0), 256, 256, 128,
     max_depth=50, background=(0.7, 0.8, 1.0))`, a warm-up and a timed run
     (the counters zeroed just before the timed run: one megakernel launch
     and nothing else), the image finite with the sky at its top, seconds,
     rays, Mrays/s, the kernel's ms per launch (CUDA events), its bound from
     a launch with the draw counter buffer and its share; and the engine
     policy: the same render through the queue pool and the BVH4 kernel
     (`use_bvh=True`), its seconds beside the megakernel's, rays, mean and
     pixels within phase 4's tolerances;
 14. `pbr_ibl` (PBR spheres with image maps through the combined stack,
     under an image-lit sky dome) through the queue pool: the card
     against the CPU at 16×16@4 depth 16, rays and means within phase 4's
     tolerances and 99% of the pixels within 1e-4 + 1e-5·|CPU|; then
     bench.py's `pbr_ibl`, 256×256@256 depth 16, a warm-up and a timed run
     (counters zeroed just before: the cipher entry launched, nothing
     else), the sky above, the ground below and the spheres lit, pool
     iterations, the cipher entry's launches, its time alone, bound and
     plain time at each shape the timed run launched it with (as in phase
     9), and L (below) with its profile at 16 spp;
 15. the book-2 final scene (3,407 primitives, a smoke ball and a fog of
     radius 5000 as media, an image and a marble texture, a moving sphere)
     through the pool and the BVH4 kernel: the kernel against its plain
     version on its tree (phase 7's ray recipe from its camera), then
     256×256@16 depth 50, a warm-up and a timed run (counters zeroed just
     before: the traversal kernel's launches equal the pool bodies run, the
     cipher entry's and nothing else), the cipher entry at each shape as in
     phase 14 (the media's two uniforms a ray among them), and L (below),
     which gives the kernel's ms per launch and share. Its light faces up (one-sided on its
     record normal, as in the JAX package), so red and green must be 0 and
     some blue (the depth-cap sentinel) must show. Then the card against
     the CPU at 64×64@4, seed 0: rays within 0.5% and 99% of the pixels
     within 1e-4 + 1e-5·|CPU|.
 16. the training step (`parallel.dist.build_train_step`, the
     differentiable sample pass, 1 spp, seed 0) on `cornell_box()` (13
     primitives, brute force) at 256×256, depth 50, as one CUDA graph
     (`core.loops.Graphed`, the default on the card) on the fused route
     (`ops.diff_trace`, the default for the scene): the checkpointed
     bounces' fixed trip against the early-exit form (equal rays, 50
     bounces each) and the fused forward's launches (the new-sample cipher
     and the forward kernel once each); the fused route's kernels
     (`csrc/diff_trace.cu`) against their plain versions at the step's
     camera rays: the forward kernel within phase 4's tolerances, the
     paths that take the same branches (at least PIXEL_SHARE of them)
     with records within rtol 1e-4, the fused reverse (its table
     gradient, two launches and no slot) on the plain forward's records at
     the step's own cotangent bit for bit G's on the plain version's slots
     (`reverse_reference`: one slot a record, their count on the device
     equal to the rays), G on those slots and count against its plain
     version on the counted slots (the float64 sum
     within the kernel's bound, the plain version within that plus f32
     summation's, two launches and the rows in another order bit for
     bit; its ms beside `index_put_`'s and `index_add_`'s); each kernel's
     ms beside its plain version's and its bound (the forward's from the
     SASS probes' units and its bytes, the reverse's by bytes, beside R's
     and G's bounds before they were fused); the
     target is the colour render at the true parameters, 256×256@64; from
     tex_c0 at 0.7 of its values, five steps of plain gradient descent
     (every parameter, rate 1) through the captured step, each printing
     its loss, seconds (CUDA-synchronised; the first call warms up and
     captures, the median of the last four), launches and
     `torch.cuda.max_memory_allocated`; every gradient finite and the loss
     after the five steps below step 0's; a replay launches the
     new-sample cipher, the forward kernel and the reverse once each and
     nothing else, G no time (the cipher's bounce form no time: its counter
     less the new-sample form's), the forward's launch carrying one sample
     pass (`diff_trace.fwd_passes`); the capture's seconds and the MiB its
     graph holds; the captured step at STEP_SPP samples a pixel, whose
     replay launches the same kernels once each, the forward's launch
     carrying its STEP_SPP passes (one launch a step, not one a pass), its
     seconds, capture seconds and graph MiB, and its rays, loss and
     gradients bit for bit those of the same step run eagerly a sample
     pass at a time; the kernels as that step launches them
     (`merged_kernel_phase`): each pass's slice of the forward's one
     launch bit for bit the launch on that pass's rays alone and within
     phase 4's tolerances of the plain version, each pass's table of the
     reverse's one call bit for bit G's on that pass's plain slots, and
     the merged launch's and call's ms beside STEP_SPP launches and calls
     of a pass; the eager step on the same route in the same call, its
     seconds beside the captured step's, two replays bit for bit, and the
     captured step held to the eager one (equal rays, the tolerances of
     tests/test_torch_grad.py); the checkpointed bounces' captured step
     in the same call (a replay launches the cipher entry 51 + 50 times
     and G): its seconds, and the fused step held to it (equal rays and
     losses, every gradient within G's tolerances, rtol 1e-5 and atol
     1e-6·max|g|); a replay under
     torch.profiler (its device records, which must name the forward
     kernel and the reverse's two passes once each, and no G and no
     bounce-form cipher, and its idle
     share); the memory at depth 8 and 50 of the eager step (peak above
     its start) and of the graph, whose growth a bounce must each stay
     within twice one checkpointed bounce's carried state; and the card's
     captured step against the CPU's at 32×32, depth 8 (equal rays, the
     tolerances above);
 17. the same on `cornell_box_obj` (20,007 primitives) at 256×256, depth
     50, through its BVH4: the forward kernel's BVH form against its plain
     version through the plain traversal at 64×64 (phase 16's checks, the
     merged kernels' too;
     its bound from the nodes and tests of its traversal, counted by the
     BVH4 kernel on the same rays), the captured fused step (a replay:
     the new-sample cipher, the two kernels once each, G and the BVH4
     kernel no time), its seconds, capture and graph MiB, the eager step
     in the same call, two replays bit for bit, captured against eager;
     the checkpointed captured step (the BVH4 kernel 50 + 50, the cipher
     entry 51 + 50) beside it and the fused step held to it likewise; at
     64×64 the fused captured step against the checkpointed step through
     the plain traversal (`accel.traverse.intersect_bvh`, which syncs, so
     eager) on the card: equal rays, the tolerances above;
 18. the command line: `python -m izpi_tpu_torch --output-file a.png` (the
     default: the spectral pyramid, 500×500@1000, depth 50, through the
     spectral megakernel) in a subprocess, and again with `--output-mode
     exr --output-file b.exr` in a subprocess that prints the launch
     counters after the run (one spectral megakernel launch and nothing
     else); both files read back with the port's reader, the PNG within
     one 8-bit step of the EXR's gamma-2 clamped image; the same render in
     process in chunks of 250 samples with a checkpoint, the 500-sample
     state written back and resumed: every resumed pixel within
     1e-4 + 1e-5·|EXR|, equal rays; `--sampler albedo|normal|wireframe` on
     `cornell_box_obj` at 256×256@4 through the BVH4 kernel (4 launches),
     each within 1e-4 of the same AOV through the plain traversal on the
     card on 99% of the pixels; `--scene cornell_box --sampler spectral` at
     256×256@16 (the spectral pool on an RGB scene), timed, and the same
     path at 64×64@4 on the card against the CPU within phase 4's
     tolerances. Each render's seconds and Mrays/s are printed.
  L. the pool's loop (`core.loops`) at each pool main path's frame
     (phases 9, 12, 14 and 15: `cornell_box_obj` 256²@128 depth 50, the
     dragon 256²@8 depth 16 through each traversal kernel, `pbr_ibl`
     256²@256 depth 16 and `final` 256²@16 depth 50): the pool through the
     plain loop (the same body, the end tested after every iteration, no
     graph) and through the graphed loop (the context's CUDA graph from
     the main-path render, replayed every `wavefront.pool_chunk`
     iterations between tests of the end): rays and iterations equal,
     pixels (XYZ for the dragon) within phase 4's tolerances; for each, its
     seconds, Mrays/s, iterations, bodies run, replays, chunk and capture
     seconds, the MiB the graph's capture added to
     `torch.cuda.memory_reserved`, and under torch.profiler at a frame of
     the same pool size its device events per iteration and the device's
     idle share; in each profile the launches of the body's kernels
     (`bvh4_traverse` or `bvh4_rowstack`, `bounce_tiles`,
     `new_sample_tiles`), counted by name, must equal the bodies run times
     the launches the graph's capture recorded a body (the new-sample form
     once more for the pool's first issue): the replays are seen to run
     the kernels, not only worked out from the capture.
Then the distribution phases (`parallel.dist`), each on the one card with
four gloo ranks that share it (`dist.spawn`, a process a rank; NCCL
refuses two ranks on one card) unless it says otherwise, each rank's
launch counters zeroed just before its part and read just after, every
phase printing its seconds per rank and the spawn's wall, its backend,
rank count, peak memory a rank, each rank's all-reduces (count, MiB and
seconds between card syncs, which gloo spends through the host) and the
card:
 D1. `render_distributed(cornell_box_obj(), 256, 256, 128, max_depth=50)`,
     32 samples a rank through the pool, the BVH4 kernel and the cipher
     entry on every rank: rays equal to phase 9's one-process pool render,
     pixels within atol/rtol 1e-4 (and PERF.md §2's gate); then the same
     render on a group of one rank through NCCL: rays equal and every pixel
     within WS1_ATOL + WS1_RTOL·|b| (the bound of the pool's float-atomic
     deposits, before its deposit became a segment sum in a fixed order;
     it prints how far two runs of one process differ, now 0);
 D2. the RGB megakernel sample-sharded (`dist.build_mega_renderer`),
     Cornell 256²@1024, depth 50, 256 samples a rank, one launch a rank:
     rays equal to phase 5's single launch, §2's gate;
 D3. the dragon scene (871,213 primitives) primitive-sharded, four shards
     of ~218k with a BVH4 each through the BVH4 kernel, 256²@8 depth 16:
     rays equal to phase 12's render through the BVH4 kernel, its XYZ
     after firefly rejection within phase 4's XYZ tolerances; each
     shard's primitives and nodes, and its kernel launches;
 D4. `pbr_ibl` primitive- and texture-sharded, 256²@64 (its main path's
     256 samples cut to 64), depth 16, against the same render in one
     process: rays equal, §2's gate;
 D5. the training step (Cornell 256², depth 50, 1 spp, its true
     parameters against a black target) with the pixels split over four
     ranks, two steps (the first also loads the backward's kernels):
     loss within 1e-5 relative and each gradient within 1e-4·max|g| of
     the one-process step; seconds and peak memory a rank;
 D6. the command line: `--role leader` and `--role worker --process-id 1`
     with `--coordinator 127.0.0.1:<port> --num-processes 2` render the
     default pyramid at 500²@8 (1000 samples cut to 8) into an EXR; the
     summary line must name gloo and the worker write nothing. The
     leader's XYZ canvas before firefly rejection (taken from its process
     as the CLI hands it on) must equal `render_distributed`'s at world
     size 1 (NCCL) within atol/rtol 1e-4 with rays equal, and its image
     pass §2's gate; it prints the largest difference in float32 ulps, and
     how many of the pixels that differ by more than 1e-4 after the
     post-pass firefly rejection scaled;
 and `entry.dryrun_multichip(4)`, whose ranks must launch the BVH4
 kernel, the cipher entry and one RGB megakernel each.
The build line is followed by the ptxas registers and spills of every
kernel (the RGB and spectral megakernels must not spill; the BVH form's
spill, which its launch bounds accept, is printed), each megakernel's
persistent grid (blocks × threads) and slots, and the two traversal
kernels' registers, spills, stack frame and shared memory per block, which
phases 7, 10, 11 and 12 print again. Phase 3 prints the instructions of
each unit of the megakernels' work from the SASS of its probe
(csrc/sass_probes.cu: a Threefry call, a primitive test of each kind, a
BVH4 node visit), from which the megakernels' bounds are counted: the
units a launch ran (its counter buffers) times their instructions, the
integer ALU ones over the INT32 pipe and all of them over the issue
rate. The line before the last is a JSON object describing the
kernels (the two megakernels and the RGB one's BVH form, the two
traversal kernels, the cipher entry's two forms, G, the fused route's
forward and reverse kernels, and the step's CUDA graph), each with its time,
its plain version's time and its bound (the least time the card could
take for the work this run's inputs needed); the last is {"ok": true,
"device": {...}}. A "time:" line after each phase gives the seconds since
the run started. Any failure, in this process or in a rank, raises and
exits non-zero. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import measure_port
from h100bench import harness
from izpi_tpu_torch import camera, entry, ops, profiling
from izpi_tpu_torch.accel import traverse
from izpi_tpu_torch.core import loops, rng
from izpi_tpu_torch.geometry import primitives, procedural
from izpi_tpu_torch.integrator import path, wavefront
from izpi_tpu_torch.io import output
from izpi_tpu_torch.materials import tables as mat_tables
from izpi_tpu_torch.core import vecmath as vm
from izpi_tpu_torch.ops import (_build, bvh_kernel, bvh_rowkernel, diff_trace,
                                megakernel, megakernel_spectral, table_grad,
                                threefry)
from izpi_tpu_torch.parallel import dist
from izpi_tpu_torch.render import checkpoint, renderer
from izpi_tpu_torch.scene import compiler
from izpi_tpu_torch.scene import types as scene_types
from izpi_tpu_torch.scene.library.cornell import cornell_box
from izpi_tpu_torch.scene.library.cornell_spectral import (
    cornell_box_pyramid_spectral)
from izpi_tpu_torch.scene.library.extracted import (
    cornell_box_pbr_stanford_dragon_spectral)
from izpi_tpu_torch.scene.library.misc import cornell_box_obj, pbr_ibl
from izpi_tpu_torch.scene.library.shirley import final, random_scene
from izpi_tpu_torch.spectral import cie, convert

# Phase 4 tolerances. A tolerance at all because libdevice transcendentals
# and torch's reciprocal-multiply for division by a Python scalar on the card
# round differently in the last ulp from the kernel, which can flip a rare
# branch of a path.
RAYS_RTOL = 0.005      # ray counts within 0.5%
PIXEL_ATOL = 1e-4      # a pixel agrees when every channel is within this
PIXEL_SHARE = 0.99     # share of pixels that must agree
MEAN_RTOL = 0.005      # image means within 0.5%
# The spectral kernel's XYZ reaches ~321 at the light, where an f32 ulp is
# ~3e-5, so its pixels agree when every channel is within
# XYZ_ATOL + XYZ_RTOL·|plain|.
XYZ_ATOL = 1e-4
XYZ_RTOL = 1e-5

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): 67 TFLOP/s
# of FP32 counts an FMA as two operations; the kernels are built with
# -fmad=false, so they issue separate multiplies and adds at half that rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2

# Operations per thread, counted from the CUDA sources (common.cuh and the
# kernels), for the work the SASS probes do not cover (the megakernels'
# shading, camera, uniforms and deposit; the traversal kernels' primitive
# tests): FP32 adds, multiplies, divisions, square roots, comparisons,
# selects and libdevice calls count one each; INT32 adds, shifts and
# compares likewise.
UNIFORM_INT, UNIFORM_FP = 2, 1   # bits_to_uniform: shift, or | subtract
PRIM_FP = {0: 58, 1: 56, 2: 56}  # closest-hit test per triangle, rect, sphere
SCATTER_FP = 80          # the cheapest scattering bounce (a dielectric), NEE left out
CAMERA_FP = 46           # thin-lens ray from 5 uniforms
CAMERA_CIPHER = 7        # path key (2 fold-ins), camera key (2), 3 pairs
SPECTRAL_SAMPLE_FP = 20 + 11 + 51   # λ sampling, background SPD, XYZ deposit
SPECTRAL_SAMPLE_INT = 30            # λ sampling's binary search
RGB_SAMPLE_FP = 9        # RGB deposit: DeNAN and add, three channels
# Phase 4's layouts at which every thread of the persistent grid serves
# several slots, and at which besides every slot serves several samples:
# (n, spp, depth, seed, offset).
MULTI_SLOT = (64, 64, 8, 5, 0)
MULTI_SAMPLE = (128, 128, 8, 7, 0)
# Phase 8's checks of the RGB megakernel's BVH form on cornell_box_obj:
# (n, spp, depth, seed); at the second every thread serves several slots.
BVH_FORM_CHECKS = ((32, 4, 8, 0), (64, 64, 8, 5))
# The traversal kernel (csrc/bvh4_traverse.cu), per node popped: 4 children ×
# 3 axes × (2 subtractions, 2 multiplications, fminf, fmaxf, fmaxf, fminf),
# 4 hit comparisons and the 5 compares of the sorting network; per ray the 3
# guarded reciprocals of the direction. A leaf primitive costs PRIM_FP of
# its kind; the counter does not tell kinds apart, so the bound takes the
# cheapest.
VISIT_FP = 4 * 3 * 8 + 4 + 5
RAY_FP = 3 * 3
# The row-stack kernel (csrc/bvh4_rowstack.cu), per node a ray needs: the
# same slab test and 4 hit comparisons, no sort. Its bound counts the nodes
# and primitives each ray alone needs on the leaf-64 tree (the per-ray
# traversal over the same tables, walked in chunks of PER_RAY_CHUNK rays),
# not the union its warp walks.
ROW_VISIT_FP = 4 * 3 * 8 + 4
PER_RAY_CHUNK = 1 << 16
# Phase 7: traversal rays per scale (the main path's pool size), and the
# share of them allowed to pick another primitive at an exactly equal t.
TRAVERSE_RAYS = 1 << 18
T_RTOL = 1e-6
# Phase 12: the dragon main path, bench.py's `dragon` (bench.py:41-42).
DRAGON_SIZE, DRAGON_SPP, DRAGON_DEPTH = 256, 8, 16
TIE_SHARE = 1e-5
# Phases 13-15: bench.py's `shirley` (random_scene under its sky) and
# `pbr_ibl` (bench.py:39-45), and the book-2 final scene.
SKY = (0.7, 0.8, 1.0)
SHIRLEY_SIZE, SHIRLEY_SPP, SHIRLEY_DEPTH = 256, 128, 50
IBL_SIZE, IBL_SPP, IBL_DEPTH = 256, 256, 16
FINAL_SIZE, FINAL_SPP, FINAL_DEPTH = 256, 16, 50
# Phase 15: the frame (n, spp) of final's card-vs-CPU render.
FINAL_VS_CPU = (64, 4)
REPO = os.path.dirname(os.path.abspath(__file__))
START = [time.perf_counter()]


def mark(label: str) -> None:
    """Print the seconds since the run started, after `label`: the run must
    end within its time limit, and these lines say where the time went."""
    print(f"time: {label} done at {time.perf_counter() - START[0]:.1f} s",
          flush=True)


def zero_counts() -> None:
    ops.zero_launch_counts()


def read_counts() -> dict:
    """{kernel: launches} of every counter (`ops.KERNEL_COUNTERS`)."""
    return ops.kernel_launches()


def launch_bound(label: str, rays: int, samples: int, draws, prim_kinds,
                 spectral: bool, lay: dict, table_bytes: int, card: str,
                 traversal=None):
    """The bound of one megakernel launch (`sass_bound_ms`) from its draw
    counts (scatters, bounce pairs) and, for the BVH form, its traversal
    counts (nodes popped, primitives tested); the outputs are the layout's
    per-slot sums and ray counts. Prints it and returns a dict of the
    numbers."""
    scatters, pairs = (int(x) for x in draws)
    trav = None if traversal is None else tuple(int(x) for x in traversal)
    bound, by, what = sass_bound_ms(rays, samples, prim_kinds, spectral,
                                    lay["slots"] * 16, table_bytes,
                                    (scatters, pairs), trav)
    walk = ("" if trav is None else
            f", {trav[0]} nodes popped and {trav[1]} primitives tested "
            f"({trav[0] / rays:.4f} and {trav[1] / rays:.4f} a ray)")
    print(f"bound: {label}: {rays} rays, {samples} samples, {scatters} "
          f"scatters drawing {pairs} pairs ({pairs / max(scatters, 1):.4f} a "
          f"scatter){walk}: {bound:.4f} ms by {what} (SASS) ({card})",
          flush=True)
    out = dict(bound_ms=bound, bound_by=by, scatters=scatters, pairs=pairs)
    if trav is not None:
        out.update(nodes=trav[0], tests=trav[1])
    return out


@contextlib.contextmanager
def recorded_cipher_calls():
    """Within the block, record each call of the cipher entry's wrappers
    (`threefry.uniforms_for_keys`, `threefry.new_samples`) as (form, keys,
    uniforms) in the dict it yields: under "captured" the calls a CUDA
    graph capture recorded (the pool's body, launched once a replay),
    under "eager" the others (one launch each)."""
    rec = {"eager": [], "captured": []}
    uniforms, new = threefry.uniforms_for_keys, threefry.new_samples

    def note(call):
        rec["captured" if torch.cuda.is_current_stream_capturing()
            else "eager"].append(call)

    def recording_uniforms(keys, depths, n, salt):
        note(("bounce", int(keys.shape[0]), n))
        return uniforms(keys, depths, n, salt)

    def recording_new(base_key, pixel_ids, sample_ids, camera_salt=None,
                      lambda_salt=None):
        note(("new_sample", int(pixel_ids.shape[0]),
              5 * (camera_salt is not None) + (lambda_salt is not None)))
        return new(base_key, pixel_ids, sample_ids, camera_salt, lambda_salt)

    threefry.uniforms_for_keys = recording_uniforms
    threefry.new_samples = recording_new
    try:
        yield rec
    finally:
        threefry.uniforms_for_keys, threefry.new_samples = uniforms, new


def executed_cipher_calls(warm: dict, timed: dict, replays: int) -> list:
    """The cipher launches of a render whose pool replayed, `replays`
    times, the body the warm-up render captured: its own eager calls and
    the captured body's calls once a replay."""
    return timed["eager"] + warm["captured"] * replays


def cipher_launcher(form: str, n_keys: int, n_u: int, seed: int = 3):
    """(launch, plain) of the cipher entry's `form` ("bounce": n_u
    uniforms a key; "new_sample": the path key, with n_u = 5 the camera's
    uniforms, with 6 λ's too) on n_keys random keys: launch() calls the C
    entry on the stream current at the call (int64 words, as the wrappers
    hand them over), plain() the plain version on the same inputs."""
    lib = _build.load()
    rs = np.random.RandomState(seed)
    words = torch.as_tensor(rs.randint(0, 2**32, (n_keys, 3), dtype=np.uint64)
                            .astype(np.int64), device="cuda")

    def check(err, name):
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    if form == "bounce":
        keys, depths = words[:, :2].contiguous(), words[:, 2].contiguous()
        out = torch.empty((n_keys, n_u), dtype=torch.float32, device="cuda")

        def launch():
            check(lib.izpi_threefry_uniforms(
                keys.data_ptr(), depths.data_ptr(), n_keys, n_u, 0,
                out.data_ptr(), stream()), "izpi_threefry_uniforms")

        return launch, lambda: threefry.uniforms_for_keys_reference(
            keys, depths, n_u, 0)
    base = words[0, :2].contiguous()
    pix, sid = words[:, 1].contiguous(), words[:, 2].contiguous()
    keys = torch.empty((n_keys, 2), dtype=torch.int64, device="cuda")
    cam = (torch.empty((n_keys, 5), dtype=torch.float32, device="cuda")
           if n_u >= 5 else None)
    lam = (torch.empty((n_keys,), dtype=torch.float32, device="cuda")
           if n_u == 6 else None)
    salts = (camera.CAMERA_SALT, wavefront.LAMBDA_SALT)[:{0: 0, 5: 1, 6: 2}[n_u]]

    def launch():
        check(lib.izpi_threefry_new_sample(
            base.data_ptr(), pix.data_ptr(), sid.data_ptr(), 0, n_keys,
            camera.CAMERA_SALT, wavefront.LAMBDA_SALT, keys.data_ptr(),
            None if cam is None else cam.data_ptr(),
            None if lam is None else lam.data_ptr(), stream()),
            "izpi_threefry_new_sample")

    return launch, lambda: threefry.new_samples_reference(base, pix, sid,
                                                          *salts)


def cipher_calls(form: str, n_u: int) -> int:
    """Cipher calls a key of the cipher entry's form: a bounce draw's two
    fold-ins and a pair for two uniforms; a new sample's two fold-ins of
    the path key, then the camera's (two fold-ins and 3 pairs) and λ's
    (one more fold-in and a pair)."""
    if form == "bounce":
        return 2 + (n_u + 1) // 2
    return 2 + (5 if n_u >= 5 else 0) + (2 if n_u == 6 else 0)


# The integer ALU instructions of the SASS (the INT32 pipe: 64 lanes an SM);
# every instruction issues at 4 warps an SM a clock (128 lanes).
SASS_INT_ALU = {"IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL", "IMNMX", "PRMT",
                "IABS", "POPC", "FLO", "BREV", "SGXT", "BMSK", "LOP", "IADD",
                "SHL", "SHR"}
CLOCK_HZ = 1.98e9
# The cipher entry's kernels by form (their mangled names hold these), and
# the keys each thread takes a tile (csrc/cipher.cu kKeysPerThread).
CIPHER_KERNELS = {("bounce", 12): "bounce_tilesILi12E",
                  ("bounce", 5): "bounce_tilesILi5E",
                  ("bounce", 1): "bounce_tilesILi1E",
                  ("new_sample", 0): "new_sample_tilesILb0ELb0E",
                  ("new_sample", 5): "new_sample_tilesILb1ELb0E",
                  ("new_sample", 6): "new_sample_tilesILb1ELb1E"}
KEYS_PER_THREAD = 2
# {kernel's mangled name: {opcode: instructions}} of the built library's
# and the SASS probes' SASS, and of each kernel's main path; phase 3 fills
# them.
SASS = {}
SASS_MAIN = {}


def start_probe_build():
    """Start nvcc on the SASS probes (csrc/sass_probes.cu, not part of the
    library) with the library's flags, into a cubin beside it; returns
    (cubin path, the nvcc process)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "sass_probes.cubin"
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-cubin",
         str(_build.CSRC / "sass_probes.cu"), "-o", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc


def sass_counts(lib_path):
    """({kernel's mangled name: {opcode: instructions}} of the library's
    SASS (`cuobjdump -sass`, beside nvcc), the same of each kernel's main
    path: its instructions up to its first unpredicated EXIT, without the
    subroutines placed after it, such as the slow paths of IEEE division
    and square root, which run only on special operands)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    out, main, name, ended = {}, {}, None, False
    for line in text.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            name, ended = m.group(1), False
            out[name], main[name] = {}, {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                     line)
        if m and name:
            op = m.group(2)
            out[name][op] = out[name].get(op, 0) + 1
            if not ended:
                main[name][op] = main[name].get(op, 0) + 1
                ended = op == "EXIT" and m.group(1) is None
    return out, main


def _sass_per_key(form: str, n_u: int):
    """(integer ALU, all) instructions a key of the form's kernel in
    `SASS`: its tile's straight-line code runs once per thread for
    KEYS_PER_THREAD keys. A bounce width that the entry counts at run time
    (its pair loop's trip count is data, not code) takes the 12-uniform
    form's instructions a cipher call, times its own cipher calls."""
    if (form, n_u) not in CIPHER_KERNELS:
        if form != "bounce":
            raise ValueError(f"no kernel of the {form} form draws {n_u}")
        alu, total = _sass_per_key("bounce", 12)
        scale = cipher_calls(form, n_u) / cipher_calls("bounce", 12)
        return alu * scale, total * scale
    tag = CIPHER_KERNELS[(form, n_u)]
    fn = next((c for k, c in SASS.items() if tag in k), None)
    if fn is None:
        raise AssertionError(f"no kernel {tag} in the library's SASS")
    alu = sum(n for op, n in fn.items() if op in SASS_INT_ALU)
    return alu / KEYS_PER_THREAD, sum(fn.values()) / KEYS_PER_THREAD


def cipher_bound(form: str, n_keys: int, n_u: int):
    """The least milliseconds of the cipher entry's form on n_keys keys,
    counted from the SASS that `cuobjdump -sass` shows (`SASS`): per key
    its integer ALU instructions over the INT32 pipe's lanes, or all its
    instructions over the issue rate (both "operations"), or its bytes
    (each input read once, each output written once) over the memory rate
    ("bytes"), whichever is larger. Returns (ms, bound_by, what bounds it
    in words, (integer ALU, all) instructions a key)."""
    per_key = _sass_per_key(form, n_u)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_alu = n_keys * per_key[0] / (64 * sms * CLOCK_HZ)
    t_issue = n_keys * per_key[1] / (128 * sms * CLOCK_HZ)
    nbytes = (16 + 8 + 4 * n_u) if form == "bounce" else (32 + 4 * n_u)
    t_bytes = n_keys * nbytes / HBM_BYTES_PER_S
    t = max(t_alu, t_issue, t_bytes)
    what = ("integer ALU instructions" if t == t_alu else
            "issued instructions" if t == t_issue else "bytes")
    return 1e3 * t, "bytes" if t == t_bytes else "operations", what, per_key


# The SASS probes (csrc/sass_probes.cu), one unit of the megakernels' work
# each, by a tag their mangled names hold; "empty" is taken from the others.
PROBES = {"empty": "probe_empty", "cipher": "probe_cipher",
          "prim0": "probe_primILi0EE", "prim1": "probe_primILi1EE",
          "prim2": "probe_primILi2EE", "visit": "probe_visit"}


def unit_instructions() -> dict:
    """{unit: (integer ALU, all) instructions} of each SASS probe's main
    path in `SASS_MAIN` (a probe's slow-path subroutines, run only on
    special operands, are left out), less probe_empty's (its store and
    exit). Units: "cipher" (one threefry2x32), "prim0"/"prim1"/"prim2" (a
    triangle, rect, sphere test, with the loads of its 13 words), "visit"
    (a BVH4 node's load, slab test and push, without its leaf tests)."""
    def counts(tag):
        fn = next((c for k, c in SASS_MAIN.items() if tag in k), None)
        if fn is None:
            raise AssertionError(f"no kernel {tag} in the probes' SASS")
        return (sum(n for op, n in fn.items() if op in SASS_INT_ALU),
                sum(fn.values()))

    base = counts(PROBES["empty"])
    return {unit: tuple(max(a - b, 0) for a, b in zip(counts(tag), base))
            for unit, tag in PROBES.items() if unit != "empty"}


def sass_bound_ms(rays: int, samples: int, prim_kinds, spectral: bool,
                  out_bytes: int, table_bytes: int, draws, traversal=None):
    """The least milliseconds of a megakernel launch, its units' instructions
    counted from the SASS (`unit_instructions`): the integer ALU ones over
    the INT32 pipe (64 lanes an SM a clock), all of them over the issue
    rate (128), or the bytes (the tables read once, the outputs written
    once) over the memory rate, whichever is largest. Returns (ms,
    "operations" or "bytes", what bounds it in words).

    Units counted from this run's counter buffers: the cipher calls of the
    draws (`draws`: each scatter ciphers its two fold-ins and the pairs its
    material and branch read, two uniforms a pair; each sample its camera
    ray's CAMERA_CIPHER calls and 5 uniforms, and a spectral sample's λ two
    calls more and one uniform); the primitive tests, every
    ray against every primitive (brute force) or, with `traversal` (the
    BVH form's nodes popped and primitives tested), the tests it ran at
    the cheapest kind's instructions (the counter does not tell kinds
    apart) and its node visits. Shading, the camera, the uniforms'
    conversion, the deposit and a traversal's three reciprocals a ray keep
    their source counts (the constants above), as instructions of the
    issue rate."""
    units = unit_instructions()
    scatter, pairs = draws
    cipher = 2 * scatter + pairs + (CAMERA_CIPHER + 2 * spectral) * samples
    uniforms = 2 * pairs + (5 + spectral) * samples
    if traversal is None:
        prim = [sum(units[f"prim{int(k)}"][i] for k in prim_kinds) * rays
                for i in (0, 1)]
        visit = [0, 0]
    else:
        nodes, tests = traversal
        cheapest = min({int(k) for k in prim_kinds},
                       key=lambda k: units[f"prim{k}"][1])
        prim = [units[f"prim{cheapest}"][i] * tests for i in (0, 1)]
        visit = [units["visit"][i] * nodes + (rays * RAY_FP if i else 0)
                 for i in (0, 1)]
    alu = (cipher * units["cipher"][0] + prim[0] + visit[0]
           + uniforms * UNIFORM_INT + spectral * samples * SPECTRAL_SAMPLE_INT)
    issued = (cipher * units["cipher"][1] + prim[1] + visit[1]
              + uniforms * (UNIFORM_INT + UNIFORM_FP) + scatter * SCATTER_FP
              + samples * CAMERA_FP
              + samples * (SPECTRAL_SAMPLE_FP + SPECTRAL_SAMPLE_INT
                           if spectral else RGB_SAMPLE_FP))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_alu = alu / (64 * sms * CLOCK_HZ)
    t_issue = issued / (128 * sms * CLOCK_HZ)
    t_bytes = (out_bytes + table_bytes) / HBM_BYTES_PER_S
    t = max(t_alu, t_issue, t_bytes)
    what = ("integer ALU instructions" if t == t_alu else
            "issued instructions" if t == t_issue else "bytes")
    return 1e3 * t, "bytes" if t == t_bytes else "operations", what


def cipher_forms(card: str) -> list:
    """Phase 3's timing of every form of the cipher entry at the pool's
    batch (262,144 keys) and at 1M keys: its time (CUDA events around a
    CUDA graph of 50 launches, so the host's launch cost is not timed), its
    bound counted from the SASS (`cipher_bound`), and the plain version's
    time."""
    rows = []
    for n_keys in (1 << 18, 1 << 20):
        for form, n_u in (("bounce", 12), ("bounce", 5), ("bounce", 1),
                          ("bounce", 2), ("new_sample", 0),
                          ("new_sample", 5), ("new_sample", 6)):
            launch, plain = cipher_launcher(form, n_keys, n_u)
            ms = profiling.graph_ms(launch, 50)
            plain_ms = cuda_ms(plain, 2)
            bound, by, what, per_key = cipher_bound(form, n_keys, n_u)
            calls = cipher_calls(form, n_u)
            rows.append(dict(form=form, keys=n_keys, uniforms=n_u, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             bound_by_sass=what, cipher_calls_a_key=calls,
                             sass_instructions_a_key=per_key))
            scaled = ("" if (form, n_u) in CIPHER_KERNELS else
                      ", scaled from the 12-uniform form's a cipher call")
            print(f"cipher form: {form} x {n_u} at {n_keys} keys: {ms:.5f} ms "
                  f"per launch; SASS bound {bound:.5f} ms by {what} "
                  f"({per_key[0]:g} integer ALU of {per_key[1]:g} "
                  f"instructions a key{scaled}; {calls} cipher calls a key), "
                  f"{bound / ms:.1%} of it; plain {plain_ms:.3f} ms ({card})",
                  flush=True)
    return rows


def cipher_on_path(calls, launches: int, card: str,
                   path_name: str = "the BVH main path") -> dict:
    """The cipher entry at the (form, keys, uniforms) calls a main path
    made (`calls`, one per launch): for each shape its launches, the
    entry's time per launch alone on random keys (`profiling.graph_ms`), its
    bound (`cipher_bound`, from the SASS) and the plain version's time; and
    over the path, launches x (time - bound). Raises unless the calls are
    as many as the path's `launches`."""
    if len(calls) != launches:
        raise AssertionError(f"{len(calls)} cipher calls recorded, "
                             f"{launches} launched")
    rows, excess = [], 0.0
    for (form, n_keys, n_u), count in sorted(
            {sh: calls.count(sh) for sh in set(calls)}.items()):
        launch, plain = cipher_launcher(form, n_keys, n_u)
        ms = profiling.graph_ms(launch, 50)
        plain_ms = cuda_ms(plain, 2)
        bound, by, what, _ = cipher_bound(form, n_keys, n_u)
        excess += count * (ms - bound)
        rows.append(dict(form=form, keys=n_keys, uniforms=n_u, calls=count,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by))
        print(f"cipher on {path_name}: {count} launches of the {form} form, "
              f"{n_keys} keys x {n_u} uniforms: {ms:.5f} ms per launch, SASS "
              f"bound {bound:.5f} ms by {what}, plain {plain_ms:.3f} ms "
              f"({card})", flush=True)
    top = max((r for r in rows if r["form"] == "bounce"),
              key=lambda r: r["calls"], default=rows[0] if rows else None)
    sample = next((r for r in rows if r["form"] == "new_sample"), None)
    print(f"cipher on {path_name}: {launches} launches, launches x "
          f"(time - bound) = {excess:.3f} ms a render ({card})", flush=True)
    return dict(launches=launches, shapes=rows, excess_ms=excess,
                ms=top["ms"] if top else None,
                plain_ms=top["plain_ms"] if top else None,
                bound_ms=top["bound_ms"] if top else None,
                bound_by=top["bound_by"] if top else None,
                shape=(top["keys"], top["uniforms"]) if top else None,
                new_sample=sample)


def image_close(label: str, acc_a, rays_a: int, acc_b, rays_b: int,
                spp: int) -> float:
    """Two RGB accumulators of one render, `b` the reference, held to phase
    4's tolerances (rays, the share of pixels within PIXEL_ATOL, means).
    Returns the largest absolute pixel error."""
    img_a, img_b = acc_a / spp, acc_b / spp
    pix_err = (img_a - img_b).abs().amax(dim=1)
    share = float((pix_err <= PIXEL_ATOL).float().mean())
    rays_rel = abs(rays_a - rays_b) / rays_b
    mean_rel = abs(float(img_a.mean()) / float(img_b.mean()) - 1)
    print(f"{label}: rays {rays_a} vs {rays_b} (rel {rays_rel:.2e}, tol "
          f"{RAYS_RTOL}); pixels within {PIXEL_ATOL}: {share:.6f} (tol "
          f"{PIXEL_SHARE}); max abs err {float(pix_err.max()):.3e}; mean rel "
          f"{mean_rel:.2e} (tol {MEAN_RTOL})", flush=True)
    if not (bool(torch.isfinite(img_a).all()) and rays_rel <= RAYS_RTOL
            and share >= PIXEL_SHARE and mean_rel <= MEAN_RTOL):
        raise AssertionError(f"{label}: the two renders disagree")
    return float(pix_err.max())


def loop_phase(label: str, ctx, n: int, spp: int, settings, card: str,
               prof_spp: int, kernel=None) -> dict:
    """The pool's loop at a main path's frame (the module docstring, L):
    the plain loop (the same body, the end tested after every iteration,
    no graph; `kernel`, a (module, wrapper) pair, timed by CUDA events
    around each of its launches) against the graphed loop (the context's
    graph, which its main-path render captured), both through
    `trace_pool`'s body: rays and iterations equal, pixels within phase 4's
    tolerances. Then each at prof_spp (the same pool size) under
    torch.profiler: device events per iteration and the idle share."""
    dev = ctx.device
    spectral = bool(ctx.meta.spectral)
    bg = ctx.meta.spectral_background_spd or 0
    key = rng.render_key(0, device=dev)

    def pool(spp_):
        return min(n * n * spp_, renderer.POOL_MAX)

    def plain(spp_, stats=None):
        return wavefront._trace_pool(
            ctx.cs, ctx.meta, settings, ctx.intersect, n, n, spp_, key,
            pool(spp_), spectral, bg, 0, 1, False, stats=stats)

    def graphed(spp_, stats=None):
        return wavefront.trace_pool(
            ctx.cs, ctx.meta, settings, ctx.intersect, n, n, spp_, key,
            pool(spp_), spectral=spectral, bg_spd_id=bg, graphs=ctx.graphs,
            stats=stats)

    def timed(fn):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, rays, its = fn(spp, stats)
        torch.cuda.synchronize()
        return acc, int(rays), its, time.perf_counter() - t0, stats

    times = []
    if kernel is not None:
        with profiling.event_timed(*kernel) as times:
            acc_p, rays_p, its_p, sec_p, st_p = timed(plain)
    else:
        acc_p, rays_p, its_p, sec_p, st_p = timed(plain)
    acc_g, rays_g, its_g, sec_g, st_g = timed(graphed)
    if st_g["capture_seconds"] or st_g["replays"] != st_g["trips"]:
        raise AssertionError(f"{label}: the graphed loop captured anew "
                             f"({st_g})")
    compare = compare_xyz if spectral else image_close
    err = compare(f"loop: {label} {n}x{n}@{spp}, graphed vs plain loop",
                  acc_g, rays_g, acc_p, rays_p, spp)
    if rays_g != rays_p or its_g != its_p:
        raise AssertionError(f"{label}: the graphed loop traced {rays_g} rays "
                             f"in {its_g} iterations, the plain loop "
                             f"{rays_p} in {its_p}")
    kernel_ms = (profiling.event_ms(times) / len(times)) if times else None
    per_body = body_kernels(st_g["per_body"])
    prof = {}
    for name, fn in (("plain", plain), ("graphed", graphed)):
        got, st = {}, {}

        def run(fn=fn, got=got, st=st):
            got["its"] = fn(prof_spp, st)[2]

        wall, records, _ = harness.device_intervals(torch, run)
        busy = harness.union_seconds(records)
        rows = profiling.device_rows(records)
        events = len(records)
        # Each body launches its kernels; the pool's first issue, before
        # the loop, launches the new-sample form once more.
        want = {k: st["trips"] * n + (k == "new_sample_tiles")
                for k, n in per_body.items()}
        seen = {k: sum(c for _, key, c in rows if k in key) for k in want}
        print(f"loop: {label} at {prof_spp} spp through the {name} loop: "
              f"kernels in the profile {seen}, worked out {want} "
              f"({st['trips']} bodies run x {per_body} a body)", flush=True)
        if seen != want:
            raise AssertionError(f"{label}: the profile of the {name} loop "
                                 f"holds {seen} kernel launches, not {want}")
        prof[name] = dict(spp=prof_spp, wall_s=wall, busy_s=busy,
                          idle_share=1 - busy / wall, events=events,
                          iterations=got["its"], trips=st["trips"],
                          kernels_in_profile=seen,
                          events_per_iteration=events / max(got["its"], 1))
    out = {}
    for name, sec, its, st in (("plain", sec_p, its_p, st_p),
                               ("graphed", sec_g, its_g, st_g)):
        out[name] = dict(seconds=sec, mrays_per_sec=rays_g / sec / 1e6,
                         iterations=its, trips=st["trips"],
                         replays=st["replays"], chunk=st["chunk"],
                         capture_seconds=st["capture_seconds"],
                         profile=prof[name])
        pr = prof[name]
        print(f"loop: {label} {n}x{n}@{spp} through the {name} loop: "
              f"{sec:.4f} s, {rays_g / sec / 1e6:.3f} Mrays/s, {its} "
              f"iterations, {st['trips']} bodies run, {st['replays']} "
              f"replays, chunk {st['chunk']}, capture "
              f"{st['capture_seconds']:.4f} s; at {prof_spp} spp under "
              f"torch.profiler: {pr['events_per_iteration']:.1f} device "
              f"events per iteration, idle share {pr['idle_share']:.2%} "
              f"(wall {pr['wall_s']:.4f} s, busy {pr['busy_s']:.4f} s) "
              f"({card})", flush=True)
    graph_mib = st_g["graph_bytes"] / 2**20
    print(f"loop: {label}: graphed / plain seconds {sec_g / sec_p:.3f}; the "
          f"context's graph holds {graph_mib:.1f} MiB that its capture added "
          f"to torch.cuda.memory_reserved ({card})"
          + (f"; the traversal kernel {kernel_ms:.4f} ms per launch over the "
             f"plain loop's {len(times)} launches (CUDA events)"
             if kernel_ms else ""), flush=True)
    mark(f"L {label}")
    return dict(out, rays=rays_g, max_abs_err=err, kernel_ms=kernel_ms,
                kernel_launches_plain=len(times), graph_mib=graph_mib,
                kernels_a_body=per_body)


def body_kernels(per_body: dict) -> dict:
    """{kernel's name in a profile: launches a pool body} from a captured
    body's launches by counter (`trace_pool`'s stats["per_body"]); a
    megakernel has no place in the body."""
    if per_body[("megakernel", "launches")] or per_body[
            ("megakernel_spectral", "launches")]:
        raise AssertionError(f"a megakernel in the pool's body: {per_body}")
    sample = per_body[("threefry", "sample_launches")]
    out = {"bvh4_traverse": per_body[("bvh_kernel", "launches")],
           "bvh4_rowstack": per_body[("bvh_rowkernel", "launches")],
           "bounce_tiles": per_body[("threefry", "launches")] - sample,
           "new_sample_tiles": sample}
    return {k: n for k, n in out.items() if n}


def traversal_build(usage: dict, label: str) -> dict:
    """Print the two traversal kernels' registers, spills, stack frame and
    shared memory per block (ptxas) under `label`; returns them by
    kernel."""
    out = {name: usage[name]._asdict() for name in ("bvh4_traverse",
                                                     "bvh4_rowstack")}
    print(f"{label}: " + "; ".join(
        f"{name} {u['registers']} registers, spill stores {u['spill_stores']} "
        f"B, loads {u['spill_loads']} B, stack frame {u['stack_frame']} B, "
        f"shared memory {u['smem']} B per block" for name, u in out.items()),
          flush=True)
    return out


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card_layout(mod, n: int, spp: int, entry: str = None) -> dict:
    """The persistent grid of megakernel module `mod` (or of its C entry
    `entry`) on the card and the card's layout of an n×n frame at spp:
    blocks, threads, replicas, samples per slot, slots, slots per resident
    thread."""
    dev = torch.device("cuda")
    entry = entry or mod.ENTRY
    blocks, threads = megakernel.card_grid(entry, dev)
    repl, spp_slot, n_slots = megakernel.slot_layout(
        n * n, spp, megakernel.card_min_slots(entry, dev))
    return dict(blocks=blocks, threads=threads, replicas=repl,
                spp_slot=spp_slot, slots=n_slots,
                slots_per_thread=n_slots / (blocks * threads))


def canvas(acc, n: int, spp: int) -> np.ndarray:
    """The (n, n, 3) f32 canvas `renderer.render` makes of a wrapper's sums
    (float64 division, rows flipped)."""
    acc64 = np.zeros((n * n, 3), np.float64)
    acc64 += acc.cpu().numpy()
    return (acc64 / spp).reshape(n, n, 3)[::-1].astype(np.float32)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over reps runs, after one
    warm-up run (`profiling.cuda_ms`)."""
    return profiling.cuda_ms(fn, reps)[1]


def compare(cs, meta, tables, n: int, spp: int, depth: int, seed: int,
            offset: int, label: str = "cornell", background=(0.0, 0.0, 0.0),
            rays_equal: bool = False) -> float:
    """Render n x n at spp samples from `offset` through the CUDA megakernel
    and through its plain twin, both on the card; print the deviations and
    raise unless they are within the tolerances above (and, with
    `rays_equal`, the ray counts are equal). Returns the largest absolute
    pixel error."""
    s = path.RenderSettings(max_depth=depth, background=background)
    key = rng.render_key(seed, device="cuda")
    acc_k, rays_k = megakernel.render_slots(cs, meta, s, n, n, spp, key, offset,
                                            tables=tables)
    acc_p, rays_p = megakernel.render_slots_reference(
        cs, meta, s, n, n, spp, key, offset,
        min_slots=megakernel.card_min_slots(megakernel.ENTRY, cs.device))
    torch.cuda.synchronize()
    img_k, img_p = acc_k / spp, acc_p / spp
    rays_k, rays_p = int(rays_k), int(rays_p)
    pix_err = (img_k - img_p).abs().amax(dim=1)
    max_abs_err = float(pix_err.max())
    share = float((pix_err <= PIXEL_ATOL).float().mean())
    mean_k, mean_p = float(img_k.mean()), float(img_p.mean())
    rays_rel = abs(rays_k - rays_p) / rays_p
    mean_rel = abs(mean_k - mean_p) / mean_p
    lay = card_layout(megakernel, n, spp)
    print(f"kernel-vs-twin: {label} {n}x{n}@{spp} depth {depth} seed {seed} "
          f"offset {offset} ({lay['slots']} slots of {lay['spp_slot']} "
          f"samples, {lay['slots_per_thread']:.3f} per resident thread): rays "
          f"{rays_k} vs {rays_p} (rel "
          f"{rays_rel:.2e}, tol {RAYS_RTOL}); pixels within {PIXEL_ATOL}: "
          f"{share:.6f} (tol {PIXEL_SHARE}); max abs err {max_abs_err:.3e}; "
          f"mean {mean_k:.7f} vs {mean_p:.7f} (rel {mean_rel:.2e}, tol "
          f"{MEAN_RTOL})", flush=True)
    if not (bool(torch.isfinite(img_k).all()) and rays_rel <= RAYS_RTOL
            and share >= PIXEL_SHARE and mean_rel <= MEAN_RTOL
            and (rays_k == rays_p or not rays_equal)):
        raise AssertionError(f"CUDA megakernel disagrees with its plain twin "
                             f"on {label} at {n}x{n}@{spp} depth {depth} "
                             f"offset {offset}")
    return max_abs_err


def compare_xyz(label: str, acc_a, rays_a: int, acc_b, rays_b: int,
                spp: int) -> float:
    """Two spectral XYZ accumulators of one render, `b` the reference:
    print the deviations and raise unless the rays, pixels and mean Y are
    within the tolerances above. Returns the largest absolute XYZ error."""
    xyz_a, xyz_b = acc_a / spp, acc_b / spp
    diff = (xyz_a - xyz_b).abs()
    max_abs_err = float(diff.max())
    max_rel_err = float((diff / xyz_b.abs().clamp(min=1e-6)).max())
    share = float((diff <= XYZ_ATOL + XYZ_RTOL * xyz_b.abs()).all(dim=1)
                  .float().mean())
    mean_a, mean_b = float(xyz_a[:, 1].mean()), float(xyz_b[:, 1].mean())
    rays_rel = abs(rays_a - rays_b) / rays_b
    mean_rel = abs(mean_a - mean_b) / mean_b
    print(f"{label}: rays {rays_a} vs {rays_b} (rel {rays_rel:.2e}, tol "
          f"{RAYS_RTOL}); pixels with XYZ within {XYZ_ATOL} + {XYZ_RTOL}|b|: "
          f"{share:.6f} (tol {PIXEL_SHARE}); max abs err {max_abs_err:.3e}; "
          f"max rel err {max_rel_err:.3e}; mean Y {mean_a:.6f} vs "
          f"{mean_b:.6f} (rel {mean_rel:.2e}, tol {MEAN_RTOL})", flush=True)
    if not (bool(torch.isfinite(xyz_a).all()) and rays_rel <= RAYS_RTOL
            and share >= PIXEL_SHARE and mean_rel <= MEAN_RTOL):
        raise AssertionError(f"{label}: the two renders disagree")
    return max_abs_err


def compare_spectral(cs, meta, tables, n: int, spp: int, depth: int, seed: int,
                     offset: int):
    """The spectral pyramid n x n at spp samples from `offset` through the
    CUDA spectral megakernel (a) and through its plain version (b), both on
    the card, held to `compare_xyz`. Returns the largest absolute XYZ
    error."""
    s = path.RenderSettings(max_depth=depth)
    key = rng.render_key(seed, device="cuda")
    acc_k, rays_k = megakernel_spectral.render_slots_spectral(
        cs, meta, s, n, n, spp, key, offset, tables=tables)
    acc_p, rays_p = megakernel_spectral.render_slots_spectral_reference(
        cs, meta, s, n, n, spp, key, offset,
        min_slots=megakernel.card_min_slots(megakernel_spectral.ENTRY,
                                            cs.device))
    torch.cuda.synchronize()
    lay = card_layout(megakernel_spectral, n, spp)
    err = compare_xyz(f"kernel-vs-twin: spectral pyramid {n}x{n}@{spp} depth "
                      f"{depth} seed {seed} offset {offset} ({lay['slots']} "
                      f"slots of {lay['spp_slot']} samples, "
                      f"{lay['slots_per_thread']:.3f} per resident thread)",
                      acc_k, int(rays_k), acc_p, int(rays_p), spp)
    return err


def traversal_bound_ms(fp: int, n_rays: int, table_bytes: int):
    """The least milliseconds the card could take for a traversal of n_rays
    that needs `fp` FP32 operations (counted from the kernel's counter
    buffer) over the FP32 peak, against the tables read once, 28 bytes in
    and 8 out per ray over HBM bandwidth. Returns (ms, "operations" or
    "bytes")."""
    t_ops = (fp + n_rays * RAY_FP) / FP32_OPS_PER_S
    t_bytes = (table_bytes + n_rays * (28 + 8)) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compare_rowstack(label: str, cs2, inter, attach_s: float, rays, ks3,
                     card: str):
    """The row-stack kernel of `attach`'s pair (cs2, inter) against its
    plain version on `rays` in their order, as `RowBVHIntersector` hands
    them over, both on the card, and against the BVH4 kernel's hits (tree
    `ks3`) on the same rays: print the deviations, the times (also on the
    rays sorted by the JAX intersector's coherence key, `sort_keys`) and the
    bound; raise unless hit masks are equal, t is within T_RTOL, block slots
    differ only on exact-t ties (at most TIE_SHARE of the rays) and the
    per-warp counters are equal. Returns a dict of the numbers."""
    rs = inter.rs
    o, d, tme = rays
    n = o.shape[0]
    t_k, i_k, c_k = bvh_rowkernel.closest_hit_rows(
        rs, o, d, tme, path.T_MIN, primitives.T_MAX, counters=True)
    (t_p, i_p, c_p), plain_ms = profiling.cuda_ms(
        lambda: bvh_rowkernel.closest_rows(rs, o, d, tme, path.T_MIN,
                                           primitives.T_MAX), 1, warm_up=False)
    hit = i_p >= 0
    same_mask = torch.equal(i_k >= 0, hit)
    err = (t_k[hit] - t_p[hit]).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / t_p[hit].abs()).max()) if err.numel() else 0.0
    differ = hit & (i_k != i_p)
    ties = int((differ & (t_k == t_p)).sum())
    wrong = int((differ & (t_k != t_p)).sum())
    same_counters = torch.equal(c_k, c_p)
    # The BVH4 kernel on the same rays.
    t3, i3 = bvh_kernel.closest_hit(ks3, o, d, tme, path.T_MIN,
                                    primitives.T_MAX)
    same_mask3 = torch.equal(i3 >= 0, i_k >= 0)
    hit3 = i3 >= 0
    rel3 = (float(((t_k[hit3] - t3[hit3]).abs() / t3[hit3].abs()).max())
            if bool(hit3.any()) else 0.0)
    ms = cuda_ms(lambda: bvh_rowkernel.closest_hit_rows(
        rs, o, d, tme, path.T_MIN, primitives.T_MAX), 20)
    order = torch.argsort(bvh_rowkernel.sort_keys(o, d, inter.lo, inter.hi),
                          stable=True)
    o_s, d_s, t_s = (x[order].contiguous() for x in (o, d, tme))
    ms_sorted = cuda_ms(lambda: bvh_rowkernel.closest_hit_rows(
        rs, o_s, d_s, t_s, path.T_MIN, primitives.T_MAX), 20)
    # The warps' work unsorted and sorted: totals, the 99th percentile and
    # the longest warp (what a launch's tail waits for).
    c_s = bvh_rowkernel.closest_hit_rows(rs, o_s, d_s, t_s, path.T_MIN,
                                         primitives.T_MAX, counters=True)[2]
    work = {order: dict(total=[int(x) for x in c.sum(dim=0)],
                        max=[int(x) for x in c.max(dim=0).values],
                        p99=[float(x) for x in torch.quantile(
                            c.double(), 0.99, dim=0)])
            for order, c in (("unsorted", c_k), ("sorted", c_s))}
    # The bound: the work each ray alone needs on this leaf-64 tree, the
    # node pops and primitive tests of the per-ray traversal (near child
    # first) over the same tables, in chunks of rays.
    tree = bvh_rowkernel.per_ray_tree(rs)
    visits = tests = 0
    for lo in range(0, n, PER_RAY_CHUNK):
        sl = slice(lo, lo + PER_RAY_CHUNK)
        _, i_r, c_r = traverse.closest_bvh(cs2.prims, tree, o[sl], d[sl],
                                           tme[sl], path.T_MIN,
                                           primitives.T_MAX, counts=True)
        same_mask = same_mask and torch.equal(i_r >= 0, hit[sl])
        visits += int(c_r[:, 0].sum())
        tests += int(c_r[:, 1].sum())
    table_bytes = tensor_bytes([rs.nodes, rs.blocks])
    bound, bound_by = traversal_bound_ms(
        visits * ROW_VISIT_FP + tests * min(PRIM_FP.values()), n, table_bytes)
    # Beside it, the warps' own work: 32 lanes x its node pops, and the (ray,
    # primitive) pairs it tests (the third counter: each visited block's
    # primitives times the rays whose own box test hit it). Not a bound.
    pops, _, pairs = (int(x) for x in c_k.sum(dim=0))
    warp_bound, _ = traversal_bound_ms(
        32 * pops * ROW_VISIT_FP + pairs * min(PRIM_FP.values()), n,
        table_bytes)
    mean_c = [round(float(x), 3) for x in c_k.double().mean(dim=0)]
    print(f"row-stack {label}: leaf-64 tree {rs.nodes.shape[0]} nodes, "
          f"{rs.blocks.shape[0]} blocks, attach {attach_s:.3f} s; {n} rays "
          f"in the pool's order, hits {float(hit.float().mean()):.4f}; hit "
          f"masks equal {same_mask}; t max abs err {max_abs:.3e}, max rel {max_rel:.3e} "
          f"(tol {T_RTOL}); slots differing on exact-t ties {ties} (allowed "
          f"{TIE_SHARE * n:.2f}), otherwise {wrong}; per-warp counters equal "
          f"{same_counters}; mean per warp: nodes popped, blocks, (ray, prim) "
          f"pairs {mean_c}, max {c_k.max(dim=0).values.tolist()}; per ray "
          f"alone: nodes {visits / n:.3f}, prims {tests / n:.3f}; vs the "
          f"BVH4 kernel: hit masks equal {same_mask3}, t max rel {rel3:.3e}; "
          f"warps' (pops, blocks, pairs) {work}; "
          f"kernel {ms:.4f} ms ({ms_sorted:.4f} ms sorted), plain "
          f"{plain_ms:.2f} ms, bound {bound:.4f} ms by {bound_by} (the "
          f"warp's own work {warp_bound:.4f} ms) ({card})", flush=True)
    if not (same_mask and max_rel <= T_RTOL and wrong == 0
            and ties <= TIE_SHARE * n and same_counters and same_mask3
            and rel3 <= T_RTOL):
        raise AssertionError(f"row-stack kernel disagrees with its plain "
                             f"version or the BVH4 kernel on {label}")
    return dict(max_abs_err=max_abs, ms=ms, ms_sorted=ms_sorted,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                warp_work_ms=warp_bound, attach_s=attach_s,
                nodes=rs.nodes.shape[0], blocks=rs.blocks.shape[0],
                mean_counters=mean_c, warp_work=work,
                per_ray_nodes_prims=[visits / n, tests / n])


def dragon_stand_in() -> scene_types.Scene:
    """The dragon scene's procedural mesh, `bumpy_blob(871_414)` placed as
    izpi_tpu/scene/library/extracted.py:73-75 places it (871,200
    triangles), seen by a camera 60 units in front of its centre, which it
    fills."""
    tris = procedural.transform_mesh(procedural.bumpy_blob(871_414),
                                     scale=25.0, rotate_y_deg=-60.0,
                                     translate=(50.0, 25.1, 60.0))
    white = scene_types.Lambertian(
        albedo=scene_types.ConstantTexture((0.5, 0.5, 0.5)))
    mesh = scene_types.TriangleMesh(vertices=tris, material=white)
    return scene_types.Scene(world=[mesh], camera=scene_types.Camera(
        look_from=(50.0, 35.0, 0.0), look_at=(50.0, 25.1, 60.0), vfov=40.0))


def traversal_rays(ks, cam, n: int, seed: int):
    """n rays for the tree `ks`: n/2 camera rays through a square frame
    (jittered from a seeded generator), and n/2 from where those rays hit
    (their origin where they miss) in directions drawn from the same
    generator. The hit points come from the plain traversal."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    half = n // 2
    u = torch.rand((half, 5), generator=gen, device="cuda")
    o, d, tme = camera.get_rays(cam, u[:, 0], u[:, 1], u[:, 2:5])
    t, idx = traverse.closest_bvh(ks.prims, ks.tree, o, d, tme, path.T_MIN,
                                  primitives.T_MAX)
    start = torch.where((idx >= 0)[:, None], o + t[:, None] * d, o)
    d2 = torch.randn((half, 3), generator=gen, device="cuda")
    return (torch.cat([o, start]).contiguous(), torch.cat([d, d2]).contiguous(),
            torch.cat([tme, tme]).contiguous())


def compare_traversal(label: str, ks, rays, card: str):
    """The traversal kernel against its plain version on `rays`, both on
    the card: print the deviations, the times and the bound; raise unless
    the hit masks are equal, t is within T_RTOL and the primitives differ
    only on exact-t ties, on at most TIE_SHARE of the rays. Returns a dict
    of the numbers."""
    o, d, tme = rays
    n = o.shape[0]
    t_k, i_k, counts = bvh_kernel.closest_hit(ks, o, d, tme, path.T_MIN,
                                             primitives.T_MAX, counts=True)
    t_p, i_p, counts_p = traverse.closest_bvh(ks.prims, ks.tree, o, d, tme,
                                              path.T_MIN, primitives.T_MAX,
                                              counts=True)
    torch.cuda.synchronize()
    hit = i_p >= 0
    same_mask = torch.equal(i_k >= 0, hit)
    err = (t_k[hit] - t_p[hit]).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / t_p[hit].abs()).max()) if err.numel() else 0.0
    differ = hit & (i_k != i_p)
    ties = int((differ & (t_k == t_p)).sum())
    wrong = int((differ & (t_k != t_p)).sum())
    same_counts = torch.equal(counts, counts_p)
    ms = cuda_ms(lambda: bvh_kernel.closest_hit(ks, o, d, tme, path.T_MIN,
                                                primitives.T_MAX), 20)
    plain_ms = cuda_ms(lambda: traverse.closest_bvh(
        ks.prims, ks.tree, o, d, tme, path.T_MIN, primitives.T_MAX), 1)
    table_bytes = tensor_bytes([ks.nodes, ks.prim_table])
    visits, tests = (int(x) for x in counts.sum(dim=0))
    bound, bound_by = traversal_bound_ms(
        visits * VISIT_FP + tests * min(PRIM_FP.values()), n, table_bytes)
    mean_counts = [round(float(x), 3) for x in counts.double().mean(dim=0)]
    print(f"traversal {label}: {n} rays, hits {float(hit.float().mean()):.4f}; "
          f"hit masks equal {same_mask}; t max abs err {max_abs:.3e}, max rel "
          f"{max_rel:.3e} (tol {T_RTOL}); primitives differing on exact-t ties "
          f"{ties} (allowed {TIE_SHARE * n:.2f}), otherwise {wrong}; node/prim "
          f"counts equal to the plain version's {same_counts}; mean nodes "
          f"popped, prims tested per ray {mean_counts}, max "
          f"{counts.max(dim=0).values.tolist()}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {bound:.4f} ms by {bound_by} ({card})",
          flush=True)
    if not (same_mask and max_rel <= T_RTOL and wrong == 0
            and ties <= TIE_SHARE * n and same_counts):
        raise AssertionError(f"traversal kernel disagrees with its plain "
                             f"version on {label}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, per_ray=mean_counts)


def mesh_pixels(ctx, n: int) -> np.ndarray:
    """(n, n) bool, image rows top first: the pixels whose centre's camera
    ray first hits a PBR material (the renderer's film convention, v up)."""
    c = (torch.arange(n, device=ctx.device, dtype=torch.float32) + 0.5) / n
    s = c.repeat(n)
    t = 1.0 - c.repeat_interleave(n)
    o, d, tme = camera.get_rays(ctx.cs.camera, s, t,
                                torch.zeros((n * n, 3), device=ctx.device))
    hit = ctx.intersect(o, d, tme, path.T_MIN, primitives.T_MAX)
    kind = ctx.cs.materials.kind[torch.clamp(hit.mat_id, min=0)]
    return (hit.hit & (kind == mat_tables.MAT_PBR)).reshape(n, n).cpu().numpy()


def row_stack_phases(bctx, dctx, rays7, card: str, usage: dict):
    """Phases 10-12 (the module docstring). Returns (phase 10's numbers
    by tree, phase 12's numbers by traversal kernel)."""
    # 10. The row-stack kernel against its plain version and the BVH4 kernel,
    # on phase 7's scenes and rays, then on the dragon scene's own tree.
    traversal_build(usage, "phase 10")
    rows10 = {}
    for label, ctx in (("cornell_box_obj", bctx), ("dragon stand-in", dctx)):
        t0 = time.perf_counter()
        cs2, inter = bvh_rowkernel.attach(ctx.cs)
        torch.cuda.synchronize()
        rows10[label] = compare_rowstack(label, cs2, inter,
                                         time.perf_counter() - t0,
                                         rays7[label], ctx.intersect.ks, card)
        del cs2, inter
    torch.cuda.empty_cache()

    # Two contexts of the dragon scene: the default (the BVH4 kernel, above
    # BVH_THRESHOLD) and brute force replaced by the row-stack pair, as a
    # user selects it.
    dev = bctx.device
    dragon = cornell_box_pbr_stanford_dragon_spectral()
    d3ctx = renderer.RenderContext(dragon, device=dev)
    d4ctx = renderer.RenderContext(dragon, use_bvh=False, device=dev)
    t0 = time.perf_counter()
    d4ctx.cs, d4ctx.intersect = bvh_rowkernel.attach(d4ctx.cs)
    torch.cuda.synchronize()
    d4_attach = time.perf_counter() - t0
    print(f"dragon: {d3ctx.meta.n_prims} prims, has_pbr {d3ctx.meta.has_pbr}, "
          f"megakernel-eligible {d3ctx.mega_supported()}; BVH4 context "
          f"(compile and leaf-4 build) {d3ctx.build_seconds:.3f} s; row-stack "
          f"context: compile {d4ctx.build_seconds:.3f} s, leaf-64 attach "
          f"{d4_attach:.3f} s", flush=True)
    # 10, the main path's tree: the dragon's rects, sphere and triangles in
    # mixed blocks, on phase 7's ray recipe from the dragon's camera.
    rows10["dragon"] = compare_rowstack(
        "dragon", d4ctx.cs, d4ctx.intersect, d4_attach,
        traversal_rays(d3ctx.intersect.ks, d3ctx.cs.camera, TRAVERSE_RAYS, 10),
        d3ctx.intersect.ks, card)
    torch.cuda.empty_cache()

    # 11. The dragon's pool through the row-stack pair against the pool
    # through the BVH4 kernel.
    traversal_build(usage, "phase 11")
    s11 = path.RenderSettings(max_depth=DRAGON_DEPTH)
    key11 = rng.render_key(0, device=dev)
    bg11 = d3ctx.meta.spectral_background_spd or 0
    before, stats11 = bvh_rowkernel.launches, {}
    acc4, rays4, it4 = wavefront.trace_pool(
        d4ctx.cs, d4ctx.meta, s11, d4ctx.intersect, 32, 32, 4, key11, 4096,
        spectral=True, bg_spd_id=bg11, stats=stats11)
    launched4 = bvh_rowkernel.launches - before
    acc3, rays3, it3 = wavefront.trace_pool(
        d3ctx.cs, d3ctx.meta, s11, d3ctx.intersect, 32, 32, 4, key11, 4096,
        spectral=True, bg_spd_id=bg11)
    torch.cuda.synchronize()
    print(f"pool: dragon 32x32@4 depth 16 (pool 4096): row-stack "
          f"{it4} iterations ({launched4} launches), BVH4 kernel {it3}",
          flush=True)
    compare_xyz("pool: dragon row-stack vs BVH4 kernel", acc4, int(rays4), acc3,
                int(rays3), 4)
    if launched4 != stats11["trips"]:
        raise AssertionError(f"{launched4} row-stack launches in "
                             f"{stats11['trips']} pool bodies run")

    # 12. The dragon main path through each traversal kernel, through the
    # entry points a user calls.
    traversal_build(usage, "phase 12")
    print(f"dragon main path: placeholder assets "
          f"{d3ctx.meta.placeholder_assets} (the mesh is the procedural "
          f"871,200-triangle stand-in)", flush=True)
    if not d3ctx.meta.placeholder_assets:
        raise AssertionError("the dragon's meta does not flag its stand-in")
    s12 = path.RenderSettings(max_depth=DRAGON_DEPTH)

    def dragon_render(ctx, spp):
        return renderer.render(None, DRAGON_SIZE, DRAGON_SIZE, spp, s12,
                               seed=0, mode="wavefront", context=ctx,
                               device=dev)

    mesh = mesh_pixels(d3ctx, DRAGON_SIZE)
    if mesh.sum() < 16:
        raise AssertionError(f"the dragon's mesh covers {mesh.sum()} pixels")
    dragon_runs, dres = {}, {}
    for name, ctx, mod, fn in (
            ("bvh4_traverse", d3ctx, bvh_kernel, "closest_hit"),
            ("bvh4_rowstack", d4ctx, bvh_rowkernel, "closest_hit_rows")):
        zero_counts()
        warm = dragon_render(ctx, DRAGON_SPP)
        moved = read_counts()
        if mod.launches != warm.trips or sum(moved.values()) != (
                mod.launches + threefry.launches):
            raise AssertionError(f"dragon warm-up through {name}: launches "
                                 f"{moved} in {warm.trips} bodies run")
        zero_counts()
        res12 = dragon_render(ctx, DRAGON_SPP)
        moved = read_counts()
        launched = moved[mod.__name__.rsplit(".", 1)[1]]
        loop12 = loop_phase(f"dragon through {name}", ctx, DRAGON_SIZE,
                            DRAGON_SPP, s12, card, DRAGON_SPP, (mod, fn))
        kernel_ms = loop12["kernel_ms"] * launched
        print(f"dragon main path through {name}: {DRAGON_SIZE}x{DRAGON_SIZE}@"
              f"{DRAGON_SPP} depth {DRAGON_DEPTH} seed 0 on "
              f"{res12.device}: {res12.rays_traced} rays in {res12.seconds:.4f} "
              f"s = {res12.mrays_per_sec:.3f} Mrays/s in {res12.iterations} "
              f"pool iterations, {res12.trips} bodies run, {res12.replays} "
              f"replayed (warm-up {warm.seconds:.4f} s with its capture "
              f"{warm.capture_seconds:.4f} s, {warm.rays_traced} rays; "
              f"{card}); launches {moved}; {name} {loop12['kernel_ms']:.4f} "
              f"ms per launch (the plain loop's, CUDA events) x {launched} "
              f"= {kernel_ms / 1e3 / res12.seconds:.2%} of render()",
              flush=True)
        if (launched != res12.replays or res12.replays != res12.trips
                or sum(moved.values()) != launched + moved["threefry"]):
            raise AssertionError(f"the dragon main path through {name} "
                                 f"launched {moved} in {res12.replays} "
                                 f"replays of {res12.trips} bodies")
        if res12.rays_traced != warm.rays_traced:
            raise AssertionError(f"two dragon renders through {name} differ")
        xyz, img = res12.xyz, res12.image
        for label, arr in (("xyz", xyz), ("image", img)):
            if (arr.shape != (DRAGON_SIZE, DRAGON_SIZE, 3)
                    or not np.isfinite(arr).all()):
                raise AssertionError(f"dragon {label} is not finite "
                                     f"({DRAGON_SIZE}, {DRAGON_SIZE}, 3)")
        # The camera's horizontal axis points to -x: the red wall (x = 100)
        # is on the image's left, the green one (x = 0) on its right; the
        # walls' middle band, as fractions of the frame.
        q = DRAGON_SIZE / 256
        rows, c0, c1 = slice(int(64 * q), int(192 * q)), int(8 * q), int(40 * q)
        dleft = img[rows, c0:c1].mean(axis=(0, 1))
        dright = img[rows, -c1:-c0].mean(axis=(0, 1))
        mesh_y = float(xyz[mesh, 1].mean())
        print(f"dragon main path through {name}: ACEScg left wall "
              f"{np.round(dleft, 4).tolist()}, right wall "
              f"{np.round(dright, 4).tolist()}; mesh region ({int(mesh.sum())} "
              f"pixels) mean Y {mesh_y:.5f}, lit (Y > 1e-3) "
              f"{float((xyz[mesh, 1] > 1e-3).mean()):.2%}; image mean Y "
              f"{float(xyz[..., 1].mean()):.5f}", flush=True)
        if not (dleft[0] > dleft[1] and dright[1] > dright[0]):
            raise AssertionError("dragon walls: expected red on the left, "
                                 "green on the right")
        if not mesh_y > 1e-3:
            raise AssertionError(f"dragon mesh region is black (Y {mesh_y})")
        dres[name] = res12
        dragon_runs[name] = {
            "launches": moved[mod.__name__.rsplit(".", 1)[1]],
            "rays": res12.rays_traced,
            "seconds": res12.seconds, "mrays_per_sec": res12.mrays_per_sec,
            "iterations": res12.iterations, "trips": res12.trips,
            "replays": res12.replays,
            "capture_seconds": warm.capture_seconds,
            "kernel_share": kernel_ms / 1e3 / res12.seconds,
            "ms_per_launch": loop12["kernel_ms"],
            "profiled_idle_share": loop12["graphed"]["profile"]["idle_share"],
            "loop": loop12,
            "placeholder_assets": list(ctx.meta.placeholder_assets)}
    compare_xyz("dragon main path: row-stack vs BVH4 kernel (XYZ after "
                "firefly rejection)",
                torch.as_tensor(dres["bvh4_rowstack"].xyz.reshape(-1, 3)),
                dres["bvh4_rowstack"].rays_traced,
                torch.as_tensor(dres["bvh4_traverse"].xyz.reshape(-1, 3)),
                dres["bvh4_traverse"].rays_traced, 1)
    return rows10, dragon_runs, dres["bvh4_traverse"]


def cornell_checks(label: str, img: np.ndarray) -> None:
    """Phase 9's checks of a 256x256 cornell_box_obj image: finite, green
    on the left, red on the right, the ceiling light at 15."""
    if img.shape != (256, 256, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{label}: the image is not finite (256, 256, 3)")
    left = img[64:192, 4:24].mean(axis=(0, 1))
    right = img[64:192, -24:-4].mean(axis=(0, 1))
    light = float(np.percentile(img[:64].max(axis=2), 99.5))
    print(f"{label}: left wall rgb {np.round(left, 4).tolist()}, right wall "
          f"rgb {np.round(right, 4).tolist()}, light patch {light:.4f}, "
          f"image mean {float(img.mean()):.5f}", flush=True)
    if not (left[1] > left[0] and right[0] > right[1]):
        raise AssertionError(f"{label}: expected green on the left, red on "
                             f"the right")
    if abs(light - 15.0) > 0.5:
        raise AssertionError(f"{label}: ceiling light patch {light}, "
                             f"expected ~15")


def image_checks(label: str, img: np.ndarray, n: int) -> dict:
    """Print and return an image's bands: its top and bottom eighth and its
    centre quarter (rgb means), its mean and max; raise unless it is
    finite and of shape (n, n, 3)."""
    if img.shape != (n, n, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{label}: the image is not finite ({n}, {n}, 3)")
    e = n // 8
    bands = dict(top=img[:e].mean(axis=(0, 1)), bottom=img[-e:].mean(axis=(0, 1)),
                 centre=img[3 * e:5 * e, 3 * e:5 * e].mean(axis=(0, 1)),
                 mean=img.mean(axis=(0, 1)), max=img.max(axis=(0, 1)))
    print(f"{label}: " + "; ".join(f"{k} rgb {np.round(v, 5).tolist()}"
                                    for k, v in bands.items()), flush=True)
    return {k: v.tolist() for k, v in bands.items()}


def timed_render(label: str, ctx, n: int, spp: int, settings, card: str,
                 module, fn: str, launches_of):
    """A warm-up render of `ctx`'s scene and a timed one through the entry
    points a user calls, every launch counter zeroed just before the timed
    run and read just after. `launches_of(res)` is the count the kernel of
    `module` must show, or None for at least one; the other kernels but the
    cipher entry must show none. The two runs must trace the same rays. A
    megakernel's wrapper `module.fn` runs between CUDA events; a pool
    render's launches come from its CUDA graph's replays, which the host
    does not see, so its kernel is timed in `loop_phase`. Returns (result,
    counts, kernel ms summed or None, calls, the cipher entry's calls in
    the timed run, one per launch)."""
    def run():
        return renderer.render(None, n, n, spp, settings, seed=0,
                               mode="wavefront", context=ctx, device="cuda")

    with recorded_cipher_calls() as warm_calls:
        warm = run()
    zero_counts()
    with recorded_cipher_calls() as timed_calls, \
            profiling.event_timed(module, fn) as times:
        res = run()
    counts = read_counts()
    pool = res.trips is not None
    kernel_ms = None if pool else profiling.event_ms(times)
    calls = counts[module.__name__.rsplit(".", 1)[1]] if pool else len(times)
    name = module.__name__.rsplit(".", 1)[1]
    loop = (f", {res.trips} bodies run, {res.replays} replayed (the warm-up's "
            f"capture {warm.capture_seconds:.4f} s)" if pool else "")
    timing = (f"; {name}.{fn} {kernel_ms:.3f} ms over {len(times)} calls = "
              f"{kernel_ms / 1e3 / res.seconds:.2%} of render() (CUDA events)"
              if not pool else "")
    print(f"{label}: {n}x{n}@{spp} depth {settings.max_depth} seed 0 on "
          f"{res.device}: {res.rays_traced} rays in {res.seconds:.4f} s = "
          f"{res.mrays_per_sec:.3f} Mrays/s, pool iterations {res.iterations}"
          f"{loop} (warm-up {warm.seconds:.4f} s, {warm.rays_traced} rays; "
          f"{card}); launches {counts}{timing}", flush=True)
    others = sum(v for k, v in counts.items() if k not in (name, "threefry"))
    want = launches_of(res)
    if ((counts[name] != want if want is not None else counts[name] < 1)
            or others or calls != counts[name]
            or (pool and (res.replays != res.trips
                          or res.capture_seconds != 0))):
        raise AssertionError(f"{label}: launches {counts} for "
                             f"{res.iterations} pool iterations, {res.trips} "
                             f"bodies run, {res.replays} replayed")
    if res.rays_traced != warm.rays_traced:
        raise AssertionError(f"{label}: two renders traced {warm.rays_traced} "
                             f"and {res.rays_traced} rays")
    cipher_calls = (executed_cipher_calls(warm_calls, timed_calls, res.replays)
                    if pool else timed_calls["eager"])
    return res, counts, kernel_ms, calls, cipher_calls


def texture_phases(card: str, usage: dict) -> dict:
    """Phases 13-15 (the module docstring): the RGB megakernel on
    random_scene, pbr_ibl through the queue pool, and the book-2 final scene
    through the pool and the BVH4 kernel. Returns their numbers."""
    dev = torch.device("cuda")
    out = {}

    # 13 (P1). random_scene through the RGB megakernel.
    scene = random_scene(aspect=1.0)
    ctx = renderer.RenderContext(scene, device=dev)
    regs, spill_st, spill_ld = usage["megakernel_rgb"][:3]
    print(f"phase 13: random_scene: {ctx.meta.n_prims} prims (moving "
          f"spheres, a checker ground of radius 1000, thin lens aperture "
          f"{scene.camera.aperture}), megakernel-eligible "
          f"{ctx.mega_supported()}; megakernel_rgb {regs} registers, spill "
          f"stores {spill_st} B, loads {spill_ld} B", flush=True)
    if not ctx.mega_supported():
        raise AssertionError("random_scene is not the RGB megakernel's")
    err = compare(ctx.cs, ctx.meta, ctx.tables(), 64, 4, 8, 3, 0,
                  label="random_scene", background=SKY, rays_equal=True)
    # At phase 4's multi-sample layout every slot starts a next sample: its
    # thin-lens ray and its time draw come from the regenerated stream.
    if card_layout(megakernel, *MULTI_SAMPLE[:2])["spp_slot"] < 2:
        raise AssertionError("random_scene: the multi-sample layout has one "
                             "sample a slot")
    err = max(err, compare(ctx.cs, ctx.meta, ctx.tables(), *MULTI_SAMPLE,
                           label="random_scene", background=SKY,
                           rays_equal=True))
    s13 = path.RenderSettings(max_depth=SHIRLEY_DEPTH, background=SKY)
    res, counts, mk_ms, _, _ = timed_render(
        "random_scene main path", ctx, SHIRLEY_SIZE, SHIRLEY_SPP, s13, card,
        megakernel, "render_slots", lambda r: 1)
    bands = image_checks("random_scene image", res.image, SHIRLEY_SIZE)
    if not (bands["top"][2] > bands["top"][0] > 0.3
            and bands["mean"][1] > 0.1):
        raise AssertionError("random_scene: expected the sky at the top")
    _, rays_d, draws_d = megakernel.render_slots(
        ctx.cs, ctx.meta, s13, SHIRLEY_SIZE, SHIRLEY_SIZE, SHIRLEY_SPP,
        rng.render_key(0, device="cuda"), tables=ctx.tables(), draws=True)
    if int(rays_d) != res.rays_traced:
        raise AssertionError("random_scene: the launch with draw counts "
                             "traced other rays")
    lay = card_layout(megakernel, SHIRLEY_SIZE, SHIRLEY_SPP)
    bound = launch_bound("megakernel_rgb per launch on random_scene",
                         res.rays_traced, SHIRLEY_SIZE ** 2 * SHIRLEY_SPP,
                         draws_d, ctx.cs.prims.kind.tolist(), False, lay,
                         tensor_bytes(ctx.tables()), card)
    print(f"random_scene main path: megakernel_rgb {mk_ms:.4f} ms per launch "
          f"at {bound['bound_ms'] / mk_ms:.2%} of its bound ({card})",
          flush=True)
    # The engine policy: the same render through the queue pool and the
    # BVH4 kernel, as a scene above BVH_THRESHOLD would take it.
    pctx = renderer.RenderContext(scene, use_bvh=True, device=dev)
    # A warm-up at the same pool size captures the pool's graph.
    renderer.render(None, SHIRLEY_SIZE, SHIRLEY_SIZE, 4, s13, seed=1,
                    mode="pool", context=pctx, device="cuda")
    zero_counts()
    pres = renderer.render(None, SHIRLEY_SIZE, SHIRLEY_SIZE, SHIRLEY_SPP, s13,
                           seed=0, mode="pool", context=pctx, device="cuda")
    pcounts = read_counts()
    rays_rel = abs(pres.rays_traced - res.rays_traced) / res.rays_traced
    mean_rel = abs(float(pres.image.mean()) / float(res.image.mean()) - 1)
    close = (np.abs(pres.image - res.image) <= PIXEL_ATOL).all(axis=2).mean()
    print(f"policy: random_scene {SHIRLEY_SIZE}x{SHIRLEY_SIZE}@{SHIRLEY_SPP}: "
          f"megakernel {res.seconds:.4f} s ({res.mrays_per_sec:.2f} Mrays/s) "
          f"vs queue pool + BVH4 kernel {pres.seconds:.4f} s "
          f"({pres.mrays_per_sec:.2f} Mrays/s, {pres.iterations} iterations, "
          f"launches {pcounts}): the megakernel "
          f"{pres.seconds / res.seconds:.2f}x faster; rays rel {rays_rel:.2e}, "
          f"mean rel {mean_rel:.2e}, pixels within {PIXEL_ATOL} {close:.4f} "
          f"(tol {PIXEL_SHARE}; {card})", flush=True)
    if (rays_rel > RAYS_RTOL or mean_rel > MEAN_RTOL or close < PIXEL_SHARE
            or pcounts["bvh_kernel"] != pres.trips):
        raise AssertionError("random_scene: the pool with the BVH disagrees "
                             "with the megakernel")
    out["shirley"] = dict(
        rays=res.rays_traced, seconds=res.seconds,
        mrays_per_sec=res.mrays_per_sec, launches=counts["megakernel"],
        ms_per_launch=mk_ms, bound_ms=bound["bound_ms"],
        bound_by=bound["bound_by"], max_abs_err=err, layout=lay,
        registers=regs, spill_bytes=spill_st + spill_ld, image=bands,
        pool_bvh=dict(seconds=pres.seconds, mrays_per_sec=pres.mrays_per_sec,
                      iterations=pres.iterations, rays=pres.rays_traced))
    del ctx, pctx
    torch.cuda.empty_cache()

    mark("phase 13")
    # 14 (P2). pbr_ibl through the queue pool: the card against the CPU,
    # then the main path.
    s14 = path.RenderSettings(max_depth=IBL_DEPTH)
    small = {d: renderer.render(pbr_ibl(), 16, 16, 4, s14, seed=0, device=d)
             for d in ("cpu", "cuda")}
    a, b = small["cuda"].image, small["cpu"].image
    share = float((np.abs(a - b) <= PIXEL_ATOL + XYZ_RTOL * np.abs(b))
                  .all(axis=2).mean())
    rays_rel = abs(small["cuda"].rays_traced - small["cpu"].rays_traced) / (
        small["cpu"].rays_traced)
    mean_rel = abs(float(a.mean()) / float(b.mean()) - 1)
    print(f"phase 14: pbr_ibl 16x16@4 depth {IBL_DEPTH}, card vs CPU: rays "
          f"{small['cuda'].rays_traced} vs {small['cpu'].rays_traced}; pixels "
          f"within {PIXEL_ATOL} + {XYZ_RTOL}|cpu| {share:.4f} (tol "
          f"{PIXEL_SHARE}); max abs err {float(np.abs(a - b).max()):.3e}; mean "
          f"rel {mean_rel:.2e}", flush=True)
    if not (rays_rel <= RAYS_RTOL and share >= PIXEL_SHARE
            and mean_rel <= MEAN_RTOL and np.isfinite(a).all()):
        raise AssertionError("pbr_ibl: the card disagrees with the CPU")
    ctx = renderer.RenderContext(pbr_ibl(), device=dev)
    print(f"pbr_ibl: {ctx.meta.n_prims} prims, combined stack "
          f"{tuple(ctx.cs.textures.combined.shape)}, megakernel-eligible "
          f"{ctx.mega_supported()}", flush=True)
    res, counts, _, _, ibl_calls = timed_render(
        "pbr_ibl main path", ctx, IBL_SIZE, IBL_SPP, s14, card, threefry,
        "uniforms_for_keys", lambda r: None)
    ibl_cipher = cipher_on_path(ibl_calls, counts["threefry"], card,
                                "the pbr_ibl main path")
    bands = image_checks("pbr_ibl image", res.image, IBL_SIZE)
    if not (bands["top"][2] > bands["top"][0] and bands["bottom"][0]
            > bands["bottom"][2] and bands["centre"][1] > 0.02):
        raise AssertionError("pbr_ibl: expected the sky above, the ground "
                             "below and the spheres lit")
    mark("phase 14 before L")
    loop14 = loop_phase("pbr_ibl", ctx, IBL_SIZE, IBL_SPP, s14, card, 16)
    out["pbr_ibl"] = dict(
        rays=res.rays_traced, seconds=res.seconds,
        mrays_per_sec=res.mrays_per_sec, iterations=res.iterations,
        trips=res.trips, replays=res.replays,
        cipher_launches=counts["threefry"], cipher=ibl_cipher, image=bands,
        profiled_idle_share_16spp=loop14["graphed"]["profile"]["idle_share"],
        loop=loop14)
    del ctx
    torch.cuda.empty_cache()

    mark("phase 14")
    # 15 (P3). The book-2 final scene through the pool and the BVH4 kernel.
    ctx = renderer.RenderContext(final(), device=dev)
    ks = ctx.intersect.ks
    print(f"phase 15: final: {ctx.meta.n_prims} prims, {ks.nodes.shape[0]} "
          f"nodes; media {ctx.meta.n_media} (spheres {ctx.meta.media_is_sphere}"
          f"), has_image {ctx.meta.has_image}, has_noise "
          f"{ctx.meta.has_noise}; compile and build {ctx.build_seconds:.3f} s",
          flush=True)
    trav = compare_traversal("final", ks, traversal_rays(
        ks, ctx.cs.camera, TRAVERSE_RAYS, 15), card)
    s15 = path.RenderSettings(max_depth=FINAL_DEPTH)
    res, counts, _, calls, final_calls = timed_render(
        "final main path", ctx, FINAL_SIZE, FINAL_SPP, s15, card, bvh_kernel,
        "closest_hit", lambda r: r.trips)
    final_cipher = cipher_on_path(final_calls, counts["threefry"], card,
                                  "the final main path")
    mark("phase 15 before L")
    loop15 = loop_phase("final", ctx, FINAL_SIZE, FINAL_SPP, s15, card,
                        FINAL_SPP, (bvh_kernel, "closest_hit"))
    trav_ms = loop15["kernel_ms"] * calls
    bands = image_checks("final image", res.image, FINAL_SIZE)
    # The light faces up (an unflipped XZRect, one-sided on its record
    # normal, diffuselight.go:49-63) and lights nothing below it: red and
    # green are 0, blue is the depth-cap sentinel's on paths that reach
    # depth 50, as in the JAX package.
    blue = float((res.image[..., 2] > 0).mean())
    print(f"final image: red and green max {bands['max'][:2]}, blue on "
          f"{blue:.4%} of the pixels", flush=True)
    if bands["max"][0] != 0.0 or bands["max"][1] != 0.0 or not blue > 0:
        raise AssertionError("final: expected red and green 0 and some blue")
    # The card against the CPU (the same code, the plain traversal). The
    # two devices' libm and division differ in the last ulp, which turns a
    # few of final's paths (its fog, its noise) into others; at 16x16@2 the
    # rays' gap reached 0.51%, and it shrinks as the frame grows.
    n_c, spp_c = FINAL_VS_CPU
    mark("phase 15 before the CPU")
    small = {d: renderer.render(final(), n_c, n_c, spp_c, s15, seed=0,
                                device=d) for d in ("cpu", "cuda")}
    a, b = small["cuda"].image, small["cpu"].image
    share = float((np.abs(a - b) <= PIXEL_ATOL + XYZ_RTOL * np.abs(b))
                  .all(axis=2).mean())
    rays_rel = abs(small["cuda"].rays_traced - small["cpu"].rays_traced) / (
        small["cpu"].rays_traced)
    lit = [int((img[..., 2] > 0).sum()) for img in (a, b)]
    print(f"final {n_c}x{n_c}@{spp_c} depth {FINAL_DEPTH}, card vs CPU: rays "
          f"{small['cuda'].rays_traced} vs {small['cpu'].rays_traced} (rel "
          f"{rays_rel:.2e}, tol {RAYS_RTOL}); pixels within {PIXEL_ATOL} + "
          f"{XYZ_RTOL}|cpu| {share:.6f} (tol {PIXEL_SHARE}); blue pixels "
          f"{lit[0]} vs {lit[1]}; max abs err "
          f"{float(np.abs(a - b).max()):.3e}", flush=True)
    if not (rays_rel <= RAYS_RTOL and share >= PIXEL_SHARE
            and np.isfinite(a).all()):
        raise AssertionError("final: the card disagrees with the CPU")
    out["final"] = dict(
        rays=res.rays_traced, seconds=res.seconds,
        mrays_per_sec=res.mrays_per_sec, iterations=res.iterations,
        trips=res.trips, replays=res.replays,
        launches=counts["bvh_kernel"], cipher_launches=counts["threefry"],
        ms_per_launch=loop15["kernel_ms"],
        kernel_share=trav_ms / 1e3 / res.seconds, traversal=trav,
        loop=loop15,
        blue_pixel_share=blue, cipher=final_cipher,
        vs_cpu=dict(frame=FINAL_VS_CPU, rays_rel=rays_rel, pixel_share=share))
    return out


# Phases 16-17: the training step (the Cornell box at 256², depth 50, as
# __graft_entry__ compiles it; cornell_box_obj through the BVH4 kernel),
# 1 spp a step, seed 0, plain gradient descent on every parameter.
TRAIN_SIZE, TRAIN_DEPTH, TRAIN_TARGET_SPP = 256, 50, 64
TRAIN_STEPS, TRAIN_LR = 5, 1.0
STEP_SPP = 4                  # the samples a pixel of phase 16's merged step
TRAIN_VS_CPU = (32, 8)        # frame and depth of the card-vs-CPU step
TRAIN_VS_PLAIN = 64           # frame of phase 17's kernel-vs-plain step
# tests/test_torch_grad.py's tolerances: loss within STEP_LOSS_RTOL, each
# gradient entry within STEP_GRAD_ATOL + STEP_GRAD_RTOL·|reference|.
STEP_LOSS_RTOL, STEP_GRAD_ATOL, STEP_GRAD_RTOL = 1e-4, 1e-5, 1e-3
# G's tolerances (tests/test_torch_step.py), which the fused step meets
# against the checkpointed one on the CPU: reported on the card.
STEP_TIGHT_RTOL, STEP_TIGHT_ATOL = 1e-5, 1e-6
# Bytes of one bounce's carried state a ray: o, d, throughput, radiance
# (f32 × 3 each), the live flag and the depth (int64), which each
# checkpointed bounce keeps.
STATE_BYTES_PER_RAY = 4 * 3 * 4 + 1 + 8
# Phase 18: the CLI's default render (500²@1000, depth 50, the spectral
# pyramid), its checkpoint interval, and the AOV and spectral-upgrade
# frames.
CKPT_INTERVAL = 250
AOV_SIZE, AOV_SPP = 256, 4
UPGRADE_SIZE, UPGRADE_SPP = 256, 16
UPGRADE_VS_CPU = (64, 4)
# Runs `python -m izpi_tpu_torch` as runpy does it for -m, in a process
# that prints the launch counters after the run.
COUNTING_MAIN = (
    "import json, runpy, sys\n"
    "from izpi_tpu_torch.ops import (bvh_kernel, bvh_rowkernel, megakernel,\n"
    "                                megakernel_spectral, threefry)\n"
    "sys.argv[0] = 'izpi_tpu_torch'\n"
    "code = 0\n"
    "try:\n"
    "    runpy.run_module('izpi_tpu_torch', run_name='__main__',\n"
    "                     alter_sys=True)\n"
    "except SystemExit as exc:\n"
    "    code = exc.code\n"
    "print('LAUNCHES ' + json.dumps({m.__name__.rsplit('.', 1)[1]: m.launches\n"
    "      for m in (bvh_kernel, bvh_rowkernel, megakernel,\n"
    "                megakernel_spectral, threefry)}))\n"
    "sys.exit(code)\n")


def train_pixels(n: int, dev):
    ys = torch.arange(n, device=dev).repeat_interleave(n)
    xs = torch.arange(n, device=dev).repeat(n)
    return xs, ys


def scaled_params(cs):
    """The scene's parameters, tex_c0 at 0.7 of its values."""
    params = dist.extract_params(cs)
    with torch.no_grad():
        params["tex_c0"] *= 0.7
    return params


def forward_counts(ctx, n: int, depth: int, params, intersect=None,
                   early_exit=None, route="checkpoint"):
    """Launches and rays of the training step's forward pass alone (the
    differentiable sample's trace under no_grad, on `route`: by default
    the checkpointed bounces' fixed trip, or with early_exit the
    early-exit form the eager step ran before; a `DiffScene` for the
    fused route's forward kernel)."""
    xs, ys = train_pixels(n, ctx.device)
    cs_p = dist.inject_params(ctx.cs, params)
    zero_counts()
    with torch.no_grad():
        o, d, tme, keys = renderer.camera_rays(
            cs_p, rng.render_key(0, device=ctx.device), xs, ys, n, n, 0)
        _, rays = path.trace(cs_p, ctx.meta, path.RenderSettings(
            max_depth=depth), intersect or ctx.intersect, o, d, tme, keys,
            differentiable=True, early_exit=early_exit, route=route)
    return read_counts(), int(rays)


def make_step(ctx, n: int, depth: int, intersect=None, runner=None,
              route=None, spp: int = 1):
    """`dist.build_train_step` on the context's scene at n², spp samples a
    pixel (1 by default): by default the captured step (a `loops.Graphed`,
    `step.runner`) on the route the step picks (the fused one for the
    Cornell scenes)."""
    return dist.build_train_step(ctx.cs, ctx.meta,
                                 path.RenderSettings(max_depth=depth),
                                 intersect or ctx.intersect, n, n, spp=spp,
                                 runner=runner, route=route)


def timed_step(step, ctx, n: int, params, target) -> dict:
    """One call of `step`, every launch counter zeroed just before and read
    just after: loss, grads, rays, seconds (CUDA-synchronised), counts,
    the cipher entry's launches in its bounce form (`bounce_cipher`: its
    counter less the new-sample form's), the sample passes the forward
    kernel's launches carried (`passes`), and the peak memory allocated
    during the call (absolute, and above what was allocated before)."""
    dev = ctx.device
    xs, ys = train_pixels(n, dev)
    key = rng.render_key(0, device=dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    zero_counts()
    t0 = time.perf_counter()
    loss, grads = step(params, xs, ys, target, key)
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    samples = threefry.sample_launches
    passes = diff_trace.fwd_passes
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"the gradient of {k} is not finite")
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"the loss is {float(loss)}")
    return dict(loss=float(loss), grads={k: g.cpu().numpy()
                                         for k, g in grads.items()},
                rays=step.rays, seconds=seconds, counts=counts,
                bounce_cipher=counts["threefry"] - samples, passes=passes,
                peak=peak, peak_above=peak - base if cuda else 0)


def steps_agree(label: str, got: dict, want: dict, card: str) -> float:
    """Raise unless two steps traced equal rays and their losses and
    gradients agree within the tolerances above; returns the largest
    gradient difference."""
    err = max(float(np.abs(got["grads"][k] - want["grads"][k]).max())
              for k in want["grads"])
    ok = got["rays"] == want["rays"] and abs(got["loss"] - want["loss"]) <= (
        STEP_LOSS_RTOL * abs(want["loss"]))
    for k, w in want["grads"].items():
        ok &= bool(np.all(np.abs(got["grads"][k] - w)
                          <= STEP_GRAD_ATOL + STEP_GRAD_RTOL * np.abs(w)))
    print(f"{label}: rays {got['rays']} vs {want['rays']}, loss "
          f"{got['loss']:.7f} vs {want['loss']:.7f} (rtol {STEP_LOSS_RTOL}), "
          f"largest gradient difference {err:.3e} (tol {STEP_GRAD_ATOL} + "
          f"{STEP_GRAD_RTOL}|ref|); {got['seconds']:.4f} s vs "
          f"{want['seconds']:.4f} s ({card})", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the steps disagree")
    return err


def steps_equal(label: str, a: dict, b: dict) -> None:
    """Raise unless two replays gave the same rays and the same bits."""
    same = a["rays"] == b["rays"] and np.float32(a["loss"]).tobytes() == (
        np.float32(b["loss"]).tobytes()) and all(
        a["grads"][k].tobytes() == b["grads"][k].tobytes() for k in a["grads"])
    print(f"{label}: two replays bit for bit {same}", flush=True)
    if not same:
        raise AssertionError(f"{label}: two replays differ")


def captured_vs_eager(label: str, ctx, n: int, depth: int, params, target,
                      step, card: str, eager_runs: int = 2) -> dict:
    """The captured `step` (already warm) and the eager step on its route
    on the same context at the same parameters, in one call: each one's
    seconds (the eager median of its runs after the first), two replays
    bit for bit, and the captured step held to the eager one."""
    eager = make_step(ctx, n, depth, runner=loops.Eager(), route=step.route)
    e_runs = [timed_step(eager, ctx, n, params, target)
              for _ in range(eager_runs + 1)]
    c1 = timed_step(step, ctx, n, params, target)
    c2 = timed_step(step, ctx, n, params, target)
    steps_equal(label, c1, c2)
    err = steps_agree(f"{label}, captured vs eager", c1, e_runs[-1], card)
    eager_s = float(np.median([r["seconds"] for r in e_runs[1:]]))
    return dict(eager=e_runs[-1], captured=c1, eager_seconds=eager_s,
                eager_seconds_all=[r["seconds"] for r in e_runs],
                captured_seconds=[c1["seconds"], c2["seconds"]],
                max_grad_err_vs_eager=err)


def replay_counts(label: str, s: dict, forward: dict, want: dict) -> dict:
    """The launches of one replay, forward and in the recompute: raise
    unless each kernel of `want` ran its launches and nothing else ran but
    the gathers' backward kernel."""
    counts = s["counts"]
    others = {k: v for k, v in counts.items()
              if k not in want and k != "table_grad" and v}
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad or others or not counts["table_grad"]:
        raise AssertionError(f"{label}: a replay launched {counts} (want "
                             f"{want} and the gathers' backward)")
    return {k: dict(forward=forward[k], recompute=counts[k] - forward[k])
            for k in want}


def table_grad_phase(inputs: dict, names: dict, card: str,
                     plain_reps: int = 100) -> dict:
    """G (`csrc/table_grad.cu`) against its plain version at the step's
    inputs of each table, (rows, g, calls a step, count): where count (on
    the device) is given, G is called as the fused step calls it, on the
    reverse kernel's whole buffer with that count, and every other form
    takes the first count rows alone. The float64 sum within the kernel's
    bound (its source), the plain version (`index_put_`, the checkpointed
    route's backward) within that bound plus f32 recursive summation's
    γ_count·Σ|g|, two launches and the counted rows given alone in another
    order bit for bit; its ms and `index_add_`'s (the atomic library call),
    each over a CUDA graph of 100 calls, the plain version's over
    plain_reps, and its bound by bytes (the rows that count)."""
    out = {}
    for shape, (slot_rows, slot_g, calls, n_live) in inputs.items():
        slots = slot_g.shape[0]
        live = slots if n_live is None else int(n_live)
        rows, g = slot_rows[:live].contiguous(), slot_g[:live].contiguous()
        n, c = g.shape
        r = int(np.prod(shape)) // c

        def kernel():
            return table_grad.table_grad(slot_rows, slot_g, shape,
                                         count=n_live)

        got = kernel()
        again = kernel()
        perm = torch.randperm(n, device=g.device, generator=torch.Generator(
            device=g.device).manual_seed(0))
        permuted = table_grad.table_grad(rows[perm].contiguous(),
                                         g[perm].contiguous(), shape)
        plain = table_grad.table_grad_reference(rows, g, shape)

        def summed(x):
            acc = torch.zeros((r, c), dtype=x.dtype, device=x.device)
            return acc.index_put_((rows,), x, accumulate=True).reshape(shape)

        exact = summed(g.double())
        count = summed(torch.ones_like(g, dtype=torch.float64))
        bound = n * n * float(g.abs().max()) * 2.0 ** -63 + (
            exact.abs() * 2.0 ** -24)
        gamma = count * 2.0 ** -24 / (1 - count * 2.0 ** -24)
        err = float((got.double() - plain.double()).abs().max())
        ok_exact = bool(((got.double() - exact).abs() <= bound).all())
        ok_plain = bool(((got.double() - plain.double()).abs()
                         <= bound + gamma * summed(g.abs().double())).all())
        bits = torch.equal(got.view(torch.int32), again.view(torch.int32)) and (
            torch.equal(got.view(torch.int32), permuted.view(torch.int32)))
        flat = torch.zeros((r, c), device=g.device)
        ms = profiling.graph_ms(kernel, 100)
        plain_ms = profiling.graph_ms(
            lambda: table_grad.table_grad_reference(rows, g, shape),
            plain_reps)
        library_ms = profiling.graph_ms(
            lambda: flat.index_add_(0, rows, g), 100)
        nbytes = 8 * n + 4 * n * c + 4 * r * c + (0 if n_live is None else 4)
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        name = names.get(shape, str(shape))
        print(f"table_grad: {name} {tuple(shape)} ({table_grad.path_for(shape)}"
              f" path), {n} rows of {c}"
              f"{'' if n_live is None else f' counted on the device in a buffer of {slots}'}"
              f", {calls} calls a step: kernel "
              f"{ms:.5f} ms, plain (index_put_) {plain_ms:.5f} ms, "
              f"index_add_ {library_ms:.5f} ms, bound {bound_ms:.5f} ms by "
              f"bytes ({bound_ms / ms:.2%}); max |kernel - plain| {err:.3e}, "
              f"within the fixed point's bound of the float64 sum "
              f"{ok_exact}, of the plain version (+ f32 summation's "
              f"gamma·sum|g|) {ok_plain}; two launches and permuted rows "
              f"{'given alone ' if n_live is not None else ''}bit for bit "
              f"{bits} ({card})", flush=True)
        if not (ok_exact and ok_plain and bits):
            raise AssertionError(f"table_grad disagrees on {name}")
        out[name] = dict(shape=list(shape), path=table_grad.path_for(shape),
                         rows=n, slots=slots, width=c, calls_per_step=calls,
                         ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by="bytes",
                         max_abs_err=err)
    return out


def memory_per_bounce(ctx, n: int, depth: int, target, step, eager_peak_above,
                      card: str) -> dict:
    """Memory against depth (the fixed trip runs `depth` bounces): the
    eager step's peak above its start and the captured step's graph
    (`capture_bytes`: its static buffers and private pool) at depth 8 and
    at `depth`; each one's growth a bounce must stay within twice one
    bounce's carried state."""
    s8 = make_step(ctx, n, 8)
    timed_step(s8, ctx, n, scaled_params(ctx.cs), target)
    e8 = timed_step(make_step(ctx, n, 8, runner=loops.Eager()), ctx, n,
                    scaled_params(ctx.cs), target)
    state = n * n * STATE_BYTES_PER_RAY
    out = dict(state_bytes=state)
    for form, at8, atd in (("eager", e8["peak_above"], eager_peak_above),
                           ("captured", s8.runner.capture_bytes,
                            step.runner.capture_bytes)):
        per = (atd - at8) / (depth - 8)
        print(f"training step memory, {form}: depth 8 {at8 / 2**20:.1f} MiB, "
              f"depth {depth} {atd / 2**20:.1f} MiB "
              f"({'peak above the start' if form == 'eager' else 'the graph'}"
              f"); growth {per / 2**20:.3f} MiB a bounce, one bounce's "
              f"carried state {state / 2**20:.3f} MiB, ratio "
              f"{per / state:.3f} (tol 2) ({card})", flush=True)
        if not per <= 2 * state:
            raise AssertionError(f"the {form} step's memory grows by more "
                                 f"than two bounces' state a bounce")
        out[form] = dict(at_8=at8, at_depth=atd, bytes_per_bounce=per)
    del s8
    return out


def diff_pairs(keys, rec_i, cnt, depth: int) -> tuple:
    """(scatters, bounce pairs drawn) of the forward kernel's records: a
    dielectric draws pair 3, a diffuse bounce pair 4 and then the light
    sample's four pairs or the cosine lobe's one, by its us[4]
    (csrc/draws.cuh); us[4] from the cipher entry, bounce by bounce."""
    code = rec_i & ((1 << diff_trace.CODE_BITS) - 1)
    live = torch.arange(depth, device=rec_i.device)[:, None] < cnt[None, :]
    scatters = pairs = 0
    for k in range(depth):
        diffuse = live[k] & (code[k] == diff_trace.SCATTER)
        glass = live[k] & (code[k] == diff_trace.REFRACT)
        if not bool((diffuse | glass).any()):
            break
        u4 = rng.bounce_uniforms(keys, k, 12)[:, 4]
        scatters += int(diffuse.sum()) + int(glass.sum())
        pairs += int(glass.sum()) + int(
            torch.where(diffuse, torch.where(u4 < 0.5, 5, 2), 0).sum())
    return scatters, pairs


def counting_bvh(ctx):
    """The BVH4 kernel's intersector over ctx's tree that adds the (nodes
    popped, primitives tested) of each ray not parked outside the scene to
    `.counts`: the traversal the forward kernel's BVH form runs
    (bvh4.cuh), counted for its bound."""
    ks, cs = ctx.intersect.ks, ctx.intersect.cs

    def intersect(o, d, time, t_min, t_max):
        t, idx, c = bvh_kernel.closest_hit(ks, o.contiguous(), d.contiguous(),
                                           time.contiguous(), t_min, t_max,
                                           counts=True)
        live = o[:, 0] < 0.5 * path.PARK
        intersect.counts += c[live].sum(dim=0)
        return primitives.finalize_hit(cs.prims, o, d, time, t, idx, idx >= 0)

    intersect.counts = torch.zeros(2, dtype=torch.int64, device=ctx.device)
    return intersect


def forward_vs_plain(label: str, got, want, depth: int, card: str) -> tuple:
    """Raise unless the forward kernel's outputs `got` (rad, cnt, rec_f,
    rec_i) agree with its plain version's `want` on the same rays: the
    image within phase 4's tolerances, and on the paths that take the
    plain version's branches (at least PIXEL_SHARE of them) the records
    within rtol 1e-4. Returns (the largest pixel difference, that share,
    the kernel's rays, the plain version's)."""
    rays_k, rays_p = int(got[1].sum()), int(want[1].sum())
    err = image_close(label, vm.de_nan(got[0]), rays_k, vm.de_nan(want[0]),
                      rays_p, 1)
    live = torch.arange(depth, device=got[1].device)[:, None] < want[1][None, :]
    same = (got[1] == want[1]) & ((got[3] == want[3]) | ~live).all(0)
    keep = live & same[None, :]
    rec_err = float(((got[2][keep] - want[2][keep]).abs() / (
        1e-6 + want[2][keep].abs())).max()) if bool(keep.any()) else 0.0
    share = float(same.float().mean())
    rec_ok = bool(torch.allclose(got[2][keep], want[2][keep], rtol=1e-4,
                                 atol=1e-6))
    print(f"{label}: diff_trace_fwd records: paths taking the plain "
          f"version's branches {share:.6f} (tol {PIXEL_SHARE}), their "
          f"records within rtol 1e-4 {rec_ok} (largest relative difference "
          f"{rec_err:.3e}); rays equal {rays_k == rays_p} ({card})",
          flush=True)
    if not (share >= PIXEL_SHARE and rec_ok):
        raise AssertionError(f"{label}: the forward kernel's records differ")
    return err, share, rays_k, rays_p


def reverse_vs_g(label: str, scene, want, g_rad, c0, c1, s, card: str,
                 passes: int = 1) -> list:
    """Raise unless one call of the fused reverse (`diff_trace.reverse`,
    one call counted and nothing else) on the plain forward's records
    `want` of `passes` sample passes at the radiance's cotangent g_rad
    gives each pass's table gradient bit for bit as G (`table_grad`) on
    `reverse_reference`'s slots of that pass's paths, one a record (their
    count on the device equal to the pass's rays). The slots are taken
    first: the reverse keeps its cotangents in want's records. Returns
    each pass's slots (rows, g, count)."""
    n_pass = want[1].shape[0] // passes
    n_rows = scene.n_tex * (2 if scene.checker else 1)
    out = []
    for k in range(passes):
        own = slice(k * n_pass, (k + 1) * n_pass)
        out.append(diff_trace.reverse_reference(
            want[2][:, own], want[3][:, own], want[1][own], g_rad[own], c0, c1,
            s, scene.checker))
    zero_counts()
    grads = diff_trace.reverse(scene, want[2], want[3], want[1], g_rad, c0,
                               c1, s, passes)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["diff_trace_bwd"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"{label}: the reverse's wrapper launched "
                             f"{counts}")
    for k, (rows, g, count) in enumerate(out):
        own = slice(k * n_pass, (k + 1) * n_pass)
        via_g = table_grad.table_grad(rows, g, (n_rows, 3), count=count)
        slots = int(count)
        bits = slots == int(want[1][own].sum()) and torch.equal(
            grads[k].view(torch.int32), via_g.view(torch.int32))
        print(f"{label}, sample pass {k} of {passes}: {slots} slots, one a "
              f"record, of a buffer of {rows.shape[0]}: the ({n_rows}, 3) "
              f"table gradient bit for bit {bits} ({card})", flush=True)
        if not bits:
            raise AssertionError(f"{label}: the fused reverse differs from G "
                                 f"in sample pass {k}")
    return out


def restored_ms(fn, records, reps: int = 20) -> float:
    """ms of fn() over a CUDA graph of reps calls, each after `records`
    are copied back from a clone taken first, less the copies' own ms:
    `diff_trace.reverse` keeps its cotangents in the records it reads, so
    that each timed call reads the forward's records. They are left as
    they were."""
    pristine = [r.clone() for r in records]

    def restore():
        for r, p in zip(records, pristine):
            r.copy_(p)

    def both():
        restore()
        fn()

    ms = profiling.graph_ms(both, reps) - profiling.graph_ms(restore, reps)
    restore()
    torch.cuda.synchronize()
    return ms


def merged_kernel_phase(label: str, ctx, n: int, depth: int, params, target,
                        spp: int, card: str, plain_intersect=None,
                        plain_n=None) -> dict:
    """The fused route's kernels as the training step at spp samples a
    pixel launches them (`renderer.sample_passes`): the camera rays of
    samples 0..spp-1 (`renderer.sample_rays`) in one launch of the forward
    kernel, `fwd_passes` counting spp. Each pass's slice of its outputs
    bit for bit those of the kernel's launch on that pass's rays alone,
    and at plain_n² (by default n²) within `forward_vs_plain`'s
    tolerances of `forward_reference` (through `plain_intersect`, by
    default the context's) on them; one call of the reverse with spp
    passes on the plain forward's records of every pass, at the cotangent
    of the passes' mean against `target` (grey where plain_n < n): each
    pass's table bit for bit G's on that pass's slots (`reverse_vs_g`).
    Then, at n², the merged launch's and call's ms against spp launches
    and calls of one pass each (CUDA graphs of 20)."""
    dev = ctx.device
    meta = ctx.meta
    scene = diff_trace.prepare(ctx.cs, meta, ctx.intersect)
    s = path.RenderSettings(max_depth=depth)
    cs_p = dist.inject_params(ctx.cs, {k: v.detach()
                                       for k, v in params.items()})
    c0, c1 = cs_p.textures.c0, cs_p.textures.c1
    key = rng.render_key(0, device=dev)

    def fwd(rays, passes=1):
        return diff_trace.forward(scene, cs_p, meta, s, ctx.intersect, *rays,
                                  passes)

    def rays_of(m):
        xs, ys = train_pixels(m, dev)
        merged = tuple(x.contiguous() for x in renderer.sample_rays(
            cs_p, key, xs, ys, m, m, spp))
        own = [tuple(x.contiguous() for x in renderer.camera_rays(
            cs_p, key, xs, ys, m, m, k)) for k in range(spp)]
        return merged, own

    m = plain_n or n
    merged, own = rays_of(m)
    zero_counts()
    p0 = diff_trace.fwd_passes
    got = fwd(merged, spp)
    torch.cuda.synchronize()
    counts = read_counts()
    if (counts["diff_trace_fwd"] != 1 or sum(counts.values()) != 1
            or diff_trace.fwd_passes - p0 != spp):
        raise AssertionError(f"{label}: the merged forward launched {counts}, "
                             f"{diff_trace.fwd_passes - p0} passes")
    plain_int = plain_intersect or ctx.intersect
    wants, slices_bits = [], []
    for k, rays in enumerate(own):
        sl = slice(k * m * m, (k + 1) * m * m)
        alone = fwd(rays)
        live = torch.arange(depth, device=dev)[:, None] < alone[1][None, :]
        bits = (torch.equal(got[0][sl].view(torch.int32),
                            alone[0].view(torch.int32))
                and torch.equal(got[1][sl], alone[1])
                and torch.equal(got[2][:, sl][live].view(torch.int32),
                                alone[2][live].view(torch.int32))
                and torch.equal(got[3][:, sl][live], alone[3][live])
                and all(torch.equal(a[sl], b)
                        for a, b in zip(merged, rays)))
        slices_bits.append(bits)
        print(f"{label}: diff_trace_fwd's merged launch of {spp} passes "
              f"{m}x{m} depth {depth}, pass {k}: its camera rays, radiance, "
              f"counts and records bit for bit the launch on the pass's rays "
              f"alone {bits} ({card})", flush=True)
        if not bits:
            raise AssertionError(f"{label}: pass {k}'s slice of the merged "
                                 f"launch differs from its own launch")
        want = diff_trace.forward_reference(cs_p, meta, s, plain_int, *rays)
        forward_vs_plain(f"{label}: diff_trace_fwd's merged launch, pass {k}, "
                         f"vs its plain version {m}x{m} depth {depth}",
                         (got[0][sl], got[1][sl], got[2][:, sl],
                          got[3][:, sl]), want, depth, card)
        wants.append(want)
    want = (torch.cat([w[0] for w in wants]), torch.cat([w[1] for w in wants]),
            torch.cat([w[2] for w in wants], 1).contiguous(),
            torch.cat([w[3] for w in wants], 1).contiguous())
    colours = vm.de_nan(want[0]).view(spp, m * m, 3)
    tgt = target if m == n else torch.full((m * m, 3), 0.25, device=dev)
    mean = colours.sum(0) / spp
    g_rad = torch.where(torch.isfinite(want[0]),
                        (2.0 * (mean - tgt) / float(m * m * 3 * spp)).repeat(
                            spp, 1),
                        torch.zeros((), device=dev)).contiguous()
    reverse_vs_g(f"{label}: diff_trace_bwd (the fused reverse) of {spp} "
                 f"passes vs G on its plain version's slots ({m}x{m})",
                 scene, want, g_rad, c0, c1, s, card, spp)
    del wants, want, got

    # Times at n²: the merged launch and call against spp of one pass.
    big, big_own = rays_of(n) if m != n else (merged, own)
    rad, cnt, rec_f, rec_i = fwd(big, spp)
    g_big = torch.where(torch.isfinite(rad), 2.0 * (vm.de_nan(rad) - 0.25)
                        / float(n * n * 3 * spp),
                        torch.zeros((), device=dev)).contiguous()
    fwd_ms = profiling.graph_ms(lambda: fwd(big, spp), 20)
    fwd_own_ms = profiling.graph_ms(lambda: [fwd(r) for r in big_own], 20)
    bwd_ms = restored_ms(lambda: diff_trace.reverse(
        scene, rec_f, rec_i, cnt, g_big, c0, c1, s, spp), [rec_f])
    sl = [slice(k * n * n, (k + 1) * n * n) for k in range(spp)]
    parts = [(rec_f[:, x].contiguous(), rec_i[:, x].contiguous(),
              cnt[x].contiguous(), g_big[x].contiguous()) for x in sl]
    bwd_own_ms = restored_ms(lambda: [diff_trace.reverse(
        scene, *p[:3], p[3], c0, c1, s) for p in parts], [p[0] for p in parts])
    print(f"{label}: {n}x{n}@{spp} depth {depth}, {int(cnt.sum())} rays: "
          f"diff_trace_fwd one launch of the {spp} passes {fwd_ms:.4f} ms, "
          f"{spp} launches of a pass {fwd_own_ms:.4f} ms; the reverse one "
          f"call of the {spp} passes {bwd_ms:.4f} ms, {spp} calls of a pass "
          f"{bwd_own_ms:.4f} ms (CUDA graphs of 20; the reverse's each call "
          f"on the forward's records copied back, the copies' time taken "
          f"off) ({card})", flush=True)
    return dict(spp=spp, plain_frame=m, slices_bit_for_bit=slices_bits,
                fwd_ms=fwd_ms, fwd_own_ms=fwd_own_ms, bwd_ms=bwd_ms,
                bwd_own_ms=bwd_own_ms, rays=int(cnt.sum()))


def loop_step(ctx, n: int, depth: int, spp: int, route):
    """The training step at n², spp samples a pixel, a sample pass at a
    time and eagerly, as `dist.build_train_step` ran every route before the
    fused route traced its passes as one (`renderer.sample_pass` for each
    sample, the colours added in order): step(params, xs, ys, target, key)
    -> (loss, grads), its rays in `step.rays`."""
    settings = path.RenderSettings(max_depth=depth)

    def step(params, xs, ys, target, key):
        leaves = {k: params[k].detach().requires_grad_(True)
                  for k in dist.PARAMS}
        cs_p = dist.inject_params(ctx.cs, leaves)
        acc = rays = None
        for k in range(spp):
            color, nr = renderer.sample_pass(
                cs_p, ctx.meta, settings, ctx.intersect, n, n, xs, ys, key, k,
                differentiable=True, route=route)
            acc = color if acc is None else acc + color
            rays = nr if rays is None else rays + nr
        n_total = xs.shape[0] * 3
        se = torch.sum((acc / spp - target) ** 2)
        grads = torch.autograd.grad(se / float(n_total),
                                    [leaves[k] for k in dist.PARAMS],
                                    allow_unused=True)
        step.rays = int(rays)
        return se.detach() / float(n_total), {
            k: torch.zeros_like(leaves[k]) if g is None else g
            for k, g in zip(dist.PARAMS, grads)}

    return step


def diff_kernel_phase(label: str, ctx, n: int, depth: int, params, target,
                      card: str, plain_intersect=None, plain_n=None,
                      probe: bool = False) -> dict:
    """The fused route's kernels (`ops.diff_trace`) against their plain
    versions on the card at the step's camera rays: the forward kernel
    (its BVH form through the context's tree) against `forward_reference`
    through `plain_intersect` (by default the context's) at plain_n² (by
    default n²) within phase 4's tolerances, and on the paths that take the
    same branches its records within rtol 1e-4; the fused reverse on the
    plain forward's records at the step's own cotangent of the radiance
    (the loss's against `target`, through DeNAN): its table gradient bit
    for bit G's on `reverse_reference`'s slots (one a record; their count
    on the device must equal the rays); G on those slots and count through
    `table_grad_phase`. Then
    each kernel's ms at n² (over a CUDA graph of 20 calls, so that the
    wrapper's host cost is not timed) beside its plain version's and
    its bound: the forward's from the SASS probes' units (the draws its
    records hold, the primitives every ray tests or, for the BVH form, the
    nodes and tests of its traversal) and its bytes, its records among
    them; the reverse's by bytes (its records, ray counts, the step's
    cotangent and the texture rows read once, the table written once),
    beside R's and G's bounds before they were fused. With `probe`, the
    forward kernel's probe instance
    at n² (`diff_trace.probe`): its outputs must equal the kernel's bit
    for bit, its passes each warp's longest path; its figures printed."""
    dev = ctx.device
    meta = ctx.meta
    scene = diff_trace.prepare(ctx.cs, meta, ctx.intersect)
    if scene is None:
        raise AssertionError(f"{label}: the scene does not take the fused "
                             f"route")
    s = path.RenderSettings(max_depth=depth)
    cs_p = dist.inject_params(ctx.cs, {k: v.detach()
                                       for k, v in params.items()})
    c0, c1 = cs_p.textures.c0, cs_p.textures.c1

    def rays_of(m):
        xs, ys = train_pixels(m, dev)
        return tuple(x.contiguous() for x in renderer.camera_rays(
            cs_p, rng.render_key(0, device=dev), xs, ys, m, m, 0))

    def fwd(rays):
        return diff_trace.forward(scene, cs_p, meta, s, ctx.intersect, *rays)

    m = plain_n or n
    small = rays_of(m)
    zero_counts()
    got = fwd(small)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["diff_trace_fwd"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"{label}: the forward kernel's wrapper "
                             f"launched {counts}")
    plain_int = plain_intersect or ctx.intersect
    want = diff_trace.forward_reference(cs_p, meta, s, plain_int, *small)
    fwd_err, share, rays_k, rays_p = forward_vs_plain(
        f"{label}: diff_trace_fwd vs its plain version {m}x{m} depth {depth}",
        got, want, depth, card)

    # The fused reverse at the step's own cotangent of the radiance,
    # against G on the plain version's slots.
    color = vm.de_nan(want[0])
    tgt = target if m == n else torch.full_like(color, 0.25)
    g_rad = torch.where(torch.isfinite(want[0]),
                        2.0 * (color - tgt) / float(m * m * 3),
                        torch.zeros((), device=dev)).contiguous()
    n_rows = scene.n_tex * (2 if scene.checker else 1)
    (w_rows, w_g, w_count), = reverse_vs_g(
        f"{label}: diff_trace_bwd (the fused reverse) vs G on its plain "
        f"version's slots ({m}x{m})", scene, want, g_rad, c0, c1, s, card)
    g_tab = table_grad_phase({(n_rows, 3): (w_rows, w_g, 0, w_count)},
                             {(n_rows, 3): "tex_c0" + (
                                 "/tex_c1" if scene.checker else "")}, card,
                             plain_reps=3)

    # Times and bounds at the step's frame.
    big = rays_of(n) if m != n else small
    rad, cnt, rec_f, rec_i = fwd(big)
    rays = int(cnt.sum())
    # A CUDA graph of 20 calls, as R's and G's times are taken: the
    # wrapper's host cost (its table checks, buffers, the ctypes call) is
    # no part of the kernel's.
    ms = profiling.graph_ms(lambda: fwd(big), 20)
    probed = None
    if probe:
        out, probed = diff_trace.probe(scene, cs_p, meta, s, *big)
        live_b = torch.arange(depth, device=dev)[:, None] < cnt[None, :]
        same = (torch.equal(out[0].view(torch.int32), rad.view(torch.int32))
                and torch.equal(out[1], cnt)
                and torch.equal(out[2][live_b].view(torch.int32),
                                rec_f[live_b].view(torch.int32))
                and torch.equal(out[3][live_b], rec_i[live_b]))
        print(f"{label}: diff_trace_fwd {measure_port.step_probe_line(probed)}"
              f"; its outputs equal the kernel's bit for bit {same}, its "
              f"passes each warp's longest path "
              f"{probed['passes_equal_longest']} ({card})", flush=True)
        if not (same and probed["passes_equal_longest"]):
            raise AssertionError(f"{label}: the forward kernel's probe "
                                 f"differs from its main instance")
    plain_ms = cuda_ms(lambda: diff_trace.forward_reference(
        cs_p, meta, s, plain_int, *big), 1)
    if m == n:
        g_big = g_rad
    else:
        g_big = torch.where(torch.isfinite(rad), 2.0 * (vm.de_nan(rad) - target)
                            / float(n * n * 3), torch.zeros((), device=dev))
    g_big = g_big.contiguous()
    # A CUDA graph of 20 calls, as G's time is taken: the wrapper's host
    # cost (its buffers, the ctypes call) is no part of the kernel's.
    bwd_ms = restored_ms(lambda: diff_trace.reverse(
        scene, rec_f, rec_i, cnt, g_big, c0, c1, s), [rec_f])

    def plain_reverse():
        rows, g, count = diff_trace.reverse_reference(
            rec_f, rec_i, cnt, g_big, c0, c1, s, scene.checker)
        live = int(count)
        return table_grad.table_grad_reference(rows[:live], g[:live],
                                               (n_rows, 3))

    bwd_plain_ms = cuda_ms(plain_reverse, 2)
    scatters, pairs = diff_pairs(big[3], rec_i, cnt, depth)
    trav = None
    if scene.bvh is not None:
        counting = counting_bvh(ctx)
        check = diff_trace.forward_reference(cs_p, meta, s, counting, *big)
        if int(check[1].sum()) != rays:
            raise AssertionError(f"{label}: the counted traversal's rays "
                                 f"differ")
        trav = tuple(int(x) for x in counting.counts)
    tables = [scene.prim_f, scene.prim_i, scene.mat_f, scene.mat_i,
              scene.light_f, scene.light_i, c0, c1, *big]
    if scene.bvh is not None:
        tables += [scene.bvh.nodes, scene.bvh.prim_table]
    n_paths = n * n
    rec_bytes = rays * 4 * (diff_trace.REC_F + 1)
    bound, by, what = sass_bound_ms(
        rays, 0, ctx.cs.prims.kind.tolist(), False,
        rec_bytes + n_paths * (12 + 4), tensor_bytes(tables),
        (scatters, pairs), trav)
    # Read once: the records, each path's count and cotangent, the texture
    # rows; written once: the table gradient. Beside it the bounds of R and
    # G before they were fused: R wrote a (row int64, cotangent f32 × 3)
    # slot a record and their count, which G read back.
    bwd_bytes = (rec_bytes + n_paths * (4 + 12) + tensor_bytes([c0, c1])
                 + 4 * 3 * n_rows)
    bwd_bound = 1e3 * bwd_bytes / HBM_BYTES_PER_S
    r_bytes = (rec_bytes + n_paths * (4 + 12) + tensor_bytes([c0, c1])
               + rays * (8 + 12) + 4)
    g_bytes = rays * (8 + 12) + 4 + 4 * 3 * n_rows
    walk = ("" if trav is None else f", {trav[0]} nodes popped and "
            f"{trav[1]} primitives tested ({trav[0] / rays:.4f} and "
            f"{trav[1] / rays:.4f} a ray)")
    print(f"{label}: diff_trace_fwd {n}x{n} depth {depth}: {rays} rays, "
          f"{scatters} scatters drawing {pairs} pairs{walk}, {rec_bytes} "
          f"record bytes: {ms:.4f} ms a launch (a CUDA graph of 20), plain "
          f"{plain_ms:.4f} ms, "
          f"bound {bound:.4f} ms by {what} ({bound / ms:.2%}) ({card})",
          flush=True)
    print(f"{label}: diff_trace_bwd (the fused reverse) {n}x{n}, {rays} "
          f"records into a ({n_rows}, 3) table ({diff_trace.add_path(n_rows)} "
          f"path): {bwd_ms:.4f} ms a call (a "
          f"CUDA graph of 20), plain (reverse_reference, then index_put_) "
          f"{bwd_plain_ms:.4f} ms, bound "
          f"{bwd_bound:.4f} ms by bytes ({bwd_bytes} B, "
          f"{bwd_bound / bwd_ms:.2%}); R's and G's bounds before they were "
          f"fused {1e3 * r_bytes / HBM_BYTES_PER_S:.4f} and "
          f"{1e3 * g_bytes / HBM_BYTES_PER_S:.4f} ms ({r_bytes} and "
          f"{g_bytes} B) ({card})", flush=True)
    return dict(fwd=dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, max_abs_err=fwd_err, rays=rays,
                         rays_equal_at_plain_frame=rays_k == rays_p,
                         plain_frame=m, branch_share=share,
                         scatters=scatters, pairs=pairs, traversal=trav,
                         record_bytes=rec_bytes, probe=probed),
                bwd=dict(ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bwd_bound,
                         bound_by="bytes", max_abs_err=0.0, bytes=bwd_bytes,
                         r_bound_ms=1e3 * r_bytes / HBM_BYTES_PER_S,
                         g_bound_ms=1e3 * g_bytes / HBM_BYTES_PER_S),
                table_grad=g_tab)


def step_bound_ms(n: int, fused: dict, params) -> float:
    """The least milliseconds of a fused step at n², 1 spp: its kernels'
    bounds (the cipher's new-sample form from its SASS, the forward and
    reverse kernels', G's at its call) and the bytes of its inputs and
    outputs (parameters in, gradients out; pixels, target, key). PyTorch's
    own ops are not counted."""
    rays = n * n
    cipher = cipher_bound("new_sample", rays, 5)[0]
    g = sum(t["calls_per_step"] * t["bound_ms"]
            for t in fused["table_grad"].values())
    nbytes = 2 * tensor_bytes(params.values()) + rays * (8 + 8 + 12) + 16
    return (cipher + fused["fwd"]["bound_ms"] + fused["bwd"]["bound_ms"] + g
            + 1e3 * nbytes / HBM_BYTES_PER_S)


def tight_agreement(label: str, got: dict, want: dict, card: str) -> dict:
    """Raise unless two steps (the fused and the checkpointed, whose rays
    `steps_agree` has held equal) have equal losses and every gradient
    entry within G's tolerances (rtol STEP_TIGHT_RTOL, atol
    STEP_TIGHT_ATOL · max|g| of its table); returns the loss's relative
    difference and the largest ratio of a difference to that bound."""
    worst = 0.0
    for k, w in want["grads"].items():
        bound = (STEP_TIGHT_RTOL * np.abs(w)
                 + STEP_TIGHT_ATOL * max(float(np.abs(w).max()), 1e-30))
        worst = max(worst, float((np.abs(got["grads"][k] - w) / bound).max()))
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    out = dict(rays_equal=got["rays"] == want["rays"], loss_rel=loss_rel,
               within_g_tolerances=worst <= 1.0, worst_ratio=worst)
    print(f"{label}: rays equal {out['rays_equal']} ({got['rays']} vs "
          f"{want['rays']}), loss relative difference {loss_rel:.3e}, every "
          f"gradient within rtol {STEP_TIGHT_RTOL} + atol {STEP_TIGHT_ATOL}"
          f"·max|g| {worst <= 1.0} (largest difference {worst:.3f} of its "
          f"bound) ({card})", flush=True)
    if not (out["rays_equal"] and got["loss"] == want["loss"]
            and out["within_g_tolerances"]):
        raise AssertionError(f"{label}: the steps differ beyond G's "
                             f"tolerances")
    return out


# The kernels of each part of the fused route on the Cornell step: the
# forward, and the reverse's two passes (pass 2 in the lanes' copies of
# its 12-element table).
BWD_KERNELS = {"fwd": ("diff_trace_fwd",),
               "bwd": ("diff_trace_bwd_stat", "diff_trace_bwd_lane")}


def fused_replay(label: str, s: dict, spp: int = 1) -> None:
    """Raise unless a replay of a fused step at spp samples a pixel
    launched the new-sample cipher, the forward kernel and the reverse
    once each, the forward's launch carrying the spp sample passes, G no
    time, no bounce-form cipher, and nothing else."""
    want = {k: 0 for k in s["counts"]}
    want.update(threefry=1, diff_trace_fwd=1, diff_trace_bwd=1)
    if s["counts"] != want or s["bounce_cipher"] != 0 or s["passes"] != spp:
        raise AssertionError(f"{label}: a replay launched {s['counts']} "
                             f"({s['bounce_cipher']} in the cipher's bounce "
                             f"form, {s['passes']} sample passes), not "
                             f"{want} (none, {spp})")


def profiled_replay(label: str, step, ctx, n: int, params, target,
                    card: str) -> dict:
    """One replay of a captured fused step under torch.profiler: its wall,
    the device's busy time and idle share, its device records, the
    largest rows; raise unless the records name the forward and the
    reverse's two passes once each, G no time, and no checkpoint recompute
    ran (no bounce-form cipher kernel)."""
    xs, ys = train_pixels(n, ctx.device)
    wall, recs, _ = harness.device_intervals(torch, lambda: step(
        params, xs, ys, target, rng.render_key(0, device=ctx.device)))
    busy = harness.union_seconds(recs)
    top = profiling.device_rows(recs)
    records = len(recs)

    def named(tag):
        return sum(c for _, name, c in top if tag in name)

    fwd, stat, bwd = (named("diff_trace_fwd"), named("diff_trace_bwd_stat"),
                      named("diff_trace_bwd"))
    g, bounce = named("table_grad"), named("bounce_tiles")
    print(f"{label} profile: a replay under torch.profiler: wall "
          f"{wall:.5f} s, device busy {busy:.5f} s, idle share "
          f"{1 - busy / wall:.2%}, {records} device records; "
          f"diff_trace_fwd {fwd}, the reverse's passes {stat} and "
          f"{bwd - stat}, G {g}, bounce-form cipher {bounce} ({card})",
          flush=True)
    for dt, name, count in top[:10]:
        print(f"  {dt / 1e3:10.4f} ms  x{count}  {name[:90]}", flush=True)
    if not (fwd == 1 and stat == 1 and bwd == 2 and g == 0 and bounce == 0):
        raise AssertionError(f"{label}: the profiled replay ran the forward "
                             f"kernel {fwd} times, the reverse's passes "
                             f"{stat} and {bwd - stat}, G {g}, the "
                             f"bounce-form cipher {bounce}")
    return dict(wall=wall, busy=busy, idle_share=1 - busy / wall,
                records=records,
                top=[(dt, name[:120], c) for dt, name, c in top[:10]])


def training_phases(card: str) -> dict:
    """Phases 16 and 17 (the module docstring)."""
    n, depth = TRAIN_SIZE, TRAIN_DEPTH
    out = {}
    # 16. The Cornell box, brute force: the target is the colour render at
    # the true parameters.
    ctx = renderer.RenderContext(cornell_box(), device="cuda")
    tgt = renderer.render(None, n, n, TRAIN_TARGET_SPP,
                          path.RenderSettings(max_depth=depth), seed=0,
                          context=ctx, device="cuda")
    target = torch.as_tensor(np.ascontiguousarray(tgt.image[::-1]).reshape(
        n * n, 3), device="cuda")
    params = scaled_params(ctx.cs)
    fwd, fwd_rays = forward_counts(ctx, n, depth, params)
    early, early_rays = forward_counts(ctx, n, depth, params, early_exit=True)
    fused_fwd, fused_rays = forward_counts(
        ctx, n, depth, params,
        route=diff_trace.prepare(ctx.cs, ctx.meta, ctx.intersect))
    print(f"training step: cornell_box {n}x{n}@1 depth {depth}: the "
          f"checkpointed bounces' fixed trip runs {fwd['threefry'] - 1} "
          f"bounces, the early exit {early['threefry'] - 1}; rays "
          f"{fwd_rays} vs {early_rays}; the fused route's forward {fused_rays} "
          f"rays, launches {fused_fwd} ({card})", flush=True)
    if fwd_rays != early_rays or fwd["threefry"] != depth + 1:
        raise AssertionError("the fixed trip and the early exit differ")
    if fused_fwd["diff_trace_fwd"] != 1 or fused_fwd["threefry"] != 1:
        raise AssertionError("the fused forward did not run its kernel once")
    kernels = diff_kernel_phase("phase 16 cornell_box", ctx, n, depth, params,
                                target, card, probe=True)
    merged_kernels = merged_kernel_phase("phase 16 cornell_box", ctx, n,
                                         depth, params, target, STEP_SPP,
                                         card)
    step = make_step(ctx, n, depth)
    if not isinstance(step.route, diff_trace.DiffScene):
        raise AssertionError("the Cornell step does not take the fused route")
    steps = []
    for i in range(TRAIN_STEPS):
        s = timed_step(step, ctx, n, params, target)
        steps.append(s)
        print(f"training step {i} (captured, fused): cornell_box {n}x{n}@1 "
              f"depth {depth}: loss {s['loss']:.7f}, {s['seconds']:.5f} s, "
              f"{s['rays']} rays, launches {s['counts']}, "
              f"max_memory_allocated {s['peak'] / 2**20:.1f} MiB "
              f"({s['peak_above'] / 2**20:.1f} MiB above the step's start) "
              f"({card})", flush=True)
        with torch.no_grad():
            for k, p in params.items():
                p -= TRAIN_LR * torch.as_tensor(s["grads"][k], device="cuda")
    after = timed_step(step, ctx, n, params, target)
    runner = step.runner
    secs = [s["seconds"] for s in steps]
    median = float(np.median(secs[1:]))
    for s in steps[1:] + [after]:
        fused_replay("phase 16", s)
    print(f"training step (captured, fused): cornell_box {n}x{n}@1 depth "
          f"{depth}, lr {TRAIN_LR}: loss {steps[0]['loss']:.7f} at step 0, "
          f"{after['loss']:.7f} after {TRAIN_STEPS} steps; first call "
          f"{secs[0]:.4f} s (warm-up, capture {runner.capture_seconds:.4f} s, "
          f"replay); median of the last {TRAIN_STEPS - 1} steps {median:.5f} "
          f"s ({n * n / median / 1e6:.4f} M pixel-samples/s, "
          f"{steps[0]['rays'] / median / 1e6:.3f} Mrays/s forward); the "
          f"graph holds {runner.capture_bytes / 2**20:.1f} MiB; a replay "
          f"launches {steps[1]['counts']} ({card})", flush=True)
    if not after["loss"] < steps[0]["loss"]:
        raise AssertionError("the loss did not fall over the steps")
    if runner.replays != TRAIN_STEPS + 1 or runner.trips != TRAIN_STEPS + 2:
        raise AssertionError(f"the step ran {runner.trips} times, "
                             f"{runner.replays} replayed")
    versus = captured_vs_eager("training step cornell_box 256 (fused)", ctx,
                               n, depth, params, target, step, card)
    # The checkpointed bounces captured, at the same parameters.
    ckpt = make_step(ctx, n, depth, route="checkpoint")
    c_warm = timed_step(ckpt, ctx, n, params, target)
    c_runs = [timed_step(ckpt, ctx, n, params, target) for _ in range(2)]
    c_launch = replay_counts("phase 16 checkpointed", c_runs[0], fwd,
                             {"threefry": 2 * depth + 1})
    ckpt_s = float(np.median([r["seconds"] for r in c_runs]))
    f_now = timed_step(step, ctx, n, params, target)
    fused_err = steps_agree(f"training step cornell_box {n}x{n}@1 depth "
                            f"{depth}, fused (captured) vs checkpointed "
                            f"(captured)", f_now, c_runs[0], card)
    fused_tight = tight_agreement("cornell_box fused vs checkpointed", f_now,
                                  c_runs[0], card)
    print(f"training step: cornell_box {n}x{n}@1 depth {depth}: fused "
          f"captured {median:.5f} s (median of steps 1-{TRAIN_STEPS - 1}), "
          f"checkpointed captured {ckpt_s:.5f} s (its first call "
          f"{c_warm['seconds']:.4f} s, capture "
          f"{ckpt.runner.capture_seconds:.4f} s), fused eager "
          f"{versus['eager_seconds']:.5f} s; {ckpt_s / median:.2f}x the "
          f"checkpointed step; rays {f_now['rays']} vs {c_runs[0]['rays']} "
          f"({card})", flush=True)
    del ckpt
    torch.cuda.empty_cache()
    # The step at STEP_SPP samples a pixel: one launch of each kernel, the
    # forward's carrying every sample pass.
    multi = make_step(ctx, n, depth, spp=STEP_SPP)
    m_warm = timed_step(multi, ctx, n, params, target)
    m_runs = [timed_step(multi, ctx, n, params, target) for _ in range(3)]
    for r in m_runs:
        fused_replay(f"phase 16 at {STEP_SPP} spp", r, STEP_SPP)
    m_s = float(np.median([r["seconds"] for r in m_runs]))
    # The same step a sample pass at a time, eagerly: the same bits.
    looped = timed_step(loop_step(ctx, n, depth, STEP_SPP, multi.route), ctx,
                        n, params, target)
    got = m_runs[-1]
    loop_bits = looped["rays"] == got["rays"] and np.float32(
        looped["loss"]).tobytes() == np.float32(got["loss"]).tobytes() and all(
        looped["grads"][k].tobytes() == got["grads"][k].tobytes()
        for k in looped["grads"])
    print(f"training step cornell_box {n}x{n}@{STEP_SPP} depth {depth}: the "
          f"captured step (its passes in one launch) vs the eager per-sample "
          f"loop ({looped['seconds']:.4f} s, launches {looped['counts']}, "
          f"{looped['passes']} passes): rays, loss and every gradient bit for "
          f"bit {loop_bits} ({card})", flush=True)
    if not (loop_bits and looped["counts"]["diff_trace_fwd"] == STEP_SPP
            and looped["counts"]["diff_trace_bwd"] == STEP_SPP):
        raise AssertionError(f"phase 16 at {STEP_SPP} spp: the captured step "
                             f"differs from the per-sample loop")
    print(f"training step (captured, fused): cornell_box {n}x{n}@{STEP_SPP} "
          f"depth {depth}: {m_s:.5f} s (median of 3; first call "
          f"{m_warm['seconds']:.4f} s, capture "
          f"{multi.runner.capture_seconds:.4f} s, the graph "
          f"{multi.runner.capture_bytes / 2**20:.1f} MiB), {m_runs[0]['rays']} "
          f"rays; a replay launches {m_runs[0]['counts']}, the forward's "
          f"launch carrying {m_runs[0]['passes']} sample passes ({card})",
          flush=True)
    multi_out = dict(spp=STEP_SPP, seconds=[r["seconds"] for r in m_runs],
                     first_call_seconds=m_warm["seconds"],
                     capture_seconds=multi.runner.capture_seconds,
                     graph_bytes=multi.runner.capture_bytes,
                     rays=m_runs[0]["rays"],
                     launches_per_replay=m_runs[0]["counts"],
                     passes_per_replay=m_runs[0]["passes"],
                     loop_bit_for_bit=loop_bits,
                     loop_seconds=looped["seconds"], kernels=merged_kernels)
    del multi
    torch.cuda.empty_cache()
    prof = profiled_replay("training step cornell_box 256 (fused)", step, ctx,
                           n, params, target, card)
    memory = memory_per_bounce(ctx, n, depth, target, step,
                               versus["eager"]["peak_above"], card)
    step_bound = step_bound_ms(n, kernels, params)
    # The card against the CPU, the card's step captured.
    mark("phase 16 before the CPU")
    n_c, d_c = TRAIN_VS_CPU
    runs = {}
    for dev in ("cuda", "cpu"):
        c = renderer.RenderContext(cornell_box(), device=dev)
        grey = torch.full((n_c * n_c, 3), 0.25, device=dev)
        st = make_step(c, n_c, d_c)
        if dev == "cuda" and not isinstance(st.runner, loops.Graphed):
            raise AssertionError("the card's step is not captured")
        runs[dev] = timed_step(st, c, n_c, scaled_params(c.cs), grey)
    cpu_err = steps_agree(f"training step {n_c}x{n_c}@1 depth {d_c}, card "
                          f"(captured, fused) vs CPU (fused, plain versions)",
                          runs["cuda"], runs["cpu"], card)
    # The entry point's demo step, captured on the card.
    zero_counts()
    demo_loss, _ = entry.train_step_demo()
    demo_counts = read_counts()
    print(f"entry.train_step_demo(): loss {float(demo_loss):.7f}, launches "
          f"{demo_counts} ({card})", flush=True)
    if not (demo_counts["diff_trace_bwd"] and demo_counts["threefry"]
            and demo_counts["diff_trace_fwd"]):
        raise AssertionError("the demo step did not run the step's kernels")
    out["cornell"] = dict(
        frame=n, depth=depth, losses=[s["loss"] for s in steps],
        loss_after=after["loss"], seconds=secs, median_seconds=median,
        eager_seconds=versus["eager_seconds"],
        eager_seconds_all=versus["eager_seconds_all"],
        checkpointed_seconds=ckpt_s,
        checkpointed_seconds_all=[r["seconds"] for r in c_runs],
        checkpointed_launches_per_replay=c_runs[0]["counts"],
        checkpointed_cipher_forward=c_launch["threefry"]["forward"],
        checkpointed_cipher_recompute=c_launch["threefry"]["recompute"],
        max_grad_err_vs_checkpointed=fused_err,
        vs_checkpointed=fused_tight,
        capture_seconds=runner.capture_seconds,
        graph_bytes=runner.capture_bytes, replays=runner.replays,
        profiled_wall=prof["wall"], profiled_busy=prof["busy"],
        profiled_idle_share=prof["idle_share"],
        profiled_records=prof["records"], profiled_top=prof["top"],
        rays=steps[0]["rays"], launches_per_replay=steps[1]["counts"],
        cipher_launches=steps[1]["counts"]["threefry"],
        bounce_cipher_per_replay=steps[1]["bounce_cipher"],
        early_exit_bounces=early["threefry"] - 1,
        fixed_trip_bounces=fwd["threefry"] - 1,
        max_grad_err_vs_eager=versus["max_grad_err_vs_eager"],
        peak_bytes=[s["peak"] for s in steps], memory=memory,
        kernels=kernels, table_grad=kernels["table_grad"],
        table_grad_launches=c_runs[0]["counts"]["table_grad"],
        bound_ms=step_bound, multi_sample=multi_out,
        vs_cpu=dict(frame=n_c, depth=d_c, max_grad_err=cpu_err))
    del ctx, target, params, step, versus
    torch.cuda.empty_cache()

    mark("phase 16")
    # 17. cornell_box_obj through its BVH4: the forward kernel's BVH form.
    octx = renderer.RenderContext(cornell_box_obj(), device="cuda")
    grey = torch.full((n * n, 3), 0.25, device="cuda")
    params = scaled_params(octx.cs)
    plain = functools.partial(traverse.intersect_bvh, octx.cs.prims,
                              octx.intersect.ks.tree)
    fwd, fwd_rays = forward_counts(octx, n, depth, params)
    okernels = diff_kernel_phase("phase 17 cornell_box_obj", octx, n, depth,
                                 params, grey, card, plain_intersect=plain,
                                 plain_n=TRAIN_VS_PLAIN)
    okernels["merged"] = merged_kernel_phase(
        "phase 17 cornell_box_obj", octx, n, depth, params, grey, STEP_SPP,
        card, plain_intersect=plain, plain_n=TRAIN_VS_PLAIN)
    ostep = make_step(octx, n, depth)
    if not isinstance(ostep.route, diff_trace.DiffScene) or (
            ostep.route.bvh is None):
        raise AssertionError("cornell_box_obj's step does not take the fused "
                             "route's BVH form")
    warm = timed_step(ostep, octx, n, params, grey)
    s = timed_step(ostep, octx, n, params, grey)
    fused_replay("phase 17", s)
    print(f"training step (captured, fused): cornell_box_obj {n}x{n}@1 depth "
          f"{depth} through the forward kernel's BVH form: loss "
          f"{s['loss']:.7f}, {s['seconds']:.5f} s (first call "
          f"{warm['seconds']:.4f} s, capture "
          f"{ostep.runner.capture_seconds:.4f} s, the graph "
          f"{ostep.runner.capture_bytes / 2**20:.1f} MiB), {s['rays']} rays; "
          f"a replay launches {s['counts']} ({card})", flush=True)
    if fwd_rays != s["rays"]:
        raise AssertionError("the step's rays differ from the checkpointed "
                             "forward's")
    oversus = captured_vs_eager("training step cornell_box_obj 256 (fused)",
                                octx, n, depth, params, grey, ostep, card,
                                eager_runs=1)
    ockpt = make_step(octx, n, depth, route="checkpoint")
    oc_warm = timed_step(ockpt, octx, n, params, grey)
    oc = timed_step(ockpt, octx, n, params, grey)
    oc_launch = replay_counts("phase 17 checkpointed", oc, fwd,
                              {"bvh_kernel": 2 * depth,
                               "threefry": 2 * depth + 1})
    oc_capture = ockpt.runner.capture_seconds
    ofused_err = steps_agree(f"training step cornell_box_obj {n}x{n}@1 depth "
                             f"{depth}, fused (captured) vs checkpointed "
                             f"(captured)", s, oc, card)
    ofused_tight = tight_agreement("cornell_box_obj fused vs checkpointed", s,
                                   oc, card)
    print(f"training step: cornell_box_obj {n}x{n}@1 depth {depth}: fused "
          f"captured {s['seconds']:.5f} s, checkpointed captured "
          f"{oc['seconds']:.5f} s (first call {oc_warm['seconds']:.4f} s, "
          f"capture {oc_capture:.4f} s; B3 "
          f"{oc_launch['bvh_kernel']}), {oc['seconds'] / s['seconds']:.2f}x "
          f"({card})", flush=True)
    del ockpt
    torch.cuda.empty_cache()
    n_p = TRAIN_VS_PLAIN
    gp = torch.full((n_p * n_p, 3), 0.25, device="cuda")
    kern = timed_step(make_step(octx, n_p, depth), octx, n_p,
                      scaled_params(octx.cs), gp)
    ref = timed_step(make_step(octx, n_p, depth, intersect=plain,
                               runner=loops.Eager()), octx, n_p,
                     scaled_params(octx.cs), gp)
    if ref["counts"]["bvh_kernel"] or ref["counts"]["diff_trace_fwd"] or (
            not kern["counts"]["diff_trace_fwd"]):
        raise AssertionError("the plain step launched a kernel of the fused "
                             "route, or the fused step did not")
    plain_err = steps_agree(f"training step {n_p}x{n_p}@1 depth {depth}, "
                            f"fused BVH form (captured) vs checkpointed plain "
                            f"traversal (eager) on the card", kern, ref, card)
    out["cornell_box_obj"] = dict(
        frame=n, depth=depth, loss=s["loss"], seconds=s["seconds"],
        first_call_seconds=warm["seconds"],
        capture_seconds=ostep.runner.capture_seconds,
        graph_bytes=ostep.runner.capture_bytes,
        eager_seconds=oversus["eager_seconds"],
        eager_seconds_all=oversus["eager_seconds_all"],
        max_grad_err_vs_eager=oversus["max_grad_err_vs_eager"],
        checkpointed_seconds=oc["seconds"],
        checkpointed_capture_seconds=oc_capture,
        checkpointed_launches_per_replay=oc["counts"],
        checkpointed_bvh_forward=oc_launch["bvh_kernel"]["forward"],
        checkpointed_bvh_recompute=oc_launch["bvh_kernel"]["recompute"],
        checkpointed_cipher_forward=oc_launch["threefry"]["forward"],
        checkpointed_cipher_recompute=oc_launch["threefry"]["recompute"],
        max_grad_err_vs_checkpointed=ofused_err,
        vs_checkpointed=ofused_tight,
        rays=s["rays"], peak_bytes=s["peak"],
        launches_per_replay=s["counts"],
        bounce_cipher_per_replay=s["bounce_cipher"], kernels=okernels,
        vs_plain=dict(frame=n_p, max_grad_err=plain_err,
                      kernel_seconds=kern["seconds"],
                      plain_seconds=ref["seconds"]))
    return out


def run_cli(label: str, args, card: str, counted: bool = True):
    """`python -m izpi_tpu_torch` in a subprocess from the repository's root
    (with `counted`, through COUNTING_MAIN, which runs it as -m does and
    prints the launch counters after): wall seconds, the render's seconds
    and Mrays/s from its summary line, and the counters."""
    cmd = ([sys.executable, "-c", COUNTING_MAIN] if counted
           else [sys.executable, "-m", "izpi_tpu_torch"]) + list(args)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}\n"
                             f"{proc.stderr[-3000:]}")
    summary = next(line for line in proc.stdout.splitlines()
                   if line.startswith("Rendering completed"))
    words = summary.split()   # "... in 1.2s using N rays (M Mrays/s) on ..."
    rays = int(words[5])
    mrays = float(words[7].lstrip("("))
    seconds = rays / (mrays * 1e6)   # render() seconds, to Mrays/s's digits
    counts = None
    if counted:
        counts = json.loads(next(line for line in proc.stdout.splitlines()
                                 if line.startswith("LAUNCHES "))[9:])
    print(f"{label}: python -m izpi_tpu_torch {' '.join(args)}: {rays} rays, "
          f"{mrays:.2f} Mrays/s, render {seconds:.4f} s (rays / Mrays/s), "
          f"process {wall:.2f} s; launches {counts} ({card})", flush=True)
    return dict(seconds=seconds, rays=rays, mrays_per_sec=mrays,
                process_seconds=wall, launches=counts)


def pixels_within(a, b, atol: float, rtol: float) -> float:
    """Share of pixels whose every channel of a is within atol + rtol·|b|."""
    return float(np.all(np.abs(a - b) <= atol + rtol * np.abs(b),
                        axis=-1).mean())


def cli_phases(card: str) -> dict:
    """Phase 18 (the module docstring)."""
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {}
    png, exr = os.path.join(work, "a.png"), os.path.join(work, "b.exr")
    out["png"] = run_cli("CLI default", ["--output-file", png], card,
                         counted=False)
    out["exr"] = run_cli("CLI default, EXR", ["--output-mode", "exr",
                                               "--output-file", exr], card)
    counts = out["exr"]["launches"]
    if counts["megakernel_spectral"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"the CLI's default render launched {counts}")
    a, b = output.read_image(png), output.read_image(exr)
    want = np.clip(np.sqrt(np.maximum(b, 0.0)), 0.0, 1.0)
    step_err = float(np.abs(a - want).max())
    print(f"CLI files: a.png {a.shape}, b.exr {b.shape} (ACES "
          f"chromaticities {b'chromaticities' in open(exr, 'rb').read()}); "
          f"PNG vs the EXR's gamma-2 clamped image: max difference "
          f"{step_err * 255:.4f} 8-bit steps (tol 1)", flush=True)
    if a.shape != (500, 500, 3) or not np.isfinite(b).all() or (
            step_err > 1.0 / 255 + 1e-6):
        raise AssertionError("the CLI's PNG and EXR disagree")

    # Checkpoint and resume of the same render, in process, as
    # tests/test_checkpoint.py:33-71 does it.
    settings = path.RenderSettings(max_depth=50)
    sctx = renderer.RenderContext(cornell_box_pyramid_spectral(),
                                  device="cuda")
    ck_path = os.path.join(work, "r.npz")
    states = {}
    save = checkpoint.save

    def spy(p, acc, done, rays, fp):
        states[done] = (acc.copy(), rays, fp)
        save(p, acc, done, rays, fp)

    checkpoint.save = spy
    try:
        zero_counts()
        chunked = renderer.render(None, 500, 500, 1000, settings, seed=0,
                                  context=sctx, device="cuda",
                                  sampler_type="spectral",
                                  checkpoint_path=ck_path,
                                  checkpoint_interval=CKPT_INTERVAL)
        first = read_counts()
        acc, rays, fp = states[500]
        save(ck_path, acc, 500, rays, fp)
        states.clear()
        zero_counts()
        resumed = renderer.render(None, 500, 500, 1000, settings, seed=0,
                                  context=sctx, device="cuda",
                                  sampler_type="spectral",
                                  checkpoint_path=ck_path,
                                  checkpoint_interval=CKPT_INTERVAL)
        second = read_counts()
    finally:
        checkpoint.save = save
    share = pixels_within(resumed.image, b, XYZ_ATOL, XYZ_RTOL)
    print(f"checkpoint: pyramid 500x500@1000 depth 50 in chunks of "
          f"{CKPT_INTERVAL}: {chunked.seconds:.4f} s, launches {first}; "
          f"resumed at sample 500: {resumed.seconds:.4f} s, launches {second}, "
          f"saved at {sorted(states)}; rays {resumed.rays_traced} vs the "
          f"CLI's {out['exr']['rays']}; resumed pixels within {XYZ_ATOL} + "
          f"{XYZ_RTOL}|exr| of the EXR: {share:.6f} (tol 1), max abs err "
          f"{float(np.abs(resumed.image - b).max()):.3e} ({card})", flush=True)
    if (first["megakernel_spectral"] != 1000 // CKPT_INTERVAL
            or second["megakernel_spectral"] != 500 // CKPT_INTERVAL
            or sorted(states) != [750, 1000] or share < 1.0
            or resumed.rays_traced != out["exr"]["rays"]):
        raise AssertionError("the resumed render differs from the "
                             "uninterrupted one")
    out["checkpoint"] = dict(chunked_seconds=chunked.seconds,
                             resumed_seconds=resumed.seconds,
                             pixel_share=share)
    del sctx

    # The AOVs through the BVH4 kernel, against the plain traversal.
    octx = renderer.RenderContext(cornell_box_obj(), device="cuda")
    octx.intersect = functools.partial(traverse.intersect_bvh, octx.cs.prims,
                                       octx.intersect.ks.tree)
    for sampler in ("albedo", "normal", "wireframe"):
        f = os.path.join(work, f"{sampler}.pfm")
        r = run_cli(f"CLI {sampler}", [
            "--scene", "cornell_box_obj", "--sampler", sampler, "-x",
            str(AOV_SIZE), "-y", str(AOV_SIZE), "--samples", str(AOV_SPP),
            "--ink", "1,1,1", "--output-mode", "pfm", "--output-file", f],
            card)
        zero_counts()
        ref = renderer.render(None, AOV_SIZE, AOV_SIZE, AOV_SPP, seed=0,
                              context=octx, sampler_type=sampler,
                              ink=(1.0, 1.0, 1.0), device="cuda")
        if read_counts()["bvh_kernel"]:
            raise AssertionError("the plain AOV launched the BVH4 kernel")
        img = output.read_image(f)
        share = pixels_within(img, ref.image, PIXEL_ATOL, 0.0)
        print(f"CLI {sampler}: BVH4 kernel launches {r['launches']['bvh_kernel']}"
              f" (tol {AOV_SPP}); pixels within {PIXEL_ATOL} of the plain "
              f"traversal's: {share:.6f} (tol {PIXEL_SHARE}); plain render "
              f"{ref.seconds:.4f} s ({card})", flush=True)
        if (r["launches"]["bvh_kernel"] != AOV_SPP or share < PIXEL_SHARE
                or not np.isfinite(img).all() or np.ptp(img) == 0):
            raise AssertionError(f"the {sampler} AOV disagrees")
        out[sampler] = dict(r, pixel_share=share)
    del octx

    # The spectral sampler on an RGB scene: the spectral pool.
    f = os.path.join(work, "upgrade.exr")
    r = run_cli("CLI spectral on cornell_box", [
        "--scene", "cornell_box", "--sampler", "spectral", "-x",
        str(UPGRADE_SIZE), "-y", str(UPGRADE_SIZE), "--samples",
        str(UPGRADE_SPP), "--output-mode", "exr", "--output-file", f], card)
    if (r["launches"]["threefry"] < 1
            or r["launches"]["megakernel"] + r["launches"]["megakernel_spectral"]):
        raise AssertionError(f"the spectral pool launched {r['launches']}")
    out["spectral_upgrade"] = r
    n_c, spp_c = UPGRADE_VS_CPU
    small = {dev: renderer.render(cornell_box(), n_c, n_c, spp_c, settings,
                                  seed=0, sampler_type="spectral", device=dev)
             for dev in ("cuda", "cpu")}
    rays_rel = abs(small["cuda"].rays_traced - small["cpu"].rays_traced) / (
        small["cpu"].rays_traced)
    share = pixels_within(small["cuda"].xyz, small["cpu"].xyz, XYZ_ATOL,
                          XYZ_RTOL)
    mean_rel = abs(float(small["cuda"].xyz.mean())
                   / float(small["cpu"].xyz.mean()) - 1)
    print(f"spectral on cornell_box {n_c}x{n_c}@{spp_c} depth 50, card vs "
          f"CPU: rays {small['cuda'].rays_traced} vs "
          f"{small['cpu'].rays_traced} (rel {rays_rel:.2e}, tol {RAYS_RTOL}); "
          f"XYZ pixels within {XYZ_ATOL} + {XYZ_RTOL}|cpu| {share:.6f} (tol "
          f"{PIXEL_SHARE}); mean rel {mean_rel:.2e} (tol {MEAN_RTOL}); card "
          f"{small['cuda'].seconds:.4f} s, CPU {small['cpu'].seconds:.4f} s "
          f"({card})", flush=True)
    if not (rays_rel <= RAYS_RTOL and share >= PIXEL_SHARE
            and mean_rel <= MEAN_RTOL):
        raise AssertionError("the spectral pool on an RGB scene: the card "
                             "disagrees with the CPU")
    out["spectral_upgrade_vs_cpu"] = dict(rays_rel=rays_rel, pixel_share=share,
                                          mean_rel=mean_rel)
    shutil.rmtree(work, ignore_errors=True)
    return out


# Phases D1-D6 and the dry run: distribution (`parallel.dist`) on the one
# card, four gloo ranks that share it (NCCL refuses two ranks on one card)
# unless a phase says otherwise. Each rank is a process of its own
# (`dist.spawn`); it zeroes its launch counters just before each part and
# reads them just after, so each part's launches are its own.
DIST_RANKS = 4
DIST_TIMEOUT_S = 600.0
D1 = (256, 128, 50)   # cornell_box_obj n, spp, depth: the BVH main path
D2 = (256, 1024, 50)  # cornell: the RGB main path
D3 = (256, 8, 16)     # the dragon: its main path
D4 = (256, 64, 16)    # pbr_ibl: its main path's frame, 256 spp cut to 64
D5 = (256, 50)        # the training step: pixels a side, depth
D6 = (500, 8, 50)     # the CLI's default pyramid, 1000 spp cut to 8
WS1_ATOL, WS1_RTOL = 1e-6, 1e-5


@contextlib.contextmanager
def _collective_clock(rec: dict):
    """Count the all-reduces of this rank, their bytes and their seconds
    (host clock between card syncs: gloo takes a CUDA tensor through the
    host) while the block runs."""
    real = torch.distributed.all_reduce

    def timed(tensor, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = real(tensor, *args, **kwargs)
        torch.cuda.synchronize()
        rec["collective_s"] += time.perf_counter() - t0
        rec["collectives"] += 1
        rec["collective_mib"] += tensor.numel() * tensor.element_size() / 2**20
        return result

    torch.distributed.all_reduce = timed
    try:
        yield
    finally:
        torch.distributed.all_reduce = real


def _rank_part(label: str, fn, out: dict):
    """Run fn() on this rank between zeroed and read launch counters and
    card syncs; record its seconds, launches, peak memory and all-reduces
    (`_collective_clock`) under out[label]. Returns fn()'s result."""
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = {"collectives": 0, "collective_mib": 0.0, "collective_s": 0.0}
    t0 = time.perf_counter()
    with _collective_clock(rec):
        result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out[label] = {"seconds": seconds, "launches": read_counts(),
                  "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                  "backend": torch.distributed.get_backend(), **rec,
                  "collective_share": rec["collective_s"] / seconds}
    return result


def _image_of(res):
    """A RenderResult's arrays (rank 0), or None (the other ranks)."""
    if res is None:
        return None
    return {"image": res.image, "xyz": res.xyz, "rays": res.rays_traced,
            "iterations": res.iterations, "seconds": res.seconds}


def _dist_rank(rank: int, n: int, sizes: dict) -> dict:
    """D1-D5 on one rank of a gloo group on the card."""
    dev = dist.rank_device("cuda")
    out = {"device": str(dev)}
    key = rng.render_key(0, device=dev)

    nx, spp, depth = sizes["d1"]
    out["d1_result"] = _image_of(_rank_part("d1", lambda: (
        dist.render_distributed(cornell_box_obj(), nx, nx, spp,
                                settings=path.RenderSettings(max_depth=depth),
                                seed=0)), out))

    nx, spp, depth = sizes["d2"]
    cs, meta = compiler.compile_scene(cornell_box(), dev)
    mega = dist.build_mega_renderer(cs, meta, path.RenderSettings(
        max_depth=depth), nx, nx, spp // n)
    acc, rays = _rank_part("d2", lambda: mega(key), out)
    out["d2_result"] = ({"acc": acc.cpu().numpy(), "rays": int(rays)}
                        if rank == 0 else None)
    del cs, meta, mega, acc

    nx, spp, depth = sizes["d3"]
    t0 = time.perf_counter()
    dcs, dmeta = compiler.compile_scene(
        cornell_box_pbr_stanford_dragon_spectral(), "cpu")
    run = dist.build_pool_renderer_prim_sharded(
        dcs, dmeta, path.RenderSettings(max_depth=depth), nx, nx, spp,
        spectral=True, device=dev)
    shard_s = time.perf_counter() - t0
    acc, rays = _rank_part("d3", lambda: run(key), out)
    out["d3"].update(shard_seconds=shard_s, prims=run.shards.gmap.shape[0],
                     nodes=run.shards.bounds.shape[0],
                     iterations=run.iterations)
    out["d3_result"] = ({"acc": acc.cpu().numpy(), "rays": int(rays)}
                        if rank == 0 else None)
    del dcs, dmeta, run, acc

    nx, spp, depth = sizes["d4"]
    out["d4_result"] = _image_of(_rank_part("d4", lambda: (
        dist.render_distributed(pbr_ibl(), nx, nx, spp,
                                settings=path.RenderSettings(max_depth=depth),
                                seed=0, shard_prims=True,
                                shard_textures=True)), out))

    # Two steps: the first also loads the backward's CUDA kernels.
    nx, depth = sizes["d5"]
    _rank_part("d5_first", lambda: _d5_step(
        nx, depth, dev, torch.distributed.group.WORLD), out)
    out["d5_result"] = _rank_part("d5", lambda: _d5_step(
        nx, depth, dev, torch.distributed.group.WORLD), out)
    return out


def _d5_step(nx: int, depth: int, dev, group):
    """One training step of the Cornell box at nx², depth `depth`, 1 spp,
    seed 0, at its true parameters against a black target: (loss, grads
    as numpy, rays)."""
    cs, meta = compiler.compile_scene(cornell_box(), dev)
    step = dist.build_train_step(cs, meta, path.RenderSettings(
        max_depth=depth), path.make_brute_intersector(cs), nx, nx, 1,
        group=group)
    xs, ys = train_pixels(nx, dev)
    loss, grads = step(dist.extract_params(cs), xs, ys,
                       torch.zeros((nx * nx, 3), device=dev),
                       rng.render_key(0, device=dev))
    return {"loss": float(loss), "rays": step.rays,
            "grads": {k: g.cpu().numpy() for k, g in grads.items()}}


def _ws1_rank(rank: int, n: int, sizes: dict) -> dict:
    """D1 and D6's render on a group of one rank (NCCL: one card for one
    rank), with D6's XYZ canvas before firefly rejection."""
    backend = torch.distributed.get_backend()
    if backend != "nccl":
        raise AssertionError(f"world size 1 runs on {backend}")
    out = {}
    nx, spp, depth = sizes["d1"]
    out["d1_result"] = _image_of(_rank_part("d1", lambda: (
        dist.render_distributed(cornell_box_obj(), nx, nx, spp,
                                settings=path.RenderSettings(max_depth=depth),
                                seed=0)), out))
    nx, spp, depth = sizes["d6"]
    raw = []
    with _raw_xyz(raw.append):
        out["d6_result"] = _image_of(_rank_part("d6", lambda: (
            dist.render_distributed(cornell_box_pyramid_spectral(), nx, nx,
                                    spp, settings=path.RenderSettings(
                                        max_depth=depth), seed=0)), out))
    out["d6_result"]["raw_xyz"] = raw[0]
    return out


@contextlib.contextmanager
def _raw_xyz(keep):
    """Hand keep() a copy of every XYZ canvas (the sums over the samples
    divided by their count) that a spectral render passes to firefly
    rejection while the block runs."""
    real = convert.firefly_rejection

    def spy(xyz, *args, **kwargs):
        keep(np.array(xyz))
        return real(xyz, *args, **kwargs)

    convert.firefly_rejection = spy
    try:
        yield
    finally:
        convert.firefly_rejection = real


# D6's leader: the command line's main, with its XYZ canvas before firefly
# rejection saved to argv[1] (`_raw_xyz`); argv[2:] are its flags.
D6_LEADER = """import sys
import numpy as np
import chip_smoke
from izpi_tpu_torch import cli
with chip_smoke._raw_xyz(lambda xyz: np.save(sys.argv[1], xyz)):
    code = cli.main(sys.argv[2:])
raise SystemExit(code)
"""


def _print_ranks(label: str, ranks: list, wall: float, card: str) -> None:
    parts = "; ".join(
        f"rank {r}: {info['seconds']:.4f} s, peak {info['peak_mib']:.1f} "
        f"MiB, launches {info['launches']}, {info['collectives']} "
        f"all-reduces of {info['collective_mib']:.1f} MiB in "
        f"{info['collective_s']:.4f} s ({info['collective_share']:.1%})"
        for r, info in enumerate(ranks))
    print(f"{label}: {len(ranks)} ranks, backend {ranks[0]['backend']}, "
          f"spawn wall {wall:.2f} s; {parts} ({card})", flush=True)


def _gate(label: str, a, b, rays_a: int, rays_b: int) -> dict:
    """PERF.md §2's gate between two images of one render (b the
    reference): equal rays, PIXEL_SHARE of the pixels with every channel
    within PIXEL_ATOL, means within MEAN_RTOL."""
    share = pixels_within(a, b, PIXEL_ATOL, 0.0)
    mean_rel = abs(float(a.mean()) - float(b.mean())) / abs(float(b.mean()))
    err = float(np.abs(a - b).max())
    print(f"{label}: rays {rays_a} vs {rays_b}; pixels within {PIXEL_ATOL}: "
          f"{share:.6f} (tol {PIXEL_SHARE}); max abs err {err:.3e}; mean "
          f"rel {mean_rel:.2e} (tol {MEAN_RTOL})", flush=True)
    if not (np.isfinite(a).all() and rays_a == rays_b
            and share >= PIXEL_SHARE and mean_rel <= MEAN_RTOL):
        raise AssertionError(f"{label}: the renders disagree")
    return {"rays": rays_a, "share_within": share, "max_abs_err": err,
            "mean_rel": mean_rel}


def dist_launches(report: dict, counter: str, dry_name: str) -> dict:
    """A kernel's launches on each rank of each distributed phase: counter
    is its module's name in the phases' counts, dry_name its name in the
    dry run's."""
    out = {f"{k}_per_rank": [r["launches"][counter] for r in v["ranks"]]
           for k, v in report.items() if k in ("d1", "d2", "d3", "d4", "d5")}
    out["d1_world_size_1"] = report["d1"]["world_size_1"]["rank"][
        "launches"][counter]
    out["dryrun_per_rank"] = [sum(r[part]["launches"][dry_name] for part in (
        "pool_bvh", "megakernel", "spectral_pool", "train_step"))
        for r in report["dryrun"]["ranks"]]
    return out


def distribution_phases(card: str, sizes: dict, refs: dict) -> dict:
    """Phases D1-D6 and `dryrun_multichip(4)` (the module docstring).
    `refs` holds the single-process renders of D1 (`render()` of
    cornell_box_obj through the pool, twice: "d1_warm" and "d1"), D2
    (`render()` of the Cornell box through the RGB megakernel) and D3
    (`render()` of the dragon through the BVH4 kernel) at `sizes`."""
    report = {}
    t0 = time.perf_counter()
    ranks = dist.spawn(_dist_rank, DIST_RANKS, args=(sizes,),
                       timeout_s=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if len({r["device"] for r in ranks}) != 1:
        raise AssertionError(f"ranks on {[r['device'] for r in ranks]}")

    # D1: the sample-sharded pool through B3 and the cipher entry.
    nx, spp, depth = sizes["d1"]
    d1 = [r["d1"] for r in ranks]
    _print_ranks(f"D1 cornell_box_obj {nx}x{nx}@{spp} depth {depth}, "
                 f"{spp // DIST_RANKS} samples a rank", d1, wall, card)
    for r, info in enumerate(d1):
        lc = info["launches"]
        if not (lc["bvh_kernel"] > 0 and lc["threefry"] > 0
                and lc["megakernel"] == lc["megakernel_spectral"] == 0):
            raise AssertionError(f"D1 rank {r} launched {lc}")
    got = ranks[0]["d1_result"]
    ref = refs["d1"]
    report["d1"] = {"ranks": d1, "spawn_wall_s": wall, **_gate(
        "D1 sample-sharded pool vs one process", got["image"], ref.image,
        got["rays"], ref.rays_traced)}
    np.testing.assert_allclose(got["image"], ref.image, atol=1e-4, rtol=1e-4)

    # D2: the RGB megakernel sample-sharded, one launch a rank.
    nx, spp, depth = sizes["d2"]
    d2 = [r["d2"] for r in ranks]
    _print_ranks(f"D2 cornell {nx}x{nx}@{spp} depth {depth} through the RGB "
                 f"megakernel, {spp // DIST_RANKS} samples a rank", d2, wall,
                 card)
    if any(info["launches"]["megakernel"] != 1 for info in d2):
        raise AssertionError(f"D2 launches {[i['launches'] for i in d2]}")
    got = ranks[0]["d2_result"]
    ref = refs["d2"]
    report["d2"] = {"ranks": d2, **_gate(
        "D2 sample-sharded megakernel vs one launch",
        canvas(torch.as_tensor(got["acc"]), nx, spp), ref.image, got["rays"],
        ref.rays_traced)}

    # D3: the dragon, primitives sharded, each shard's BVH4 through B3.
    nx, spp, depth = sizes["d3"]
    d3 = [r["d3"] for r in ranks]
    _print_ranks(f"D3 dragon stand-in {nx}x{nx}@{spp} depth {depth}, "
                 f"primitives sharded (shards of "
                 f"{[i['prims'] for i in d3]} primitives, "
                 f"{[i['nodes'] for i in d3]} BVH4 nodes, built in "
                 f"{[round(i['shard_seconds'], 3) for i in d3]} s; B3 "
                 f"launches a rank {[i['launches']['bvh_kernel'] for i in d3]}"
                 f" in {[i['iterations'] for i in d3]} pool iterations)", d3,
                 wall, card)
    for r, info in enumerate(d3):
        if info["launches"]["bvh_kernel"] < info["iterations"]:
            raise AssertionError(f"D3 rank {r} launched {info['launches']}")
    got = ranks[0]["d3_result"]
    ref = refs["d3"]
    xyz = convert.firefly_rejection(
        canvas(torch.as_tensor(got["acc"]), nx, spp).astype(np.float64))
    report["d3"] = {"ranks": d3, "max_abs_err": compare_xyz(
        "D3 prim-sharded dragon vs one process (XYZ after firefly "
        "rejection)", torch.as_tensor(xyz.reshape(-1, 3), dtype=torch.float32),
        got["rays"], torch.as_tensor(ref.xyz.reshape(-1, 3)),
        ref.rays_traced, 1)}
    if got["rays"] != ref.rays_traced:
        raise AssertionError("D3: rays differ from the one-process render")

    # D4: pbr_ibl, primitives and image stacks sharded.
    nx, spp, depth = sizes["d4"]
    d4 = [r["d4"] for r in ranks]
    _print_ranks(f"D4 pbr_ibl {nx}x{nx}@{spp} depth {depth}, primitives and "
                 f"textures sharded", d4, wall, card)
    one = renderer.render(pbr_ibl(), nx, nx, spp, path.RenderSettings(
        max_depth=depth), seed=0, device="cuda")
    got = ranks[0]["d4_result"]
    report["d4"] = {"ranks": d4, "one_process_seconds": one.seconds, **_gate(
        "D4 prim- and texture-sharded pbr_ibl vs one process", got["image"],
        one.image, got["rays"], one.rays_traced)}

    # D5: the training step, pixels sharded.
    nx, depth = sizes["d5"]
    d5 = [r["d5"] for r in ranks]
    _print_ranks(f"D5 training step cornell {nx}x{nx} depth {depth}, "
                 f"{nx * nx // DIST_RANKS} pixels a rank, the first step",
                 [r["d5_first"] for r in ranks], wall, card)
    _print_ranks(f"D5 training step cornell {nx}x{nx} depth {depth}, "
                 f"{nx * nx // DIST_RANKS} pixels a rank, the second step",
                 d5, wall, card)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = _d5_step(nx, depth, torch.device("cuda"), None)
    one_s = time.perf_counter() - t1
    grad_err = {}
    for r, res in enumerate(rk["d5_result"] for rk in ranks):
        if abs(res["loss"] - want["loss"]) > 1e-5 * abs(want["loss"]):
            raise AssertionError(f"D5 rank {r} loss {res['loss']} vs "
                                 f"{want['loss']}")
        for k, w in want["grads"].items():
            err = float(np.abs(res["grads"][k] - w).max())
            bound = 1e-4 * float(np.abs(w).max())
            grad_err[k] = max(grad_err.get(k, 0.0), err)
            if not (np.isfinite(res["grads"][k]).all() and err <= bound):
                raise AssertionError(f"D5 rank {r} gradient {k}: {err} > "
                                     f"{bound}")
    print(f"D5: loss {ranks[0]['d5_result']['loss']:.7f} vs one process "
          f"{want['loss']:.7f} ({one_s:.4f} s a step); largest gradient "
          f"error {grad_err} (tol 1e-4 max|g|)", flush=True)
    report["d5"] = {"ranks": d5, "loss": ranks[0]["d5_result"]["loss"],
                    "one_process_loss": want["loss"],
                    "one_process_seconds": one_s, "grad_err": grad_err}

    # D1 and D6's reference at world size 1, through NCCL.
    t0 = time.perf_counter()
    ws1 = dist.spawn(_ws1_rank, 1, args=(sizes,),
                     timeout_s=DIST_TIMEOUT_S)[0]
    wall1 = time.perf_counter() - t0
    _print_ranks("D1 at world size 1", [ws1["d1"]], wall1, card)
    # One rank renders as one process does: every pixel within
    # WS1_RTOL·|b| + WS1_ATOL, each a few hundred ulps of a 15.0 pixel's
    # float32 sum, the bound the pool's float-atomic deposits needed; the
    # deposit is now a segment sum in an order the slots fix, and two runs
    # of one process (printed) repeat bit for bit.
    got, one = ws1["d1_result"], refs["d1"]
    err = float(np.abs(got["image"] - one.image).max())
    spread = float(np.abs(refs["d1_warm"].image - one.image).max())
    within = bool(np.all(np.abs(got["image"] - one.image)
                         <= WS1_ATOL + WS1_RTOL * np.abs(one.image)))
    print(f"D1 world size 1 (NCCL) vs one process: rays {got['rays']} vs "
          f"{one.rays_traced}, max abs pixel difference {err:.3e} (two runs "
          f"of one process: {spread:.3e}); every pixel within {WS1_ATOL} + "
          f"{WS1_RTOL}|b|: {within}", flush=True)
    if got["rays"] != one.rays_traced or not within:
        raise AssertionError("D1 at world size 1 differs from one process")
    report["d1"]["world_size_1"] = {"rank": ws1["d1"], "max_abs_err": err,
                                    "one_process_run_to_run": spread}

    # D6: the command line's leader and worker, two ranks (gloo).
    nx, spp, depth = sizes["d6"]
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    port = dist._free_port()
    flags = ["-x", str(nx), "-y", str(nx), "--samples", str(spp),
             "--max-depth", str(depth), "--output-mode", "exr",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
    raw_path = os.path.join(work, "d6_leader_raw_xyz.npy")
    for stale in (raw_path, os.path.join(work, "d6_leader.exr")):
        if os.path.exists(stale):
            os.remove(stale)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + flags + role + [
        "--output-file", os.path.join(work, f"d6_{name}.exr")], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, cmd, role in (
            ("leader", [sys.executable, "-c", D6_LEADER, raw_path],
             ["--role", "leader"]),
            ("worker", [sys.executable, "-m", "izpi_tpu_torch"],
             ["--role", "worker", "--process-id", "1"]))]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    wall6 = time.perf_counter() - t0
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"D6: exit {p.returncode}\n{log[-3000:]}")
    summary = next(line for line in logs[0].splitlines()
                   if line.startswith("Rendering completed"))
    print(f"D6 CLI leader + worker, the pyramid {nx}x{nx}@{spp} depth "
          f"{depth}: processes {wall6:.2f} s wall; leader: {summary} "
          f"({card})", flush=True)
    if "x 2 ranks (gloo)" not in summary or os.path.exists(
            os.path.join(work, "d6_worker.exr")):
        raise AssertionError("D6: the summary names no backend, or the "
                             "worker wrote an image")
    _print_ranks("D6 reference at world size 1", [ws1["d6"]], wall1, card)
    one = ws1["d6_result"]
    got = output.read_image(os.path.join(work, "d6_leader.exr"))
    rays = int(summary.split()[5])
    # The gate: the canvases that the post-pass starts from.
    raw, raw_one = np.load(raw_path), one["raw_xyz"]
    diff = np.abs(raw - raw_one)
    raw_err = float(diff.max())
    raw_ok = bool(np.all(diff <= 1e-4 + 1e-4 * np.abs(raw_one)))
    # Each difference in float32 ulps of the reference (the canvas is a
    # float32 sum over the samples, divided by their count, a power of 2).
    ulps = diff / np.spacing(np.abs(raw_one).astype(np.float32))
    at = float(np.abs(raw_one).flat[int(diff.argmax())])
    # What firefly rejection (whose clamp of a pixel follows its
    # neighbours' Y) makes of them.
    post_err = np.abs(got - one["image"]).max(axis=-1)
    scaled = ((convert.firefly_rejection(raw) != raw).any(axis=-1)
              | (convert.firefly_rejection(raw_one) != raw_one).any(axis=-1))
    over = post_err > PIXEL_ATOL
    dimmest = (float(np.abs(one["image"]).max(axis=-1)[over].min())
               if over.any() else 0.0)
    print(f"D6 leader's XYZ canvas before firefly rejection vs world size "
          f"1: rays {rays} vs {one['rays']}, max abs err {raw_err:.3e} "
          f"(at |b| {at:.6g}), at most {float(ulps.max()):.2f} float32 ulps "
          f"of b, every pixel within 1e-4 + 1e-4|b|: {raw_ok}; after the "
          f"post-pass {int(over.sum())} pixels differ by more than "
          f"{PIXEL_ATOL} (the dimmest of them {dimmest:.6g} in its largest "
          f"channel), {int((over & scaled).sum())} of them scaled by "
          f"firefly rejection in either render ({int(scaled.sum())} scaled "
          f"pixels in all)", flush=True)
    if rays != one["rays"] or not raw_ok:
        raise AssertionError("D6: the leader's canvas differs from world "
                             "size 1's")
    report["d6"] = {"process_seconds": wall6, "summary": summary,
                    "raw_max_abs_err": raw_err,
                    "raw_max_ulps": float(ulps.max()),
                    "post_over_atol": int(over.sum()),
                    "post_over_atol_scaled": int((over & scaled).sum()),
                    **_gate("D6 leader's image (after the post-pass) vs "
                            "world size 1", got, one["image"], rays,
                            one["rays"])}

    # The dry run, four ranks.
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(DIST_RANKS, timeout_s=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for r, res in enumerate(dry):
        lc = {k: res[k]["launches"] for k in ("pool_bvh", "megakernel",
                                              "spectral_pool", "train_step")}
        if not (lc["pool_bvh"]["bvh4_traverse"] > 0
                and lc["pool_bvh"]["izpi_threefry_uniforms"] > 0
                and lc["megakernel"]["megakernel_rgb"] == 1
                and lc["train_step"]["izpi_threefry_uniforms"] > 0):
            raise AssertionError(f"dry run rank {r} launched {lc}")
    print(f"dryrun_multichip({DIST_RANKS}): {wall:.2f} s wall; rank 0 "
          f"launches {[dry[0][k]['launches'] for k in ('pool_bvh', 'megakernel', 'spectral_pool', 'train_step')]} "
          f"({card})", flush=True)
    report["dryrun"] = {"wall_s": wall, "ranks": dry}
    return report


def main() -> None:
    # 1. The card.
    START[0] = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    # 2. Build.
    t0 = time.perf_counter()
    probes, probe_proc = start_probe_build()
    lib_path = _build.build()
    _build.load()
    probe_log = probe_proc.communicate()[0]
    if probe_proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/sass_probes.cu:\n{probe_log}")
    print(f"build: {lib_path.name} (nvcc, or an earlier build of the same "
          f"sources) in {time.perf_counter() - t0:.2f} s", flush=True)
    log = lib_path.with_suffix(".log")
    log_text = log.read_text() if log.exists() else ""
    for line in log_text.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    usage = _build.ptxas_usage(log_text)
    for name in ("megakernel_rgb", "megakernel_spectral",
                 "megakernel_rgb_bvh", "megakernel_rgb_bvh_probe"):
        if name not in usage:
            raise AssertionError(f"no ptxas report of {name} in {log}")
        # The BVH form spills at its launch bounds (csrc/common.cuh
        # kBvhMinBlocks), which ran faster than fewer blocks with less
        # spill: its spill is printed below, not refused.
        if not name.startswith("megakernel_rgb_bvh") and (
                usage[name][1] or usage[name][2]):
            raise AssertionError(f"{name} spills registers: {usage[name]}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grids = {}
    for name, mod, entry_name in (
            ("megakernel_rgb", megakernel, megakernel.ENTRY),
            ("megakernel_spectral", megakernel_spectral,
             megakernel_spectral.ENTRY),
            ("megakernel_rgb_bvh", megakernel, megakernel.ENTRY_BVH)):
        regs, spill_st, spill_ld = usage[name][:3]
        blocks, threads = megakernel.card_grid(entry_name,
                                               torch.device("cuda"))
        grids[name] = dict(registers=regs, spill_bytes=spill_st + spill_ld,
                           spill_stores=spill_st, spill_loads=spill_ld,
                           stack_frame=usage[name].stack_frame,
                           smem=usage[name].smem, blocks=blocks,
                           threads=threads, blocks_per_sm=blocks / sms)
        print(f"grid: {name}: {regs} registers, spill stores {spill_st} B, "
              f"loads {spill_ld} B, stack frame {usage[name].stack_frame} B, "
              f"shared memory {usage[name].smem} B; "
              f"persistent grid {blocks} blocks x "
              f"{threads} threads ({blocks / sms:g} per SM of {sms}; "
              f"{blocks * threads} resident threads)", flush=True)
    u = usage["megakernel_rgb_bvh_probe"]
    print(f"grid: megakernel_rgb_bvh_probe: {u.registers} registers, spill "
          f"stores {u.spill_stores} B, loads {u.spill_loads} B, stack frame "
          f"{u.stack_frame} B, shared memory {u.smem} B; launched on the "
          f"BVH form's grid, never on a main path", flush=True)
    for name in ("bvh4_traverse", "bvh4_rowstack"):
        if name not in usage:
            raise AssertionError(f"no ptxas report of {name} in {log}")
    trav_build = traversal_build(usage, "grid")
    for name, how in (("diff_trace_fwd", "a warp's 32 paths, one a lane"),
                      ("diff_trace_fwd_bvh", "one thread a path"),
                      ("diff_trace_fwd_probe", "the probe, never on a main path"),
                      ("diff_trace_fwd_bvh_probe",
                       "the probe, never on a main path"),
                      ("diff_trace_bwd_stat", "the reverse's pass 1: a "
                       "block's paths sorted by length, a warp's walked "
                       "back plane by plane, their cotangents kept"),
                      ("diff_trace_bwd_lane", "its pass 2, the lanes' own "
                       "copies of a table of up to 16 elements"),
                      ("diff_trace_bwd_block", "its pass 2, the block's "
                       "copy of up to 4,096"),
                      ("diff_trace_bwd_global", "its pass 2 into device "
                       "memory")):
        if name not in usage:
            raise AssertionError(f"no ptxas report of {name} in {log}")
        u = usage[name]
        print(f"grid: {name}: {u.registers} registers, spill stores "
              f"{u.spill_stores} B, loads {u.spill_loads} B, stack frame "
              f"{u.stack_frame} B; {how}, "
              f"{256 if name.startswith('diff_trace_bwd') else 128} a block",
              flush=True)

    # 3. Cipher, bit for bit.
    rs = np.random.RandomState(0)
    n_keys = 1 << 20
    keys = torch.as_tensor(rs.randint(0, 2**32, (n_keys, 2), dtype=np.uint64)
                           .astype(np.int64), device="cuda")
    depths = torch.as_tensor(rs.randint(0, 64, n_keys).astype(np.int64),
                             device="cuda")
    cipher = {}
    for n, salt in ((12, 0), (5, camera.CAMERA_SALT), (1, wavefront.LAMBDA_SALT),
                    (2, path.MEDIA_SALT)):
        got = threefry.uniforms_for_keys(keys, depths, n, salt)
        want = threefry.uniforms_for_keys_reference(keys, depths, n, salt)
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        print(f"cipher: n={n} salt={salt:#x} keys={n_keys} bit-identical={same}",
              flush=True)
        if not same:
            raise AssertionError("device Threefry differs from the torch twin")
    # The new-sample form: path keys, camera and λ draws, with per-ray
    # sample ids and with one for every pair.
    pix = torch.as_tensor(rs.randint(0, 1 << 22, n_keys).astype(np.int64),
                          device="cuda")
    base = rng.render_key(2**40 + 17, device="cuda")
    for samples in (keys[:, 0].contiguous(), 1023):
        for salts in ((), (camera.CAMERA_SALT,),
                      (camera.CAMERA_SALT, wavefront.LAMBDA_SALT)):
            got = threefry.new_samples(base, pix, samples, *salts)
            want = threefry.new_samples_reference(base, pix, samples, *salts)
            same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(got, want) if w is not None)
            print(f"cipher: new sample, {len(salts)} draws beside the key, "
                  f"{'per-ray' if isinstance(samples, torch.Tensor) else 'one'}"
                  f" sample ids, keys={n_keys} bit-identical={same}",
                  flush=True)
            if not same:
                raise AssertionError("the new-sample form differs from the "
                                     "torch twin")
    for binary in (lib_path, probes):
        whole, main_paths = sass_counts(binary)
        SASS.update(whole)
        SASS_MAIN.update(main_paths)
    units = unit_instructions()
    print("sass units (integer ALU, all instructions, from the SASS probes "
          "of csrc/sass_probes.cu): " + "; ".join(
              f"{u} {a} / {t}" for u, (a, t) in units.items())
          + f"; the cipher entry's x 12 form a cipher call "
          f"{tuple(round(x / 8, 2) for x in _sass_per_key('bounce', 12))}",
          flush=True)
    forms = cipher_forms(card)
    top = next(r for r in forms if r["form"] == "bounce"
               and r["uniforms"] == 12 and r["keys"] == n_keys)
    cipher.update(ms=top["ms"], plain_ms=top["plain_ms"],
                  bound_ms=top["bound_ms"], forms=forms)

    mark("phases 1-3")
    # 4. Kernel vs twin on the card, the twin on the card's layout: at
    # 64x64@4 depth 8, at the multi-slot and multi-sample layouts and at the
    # main path's frame, 256x256 depth 50, for two sample chunks, the main
    # path's first and its last.
    cs, meta = compiler.compile_scene(cornell_box(), "cuda")
    tables = megakernel.pack_tables(cs)
    errs = []
    for nx, spp, depth, seed, offset in ((64, 4, 8, 3, 0), MULTI_SLOT,
                                         MULTI_SAMPLE, (256, 2, 50, 0, 0),
                                         (256, 2, 50, 0, 1022)):
        errs.append(compare(cs, meta, tables, nx, spp, depth, seed, offset))
    for mod in (megakernel, megakernel_spectral):
        for name, layout, spp_slot in (("multi-slot", MULTI_SLOT, 1),
                                       ("multi-sample", MULTI_SAMPLE, 2)):
            lay = card_layout(mod, layout[0], layout[1])
            resident = lay["blocks"] * lay["threads"]
            if not (lay["slots"] > resident and lay["slots"] % resident
                    and lay["spp_slot"] >= spp_slot):
                raise AssertionError(
                    f"{mod.__name__}: {lay['slots']} slots of "
                    f"{lay['spp_slot']} samples at the {name} layout on "
                    f"{resident} threads")
    max_abs_err = max(errs)
    timed = {}
    for nx, spp, depth in ((64, 4, 8), (256, 2, 50)):
        s = path.RenderSettings(max_depth=depth)
        key = rng.render_key(0, device="cuda")
        timed[nx] = (
            cuda_ms(lambda: megakernel.render_slots(
                cs, meta, s, nx, nx, spp, key, tables=tables), 10),
            cuda_ms(lambda: megakernel.render_slots_reference(
                cs, meta, s, nx, nx, spp, key,
                min_slots=megakernel.card_min_slots(megakernel.ENTRY,
                                                    cs.device)), 2))
        print(f"kernel-vs-twin: time at {nx}x{nx}@{spp} depth {depth}: kernel "
              f"{timed[nx][0]:.4f} ms, plain twin {timed[nx][1]:.4f} ms ({card})",
              flush=True)
    mk_ms_2, plain_ms = timed[256]
    s = path.RenderSettings(max_depth=50)
    _, rgb_rays, rgb_draws = megakernel.render_slots(
        cs, meta, s, 256, 256, 2, rng.render_key(0, device="cuda"),
        tables=tables, draws=True)
    rgb_bound_2 = launch_bound("megakernel_rgb at 256x256@2 depth 50",
                               int(rgb_rays), 256 * 256 * 2, rgb_draws,
                               cs.prims.kind.tolist(), False,
                               card_layout(megakernel, 256, 2),
                               tensor_bytes(tables), card)

    # 4, spectral. The spectral megakernel against its plain version at
    # the RGB kernel's layouts: 64x64@4 depth 8, the multi-slot and
    # multi-sample layouts, and the spectral main path's frame, 500x500
    # depth 50, for its first and its last sample chunk.
    scs, smeta = compiler.compile_scene(cornell_box_pyramid_spectral(), "cuda")
    stables = megakernel_spectral.pack_spectral_tables(scs)
    serrs = []
    for nx, spp, depth, seed, offset in ((64, 4, 8, 3, 0), MULTI_SLOT,
                                         MULTI_SAMPLE, (500, 2, 50, 0, 0),
                                         (500, 2, 50, 0, 254)):
        serrs.append(compare_spectral(scs, smeta, stables, nx, spp, depth, seed,
                                      offset))
    s = path.RenderSettings(max_depth=50)
    key = rng.render_key(0, device="cuda")
    spec_min = megakernel.card_min_slots(megakernel_spectral.ENTRY,
                                         scs.device)
    spec_ms_2 = cuda_ms(lambda: megakernel_spectral.render_slots_spectral(
        scs, smeta, s, 500, 500, 2, key, tables=stables), 10)
    spec_plain_ms = cuda_ms(
        lambda: megakernel_spectral.render_slots_spectral_reference(
            scs, smeta, s, 500, 500, 2, key, min_slots=spec_min), 2)
    print(f"kernel-vs-twin: time at 500x500@2 depth 50: spectral kernel "
          f"{spec_ms_2:.4f} ms, plain version {spec_plain_ms:.4f} ms "
          f"({card})", flush=True)
    _, spec_rays, spec_draws = megakernel_spectral.render_slots_spectral(
        scs, smeta, s, 500, 500, 2, key, tables=stables, draws=True)
    stable_bytes = tensor_bytes(stables.rgb) + tensor_bytes(stables[1:])
    spec_bound_2 = launch_bound(
        "megakernel_spectral at 500x500@2 depth 50", int(spec_rays),
        500 * 500 * 2, spec_draws, scs.prims.kind.tolist(), True,
        card_layout(megakernel_spectral, 500, 2), stable_bytes,
        card)

    mark("phase 4")
    # 5. The main path, through the entry points a user calls; the timed
    # run's launch between CUDA events.
    settings = path.RenderSettings(max_depth=50)
    ctx = renderer.RenderContext(cornell_box(), device="cuda")
    megakernel.launches = 0
    threefry.launches = 0
    warm = renderer.render(None, 256, 256, 1024, settings, seed=0,
                           mode="wavefront", context=ctx, device="cuda")
    with profiling.event_timed(megakernel, "render_slots") as times:
        res = renderer.render(None, 256, 256, 1024, settings, seed=0,
                              mode="wavefront", context=ctx, device="cuda")
    mk_ms = profiling.event_ms(times)
    launches = megakernel.launches
    img = res.image
    lay = card_layout(megakernel, 256, 1024)
    print(f"main path: cornell 256x256@1024 depth 50 seed 0 on {res.device}: "
          f"{res.rays_traced} rays in {res.seconds:.4f} s = "
          f"{res.mrays_per_sec:.2f} Mrays/s (warm-up run {warm.seconds:.4f} s; "
          f"{card}); megakernel launches {launches}; the timed launch "
          f"{mk_ms:.4f} ms (CUDA events, {len(times)} call) = "
          f"{mk_ms / 1e3 / res.seconds:.2%} of render(); grid {lay['blocks']} x "
          f"{lay['threads']}, {lay['replicas']} replicas, {lay['slots']} slots "
          f"of {lay['spp_slot']} samples, {lay['slots_per_thread']:.3f} per "
          f"resident thread", flush=True)
    if launches != 2 or len(times) != 1:
        raise AssertionError(f"the main path launched the megakernel "
                             f"{launches} times, expected 2")
    if res.rays_traced != warm.rays_traced or not np.array_equal(img, warm.image):
        raise AssertionError("two runs of the same render differ")
    if img.shape != (256, 256, 3) or not np.isfinite(img).all():
        raise AssertionError("main-path image is not finite (256, 256, 3)")
    left = img[64:192, 4:24].mean(axis=(0, 1))
    right = img[64:192, -24:-4].mean(axis=(0, 1))
    light = float(np.percentile(img[:64].max(axis=2), 99.5))
    print(f"main path: left wall rgb {np.round(left, 4).tolist()}, right wall "
          f"rgb {np.round(right, 4).tolist()}, light patch {light:.4f}, "
          f"image mean {float(img.mean()):.5f}", flush=True)
    if not (left[1] > left[0] and right[0] > right[1]):
        raise AssertionError("walls: expected green on the left, red on the right")
    if abs(light - 15.0) > 0.5:
        raise AssertionError(f"ceiling light patch {light}, expected ~15")
    # One more launch of the same render with the draw counter buffer: it
    # repeats the image and rays, and its counts give the bound.
    acc_d, rays_d, draws_d = megakernel.render_slots(
        ctx.cs, ctx.meta, settings, 256, 256, 1024,
        rng.render_key(0, device="cuda"), tables=ctx.tables(), draws=True)
    if int(rays_d) != res.rays_traced or not np.array_equal(
            canvas(acc_d, 256, 1024), img):
        raise AssertionError("the launch with draw counts differs from the "
                             "main path's")
    main_bound = launch_bound(
        "megakernel_rgb per launch on the main path", res.rays_traced,
        256 * 256 * 1024, draws_d, cs.prims.kind.tolist(), False, lay,
        tensor_bytes(ctx.tables()), card)
    print(f"main path: megakernel_rgb {mk_ms:.4f} ms per launch at "
          f"{main_bound['bound_ms'] / mk_ms:.2%} of its bound (SASS) "
          f"({card})", flush=True)

    mark("phase 5")
    # 6. The spectral main path, through the same entry points.
    sctx = renderer.RenderContext(cornell_box_pyramid_spectral(), device="cuda")
    megakernel.launches = 0
    megakernel_spectral.launches = 0
    threefry.launches = 0
    swarm = renderer.render(None, 500, 500, 256, settings, seed=0,
                            mode="wavefront", context=sctx, device="cuda")
    with profiling.event_timed(megakernel_spectral,
                               "render_slots_spectral") as stimes:
        sres = renderer.render(None, 500, 500, 256, settings, seed=0,
                               mode="wavefront", context=sctx, device="cuda")
    spec_ms = profiling.event_ms(stimes)
    spec_launches = megakernel_spectral.launches
    slay = card_layout(megakernel_spectral, 500, 256)
    print(f"spectral main path: pyramid 500x500@256 depth 50 seed 0 on "
          f"{sres.device}: {sres.rays_traced} rays in {sres.seconds:.4f} s = "
          f"{sres.mrays_per_sec:.2f} Mrays/s (warm-up run {swarm.seconds:.4f} s; "
          f"{card}); spectral megakernel launches {spec_launches}; the timed "
          f"launch {spec_ms:.4f} ms (CUDA events, {len(stimes)} call) = "
          f"{spec_ms / 1e3 / sres.seconds:.2%} of render(); grid "
          f"{slay['blocks']} x {slay['threads']}, {slay['replicas']} replicas, "
          f"{slay['slots']} slots of {slay['spp_slot']} samples, "
          f"{slay['slots_per_thread']:.3f} per resident thread", flush=True)
    if spec_launches != 2 or len(stimes) != 1:
        raise AssertionError(f"the spectral main path launched the spectral "
                             f"megakernel {spec_launches} times, expected 2")
    if (sres.rays_traced != swarm.rays_traced
            or not np.array_equal(sres.image, swarm.image)
            or not np.array_equal(sres.xyz, swarm.xyz)):
        raise AssertionError("two runs of the same spectral render differ")
    for name, arr in (("xyz", sres.xyz), ("image", sres.image)):
        if arr.shape != (500, 500, 3) or not np.isfinite(arr).all():
            raise AssertionError(f"spectral {name} is not finite (500, 500, 3)")
    simg = sres.image
    sleft = simg[125:375, 100].mean(axis=0)
    sright = simg[125:375, -100].mean(axis=0)
    light_y = float(np.percentile(sres.xyz[:125, :, 1], 99.5))
    want_y = 15.0 * cie.CIE_Y_INTEGRAL
    print(f"spectral main path: ACEScg left wall (x=100) "
          f"{np.round(sleft, 4).tolist()}, right wall (x=400) "
          f"{np.round(sright, 4).tolist()}; light patch Y {light_y:.4f} "
          f"(expected {want_y:.4f}); mean Y {float(sres.xyz[..., 1].mean()):.5f}",
          flush=True)
    if not (sleft[1] > sleft[0] and sright[0] > sright[1]):
        raise AssertionError("spectral walls: expected green on the left, red "
                             "on the right")
    if abs(light_y - want_y) > 0.005 * want_y:
        raise AssertionError(f"spectral light patch Y {light_y}, expected "
                             f"{want_y} within 0.5%")
    st = sctx.tables()
    sacc_d, srays_d, sdraws_d = megakernel_spectral.render_slots_spectral(
        sctx.cs, sctx.meta, settings, 500, 500, 256,
        rng.render_key(0, device="cuda"), tables=st, draws=True)
    if int(srays_d) != sres.rays_traced or not np.array_equal(
            convert.firefly_rejection(canvas(sacc_d, 500, 256).astype(
                np.float64)).astype(np.float32), sres.xyz):
        raise AssertionError("the spectral launch with draw counts differs "
                             "from the main path's")
    smain_bound = launch_bound(
        "megakernel_spectral per launch on the main path", sres.rays_traced,
        500 * 500 * 256, sdraws_d, scs.prims.kind.tolist(), True, slay,
        tensor_bytes(st.rgb) + tensor_bytes(st[1:]), card)
    print(f"spectral main path: megakernel_spectral {spec_ms:.4f} ms per launch "
          f"at {smain_bound['bound_ms'] / spec_ms:.2%} of its bound (SASS) "
          f"({card})", flush=True)

    mark("phase 6")
    # 7. The traversal kernel against its plain version, at two scales,
    # each scene compiled and its tree built and packed by RenderContext.
    # The first is the main path's context.
    bctx = renderer.RenderContext(cornell_box_obj(), device="cuda")
    dctx = renderer.RenderContext(dragon_stand_in(), device="cuda")
    traversal_build(usage, "phase 7")
    found, rays7 = {}, {}
    for label, ctx, seed in (("cornell_box_obj", bctx, 7),
                             ("dragon stand-in", dctx, 8)):
        ks = ctx.intersect.ks
        print(f"traversal build: {label}, {ctx.meta.n_prims} prims, "
              f"{ks.nodes.shape[0]} nodes (SAH, leaf 4); compile and build "
              f"{ctx.build_seconds:.3f} s", flush=True)
        rays7[label] = traversal_rays(ks, ctx.cs.camera, TRAVERSE_RAYS, seed)
        found[label] = compare_traversal(label, ks, rays7[label], card)
    trav, dtrav = found["cornell_box_obj"], found["dragon stand-in"]

    mark("phase 7")
    # 8. The pool through the kernel against the pool through the plain
    # traversal, on the same tree.
    plain_inter = functools.partial(traverse.intersect_bvh, bctx.cs.prims,
                                    bctx.intersect.ks.tree)
    s8 = path.RenderSettings(max_depth=50)
    key8 = rng.render_key(0, device="cuda")
    pool8 = min(32 * 32 * 4, renderer.POOL_MAX)
    before, stats8 = bvh_kernel.launches, {}
    acc_k, rays_k, it_k = wavefront.trace_pool(
        bctx.cs, bctx.meta, s8, bctx.intersect, 32, 32, 4, key8, pool8,
        stats=stats8)
    launched = bvh_kernel.launches - before
    # The plain traversal compacts its rays (a host sync), so its pool
    # runs the plain loop, which captures nothing.
    acc_p, rays_p, it_p = wavefront._trace_pool(
        bctx.cs, bctx.meta, s8, plain_inter, 32, 32, 4, key8, pool8, False, 0,
        0, 1, False)
    torch.cuda.synchronize()
    img_k, img_p = acc_k / 4, acc_p / 4
    rays_k, rays_p = int(rays_k), int(rays_p)
    pix_err = (img_k - img_p).abs().amax(dim=1)
    share = float((pix_err <= PIXEL_ATOL).float().mean())
    rays_rel = abs(rays_k - rays_p) / rays_p
    mean_rel = abs(float(img_k.mean()) / float(img_p.mean()) - 1)
    print(f"pool: cornell_box_obj 32x32@4 depth 50 (pool {pool8}): kernel "
          f"rays {rays_k} in {it_k} iterations ({launched} kernel launches in "
          f"{stats8['trips']} bodies run, {stats8['replays']} replayed), "
          f"plain traversal rays {rays_p} in {it_p}; rel {rays_rel:.2e} (tol "
          f"{RAYS_RTOL}); pixels within {PIXEL_ATOL}: {share:.6f} (tol "
          f"{PIXEL_SHARE}); max abs err {float(pix_err.max()):.3e}; mean rel "
          f"{mean_rel:.2e} (tol {MEAN_RTOL})", flush=True)
    if not (bool(torch.isfinite(img_k).all()) and rays_rel <= RAYS_RTOL
            and share >= PIXEL_SHARE and mean_rel <= MEAN_RTOL
            and launched == stats8["trips"] >= it_k):
        raise AssertionError("the pool through the traversal kernel disagrees "
                             "with the pool through the plain traversal")

    mark("phase 8, the pool")
    # 8, the BVH form. The RGB megakernel's BVH form against its plain
    # version (`render_slots_reference` through the plain traversal), both
    # on the card, the plain version on the card's layout: rays equal,
    # phase 4's pixel tolerances.
    ks = bctx.mega_bvh()
    if ks is None or ks is not bctx.intersect.ks:
        raise AssertionError("cornell_box_obj's context does not take the "
                             "megakernel's BVH form")
    btables = bctx.tables()
    bvh_min = megakernel.card_min_slots(megakernel.ENTRY_BVH, bctx.device)
    plain_bvh = megakernel.bvh_plain_intersector(ks)
    bvh_errs = []
    for n, spp, depth, seed in BVH_FORM_CHECKS:
        s8 = path.RenderSettings(max_depth=depth)
        key = rng.render_key(seed, device="cuda")
        acc_k, rays_k, _, trav_k = megakernel.render_slots(
            bctx.cs, bctx.meta, s8, n, n, spp, key, tables=btables, bvh=ks,
            draws=True)
        acc_p, rays_p = megakernel.render_slots_reference(
            bctx.cs, bctx.meta, s8, n, n, spp, key, min_slots=bvh_min,
            intersect=plain_bvh)
        torch.cuda.synchronize()
        blay = card_layout(megakernel, n, spp, megakernel.ENTRY_BVH)
        nodes, tests = (int(x) for x in trav_k.sum(dim=0))
        bvh_errs.append(image_close(
            f"BVH form vs plain: cornell_box_obj {n}x{n}@{spp} depth {depth} "
            f"seed {seed} ({blay['slots']} slots of {blay['spp_slot']} "
            f"samples, {blay['slots_per_thread']:.3f} per resident thread; "
            f"{nodes / int(rays_k):.4f} nodes popped and "
            f"{tests / int(rays_k):.4f} primitives tested a ray)",
            acc_k, int(rays_k), acc_p, int(rays_p), spp))
        if int(rays_k) != int(rays_p):
            raise AssertionError(f"the BVH form traced {int(rays_k)} rays, "
                                 f"its plain version {int(rays_p)}")
        resident = blay["blocks"] * blay["threads"]
        if n == 64 and not (blay["slots"] > resident
                            and blay["slots"] % resident):
            raise AssertionError(f"the BVH form's {blay['slots']} slots on "
                                 f"{resident} threads at {n}x{n}@{spp}")
    # Both timed at the main path's frame at 2 spp and depth 50, and held to
    # each other there (rays equal, phase 4's pixel tolerances); the
    # launch's draw and traversal counts give its bound there.
    key = rng.render_key(0, device="cuda")
    bvh_ms_2 = cuda_ms(lambda: megakernel.render_slots(
        bctx.cs, bctx.meta, settings, 256, 256, 2, key, tables=btables,
        bvh=ks), 10)
    # One plain run, not warmed up: it takes seconds. It counts each slot's
    # traversal as it goes (`bvh_plain_intersector`'s counts), which the
    # kernel's launch with its counts is held to below.
    per_slot = torch.zeros((card_layout(megakernel, 256, 2,
                                        megakernel.ENTRY_BVH)["slots"], 2),
                           dtype=torch.int64, device="cuda")
    (acc_p2, rays_p2), bvh_plain_ms = profiling.cuda_ms(
        lambda: megakernel.render_slots_reference(
            bctx.cs, bctx.meta, settings, 256, 256, 2, key,
            min_slots=bvh_min,
            intersect=megakernel.bvh_plain_intersector(ks, per_slot)), 1,
        warm_up=False)
    print(f"BVH form: time at 256x256@2 depth 50: kernel {bvh_ms_2:.4f} ms, "
          f"plain version {bvh_plain_ms:.4f} ms, its per-slot traversal "
          f"counts with it ({card})", flush=True)
    acc_k2, brays_2, bdraws_2, btrav_2 = megakernel.render_slots(
        bctx.cs, bctx.meta, settings, 256, 256, 2, key, tables=btables, bvh=ks,
        draws=True)
    torch.cuda.synchronize()
    bvh_errs.append(image_close(
        "BVH form vs plain: cornell_box_obj 256x256@2 depth 50 seed 0",
        acc_k2, int(brays_2), acc_p2, int(rays_p2), 2))
    if int(brays_2) != int(rays_p2):
        raise AssertionError(f"the BVH form traced {int(brays_2)} rays at "
                             f"256x256@2, its plain version {int(rays_p2)}")
    del acc_p2, acc_k2
    btable_bytes = tensor_bytes(btables) + tensor_bytes([ks.nodes,
                                                         ks.prim_table])
    bvh_bound_2 = launch_bound(
        "megakernel_rgb_bvh at 256x256@2 depth 50", int(brays_2),
        256 * 256 * 2, bdraws_2, bctx.cs.prims.kind.tolist(), False,
        card_layout(megakernel, 256, 2, megakernel.ENTRY_BVH), btable_bytes,
        card, btrav_2.sum(dim=0))
    # Each slot's traversal counts at 256x256@2 equal the plain version's.
    same_counts = torch.equal(per_slot, btrav_2)
    print(f"BVH form vs plain: cornell_box_obj 256x256@2 depth 50: each "
          f"slot's (nodes popped, primitives tested) equal: {same_counts} "
          f"({tuple(int(x) for x in btrav_2.sum(dim=0))} against "
          f"{tuple(int(x) for x in per_slot.sum(dim=0))})", flush=True)
    if not same_counts:
        raise AssertionError("the BVH form's traversal counts differ from "
                             "its plain version's")

    mark("phase 8, the BVH form")
    # 9. The BVH main path, through the entry points a user calls: the RGB
    # megakernel's BVH form, one launch a render, every counter zeroed just
    # before the warm-up and read after the timed run.
    zero_counts()
    bwarm = renderer.render(None, 256, 256, 128, settings, seed=0,
                            mode="wavefront", context=bctx, device="cuda")
    with profiling.event_timed(megakernel, "render_slots") as btimes:
        bres = renderer.render(None, 256, 256, 128, settings, seed=0,
                               mode="wavefront", context=bctx, device="cuda")
    bcounts = read_counts()
    bvh_ms = profiling.event_ms(btimes)
    blay = card_layout(megakernel, 256, 128, megakernel.ENTRY_BVH)
    bimg = bres.image
    print(f"BVH main path: cornell_box_obj 256x256@128 depth 50 seed 0 on "
          f"{bres.device}: {bres.rays_traced} rays in {bres.seconds:.4f} s = "
          f"{bres.mrays_per_sec:.3f} Mrays/s through the RGB megakernel's BVH "
          f"form (warm-up run {bwarm.seconds:.4f} s; {card}); launches "
          f"{bcounts}; the timed launch {bvh_ms:.4f} ms (CUDA events, "
          f"{len(btimes)} call) = {bvh_ms / 1e3 / bres.seconds:.2%} of "
          f"render(); pool iterations {bres.iterations}, replays "
          f"{bres.replays}; grid {blay['blocks']} x {blay['threads']}, "
          f"{blay['replicas']} replicas, {blay['slots']} slots of "
          f"{blay['spp_slot']} samples, {blay['slots_per_thread']:.3f} per "
          f"resident thread", flush=True)
    if (bcounts["megakernel_bvh"] != 2 or len(btimes) != 1
            or sum(bcounts.values()) != 2 or bres.iterations is not None
            or bres.replays is not None or bwarm.replays is not None):
        raise AssertionError(f"the BVH main path launched {bcounts} "
                             f"({len(btimes)} timed calls), pool iterations "
                             f"{bres.iterations}, replays {bres.replays}")
    if (bres.rays_traced != bwarm.rays_traced
            or not np.array_equal(bimg, bwarm.image)):
        raise AssertionError("two runs of the BVH main path differ")
    cornell_checks("BVH main path", bimg)
    # One more launch with the draw and traversal counter buffers: it
    # repeats the image and rays, and its counts give the bound.
    acc_d, rays_d, draws_d, trav_d = megakernel.render_slots(
        bctx.cs, bctx.meta, settings, 256, 256, 128,
        rng.render_key(0, device="cuda"), tables=btables, bvh=ks, draws=True)
    if int(rays_d) != bres.rays_traced or not np.array_equal(
            canvas(acc_d, 256, 128), bimg):
        raise AssertionError("the BVH form's launch with counts differs from "
                             "the main path's")
    bvh_bound = launch_bound(
        "megakernel_rgb_bvh per launch on the BVH main path",
        bres.rays_traced, 256 * 256 * 128, draws_d,
        bctx.cs.prims.kind.tolist(), False, blay, btable_bytes, card,
        trav_d.sum(dim=0))
    print(f"BVH main path: megakernel_rgb_bvh {bvh_ms:.4f} ms per launch at "
          f"{bvh_bound['bound_ms'] / bvh_ms:.2%} of its bound (SASS); its "
          f"traversal {bvh_bound['nodes'] / bres.rays_traced:.4f}"
          f" nodes popped and {bvh_bound['tests'] / bres.rays_traced:.4f} "
          f"primitives tested a ray, against bvh4_traverse's "
          f"{trav['per_ray']} on phase 7's rays on the same tree ({card})",
          flush=True)
    # The probe instance on the main path's frame (not a main-path launch):
    # it renders the draws launch's bits, rays and counts, and says how the
    # warps spent the traversal.
    (pacc, prays, _, ptrav), probe9 = megakernel.probe_bvh(
        bctx.cs, bctx.meta, settings, 256, 256, 128,
        rng.render_key(0, device="cuda"), tables=btables, bvh=ks)
    probe_same = (torch.equal(pacc.view(torch.int32), acc_d.view(torch.int32))
                  and int(prays) == int(rays_d) and torch.equal(ptrav, trav_d))
    print(f"BVH main path: {measure_port.probe_line(probe9)}; its render, "
          f"rays and counts equal the main instance's: {probe_same} "
          f"({card})", flush=True)
    if not probe_same:
        raise AssertionError("the BVH form's probe renders other bits than "
                             "its main instance")

    mark("phase 9, the BVH form")
    # 9, the pool. The same render through the queue pool (mode "pool", as
    # before the BVH form): the warm-up render captures the pool's
    # iteration as a CUDA graph and records the cipher calls of the
    # captured body; the timed render replays it.
    zero_counts()
    with recorded_cipher_calls() as warm_calls:
        warm = renderer.render(None, 256, 256, 128, settings, seed=0,
                               mode="pool", context=bctx, device="cuda")
    if bvh_kernel.launches != warm.trips or warm.replays != warm.trips - 1:
        raise AssertionError(f"warm-up: {bvh_kernel.launches} traversal "
                             f"launches for {warm.trips} pool bodies run "
                             f"({warm.replays} replayed)")
    zero_counts()
    with recorded_cipher_calls() as timed_calls:
        ores = renderer.render(None, 256, 256, 128, settings, seed=0,
                               mode="pool", context=bctx, device="cuda")
    pool_counts = read_counts()
    bvh_launches, cipher_launches = bvh_kernel.launches, threefry.launches
    sample_launches = threefry.sample_launches
    mega_moved = (pool_counts["megakernel"] + pool_counts["megakernel_bvh"]
                  + pool_counts["megakernel_spectral"])
    oimg = ores.image
    print(f"BVH pool path: cornell_box_obj 256x256@128 depth 50 seed 0 "
          f"(mode pool) on {ores.device}: {ores.rays_traced} rays in "
          f"{ores.seconds:.4f} s = {ores.mrays_per_sec:.3f} Mrays/s in "
          f"{ores.iterations} pool iterations, {ores.trips} bodies run, "
          f"{ores.replays} replayed from the CUDA graph (warm-up run "
          f"{warm.seconds:.4f} s with its capture {warm.capture_seconds:.4f} "
          f"s, {warm.rays_traced} rays; {card}); launches {pool_counts} "
          f"(new-sample form {sample_launches})", flush=True)
    if (bvh_launches != ores.replays or ores.replays != ores.trips
            or mega_moved != 0 or sample_launches < 1
            or ores.capture_seconds != 0):
        raise AssertionError(f"the BVH pool path launched the traversal "
                             f"kernel {bvh_launches} times in {ores.replays} "
                             f"replays of {ores.trips} bodies, the megakernels "
                             f"{mega_moved} times, the new-sample form "
                             f"{sample_launches} times")
    cornell_checks("BVH pool path", oimg)
    print(f"BVH main path vs pool: cornell_box_obj 256x256@128: the BVH form "
          f"{bres.seconds:.4f} s, {bres.mrays_per_sec:.3f} Mrays/s; the graphed "
          f"pool {ores.seconds:.4f} s, {ores.mrays_per_sec:.3f} Mrays/s; "
          f"{ores.seconds / bres.seconds:.2f}x; rays {bres.rays_traced} vs "
          f"{ores.rays_traced} ({card})", flush=True)
    bvh_vs_pool_err = image_close(
        "BVH main path vs the graphed pool (images)",
        torch.as_tensor(bimg.reshape(-1, 3)), bres.rays_traced,
        torch.as_tensor(oimg.reshape(-1, 3)), ores.rays_traced, 1)
    if bres.rays_traced != ores.rays_traced:
        raise AssertionError(f"the BVH form traced {bres.rays_traced} rays, "
                             f"the pool {ores.rays_traced}")
    cipher_main = cipher_on_path(
        executed_cipher_calls(warm_calls, timed_calls, ores.replays),
        cipher_launches, card, "the BVH pool path")
    loop9 = loop_phase("cornell_box_obj", bctx, 256, 128, settings, card, 16,
                       (bvh_kernel, "closest_hit"))
    trav_per_launch = loop9["kernel_ms"]
    kernel_s = trav_per_launch * bvh_launches / 1e3
    busy = loop9["graphed"]["profile"]["busy_s"]
    wall = loop9["graphed"]["profile"]["wall_s"]
    print(f"BVH pool path: the traversal kernel {trav_per_launch:.4f} ms per "
          f"launch (the plain loop's launches, CUDA events) x {bvh_launches} "
          f"launches = {kernel_s:.4f} s, {kernel_s / ores.seconds:.2%} of "
          f"render() ({card})", flush=True)

    mark("phase 9, the pool")
    rows10, dragon_runs, dragon_res = row_stack_phases(bctx, dctx, rays7,
                                                       card, usage)
    del dctx, rays7
    drow = rows10["dragon"]
    torch.cuda.empty_cache()
    mark("phases 10-12")
    paths13 = texture_phases(card, usage)
    torch.cuda.empty_cache()
    mark("phases 13-15")
    train = training_phases(card)
    torch.cuda.empty_cache()
    mark("phases 16-17")
    cli = cli_phases(card)
    torch.cuda.empty_cache()
    mark("phase 18")
    distributed = distribution_phases(
        card, {"d1": D1, "d2": D2, "d3": D3, "d4": D4, "d5": D5, "d6": D6},
        {"d1": ores, "d1_warm": warm, "d2": res, "d3": dragon_res})

    mark("phases D1-D6")
    g_name, g_main = max(train["cornell"]["table_grad"].items(),
                         key=lambda kv: kv[1]["calls_per_step"])
    print(json.dumps({
        "kernels": [{
            "name": "megakernel_rgb",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/megakernel_rgb.cu",
            "replaces": "izpi_tpu/ops/megakernel.py:628",
            "launches": launches,
            "max_abs_err": max_abs_err,
            "ms": mk_ms,
            "plain_ms": plain_ms,
            "bound_ms": main_bound["bound_ms"],
            "bound_by": main_bound["bound_by"],
            "library_ms": None,
            "pairs_per_scatter": main_bound["pairs"] / main_bound["scatters"],
            "ms_at_2": mk_ms_2,
            "bound_ms_at_2": rgb_bound_2["bound_ms"],
            "launches_distributed": dist_launches(distributed, "megakernel",
                                                  "megakernel_rgb"),
            "layout": lay,
            "shirley_main_path": {k: paths13["shirley"][k] for k in (
                "launches", "ms_per_launch", "bound_ms", "bound_by",
                "max_abs_err")},
            **grids["megakernel_rgb"],
        }, {
            "name": "megakernel_rgb_bvh",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/megakernel_rgb.cu",
            "replaces": "izpi_tpu/ops/bvh_kernel.py:133",
            "launches": bcounts["megakernel_bvh"],
            "max_abs_err": max(bvh_errs),
            "ms": bvh_ms,
            "plain_ms": bvh_plain_ms,
            "bound_ms": bvh_bound["bound_ms"],
            "bound_by": bvh_bound["bound_by"],
            "library_ms": None,
            "nodes_per_ray": bvh_bound["nodes"] / bres.rays_traced,
            "tests_per_ray": bvh_bound["tests"] / bres.rays_traced,
            "bvh4_traverse_per_ray_phase7": trav["per_ray"],
            "pairs_per_scatter": bvh_bound["pairs"] / bvh_bound["scatters"],
            "ms_at_2": bvh_ms_2,
            "bound_ms_at_2": bvh_bound_2["bound_ms"],
            "max_abs_err_vs_graphed_pool": bvh_vs_pool_err,
            "also_replaces": "izpi_tpu/ops/megakernel.py:628 (its loop)",
            "traversal": "izpi_tpu_torch/csrc/bvh4.cuh",
            "probe": probe9,
            "layout": blay,
            **grids["megakernel_rgb_bvh"],
        }, {
            "name": "megakernel_spectral",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/megakernel_spectral.cu",
            "replaces": "izpi_tpu/ops/megakernel_spectral.py:267",
            "launches": spec_launches,
            "max_abs_err": max(serrs),
            "ms": spec_ms,
            "plain_ms": spec_plain_ms,
            "bound_ms": smain_bound["bound_ms"],
            "bound_by": smain_bound["bound_by"],
            "library_ms": None,
            "pairs_per_scatter": smain_bound["pairs"] / smain_bound["scatters"],
            "ms_at_2": spec_ms_2,
            "bound_ms_at_2": spec_bound_2["bound_ms"],
            "layout": slay,
            **grids["megakernel_spectral"],
        }, {
            "name": "bvh4_traverse",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/bvh4_traverse.cu",
            "replaces": "izpi_tpu/ops/bvh_kernel.py:133",
            "launches": dragon_runs["bvh4_traverse"]["launches"],
            "launches_cornell_obj_default": bcounts["bvh_kernel"],
            "launches_cornell_obj_pool": bvh_launches,
            "max_abs_err": max(trav["max_abs_err"], dtrav["max_abs_err"]),
            "ms": trav["ms"],
            "plain_ms": trav["plain_ms"],
            "bound_ms": trav["bound_ms"],
            "bound_by": trav["bound_by"],
            "library_ms": None,
            "ms_per_launch_main_path": trav_per_launch,
            "launches_distributed": dist_launches(distributed, "bvh_kernel",
                                                  "bvh4_traverse"),
            "launches_per_training_step": {
                "cornell_box_obj_256_depth50_fused": train["cornell_box_obj"][
                    "launches_per_replay"]["bvh_kernel"],
                "cornell_box_obj_256_depth50_checkpointed": {
                    "forward": train["cornell_box_obj"][
                        "checkpointed_bvh_forward"],
                    "recompute": train["cornell_box_obj"][
                        "checkpointed_bvh_recompute"]}},
            "ms_per_launch_dragon_main_path":
                dragon_runs["bvh4_traverse"]["ms_per_launch"],
            "final_main_path": {
                "launches": paths13["final"]["launches"],
                "ms_per_launch": paths13["final"]["ms_per_launch"],
                **{k: paths13["final"]["traversal"][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by")}},
            **trav_build["bvh4_traverse"],
        }, {
            "name": "bvh4_rowstack",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/bvh4_rowstack.cu",
            "replaces": "izpi_tpu/ops/bvh_rowkernel.py:126",
            "launches": dragon_runs["bvh4_rowstack"]["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in rows10.values()),
            "ms": drow["ms"],
            "plain_ms": drow["plain_ms"],
            "bound_ms": drow["bound_ms"],
            "bound_by": drow["bound_by"],
            "library_ms": None,
            "ms_per_launch_dragon_main_path":
                dragon_runs["bvh4_rowstack"]["ms_per_launch"],
            **trav_build["bvh4_rowstack"],
        }, {
            "name": "izpi_threefry_uniforms",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/cipher.cu",
            "replaces": "izpi_tpu/ops/threefry.py:30",
            "launches": cipher_launches - sample_launches,
            "max_abs_err": 0.0,
            "ms": cipher_main["ms"],
            "plain_ms": cipher_main["plain_ms"],
            "bound_ms": cipher_main["bound_ms"],
            "bound_by": cipher_main["bound_by"],
            "library_ms": None,
            "shape": cipher_main["shape"],
            "shapes_on_main_path": cipher_main["shapes"],
            "launches_x_time_minus_bound_ms": cipher_main["excess_ms"],
            "launches_pbr_ibl_main_path": paths13["pbr_ibl"]["cipher_launches"],
            "launches_final_main_path": paths13["final"]["cipher_launches"],
            "launches_distributed": dist_launches(
                distributed, "threefry", "izpi_threefry_uniforms"),
            "launches_per_training_step": {
                "cornell_256_depth50_fused": train["cornell"][
                    "bounce_cipher_per_replay"],
                "cornell_box_obj_256_depth50_fused": train[
                    "cornell_box_obj"]["bounce_cipher_per_replay"],
                "cornell_256_depth50_checkpointed": {
                    "forward": train["cornell"][
                        "checkpointed_cipher_forward"] - 1,
                    "recompute": train["cornell"][
                        "checkpointed_cipher_recompute"]},
                "cornell_box_obj_256_depth50_checkpointed": {
                    "forward": train["cornell_box_obj"][
                        "checkpointed_cipher_forward"] - 1,
                    "recompute": train["cornell_box_obj"][
                        "checkpointed_cipher_recompute"]}},
            "shapes_on_pbr_ibl_main_path": paths13["pbr_ibl"]["cipher"]["shapes"],
            "shapes_on_final_main_path": paths13["final"]["cipher"]["shapes"],
            "device_functions": ["csrc/threefry.cuh", "csrc/draws.cuh"],
            "inlined_in": ["megakernel_rgb", "megakernel_spectral"],
            "ms_1m_keys_12": cipher["ms"],
            "plain_ms_1m_keys_12": cipher["plain_ms"],
            "bound_ms_1m_keys_12": cipher["bound_ms"],
            "forms": [f for f in cipher["forms"] if f["form"] == "bounce"],
        }, {
            "name": "izpi_threefry_new_sample",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/cipher.cu",
            "replaces": "izpi_tpu/ops/threefry.py:30",
            "launches": sample_launches,
            "max_abs_err": 0.0,
            "ms": cipher_main["new_sample"]["ms"],
            "plain_ms": cipher_main["new_sample"]["plain_ms"],
            "bound_ms": cipher_main["new_sample"]["bound_ms"],
            "bound_by": cipher_main["new_sample"]["bound_by"],
            "library_ms": None,
            "shape": (cipher_main["new_sample"]["keys"],
                      cipher_main["new_sample"]["uniforms"]),
            "forms": [f for f in cipher["forms"] if f["form"] == "new_sample"],
        }, {
            "name": "table_grad",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/table_grad.cu",
            "replaces": "izpi_tpu/parallel/dist.py:597 (no pallas_call: "
                        "XLA's scatter-add, the backward of the table "
                        "gathers in the jitted step)",
            "launches": train["cornell"]["table_grad_launches"],
            "max_abs_err": max(t["max_abs_err"]
                               for t in train["cornell"]["table_grad"].values()),
            "ms": g_main["ms"],
            "plain_ms": g_main["plain_ms"],
            "bound_ms": g_main["bound_ms"],
            "bound_by": "bytes",
            "library_ms": g_main["library_ms"],
            "table": g_name,
            "tables": train["cornell"]["table_grad"],
        }, *[{
            "name": f"diff_trace_{part}",
            "route": "cuda",
            "source": "izpi_tpu_torch/csrc/diff_trace.cu",
            "replaces": "izpi_tpu/parallel/dist.py:597 / "
                        "izpi_tpu/integrator/path.py:699-740",
            "launches": train["cornell"]["launches_per_replay"][
                f"diff_trace_{part}"],
            "max_abs_err": train["cornell"]["kernels"][part]["max_abs_err"],
            "ms": train["cornell"]["kernels"][part]["ms"],
            "plain_ms": train["cornell"]["kernels"][part]["plain_ms"],
            "bound_ms": train["cornell"]["kernels"][part]["bound_ms"],
            "bound_by": train["cornell"]["kernels"][part]["bound_by"],
            "library_ms": None,
            # The reverse's registers: its two passes' on the Cornell
            # step's table (12 elements: pass 2 in the lanes' copies).
            "registers": max(usage[k].registers for k in BWD_KERNELS[part]),
            "spill_bytes": sum(usage[k].spill_stores + usage[k].spill_loads
                               for k in BWD_KERNELS[part]),
            "cornell_box_obj": {
                **train["cornell_box_obj"]["kernels"][part],
                "launches": train["cornell_box_obj"]["launches_per_replay"][
                    f"diff_trace_{part}"],
                **({"registers": usage["diff_trace_fwd_bvh"].registers,
                    "spill_bytes": usage["diff_trace_fwd_bvh"].spill_stores
                    + usage["diff_trace_fwd_bvh"].spill_loads}
                   if part == "fwd" else {})},
        } for part in ("fwd", "bwd")], {
            "name": "train_step_graph",
            "route": "cuda",
            "source": "izpi_tpu_torch/core/loops.py",
            "replaces": "izpi_tpu/parallel/dist.py:597 (no pallas_call: the "
                        "jitted step, one device program)",
            "launches": train["cornell"]["replays"],
            "max_abs_err": train["cornell"]["max_grad_err_vs_eager"],
            "ms": 1e3 * train["cornell"]["median_seconds"],
            "plain_ms": 1e3 * train["cornell"]["eager_seconds"],
            "bound_ms": train["cornell"]["bound_ms"],
            "bound_by": "operations",
            "library_ms": None,
            "checkpointed_ms": 1e3 * train["cornell"]["checkpointed_seconds"],
            "max_grad_err_vs_checkpointed": train["cornell"][
                "max_grad_err_vs_checkpointed"],
            "vs_checkpointed": train["cornell"]["vs_checkpointed"],
            "capture_seconds": train["cornell"]["capture_seconds"],
            "graph_bytes": train["cornell"]["graph_bytes"],
            "profiled_idle_share": train["cornell"]["profiled_idle_share"],
            "profiled_records": train["cornell"]["profiled_records"],
            "launches_per_replay": train["cornell"]["launches_per_replay"],
            "cornell_box_obj": {k: train["cornell_box_obj"][k] for k in (
                "seconds", "eager_seconds", "checkpointed_seconds",
                "capture_seconds", "graph_bytes", "launches_per_replay",
                "max_grad_err_vs_eager", "max_grad_err_vs_checkpointed",
                "vs_checkpointed")},
        }],
        "shapes": {
            "megakernel_rgb": "ms, bound_ms: per launch on its main path, "
                              "cornell 256x256@1024 depth 50 (CUDA events "
                              "around the timed render()'s launch); "
                              "plain_ms, ms_at_2, bound_ms_at_2: the main "
                              "path's frame at 2 spp (the plain version "
                              "would take hours at 1024)",
            "megakernel_spectral": "ms, bound_ms: per launch on its main "
                                   "path, the spectral pyramid 500x500@256 "
                                   "depth 50; plain_ms, ms_at_2, "
                                   "bound_ms_at_2: 500x500@2 depth 50",
            "megakernel_rgb_bvh": "ms, bound_ms: per launch on the BVH "
                                  "main path, cornell_box_obj 256x256@128 "
                                  "depth 50 (CUDA events around the timed "
                                  "render()'s launch); plain_ms, ms_at_2, "
                                  "bound_ms_at_2: 256x256@2 depth 50; "
                                  "bound_ms from the SASS probes' "
                                  "instructions times the launch's units",
            "bvh4_traverse_launches": "launches: the dragon main path's "
                                      "timed render (its default route); "
                                      "cornell_box_obj's default route "
                                      "launches it no time, its mode "
                                      "\"pool\" once a pool body",
            "izpi_threefry_uniforms": "the bounce form: ms, plain_ms, "
                                      "bound_ms per launch at the shape the "
                                      "BVH pool path calls it with most "
                                      "(shape: keys, uniforms), the launches "
                                      "its timed render's; ms timed over a "
                                      "CUDA graph of launches; bound_ms "
                                      "counted from the SASS; forms: each "
                                      "count at 262,144 and 1M keys with its "
                                      "bound; bit-identical "
                                      "to the plain version "
                                      f"(phase 3, {n_keys} keys)",
            "izpi_threefry_new_sample": "a new sample's path key and camera "
                                        "uniforms at the BVH pool path's "
                                        "shape; forms: keys only, + camera, "
                                        "+ camera and λ",
            "bvh4_traverse": f"{TRAVERSE_RAYS} rays (half camera, half "
                             f"incoherent) on cornell_box_obj's tree",
            "table_grad": "ms, library_ms (index_add_), bound_ms: per "
                          "call over a CUDA graph of 100 calls, plain_ms "
                          "(index_put_ with accumulate, the backward of "
                          "indexing) of 3, at the fused Cornell step's "
                          "inputs (reverse_reference's slots, one a "
                          "record, over tex_c0's rows, their count read on "
                          "the device: the fused reverse sums them itself "
                          "and calls G no time); launches: one replay of "
                          "the checkpointed Cornell step",
            "train_step_graph": "the Cornell step at 256x256@1 depth 50 as "
                                "one CUDA graph on the fused route: ms the "
                                "median of the replays of steps 1-4, "
                                "plain_ms the eager step's (the same "
                                "kernels, no graph), checkpointed_ms the "
                                "checkpointed bounces' captured step in the "
                                "same call; launches: replays in phase 16; "
                                "max_abs_err: its gradients against the "
                                "eager step's; bound_ms: its kernels' "
                                "bounds and its inputs' and outputs' bytes, "
                                "PyTorch's own ops not counted",
            "diff_trace": "fwd: ms a launch at the Cornell step's camera "
                          "rays, 256x256 depth 50 (CUDA events), plain_ms "
                          "forward_reference's, bound_ms from the SASS "
                          "probes' units (the draws its records hold, every "
                          "primitive a ray or the BVH form's nodes and "
                          "tests) and its bytes (its records among them); "
                          "bwd: the fused reverse, ms a call (a CUDA graph "
                          "of 20 calls: its two passes) on those records at "
                          "the step's own cotangent to the table gradient, "
                          "plain_ms reverse_reference then index_put_, "
                          "bound by bytes (the records, each path's count "
                          "and cotangent and the texture rows read once, "
                          "the table written once), beside R's and G's "
                          "bounds before they were fused; max_abs_err: the "
                          "forward's largest pixel difference from its "
                          "plain version, the reverse's 0 (bit for bit G's "
                          "on the plain slots); launches: one replay of "
                          "the Cornell step",
            "bvh4_rowstack": f"{TRAVERSE_RAYS} rays on phase 7's recipe, "
                             f"in their order, on the dragon scene's "
                             f"leaf-64 tree (its main path's); the third "
                             f"per-warp counter counts (ray, primitive) "
                             f"pairs tested"},
        "library_ms": "null: no PyTorch call computes a path tracer's render "
                      "loop or a BVH traversal; table_grad's is index_add_ "
                      "(float atomics, not deterministic)",
        "bvh4_traverse_dragon": dtrav,
        "bvh4_rowstack_phase10": rows10,
        "main_path": {"rays": res.rays_traced, "seconds": res.seconds,
                      "mrays_per_sec": res.mrays_per_sec},
        "spectral_main_path": {"rays": sres.rays_traced,
                               "seconds": sres.seconds,
                               "mrays_per_sec": sres.mrays_per_sec},
        "bvh_main_path": {"rays": bres.rays_traced, "seconds": bres.seconds,
                          "mrays_per_sec": bres.mrays_per_sec,
                          "launches": bcounts,
                          "kernel_ms": bvh_ms,
                          "kernel_share": bvh_ms / 1e3 / bres.seconds},
        "bvh_pool_path": {"rays": ores.rays_traced, "seconds": ores.seconds,
                          "mrays_per_sec": ores.mrays_per_sec,
                          "iterations": ores.iterations,
                          "trips": ores.trips, "replays": ores.replays,
                          "capture_seconds": warm.capture_seconds,
                          "loop": loop9,
                          "traversal_ms_per_launch": trav_per_launch,
                          "kernel_share": kernel_s / ores.seconds,
                          "profiled_idle_share_16spp": 1 - busy / wall},
        "dragon_main_path": dragon_runs,
        "shirley_main_path": paths13["shirley"],
        "pbr_ibl_main_path": paths13["pbr_ibl"],
        "final_main_path": paths13["final"],
        "training_step": train,
        "cli": cli,
        "distributed": distributed,
        "card": card,
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
