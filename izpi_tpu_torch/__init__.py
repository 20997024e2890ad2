"""izpi_tpu_torch — the PyTorch and CUDA port of the izpi_tpu path tracer.

The package mirrors `izpi_tpu`'s module names, so every module's counterpart
sits at the same relative path. It imports torch and numpy only, never JAX
and nothing of `izpi_tpu`. The JAX package is the reference each module is
tested against (`tests/test_torch_*.py`): both draw the same Threefry-2x32
sample streams, so images agree path for path.

Ported: every scene of the JAX registry through the megakernels, the
queue pool and the BVH4 traversal (each TPU kernel a hand-written CUDA
kernel in `csrc/`), the differentiable render step and distribution over
`torch.distributed` (`parallel.dist`, `entry`), the AOV samplers, the image
writers and readers (`io`), the OBJ loader (`geometry.wavefront_obj`), the
texture converter (`tools.texture_converter`) and the command-line
renderer (`python -m izpi_tpu_torch`, `cli`, multi-host included). Not
ported, by decision: `core/loops.py` and `geometry/mxu_intersect.py`,
workarounds of the TPU's compilers.
Importing the package has no side effects; kernels are built at first use
(`izpi_tpu_torch.ops._build`).
"""

__version__ = "0.1.0"
