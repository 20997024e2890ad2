"""izpi_tpu_torch — the PyTorch and CUDA port of the izpi_tpu path tracer.

The package mirrors `izpi_tpu`'s module names, so every module's counterpart
sits at the same relative path. It imports torch and numpy only, never JAX
and nothing of `izpi_tpu`. The JAX package is the reference each module is
tested against (`tests/test_torch_*.py`): both draw the same Threefry-2x32
sample streams, so images agree path for path.

Ported so far: the Cornell-box RGB main path (scene → compile → camera →
RNG → brute-force intersection → `bounce_rgb`/`trace` → the RGB megakernel)
and the spectral main path (the spectral Cornell pyramid: SPDs, CIE-Y λ
sampling, `bounce_spectral` → the spectral megakernel → firefly rejection
and ACEScg), each megakernel a hand-written CUDA kernel in `csrc/`.
Importing the package has no side effects; kernels are built at first use
(`izpi_tpu_torch.ops._build`).
"""

__version__ = "0.1.0"
