"""The benchmark of `izpi_tpu_torch` on one NVIDIA card (README.md)."""
