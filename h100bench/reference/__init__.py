"""The plain reference that decides whether a run is correct
(`tracer.py`), over a frozen copy of the port's plain versions
(`plain/`). Nothing here imports `izpi_tpu_torch`, `izpi_tpu` or JAX."""
