"""A frozen copy of the part of the port's plain versions (`izpi_tpu_torch`
as of the benchmark's first version) that the benchmark's scenes reach: the
Cornell box, its scene compile, the camera, the Threefry streams on PyTorch
integers and the RGB bounce, the kernel dispatch taken out. Later changes
to the port do not reach it; a cell that needs more copies it in."""
