"""Hand-written Hopper kernels with their plain PyTorch versions
(``kernels.ref``) and device dispatch (``kernels.ops``).  Nothing here
touches ``nvcc`` or ``ctypes`` at import."""
