"""The BigDAWG polystore on PyTorch and CUDA: the port of ``repro`` (JAX)
to an NVIDIA Hopper card.  Entry points (``core.connect``, ``BigDAWG``) run
on the CUDA device unless the caller passes ``device="cpu"``; the
hand-written kernels live in ``kernels/``."""

import torch

# float32 products run in full float32 on the card (no TF32), like the
# reference's dot on the CPU: _da_matmul and the plain knn version rely on it
torch.backends.cuda.matmul.allow_tf32 = False
