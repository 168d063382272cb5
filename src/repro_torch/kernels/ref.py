"""Plain PyTorch versions of the ported kernels — the oracles each CUDA
kernel is held against on the card, and the path ``kernels.ops`` takes for
CPU tensors.  Each is defined beside its kernel and collected here, as
``repro.kernels.ref`` collects the reference's oracles.

float32 products here run in full float32 (``allow_tf32`` is off, see
``core.engines``), like the reference's CPU einsum.
"""
from repro_torch.kernels.haar import haar_ref
from repro_torch.kernels.knn import knn_ref, knn_scores_ref

__all__ = ["haar_ref", "knn_ref", "knn_scores_ref"]
