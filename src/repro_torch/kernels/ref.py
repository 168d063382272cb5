"""Plain PyTorch versions of the ported kernels — the oracles each CUDA
kernel is held against on the card, and the path ``kernels.ops`` takes for
CPU tensors.  Each is defined beside its kernel and collected here, as
``repro.kernels.ref`` collects the reference's oracles.

float32 products here run in full float32 (``allow_tf32`` is off, see
``core.engines``), like the reference's CPU einsum.
"""
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.haar import haar_ref
from repro_torch.kernels.knn import knn_ref, knn_scores_ref
from repro_torch.kernels.ssd_scan import ssd_intra_ref

__all__ = ["decode_attention_ref", "flash_attention_ref", "haar_ref",
           "knn_ref", "knn_scores_ref", "ssd_intra_ref"]
