"""Layer-stack loop and rematerialization.

The reference iterates its stacked layers with ``lax.scan``; PyTorch runs
eagerly, so ``stack_scan`` is a Python loop over the leading (layer) axis.
``remat`` is ``jax.remat``: activations recomputed in the backward pass.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.models import partition
from repro_torch.tree import tree_leaves, tree_map, tree_unzip


def unstack(stacked) -> tuple:
    """The layers of a tree stacked on its leading axis, one tree each, by
    one ``unbind`` per leaf: views of the stack (a decode writes its cache
    through them).  Its backward stacks the layers' gradients once;
    indexing each layer instead would give every layer's gradient as a
    zero-filled tensor of the whole stack, summed layer by layer, and on a
    ``DTensor`` costs one sharding propagation a layer and leaf."""
    n = tree_leaves(stacked)[0].shape[0]
    return tree_unzip(tree_map(lambda a: a.unbind(0), stacked), n)


def stack_scan(body, x, stacked):
    """``body(x, layer_slice) -> (x, y)`` over the leading axis of
    ``stacked`` (``unstack``); returns (x, ys stacked over layers, or
    None)."""
    ys = []
    for layer in unstack(stacked):
        x, y = body(x, layer)
        ys.append(y)
    if not ys or not tree_leaves(ys[0]):
        return x, None
    return x, tree_map(lambda *a: torch.stack(a), *ys)


def remat(fn):
    """``fn`` whose activations are recomputed in the backward pass
    (``jax.remat``), by non-reentrant ``torch.utils.checkpoint``.  Without
    gradients (serving) ``fn`` runs as it is.  The recompute runs under
    the plan scope of the forward (on the card the backward pass runs on
    another thread, which has no scope of its own)."""
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        env = partition.current_env()

        def run(*a):
            with partition.use_env(env):
                return fn(*a)
        return torch.utils.checkpoint.checkpoint(run, *args,
                                                 use_reentrant=False,
                                                 preserve_rng_state=False)
    return wrapped
