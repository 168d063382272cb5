"""Production mesh construction over ``torch.distributed``.

The port of ``repro.launch.mesh``.  These are FUNCTIONS, not module-level
constants: importing this module touches no process group.  A mesh needs
one: the caller opens it (``torch.distributed.init_process_group`` with its
own store or address, world size and rank) before building a mesh, and
every rank of the group builds the same mesh.
"""
from __future__ import annotations


def make_mesh_compat(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the open process group, its
    dimensions named ``axes`` (``init_device_mesh(...,
    mesh_dim_names=axes)``); ranks fill it in row-major order, as
    ``jax.make_mesh`` fills its devices.  ``device_type`` is "cuda" (the
    card of each rank) unless the caller asks for "cpu" (gloo ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, device_type)


def mesh_devices(*, multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256
