"""Launch tooling of the port: device meshes over ``torch.distributed``."""
