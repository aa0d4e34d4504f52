"""Device meshes (counterpart of `paddle_tpu/parallel/mesh.py`:
`local_mesh` :41).

The reference's mesh is a `jax.sharding.Mesh`. The port's `Mesh` is a
list of torch devices along named axes, with the same `.shape` mapping
({axis name: size}) and `axis_names`; it starts no process group and
uses no `torch.distributed`. `local_mesh` is the one-member `dp` mesh
on the card, the only mesh the port's sparse engine and
`ParallelExecutor` take: a mesh of several members belongs to the
`torch.distributed` slice (ROADMAP queue A 10). `make_mesh`,
`axis_size`, `device_slices` and `SliceAllocator` are not ported.
"""
from ..device import resolve_device

__all__ = ["Mesh", "local_mesh"]


class Mesh:
    """Devices along one named axis: `.devices`, `.axis_names`, and
    `.shape`, {axis: number of devices}, as the JAX mesh has."""

    def __init__(self, devices, axis_names=("dp",)):
        if len(axis_names) != 1:
            raise NotImplementedError(
                "the port's Mesh has one axis; multi-axis meshes belong "
                "to the torch.distributed slice")
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        self.shape = {axis_names[0]: len(self.devices)}

    def __repr__(self):
        return f"Mesh({self.devices}, axis_names={self.axis_names})"


def local_mesh(axis="dp", devices=None):
    """A 1-D mesh over `devices` (default: the current CUDA device,
    raising without CUDA; ``["cpu"]`` for the CPU)."""
    return Mesh([None] if devices is None else list(devices), (axis,))
