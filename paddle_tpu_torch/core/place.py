"""Device places (counterpart of `paddle_tpu/core/place.py`: `Place`,
`CPUPlace` and `CUDAPlace`).

A Place names a device; `torch_device()` resolves it through
`device.resolve_device`, which raises where the card is missing rather
than falling back to the CPU as the reference's `jax_device()` does.
`place_to_device(None)` is the card. Not ported: `TPUPlace` and
`CUDAPinnedPlace` (aliases that name no device of this port).
"""
import torch

from ..device import resolve_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "place_to_device"]


class Place:
    kind = None

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def torch_device(self):
        if self.kind == "cpu":
            return resolve_device("cpu")
        return resolve_device(torch.device(self.kind, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    kind = "cpu"

    def __init__(self):
        super().__init__(0)

    def __repr__(self):
        return "CPUPlace()"


class CUDAPlace(Place):
    kind = "cuda"


def place_to_device(place):
    """A Place, a device spec or None (the card) -> `torch.device`."""
    if isinstance(place, Place):
        return place.torch_device()
    return resolve_device(place)
