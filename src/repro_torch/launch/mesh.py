"""Production mesh construction, the counterpart of `repro/launch/mesh.py`
over `torch.distributed.device_mesh.init_device_mesh`.

FUNCTIONS (not module-level constants), so importing this module touches
no device and no process group: a mesh is made only when one is asked for,
inside a process group of data x model (x pod) ranks (`torchrun`, or
`torch.distributed.init_process_group` with its address, world size and
rank given).
"""
from __future__ import annotations


def _device_type() -> str:
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str | None = None):
    """A DeviceMesh of `shape` with `mesh_dim_names=axes` over the process
    group's ranks (cuda where a card is visible, else cpu)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def mesh_shape_for(devices: int, model_parallel: int = 16) -> tuple[int, int]:
    """The best (data, model) shape for an arbitrary rank count: the
    largest model width <= model_parallel that divides it."""
    model = min(model_parallel, devices)
    while devices % model:
        model -= 1
    return devices // model, model


def make_mesh_for(devices: int, model_parallel: int = 16, device_type: str | None = None):
    """Elastic helper: best (data, model) mesh for an arbitrary rank count."""
    return make_mesh(mesh_shape_for(devices, model_parallel), ("data", "model"), device_type)
