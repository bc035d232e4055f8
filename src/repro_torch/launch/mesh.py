"""Device meshes (the reference's ``repro/launch/mesh.py``): functions, not
module-level constants, so importing this module touches no device and no
process group.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the default process
group, which the caller starts first: ``torch.distributed.init_process_group``
with its backend (``"nccl"`` on the card, ``"gloo"`` on the CPU), address
(``tcp://localhost:<port>`` or ``file://...``), world size and rank;
nothing on a machine tells a program of its cluster.
"""
from __future__ import annotations

from typing import Sequence


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: str = "cuda"):
    """An arbitrary mesh (tests, elastic rescale): ``shape`` ranks along
    the named ``axes``, rank-major over the default process group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, tuple(int(n) for n in shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16 × 16 = 256 chips a pod, ``("data", "model")``; ``multi_pod`` adds
    a leading 2-pod axis, ``("pod", "data", "model")`` over 512. Raises
    ``ValueError`` when the default process group's world size is not
    that."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != need:
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs a world of {need} ranks; "
            + ("no process group is initialized" if world is None else f"the default process group has {world}")
        )
    return make_mesh(shape, axes, device)
