"""Device meshes over the ranks of a ``torch.distributed`` world.

The counterpart of ``repro/launch/mesh.py``. ``make_fog_mesh`` builds the
1-D ``("fog",)`` mesh of the BSP runtime, one rank a fog partition (the
reference's ``Mesh(jax.devices()[:n], ("fog",))``); its ``.get_group()``
is what ``runtime.bsp``'s ``group=`` takes. ``make_host_mesh`` is the
``("data", "model")`` debug mesh over the whole world. Both need the
default process group to be up (``runtime.dist.spawn`` starts one).

The reference's ``make_production_mesh`` (a 256- or 512-chip pod) and its
per-chip roofline constants are the TPU's and have no counterpart here.
The card's peaks below are the H100 SXM's data-sheet numbers at its 700 W
limit; ``chip_smoke.py`` bounds every kernel with them.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: H100 SXM: HBM3 bandwidth (bytes/s).
H100_SXM_HBM_BYTES_PER_S = 3.35e12
#: H100 SXM: f32 rate of the CUDA cores (FLOP/s).
H100_SXM_F32_FLOP_PER_S = 67e12
#: H100 SXM: dense bf16 tensor-core rate (FLOP/s).
H100_SXM_BF16_FLOP_PER_S = 989e12


def make_fog_mesh(n: int, device_type: str = "cuda") -> DeviceMesh:
    """The 1-D ``("fog",)`` mesh of ``n`` ranks; the world must hold
    exactly ``n`` (one rank a fog, as the executor's check demands)."""
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"need {n} ranks for {n} fogs, the world has "
                         f"{world}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=("fog",))


def make_host_mesh(model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """The ``("data", "model")`` mesh over every rank of the world."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model axis {model} does not divide the world of "
                         f"{n} ranks")
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
