"""Production mesh construction: the counterpart of the JAX package's
``launch/mesh.py``.

``make_production_mesh`` returns the port's logical-rank mesh
(``repro_torch.dist.mesh.Mesh``): ``(16, 16)`` over ``("data", "model")``,
or ``(2, 16, 16)`` over ``("pod", "data", "model")``.  The dry run reads
only its axes and sizes and places nothing on a device, so every rank is
bound to the ``meta`` device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.hlo_parser import MeshInfo
from repro_torch.dist.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, (torch.device("meta"),) * math.prod(shape))


def mesh_info(mesh: Mesh) -> MeshInfo:
    """MeshInfo for the collectives' ICI/DCN classification."""
    return MeshInfo(
        axis_names=tuple(mesh.axis_names),
        axis_sizes=tuple(mesh.shape),
        dcn_axes=("pod",) if "pod" in mesh.axis_names else (),
    )
