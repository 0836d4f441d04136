"""Device meshes from the operator-declared axes: the port's counterpart of
``tf_operator_tpu/parallel/mesh.py`` over ``torch.distributed``'s
``DeviceMesh``, one process per GPU.

The canonical axes, outermost to innermost, are the JAX package's
(``AXIS_ORDER``), all of them supported: ``slice``, ``dp``, ``fsdp`` and
``ep`` (data parallelism: ``fsdp`` with parameters and optimizer state
sharded by FSDP2, ``ep`` with an MoE model's experts placed over it,
``parallel/sharding.py``), ``pp`` (pipeline stages,
``parallel/pipeline.py``), ``sp`` (the sequence, ring attention,
``ops/ring_attention.py``) and ``tp`` (tensor parallelism, innermost so
that its collectives stay on the fastest links). An axis the job declared
is kept even at size 1, as the JAX ``make_mesh`` keeps it, and the
DeviceMesh always carries an ``fsdp`` dim, of size 1 when the job declared
none, so that FSDP2 has its shard dim on every layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXIS_ORDER = ("slice", "pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclass
class MeshSpec:
    """Logical mesh layout, e.g. MeshSpec({"fsdp": 8, "tp": 4})."""

    axes: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        for name in self.axes:
            if name not in AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {name!r}; known: {AXIS_ORDER}")

    def ordered(self) -> List[tuple]:
        return [(a, self.axes[a]) for a in AXIS_ORDER if a in self.axes]

    @property
    def size(self) -> int:
        total = 1
        for _, n in self.ordered():
            total *= n
        return total


def make_mesh(spec: MeshSpec, device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh of ``spec`` over every rank of the default process
    group; an empty spec is pure data parallelism, as in the JAX package."""
    n = dist.get_world_size()
    if not spec.axes:
        spec = MeshSpec({"dp": n})
    if spec.size != n:
        raise ValueError(f"mesh {spec.axes} needs {spec.size} devices, have {n}")
    axes = dict(spec.ordered())
    axes.setdefault("fsdp", 1)
    names = tuple(a for a in AXIS_ORDER if a in axes)
    return init_device_mesh(device_type, tuple(axes[a] for a in names),
                            mesh_dim_names=names)


def standard_mesh(n_devices: Optional[int] = None, tp: int = 1, sp: int = 1, dp: int = 1,
                  ep: int = 1, pp: int = 1, num_slices: int = 1,
                  device_type: str = "cuda") -> DeviceMesh:
    """Mesh with fsdp absorbing whatever the explicit axes don't cover: the
    default for LLM training (FSDP-dominant, TP innermost)."""
    n = n_devices or dist.get_world_size()
    denom = tp * sp * dp * ep * pp * num_slices
    if n % denom:
        raise ValueError(f"{n} devices not divisible by slice*pp*dp*ep*sp*tp={denom}")
    axes = {}
    if num_slices > 1:
        axes["slice"] = num_slices
    if pp > 1:
        axes["pp"] = pp
    if dp > 1:
        axes["dp"] = dp
    axes["fsdp"] = n // denom
    for name, size in (("ep", ep), ("sp", sp), ("tp", tp)):
        if size > 1:
            axes[name] = size
    return make_mesh(MeshSpec(axes), device_type)


def mesh_axes(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis: size} of a mesh, in its order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
