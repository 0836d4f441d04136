"""Turn the operator-injected env into a live ``torch.distributed`` world
and device mesh: the port's counterpart of ``tf_operator_tpu/runtime/
tpu_init.py``. A container does::

    from tf_operator_tpu_torch.runtime import gpu_init
    topo = gpu_init.initialize()           # rendezvous
    mesh = gpu_init.global_mesh(topo)      # the declared DeviceMesh

Env consumed: the JAXJob contract (``bootstrap/jaxdist.py``), under the same
names, so one operator env drives both packages: JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES, JAX_PROCESS_ID, TPU_WORKER_ID, TPU_WORKER_HOSTNAMES,
JAX_NUM_SLICES, JAX_SLICE_INDEX, JAX_MESH_SPEC and the workload-side
JAX_SLICE_LOCAL_WORLD. When a PyTorchJob launches the workload, its c10d
env (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; ``bootstrap/c10d.py``) is
read instead. LOCAL_RANK, else the rank modulo the card count, picks the
card; the per-node launcher (``runtime/launch.py``) sets it and
LOCAL_WORLD_SIZE, and a launched process logs its node and local rank.

The rendezvous is ``init_process_group`` over a ``tcp://`` store at the
coordinator address: NCCL on CUDA, gloo only when the caller asks for the
CPU. Everything degrades to single-process local mode when the env is
absent, so the same script runs unmodified on one card.
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..parallel.mesh import MeshSpec, make_mesh, standard_mesh
from . import heartbeat

# The JAXJob contract (bootstrap/jaxdist.py).
ENV_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"
ENV_MESH_SPEC = "JAX_MESH_SPEC"
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_TPU_ACCELERATOR_TYPE = "TPU_ACCELERATOR_TYPE"
ENV_TPU_TOPOLOGY = "TPU_TOPOLOGY"
ENV_NUM_SLICES = "JAX_NUM_SLICES"
ENV_SLICE_INDEX = "JAX_SLICE_INDEX"
# Workload-side opt-in (template env, not operator-injected): one world per
# slice instead of one global world (runtime/tpu_init.py in the JAX package).
ENV_SLICE_LOCAL_WORLD = "JAX_SLICE_LOCAL_WORLD"
# The PyTorchJob c10d contract (bootstrap/c10d.py) and the launcher's
# per-node rank.
ENV_MASTER_ADDR = "MASTER_ADDR"
ENV_MASTER_PORT = "MASTER_PORT"
ENV_WORLD_SIZE = "WORLD_SIZE"
ENV_RANK = "RANK"
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"


@dataclass(frozen=True)
class Topology:
    """The operator-declared view of this process and its slice."""

    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0
    worker_id: int = 0  # host ordinal within the slice
    worker_hostnames: tuple = ()
    accelerator_type: str = ""
    tpu_topology: str = ""
    num_slices: int = 1
    slice_index: int = 0
    mesh_axes: Dict[str, int] = field(default_factory=dict)
    # True when JAX_SLICE_LOCAL_WORLD remapped this topology to a
    # per-slice world: num_processes/process_id/coordinator_address are
    # slice-scoped, and the mesh gets no `slice` axis.
    slice_world: bool = False

    @property
    def distributed(self) -> bool:
        return self.num_processes > 1 and self.coordinator_address is not None

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def topology_from_env(env: Optional[Dict[str, str]] = None) -> Topology:
    """Parse the injected JAXJob env; absent vars mean single-process local
    mode. The same parse as the JAX package's, remap included, when no
    per-node launcher set LOCAL_WORLD_SIZE. Under the launcher a node runs
    G processes, one a card, so a slice-local world holds G ranks a host:
    the remap gives it ``len(hostnames) * G`` processes, and this process
    the id ``worker_id * G + LOCAL_RANK``. The global JAX_NUM_PROCESSES/
    JAX_PROCESS_ID that the launcher writes are not read in that case."""
    env = os.environ if env is None else env

    def _int(key: str, default: int) -> int:
        raw = env.get(key)
        try:
            return int(raw) if raw is not None else default
        except ValueError:
            return default

    mesh_axes: Dict[str, int] = {}
    raw_mesh = env.get(ENV_MESH_SPEC)
    if raw_mesh:
        try:
            parsed = json.loads(raw_mesh)
            if isinstance(parsed, dict):
                mesh_axes = {str(k): int(v) for k, v in parsed.items()}
        except (ValueError, TypeError):
            mesh_axes = {}

    hostnames = tuple(h for h in env.get(ENV_TPU_WORKER_HOSTNAMES, "").split(",") if h)
    coordinator = env.get(ENV_COORDINATOR_ADDRESS) or None
    num_processes = _int(ENV_NUM_PROCESSES, 1)
    process_id = _int(ENV_PROCESS_ID, 0)
    worker_id = _int(ENV_TPU_WORKER_ID, 0)
    num_slices = _int(ENV_NUM_SLICES, 1)
    slice_world = (
        str(env.get(ENV_SLICE_LOCAL_WORLD, "")).lower() in ("1", "true", "yes")
        and num_slices > 1
        and bool(hostnames)
        and coordinator is not None
    )
    if slice_world:
        # Per-slice world: TPU_WORKER_HOSTNAMES lists exactly the slice's
        # hosts in rank order, so the slice coordinator is its first entry
        # and the in-slice process id is the worker ordinal (times G, plus
        # the local rank, under the launcher). The port is
        # offset by the slice index, so that slice coordinators sharing one
        # dev host do not contend for one port.
        slice_index = _int(ENV_SLICE_INDEX, 0)
        try:
            port = int(coordinator.rsplit(":", 1)[-1]) + slice_index
        except ValueError:
            port = coordinator.rsplit(":", 1)[-1]
        coordinator = f"{hostnames[0]}:{port}"
        num_processes = len(hostnames)
        process_id = worker_id
        if env.get(ENV_LOCAL_WORLD_SIZE):
            per_node = _int(ENV_LOCAL_WORLD_SIZE, 1)
            num_processes *= per_node
            process_id = worker_id * per_node + _int(ENV_LOCAL_RANK, 0)
    return Topology(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        worker_id=worker_id,
        worker_hostnames=hostnames,
        accelerator_type=env.get(ENV_TPU_ACCELERATOR_TYPE, ""),
        tpu_topology=env.get(ENV_TPU_TOPOLOGY, ""),
        num_slices=num_slices,
        slice_index=_int(ENV_SLICE_INDEX, 0),
        mesh_axes=mesh_axes,
        slice_world=slice_world,
    )


def c10d_topology_from_env(env: Optional[Dict[str, str]] = None) -> Optional[Topology]:
    """The PyTorchJob c10d env as a Topology (JAX_MESH_SPEC still names the
    mesh); None when MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK are not all
    set."""
    env = os.environ if env is None else env
    keys = (ENV_MASTER_ADDR, ENV_MASTER_PORT, ENV_WORLD_SIZE, ENV_RANK)
    if not all(env.get(k) for k in keys):
        return None
    base = topology_from_env({k: v for k, v in env.items() if k == ENV_MESH_SPEC})
    return Topology(
        coordinator_address=f"{env[ENV_MASTER_ADDR]}:{env[ENV_MASTER_PORT]}",
        num_processes=int(env[ENV_WORLD_SIZE]),
        process_id=int(env[ENV_RANK]),
        mesh_axes=base.mesh_axes,
    )


def local_device_index(topology: Topology, env: Optional[Dict[str, str]] = None) -> int:
    """The card of this process: LOCAL_RANK, else the rank modulo the
    card count."""
    env = os.environ if env is None else env
    if env.get(ENV_LOCAL_RANK):
        return int(env[ENV_LOCAL_RANK])
    return topology.process_id % max(torch.cuda.device_count(), 1)


def launch_note(topology: Topology, env: Optional[Dict[str, str]] = None) -> str:
    """"process i/n node p local rank l/G slice s/S" for a process the
    per-node launcher started (LOCAL_WORLD_SIZE set), else ""."""
    env = os.environ if env is None else env
    if not env.get(ENV_LOCAL_WORLD_SIZE):
        return ""
    local, per_node = int(env.get(ENV_LOCAL_RANK, "0")), int(env[ENV_LOCAL_WORLD_SIZE])
    return (f"process {topology.process_id}/{topology.num_processes} node "
            f"{topology.process_id // per_node} local rank {local}/{per_node} slice "
            f"{topology.slice_index}/{topology.num_slices}")


def initialize(topology: Optional[Topology] = None, *, device=None,
               timeout_seconds: Optional[int] = None) -> Topology:
    """Rendezvous this process: ``init_process_group`` against the
    coordinator the operator published, NCCL on CUDA (the default device)
    and gloo on the CPU. Idempotent, and a no-op single-process: local mode
    does not latch, so a later call with the env set still rendezvouses.

    The heartbeat starts first: a worker wedged inside the rendezvous must
    still prove that the process is alive."""
    heartbeat.start_from_env()
    topo = topology or c10d_topology_from_env() or topology_from_env()
    device = resolve_device(device)
    note = launch_note(topo)
    if note and not dist.is_initialized():
        print(f"[gpu_init] {note}", flush=True)
    if not topo.distributed or dist.is_initialized():
        return topo
    if device.type == "cuda":
        torch.cuda.set_device(local_device_index(topo))
    kwargs = {}
    if timeout_seconds is not None:
        kwargs["timeout"] = timedelta(seconds=timeout_seconds)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{topo.coordinator_address}",
        world_size=topo.num_processes, rank=topo.process_id, **kwargs,
    )
    return topo


def job_mesh_axes(declared: Dict[str, int], num_slices: int,
                  slice_world: bool = False) -> Dict[str, int]:
    """The axes a job's ranks build from the mesh it declared: a job over
    several slices (not slice-local worlds) gets its ``slice`` axis
    whether declared or not."""
    axes = dict(declared)
    if num_slices > 1 and not slice_world and "slice" not in axes:
        axes["slice"] = num_slices
    return axes


def mesh_axes_for(topology: Topology, n: int, device_type: str) -> Dict[str, int]:
    """The axes of the mesh the job declared (JAX_MESH_SPEC), for ``n``
    ranks; a multislice job gets its ``slice`` axis whether declared or
    not. {} (the pure-fsdp default) when none are declared. A declared size
    other than ``n`` is a misconfigured job on the card and is refused; on
    a CPU run the caller asked for, it warns and falls back to the
    default."""
    axes = job_mesh_axes(topology.mesh_axes, topology.num_slices, topology.slice_world)
    declared = 1
    for size in axes.values():
        declared *= size
    if axes and declared != n:
        if device_type == "cuda":
            raise ValueError(
                f"declared mesh {axes} has {declared} devices but the world has "
                f"{n}; fix the job's mesh/numSlices")
        warnings.warn(
            f"declared mesh {axes} needs {declared} devices, the world has {n}; "
            "falling back to a pure-FSDP mesh (CPU dev mode)", stacklevel=2)
        axes = {}
    return axes


def global_mesh(topology: Optional[Topology] = None, device=None):
    """The DeviceMesh the job declared over every rank of the world, or
    pure fsdp when it declared none."""
    topo = topology or c10d_topology_from_env() or topology_from_env()
    device = resolve_device(device)
    axes = mesh_axes_for(topo, dist.get_world_size(), device.type)
    if not axes:
        return standard_mesh(device_type=device.type)
    return make_mesh(MeshSpec(axes), device.type)
