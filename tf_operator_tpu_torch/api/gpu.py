"""GPU provisioning for the operator's job kinds: the port's counterpart of
``tf_operator_tpu/api/tpu.py`` (the accelerator table) and
``controllers/_tpu.py`` (selectors, the chip ask, one gang per slice).

The JAX package runs one process per TPU host, which drives all the host's
chips, and one gang per slice. The port runs one process per card, so a
GPU node takes a slice's place: NVLink inside the node plays the part of
ICI, the network between nodes the part of DCN, and the multislice mesh
``{"slice": nodes, "fsdp": gpus_per_node}`` is HSDP that replicates across
nodes and shards inside each one.

:func:`gpu_job` writes a kubectl-style JAXJob or PyTorchJob manifest (a
plain dict) with one pod per node, for the operator as it is: the pod
template carries the GPU ask (``nvidia.com/gpu``) and the node selector,
the operator sums the ask into each gang's ``minResources`` from the
template, and the container command runs the per-node launcher
(``runtime/launch.py``), which turns the pod's env into one process per
card. A JAXJob gets ``numSlices = nodes``, so that each of its gangs is
one node; a PyTorchJob gets a Master and ``nodes - 1`` Workers, one gang
for the job, and its mesh in the template's ``JAX_MESH_SPEC``.

**Slice-local worlds.** A JAXJob whose template sets
``JAX_SLICE_LOCAL_WORLD=1`` keeps it (template values pass through): each
node then forms a world of its own G ranks (``runtime/gpu_init.py``), an
independent replica with its own ``slice-<i>/`` checkpoint stream, and the
operator restarts a failed node's slice alone. Such a job declares the
mesh of one slice, ``mesh={"fsdp": G}``: a slice-local world has no
``slice`` axis, and on the card a declared mesh larger than the world is
refused.

**Admission.** The operator's gang admission counts the template's
``nvidia.com/gpu`` ask under the generation the capacity flag names:
``--enable-gang-admission --capacity nvidia.com/gpu@h100=N`` admits such
jobs while their GPUs fit in N, a whole job at a time, or one node's gang
at a time with ``--admission-slice-granularity``
(``tests/test_torch_slice_restart.py`` pins both).

**Elastic jobs.** ``gpu_job(..., elastic=(min_nodes, max_nodes))`` writes
a JAXJob's ``spec.elastic: {minSlices, maxSlices}``: a node is a slice, so
the job is resized in whole nodes by the operator's SDK,
``JobClient(cluster, kind="JAXJob").scale(name, nodes)``, which patches
``numSlices``, the Worker count and a declared ``slice`` axis together.
The operator then replaces every pod of the old world in one batch, and
the new world's ranks resume from the job's checkpoint (``llama_train``:
DCP reshards a sharded state to the new world; ``--batch`` is global, so
each rank's rows change and the global batch does not). A grow that does
not fit the GPUs of ``--capacity nvidia.com/gpu@h100=N`` waits at the
admission gate. A PyTorchJob is not elastic: the SDK resizes JAXJobs only.
"""

from __future__ import annotations

import copy
import json
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..runtime.gpu_init import job_mesh_axes

GPU_RESOURCE = "nvidia.com/gpu"
# Node labels: GKE's accelerator label, and GPU feature discovery's
# product label (the NVIDIA GPU operator) elsewhere.
NODE_SELECTOR_GKE = "cloud.google.com/gke-accelerator"
NODE_SELECTOR_GFD = "nvidia.com/gpu.product"
LAUNCH_MODULE = "tf_operator_tpu_torch.runtime.launch"
PYTHON = "python"  # the image's interpreter, which runs the launcher
DEFAULT_IMAGE = "ghcr.io/tf-operator-tpu/torch-h100:latest"
ENV_MESH_SPEC = "JAX_MESH_SPEC"


@dataclass(frozen=True)
class NodeType:
    """One kind of GPU node: its cards and the labels that select it."""

    gpus: int
    gke_accelerator: str  # NODE_SELECTOR_GKE's value
    product: str  # NODE_SELECTOR_GFD's value


NODE_TYPES: Dict[str, NodeType] = {
    "h100-80gb-sxm": NodeType(8, "nvidia-h100-80gb", "NVIDIA-H100-80GB-HBM3"),
}
DEFAULT_NODE_TYPE = "h100-80gb-sxm"

# kind: (the replica specs' key, the operator's default container name).
KINDS = {"JAXJob": ("jaxReplicaSpecs", "jax"),
         "PyTorchJob": ("pytorchReplicaSpecs", "pytorch")}


def default_mesh(kind: str, nodes: int, gpus_per_node: int) -> Dict[str, int]:
    """``{"fsdp": G}`` on one node; across nodes HSDP, replicated over the
    nodes and sharded inside each: over ``slice`` for a JAXJob (a node is a
    slice), over ``dp`` for a PyTorchJob (its c10d env has no slices)."""
    if nodes == 1:
        return {"fsdp": gpus_per_node}
    return {"slice" if kind == "JAXJob" else "dp": nodes, "fsdp": gpus_per_node}


def launch_command(gpus_per_node: int, command: List[str]) -> List[str]:
    """``command`` run once per card by the per-node launcher."""
    return [PYTHON, "-m", LAUNCH_MODULE, "--nproc-per-node", str(gpus_per_node), "--",
            *command]


def _check(kind: str, nodes: int, gpus: int, node: NodeType, node_type: str,
           mesh: Dict[str, int], command: List[str]) -> None:
    if kind not in KINDS:
        raise ValueError(f"gpu_job kind {kind!r}; one of {sorted(KINDS)}")
    if nodes < 1:
        raise ValueError(f"gpu_job needs at least one node, got {nodes}")
    if not 1 <= gpus <= node.gpus:
        raise ValueError(f"{node_type} has {node.gpus} GPUs a node; asked for {gpus}")
    if not command:
        raise ValueError("gpu_job needs a command")
    # The mesh the workload builds: a JAXJob's slices are its nodes.
    axes = job_mesh_axes(mesh, nodes if kind == "JAXJob" else 1)
    if kind == "JAXJob" and nodes > 1 and axes["slice"] != nodes:
        raise ValueError(f"mesh {mesh}: the slice axis is the node count ({nodes})")
    size = math.prod(axes.values())
    if size != nodes * gpus:
        raise ValueError(f"mesh {axes} has {size} devices; the job has {nodes} nodes x "
                         f"{gpus} GPUs = {nodes * gpus}")


def _elastic(kind: str, nodes: int, bounds) -> Dict[str, int]:
    """``spec.elastic`` of a job of ``nodes`` nodes resizable within
    ``bounds`` (``(min_nodes, max_nodes)``, max None for no bound), refused
    as the operator's validation refuses it (``api/jaxjob.py validate``)."""
    if kind != "JAXJob":
        raise ValueError(f"elastic resizes a JAXJob in whole nodes (JobClient.scale); a {kind} "
                         "is not elastic")
    low, high = bounds
    if low < 1:
        raise ValueError(f"JAXJobSpec is not valid: elastic.minSlices must be >= 1, got {low}")
    if high is not None and high < low:
        raise ValueError(f"JAXJobSpec is not valid: elastic.maxSlices ({high}) < minSlices "
                         f"({low})")
    if nodes < low or (high is not None and nodes > high):
        raise ValueError(f"JAXJobSpec is not valid: numSlices {nodes} outside elastic bounds "
                         f"[{low}, {high}]")
    return {"minSlices": low} if high is None else {"minSlices": low, "maxSlices": high}


def _pod_template(template: Optional[dict], container_name: str, image: str,
                  command: List[str], gpus: int, selector: Dict[str, str],
                  env: Dict[str, str]) -> dict:
    """The user's template (or an empty one) with the launcher's command,
    the GPU ask and the node selector; an ask, a selector or an env value
    the user set is kept, and an ask other than ``gpus`` is refused."""
    tpl = copy.deepcopy(template or {})
    spec = tpl.setdefault("spec", {})
    containers = spec.setdefault("containers", [])
    container = next((c for c in containers if c.get("name") == container_name), None)
    if container is None:
        container = {"name": container_name}
        containers.insert(0, container)
    container.setdefault("image", image)
    container["command"] = command
    resources = container.setdefault("resources", {})
    for part in ("limits", "requests"):
        have = resources.setdefault(part, {}).setdefault(GPU_RESOURCE, str(gpus))
        if str(have) != str(gpus):
            raise ValueError(f"the template asks {part} {GPU_RESOURCE}={have}; the launcher "
                             f"starts {gpus} processes a node")
    for key, value in selector.items():
        spec.setdefault("nodeSelector", {}).setdefault(key, value)
    for name, value in env.items():
        listed = container.setdefault("env", [])
        if not any(e.get("name") == name for e in listed):
            listed.append({"name": name, "value": value})
    return tpl


def gpu_job(name: str, kind: str, nodes: int, command: List[str], *,
            node_type: str = DEFAULT_NODE_TYPE, gpus_per_node: Optional[int] = None,
            mesh: Optional[Dict[str, int]] = None, image: str = DEFAULT_IMAGE,
            namespace: str = "default", template: Optional[dict] = None,
            selector: str = "gke", elastic: Optional[tuple] = None) -> dict:
    """A JAXJob or PyTorchJob manifest that runs ``command`` on ``nodes``
    GPU nodes of ``node_type``, ``gpus_per_node`` processes a node (all its
    cards by default), one pod a node; ``mesh`` defaults to
    :func:`default_mesh`. ``template`` is the user's pod template, whose
    values are kept; ``selector`` picks the node label: ``"gke"`` for GKE's
    GPU node pools, ``"gfd"`` for a cluster that labels its nodes through
    the NVIDIA GPU operator's feature discovery (on-premises, or a cloud
    other than GKE); ``elastic`` (``(min_nodes, max_nodes)``) makes a
    JAXJob resizable in whole nodes (module doc). Raises ``ValueError`` for
    a GPU count the node does not have, a mesh whose size is not nodes x
    GPUs, or elastic bounds the operator refuses."""
    node = NODE_TYPES.get(node_type)
    if node is None:
        raise ValueError(f"unknown GPU node type {node_type!r}; known: {sorted(NODE_TYPES)}")
    gpus = gpus_per_node or node.gpus
    mesh = dict(mesh) if mesh is not None else default_mesh(kind, nodes, gpus)
    _check(kind, nodes, gpus, node, node_type, mesh, command)
    bounds = _elastic(kind, nodes, elastic) if elastic is not None else None
    labels = {"gke": {NODE_SELECTOR_GKE: node.gke_accelerator},
              "gfd": {NODE_SELECTOR_GFD: node.product}}
    if selector not in labels:
        raise ValueError(f"selector {selector!r}; one of {sorted(labels)}")
    key, container = KINDS[kind]
    env = {} if kind == "JAXJob" else {ENV_MESH_SPEC: json.dumps(mesh, separators=(",", ":"))}
    pod = _pod_template(template, container, image, launch_command(gpus, command),
                        gpus, labels[selector], env)
    if kind == "JAXJob":
        spec = {"numSlices": nodes, "mesh": mesh,
                key: {"Worker": {"replicas": nodes, "template": pod}}}
        if bounds is not None:
            spec["elastic"] = bounds
    else:
        spec = {key: {"Master": {"replicas": 1, "template": pod}}}
        if nodes > 1:
            spec[key]["Worker"] = {"replicas": nodes - 1, "template": copy.deepcopy(pod)}
    return {"apiVersion": "kubeflow.org/v1", "kind": kind,
            "metadata": {"name": name, "namespace": namespace}, "spec": spec}


def llama2_7b_multislice(image: str = DEFAULT_IMAGE) -> dict:
    """The GPU reading of ``examples/jax/llama/jaxjob_llama2_7b_multislice.yaml``:
    llama2-7b on 2 nodes of 8 H100s, mesh ``{"slice": 2, "fsdp": 8}``,
    the same global batch and sequence."""
    return gpu_job("llama2-7b-multislice", "JAXJob", 2,
                   ["python", "-m", "tf_operator_tpu_torch.train.llama_train",
                    "--model=llama2-7b", "--batch=64", "--seq=2048"],
                   mesh={"slice": 2, "fsdp": 8}, image=image)


def mixtral_8x7b_elastic(image: str = DEFAULT_IMAGE) -> dict:
    """The GPU reading of ``examples/jax/mixtral/jaxjob_mixtral_8x7b_v5e64.yaml``:
    mixtral-8x7b on 2 nodes of 8 H100s, elastic from 1 to 4 nodes, with the
    manifest's command and checkpoint cadence. Its per-slice mesh keeps the
    manifest's ``ep`` 4 and puts the rest of a node's 8 cards on ``fsdp``;
    it has no ``slice`` axis, so a resize leaves it as it is and the ranks
    add ``slice`` = the node count (``gpu_init.job_mesh_axes``)."""
    return gpu_job("mixtral-8x7b", "JAXJob", 2,
                   ["python", "-m", "tf_operator_tpu_torch.train.llama_train",
                    "--model=mixtral-8x7b", "--steps=200000", "--batch=256", "--seq=4096",
                    "--checkpoint-dir=gs://my-bucket/mixtral-ckpt", "--checkpoint-every=500"],
                   mesh={"fsdp": 2, "ep": 4}, image=image, elastic=(1, 4))
