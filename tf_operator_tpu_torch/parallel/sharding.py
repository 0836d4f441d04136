"""How the model is sharded over a mesh: the port's counterpart of
``tf_operator_tpu/parallel/sharding.py``'s ``_PARAM_RULES`` and
``DATA_AXES``/``batch_sharding``.

Where the JAX package annotates every parameter with a PartitionSpec and
lets XLA insert the collectives, the port applies two torch mechanisms:

- tensor parallelism over ``tp`` (DTensor plans per block): the megatron
  layout of the JAX rules, wq/wk/wv/w1/w3 column-wise (their output
  features over tp) and wo/w2 row-wise (their input features over tp);
- FSDP2 ``fully_shard`` over ``fsdp`` on each block and on the root, as
  HSDP with ``slice``/``dp`` as the replicate dim.

The embedding and the output head are sharded over fsdp only, replicated
over tp, where the JAX rules also put their d (embedding) or vocab (head)
dim over tp: a difference of layout, not of results. Vocab-parallel loss
comes later.

An MoE layer's fp32 router gets a ``fully_shard`` group of its own, since
FSDP2 needs one original dtype in a group and the block's other
parameters are in ``param_dtype``; its experts shard over fsdp with the
block. Experts over ``ep`` or ``tp`` (the JAX package's
``moe_expert_axes``, an all-to-all dispatch) are refused until ported, as
is a BERT model, whose sharded step is not ported yet.
"""

from __future__ import annotations

import re
from typing import Optional

from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor.parallel import (
    ColwiseParallel,
    RowwiseParallel,
    parallelize_module,
)

from ..models.bert import BertConfig
from .mesh import mesh_axes

DATA_AXES = ("slice", "dp", "fsdp", "ep")
_REPLICATE_AXES = ("slice", "dp")

# (parameter-name regex, tensor-parallel style): the first match wins.
# Names are the model's state_dict keys, e.g. "layers.0.attention.wq.weight".
_PARAM_RULES = [
    (r"\.(wq|wk|wv|w1|w3)\.weight$", "colwise"),
    (r"\.(wo|w2)\.weight$", "rowwise"),
    (r"^(tok_embeddings|output)\.weight$", None),  # fsdp only (see above)
    (r"(norm|scale)", None),
]
_STYLES = {"colwise": ColwiseParallel, "rowwise": RowwiseParallel}


def tp_style(name: str) -> Optional[str]:
    """The tensor-parallel style of a parameter: "colwise", "rowwise", or
    None (not split over tp)."""
    for pattern, style in _PARAM_RULES:
        if re.search(pattern, name):
            return style
    return None


def _tp_plan(block: nn.Module) -> dict:
    """{submodule path: parallel style} of one block, by the rules."""
    plan = {}
    for name, _ in block.named_parameters():
        style = tp_style("." + name)
        if style is not None:
            plan[name.rsplit(".", 1)[0]] = _STYLES[style]()
    return plan


def _present(mesh: DeviceMesh, axes) -> tuple:
    return tuple(a for a in axes if a in mesh.mesh_dim_names)


def data_coords(mesh: DeviceMesh) -> tuple[int, int]:
    """(this rank's coordinate on the data axes, their total size): the
    data-parallel rank and world. Ranks of one tp group share a coordinate,
    so they read the same batch."""
    rank, size = 0, 1
    for axis in _present(mesh, DATA_AXES):
        n = mesh.size(mesh.mesh_dim_names.index(axis))
        rank, size = rank * n + mesh.get_local_rank(axis), size * n
    return rank, size


def _fsdp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The mesh FSDP2 shards over: ``fsdp``, with ``slice``/``dp`` (flattened
    into one dim when both are present) as HSDP's replicate dim."""
    rep = _present(mesh, _REPLICATE_AXES)
    if not rep:
        return mesh["fsdp"]
    if len(rep) > 1:
        mesh[rep]._flatten("replicate")
        rep = ("replicate",)
    return mesh[(*rep, "fsdp")]


def check_shardable(config, axes: dict) -> None:
    """Refuse a layout the port cannot shard ``config`` over yet: a BERT
    model on any mesh, an MoE model with ``tp`` or ``ep`` above 1."""
    if isinstance(config, BertConfig):
        raise NotImplementedError(
            f"BERT over mesh {axes}: BERT over several cards is not ported yet "
            "(ROADMAP Queue 1 item 3b, multi-card BERT)")
    if config.n_experts and any(axes.get(a, 1) > 1 for a in ("tp", "ep")):
        raise NotImplementedError(
            f"MoE over mesh {axes}: experts over ep or tp are not ported yet "
            "(ROADMAP Queue 1 item 3a, multi-card MoE)")


def shard_model(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Shard ``model`` (a Llama, before its storage exists: on the meta
    device; a Bert is refused) over ``mesh`` in place: tensor-parallel
    plans on each block over ``tp`` when it is above 1, then FSDP2 on each
    MoE router, each block and the root."""
    check_shardable(model.config, mesh_axes(mesh))
    if "tp" in mesh.mesh_dim_names and mesh["tp"].size() > 1:
        for block in model.layers:
            parallelize_module(block, mesh["tp"], _tp_plan(block))
    fsdp = _fsdp_mesh(mesh)
    for block in model.layers:
        if block.moe:
            fully_shard(block.feed_forward.router, mesh=fsdp)
        fully_shard(block, mesh=fsdp)
    fully_shard(model, mesh=fsdp)
    return model
