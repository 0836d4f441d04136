"""How the model is sharded over a mesh: the port's counterpart of
``tf_operator_tpu/parallel/sharding.py``'s ``_PARAM_RULES`` and
``DATA_AXES``/``batch_sharding``.

Where the JAX package annotates every parameter with a PartitionSpec and
lets XLA insert the collectives, the port applies two torch mechanisms:

- tensor parallelism over ``tp`` (DTensor plans per block): the megatron
  layout of the JAX rules, wq/wk/wv/w1/w3 column-wise (their output
  features over tp) and wo/w2 row-wise (their input features over tp);
- FSDP2 ``fully_shard`` over ``fsdp`` (with ``ep`` and ``sp`` folded in:
  an MoE model's tokens differ over ``ep``, and each ``sp`` rank holds its
  own piece of the sequence, so every gradient averages over both too) on
  each block and on the root, as HSDP with ``slice``/``dp`` as the
  replicate dim.

Over ``sp`` the model runs ring attention (``attention_impl="ring"``)
over the ``sp`` group, each rank's positions offset by its place in the
sequence; ``sp`` is not a data axis (``DATA_AXES``): the ranks of one
``sp`` group read the same rows, as the JAX package's
``batch_sharding(with_sp=False)`` gives them. Over ``pp`` the model is
one pipeline stage (``Llama(pp=, stage=)``) and every plan above applies
over the stage's own submesh, never across ``pp``: a DeviceMesh's dim
names the ranks that share this rank's other coordinates, its stage among
them.

Over ``tp`` the embedding's d and the head's vocab are split as the JAX
rules split them (``(fsdp, tp)`` on both), and FSDP2 shards both over
``fsdp`` too. The model's forward reads both weights itself
(``Llama.tp_mesh``): the embedding gathers its d over tp, and the loss is
the vocab-parallel chunked cross entropy (``ops/cross_entropy.py``), so
no rank ever holds the whole head or the whole vocabulary's logits.

An MoE layer's fp32 router gets a ``fully_shard`` group of its own, since
FSDP2 needs one original dtype in a group and the block's other
parameters are in ``param_dtype``. Its experts follow the JAX package's
expert rules (``resolve_expert_axis``, ``moe_expert_axes``):

- over the resolved expert axis (``ep``, else ``fsdp`` when the expert
  count divides it) they are DTensors sharded ``Shard(0)``: each rank
  keeps its ``e/E`` experts whole, never gathers them, and the dispatch
  reaches them by all-to-all (``parallel/experts.py``). They stay out of
  the block's FSDP2 group; their gradient carries the global mean's
  factor and is summed over the ranks that hold the same experts. Over
  ``ep`` with ``fsdp`` above 1, each local expert's ``d`` is sharded over
  ``fsdp`` by an FSDP2 group of its own, as the JAX rule puts ``d`` on
  ``fsdp``;
- under ``tp`` their ``f`` is split over ``tp`` (the ``w2`` product's
  partial sums are summed there);
- with no resolved axis they shard with the block, as before.

A BERT model is not sharded: its step is data parallel (replicated
parameters, gradients averaged over the whole world whatever axes the
mesh declares: ``data_parallel_group`` and ``train_step.make_train_step``'s
``replica_group``), as the JAX example's is.
"""

from __future__ import annotations

import re
from typing import Optional

import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import Shard, distribute_tensor
from torch.distributed.tensor.parallel import (
    ColwiseParallel,
    RowwiseParallel,
    parallelize_module,
)

from ..models.bert import BertConfig
from .experts import ExpertLayout
from .mesh import mesh_axes

DATA_AXES = ("slice", "dp", "fsdp", "ep")
_REPLICATE_AXES = ("slice", "dp")

# (parameter-name regex, tensor-parallel style): the first match wins.
# Names are the model's state_dict keys, e.g. "layers.0.attention.wq.weight".
_PARAM_RULES = [
    (r"\.(wq|wk|wv|w1|w3)\.weight$", "colwise"),
    (r"\.(wo|w2)\.weight$", "rowwise"),
    # The embedding [vocab, d] and the head [vocab, d], as torch's
    # ColwiseParallel splits an Embedding (d) and a Linear (vocab).
    (r"^(tok_embeddings|output)\.weight$", "colwise"),
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


def resolve_expert_axis(axes: dict, n_experts: Optional[int]) -> Optional[str]:
    """The mesh axis that carries the MoE expert dim, from the mesh's
    ``{axis: size}``: ``ep`` when present (at any size), else ``fsdp`` when
    it is above 1 and the expert count divides it, else None (the experts
    shard with their block). The JAX package's ``_resolve_expert_axis``."""
    if "ep" in axes:
        return "ep"
    fsdp = axes.get("fsdp", 0)
    if fsdp > 1 and n_experts and n_experts % fsdp == 0:
        return "fsdp"
    return None


def moe_expert_axes(axes: Optional[dict], n_experts: int):
    """(expert axis, batch axes) of the dispatch's ``[e, b, cap, d]``: the
    expert dim on the resolved expert axis, the batch dim on the remaining
    data axes. The JAX package's ``moe_expert_axes``."""
    if axes is None:
        return None, DATA_AXES
    axis = resolve_expert_axis(axes, n_experts)
    return axis, tuple(a for a in DATA_AXES if a != axis and a != "ep")


def _flat(mesh: DeviceMesh, dims: tuple) -> DeviceMesh:
    """``mesh[dims]`` as one dim, flattened under the joined names when
    there are several (they are adjacent in ``AXIS_ORDER``); made once."""
    if len(dims) == 1:
        return mesh[dims[0]]
    name = "_".join(dims)
    try:
        return mesh[name]
    except KeyError:
        return mesh[dims]._flatten(name)


def _group(mesh: DeviceMesh, dims: tuple):
    """(the process group over ``dims``, their total size), or (None, 1)
    when there are none."""
    if not dims:
        return None, 1
    sub = _flat(mesh, dims)
    return sub.get_group(), sub.size()


def _fsdp_mesh(mesh: DeviceMesh, fold_ep: bool = True) -> DeviceMesh:
    """The mesh FSDP2 shards over: ``fsdp``, with ``ep`` (when
    ``fold_ep``) and ``sp`` above 1 folded in (without ``fsdp`` when it is
    1), and ``slice``/``dp`` (flattened into one dim when both are present)
    as HSDP's replicate dim."""
    folded = tuple(a for a in _present(mesh, ("ep", "sp"))
                   if mesh[a].size() > 1 and (fold_ep or a != "ep"))
    shard = ("fsdp", *folded) if mesh["fsdp"].size() > 1 or not folded else folded
    rep = _present(mesh, _REPLICATE_AXES)
    if not rep:
        return _flat(mesh, shard)
    names = (_flat(mesh, rep).mesh_dim_names[0], _flat(mesh, shard).mesh_dim_names[0])
    return mesh[names]


def check_shardable(config, axes: dict) -> None:
    """Refuse a layout the port cannot shard ``config`` over: over ``sp``,
    a model whose attention is not the ring (the sequence is never
    gathered silently); over ``tp``, a vocabulary that the tp ranks cannot
    split evenly (the head's rows). A BERT model trains on any mesh: its
    step is data parallel over the whole world (``data_parallel_group``)."""
    if isinstance(config, BertConfig):
        return
    if axes.get("sp", 1) > 1 and config.attention_impl != "ring":
        raise ValueError(
            f"attention_impl={config.attention_impl!r} over mesh {axes}: each sp rank "
            "holds a piece of the sequence; over sp the model runs attention_impl='ring'")
    tp = axes.get("tp", 1)
    if config.vocab_size % tp:
        raise ValueError(f"vocab_size={config.vocab_size} over tp={tp}: the head's rows "
                         "split evenly over the tp ranks")


# Expert weights [e, d, f] (w1, w3) and [e, f, d] (w2): the dims of f and d.
_F_DIM = {"experts_w1": 2, "experts_w3": 2, "experts_w2": 1}
_D_DIM = {"experts_w1": 1, "experts_w3": 1, "experts_w2": 2}


def expert_layout(mesh: DeviceMesh, n_experts: int) -> ExpertLayout:
    """The layout of an MoE layer's experts on ``mesh``. The gradient of
    the global batch's mean is the owners' sum over the expert axis,
    summed over the other data axes and ``sp``, over their size: where no
    FSDP2 group holds the experts, their gradient is scaled by
    ``1/data_size`` and summed over the other data axes and ``sp``; over
    ``ep`` with ``fsdp`` above 1 an FSDP2 group of their own (``fsdp_d``,
    over ``fsdp`` and ``sp``) averages over those, and the gradient is
    scaled by ``1/E``. Over ``sp`` the layer also gets the ring's group,
    over which its ranks exchange their route counts."""
    axes = mesh_axes(mesh)
    axis = resolve_expert_axis(axes, n_experts)
    data = _present(mesh, DATA_AXES)
    # Each sp rank holds other tokens of the same rows: the statistics and
    # the gradients sum over sp as over the data axes.
    sp = axes.get("sp", 1)
    seq = dict(sp_group=mesh["sp"].get_group(), sp_rank=mesh.get_local_rank("sp"),
               sp_size=sp) if sp > 1 else {}
    with_sp = data + (("sp",) if sp > 1 else ())
    data_group, data_size = _group(mesh, with_sp)
    tp_group = _group(mesh, ("tp",))[0] if axes.get("tp", 1) > 1 else None
    if axis is None:
        return ExpertLayout(tp_group=tp_group, data_group=data_group, data_size=data_size,
                            **seq)
    fsdp_d = axis == "ep" and axes.get("fsdp", 1) > 1
    replicas = None if fsdp_d else _group(mesh, tuple(a for a in with_sp if a != axis))[0]
    return ExpertLayout(axis, mesh[axis].get_group(), axes[axis], tp_group, data_group,
                        data_size, replicas, 1.0 / (axes[axis] if fsdp_d else data_size),
                        fsdp_d, **seq)


def place_experts(moe: nn.Module, mesh: DeviceMesh) -> Optional[set]:
    """Give ``moe`` its layout (``expert_layout``) and make its expert
    weights DTensors over the expert axis (``Shard(0)``) and ``tp`` (``f``
    split); returns the parameters that the block's FSDP2 group must leave
    alone, or None."""
    layout = moe.layout = expert_layout(mesh, moe.cfg.n_experts)
    dims = tuple(a for a in (layout.axis, "tp" if layout.tp_group is not None else None) if a)
    if not dims:
        return None
    sub = mesh[dims]
    for name, f_dim in _F_DIM.items():
        placements = [Shard(0)] * (layout.axis is not None)
        placements += [Shard(f_dim)] * (layout.tp_group is not None)
        weight = getattr(moe, name)
        setattr(moe, name, nn.Parameter(distribute_tensor(weight.data, sub, placements,
                                                          src_data_rank=None)))
    if layout.axis is None:
        return None  # f split over tp, in the block's group
    if layout.fsdp_d:
        d_dims = {id(getattr(moe, n)): d for n, d in _D_DIM.items()}
        fully_shard(moe, mesh=_fsdp_mesh(mesh, fold_ep=False),
                    shard_placement_fn=lambda p: Shard(d_dims[id(p)]))
        return None
    return {getattr(moe, n) for n in _F_DIM}


def _sequence_and_stages(model: nn.Module, mesh: DeviceMesh) -> None:
    """Give ``model`` its ring (``sp``) and its pipeline (``pp``) groups."""
    axes = mesh_axes(mesh)
    pp = axes.get("pp", 1)
    if model.stages != pp:
        raise ValueError(f"a model of {model.stages} pipeline stages over mesh {axes}")
    if pp > 1:
        if model.stage != mesh.get_local_rank("pp"):
            raise ValueError(f"stage {model.stage} on the mesh's pp rank "
                             f"{mesh.get_local_rank('pp')}")
        model.pp_group = mesh["pp"].get_group()
    if axes.get("sp", 1) > 1:
        model.sp_rank, model.sp_size = mesh.get_local_rank("sp"), axes["sp"]
        for block in model.blocks():
            block.attention.sp_group = mesh["sp"].get_group()


def _vocab_parallel(model: nn.Module, mesh: DeviceMesh) -> None:
    """Split the embedding's d (dim 1) and the head's vocab (dim 0) over
    ``tp``: DTensors that ``Llama.forward`` reads itself, no module hooks
    (a pipeline stage holds either, or neither)."""
    tp = mesh["tp"]
    for module, dim in ((model.tok_embeddings, 1), (model.output, 0)):
        if module is not None:
            module.weight = nn.Parameter(distribute_tensor(module.weight.data, tp, [Shard(dim)],
                                                           src_data_rank=None))
    model.tp_mesh = tp


def shard_model(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Shard ``model`` (a Llama, or one pipeline stage of it, before its
    storage exists: on the meta device) over ``mesh`` in place: its ring
    and pipeline groups, tensor-parallel plans on each block over ``tp``
    when it is above 1 and the embedding and head split there, then FSDP2
    on each MoE router, the experts placed (``expert_layout``), FSDP2 on
    each block and the root."""
    check_shardable(model.config, mesh_axes(mesh))
    _sequence_and_stages(model, mesh)
    if "tp" in mesh.mesh_dim_names and mesh["tp"].size() > 1:
        for block in model.blocks():
            parallelize_module(block, mesh["tp"], _tp_plan(block))
        _vocab_parallel(model, mesh)
    fsdp = _fsdp_mesh(mesh)
    for block in model.blocks():
        ignored = None
        if block.moe:
            fully_shard(block.feed_forward.router, mesh=fsdp)
            ignored = place_experts(block.feed_forward, mesh)
        fully_shard(block, mesh=fsdp, ignored_params=ignored)
    fully_shard(model, mesh=fsdp)
    return model


def data_parallel_group(config, mesh: DeviceMesh):
    """(the process group a data-parallel step averages over, its size) for
    a model whose step is data parallel (BERT's): the whole world, whatever
    axes ``mesh`` declares, as the JAX example shards its batch over every
    mesh axis."""
    check_shardable(config, mesh_axes(mesh))
    return dist.group.WORLD, dist.get_world_size()
