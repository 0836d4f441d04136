"""The port's MoE over ``sp`` (``models/llama.py`` ``MoE`` with
``routing_groups``/``slot_offsets``, ``parallel/experts.sequence_counts``)
on the CPU, against the JAX package's ``MoE`` over the whole sequence.

- One fp32 moe-tiny layer over a 2-process gloo ``sp`` group, each rank
  with half of the sequence's 64 positions, against the JAX ``MoE`` on one
  device over the whole sequence, from seeded numpy weights, at capacity
  factor 0.5 so that tokens drop: routed as one group (its slots counted
  across the two ranks) and in groups of 16 (inside each rank's piece).
  The output and the aux loss within 1e-5 relative, and the gradients of
  ``sum(y * w) + aux`` (the router's, every expert's, the input's) within
  1e-4 relative in L2, as ``tests/test_torch_expert_parallel.py`` holds
  the layer over ``ep``.
- The same layer over 2 and 4 virtual sp ranks in one process
  (``testing/virtual_ranks.moe_over_sp``, as ``chip_smoke.py`` phase s
  runs it), groups inside a rank, across two ranks and across all, equal
  to the whole layer; where a group spans ranks, each rank's experts run
  on its own kept routes alone, fewer slots than the group's capacity; a
  split that no rule covers is refused.
- fp32 moe-tiny under remat "dots+rope+norms" through the ``llama_train``
  entry point from a seeded token file over ``{"sp": 2}`` (2 processes)
  and ``{"sp": 2, "ep": 2}``, ``{"sp": 2, "fsdp": 2}`` and ``{"sp": 2,
  "tp": 2}`` (4 processes, one layout after another): the 5 losses, aux
  loss included, within 1e-5 relative of one process's.

The six processes are spawned once, together, for the whole file.
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import llama as jax_llama
from tf_operator_tpu_torch.models import llama
from tf_operator_tpu_torch.testing.virtual_ranks import moe_over_sp
from tf_operator_tpu_torch.train import data, llama_train

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--model", "moe-tiny", "--device", "cpu", "--batch", "4", "--seq", "32",
        "--log-every", "100", "--lr", "3e-3", "--steps", "5", "--warmup", "1"]
CONFIG = dict(dtype=torch.float32, param_dtype=torch.float32, remat=True,
              remat_policy="dots+rope+norms")
LAYER_BATCH, LAYER_SEQ, CAPACITY = 2, 64, 0.5
GROUPS = {"whole": 0, "grouped": 16}  # moe_group_size of each layer case
# The 4-process layouts, run one after another by the same processes.
QUAD = {"sp_ep": {"sp": 2, "ep": 2}, "sp_fsdp": {"fsdp": 2, "sp": 2},
        "sp_tp": {"sp": 2, "tp": 2}}
MESHES = {"sp": {"fsdp": 1, "sp": 2}, "sp_ep": {"fsdp": 1, "ep": 2, "sp": 2},
          "sp_fsdp": {"fsdp": 2, "sp": 2}, "sp_tp": {"fsdp": 1, "sp": 2, "tp": 2}}
WORKER = r"""
import dataclasses, json, os, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from tf_operator_tpu_torch.models import llama
llama.CONFIGS["moe-tiny"] = dataclasses.replace(
    llama.CONFIGS["moe-tiny"], dtype=torch.float32, param_dtype=torch.float32, remat=True,
    remat_policy="dots+rope+norms")
from tf_operator_tpu_torch.parallel import sharding
from tf_operator_tpu_torch.train import llama_train

out_path, specs, args = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3:]
result = {}
for name, spec in specs.items():
    os.environ["JAX_MESH_SPEC"] = json.dumps(spec)
    out = llama_train.run(llama_train.parse_args(args))
    result[name] = {"losses": out["losses"], "mesh": out["mesh"]}
rank, world = dist.get_rank(), dist.get_world_size()


def layer(group_size):
    # One MoE layer over sp=2: this rank's half of the sequence.
    ref = np.load(os.environ["LAYER_INPUTS"])
    cfg = dataclasses.replace(llama.CONFIGS["moe-tiny"], remat=False,
                              capacity_factor=CAPACITY, moe_group_size=group_size)
    moe = llama.MoE(cfg, device="cpu")
    moe.router.weight.data.copy_(torch.from_numpy(ref["router"].T))
    for name in ("experts_w1", "experts_w3", "experts_w2"):
        getattr(moe, name).data.copy_(torch.from_numpy(ref[name]))
    mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("fsdp", "sp"))
    sharding.place_experts(moe, mesh)
    piece = slice(rank * ref["x"].shape[1] // world, (rank + 1) * ref["x"].shape[1] // world)
    x = torch.from_numpy(ref["x"][:, piece]).requires_grad_()
    y, aux = moe(x)
    # This rank's share of sum(y * w) + aux, times the world: the mean of
    # the ranks' objectives is the global one, as the mean of their losses.
    (world * (y * torch.from_numpy(ref["w"][:, piece])).sum() + aux).backward()
    return {"y": y.detach().tolist(), "aux": aux.item(), "dx": x.grad.tolist(),
            "span": moe.route(x.detach()).span, "router": moe.router.weight.grad.tolist(),
            **{n: getattr(moe, n).grad.tolist()
               for n in ("experts_w1", "experts_w3", "experts_w2")}}


if world == 2:
    result["layers"] = {name: layer(size) for name, size in GROUPS.items()}
with open(out_path + ".%d" % rank, "w") as fh:
    json.dump(result, fh)
dist.destroy_process_group()
""".replace("CAPACITY", str(CAPACITY)).replace("GROUPS", repr(GROUPS))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _layer_inputs():
    """Seeded fp32 weights (the flax layout: the router's kernel [d, e]),
    input [b, s, d] and the objective's weights [b, s, d] of moe-tiny."""
    cfg = llama.CONFIGS["moe-tiny"]
    e, d, f = cfg.n_experts, cfg.dim, cfg.ffn_dim
    rng = np.random.default_rng(11)

    def normal(*shape, scale=0.02):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"router": normal(d, e, scale=0.5), "experts_w1": normal(e, d, f),
            "experts_w3": normal(e, d, f), "experts_w2": normal(e, f, d),
            "x": normal(LAYER_BATCH, LAYER_SEQ, d, scale=1.0),
            "w": normal(LAYER_BATCH, LAYER_SEQ, d, scale=1.0)}


def _jax_layer(inputs, group_size):
    """(y, aux, gradients) of sum(y * w) + aux through the JAX MoE on one
    device over the whole sequence."""
    jcfg = dataclasses.replace(jax_llama.CONFIGS["moe-tiny"], dtype=jnp.float32,
                               param_dtype=jnp.float32, capacity_factor=CAPACITY,
                               moe_group_size=group_size)
    moe = jax_llama.MoE(jcfg)
    params = {"params": {"router": {"kernel": inputs["router"]},
                         **{n: inputs[n] for n in ("experts_w1", "experts_w3", "experts_w2")}}}

    def objective(params, x):
        y, mutated = moe.apply(params, x, mutable=["losses"])
        aux = sum(jnp.sum(leaf) for leaf in jax.tree.leaves(mutated["losses"]))
        return jnp.sum(y * inputs["w"]) + aux, (y, aux)

    (_, (y, aux)), (grads, dx) = jax.jit(
        jax.value_and_grad(objective, argnums=(0, 1), has_aux=True))(params, inputs["x"])
    grads = jax.tree.map(np.asarray, grads)["params"]
    return np.asarray(y), float(aux), {
        "router": grads["router"]["kernel"].T, "dx": np.asarray(dx),
        **{n: grads[n] for n in ("experts_w1", "experts_w3", "experts_w2")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"pair": [2 ranks, {"sp": ...}], "quad": [4 ranks, {layout: ...} of
    QUAD], "single": losses, "jax": {case: the JAX layer's (y, aux,
    grads)}, "inputs": the layer's inputs}."""
    tmp = tmp_path_factory.mktemp("moe_sequence")
    tokens = tmp / "tokens.bin"
    data.write_token_file(str(tokens), np.random.default_rng(0).integers(
        0, 16, 50_000).astype(np.int32))
    inputs = _layer_inputs()
    np.savez(tmp / "layer.npz", **inputs)
    args = [*ARGS, "--data", str(tokens)]
    groups = {"pair": ({"sp": {"sp": 2}}, 2), "quad": (QUAD, 4)}
    procs = []
    try:
        for name, (spec, n) in groups.items():
            port = _free_port()
            for r in range(n):
                env = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                       "JAX_NUM_PROCESSES": str(n), "JAX_PROCESS_ID": str(r),
                       "OMP_NUM_THREADS": "1", "LAYER_INPUTS": str(tmp / "layer.npz")}
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", WORKER, str(tmp / name), json.dumps(spec), *args],
                    cwd=ROOT,
                    env={**os.environ, **env}, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        jax_result = {name: _jax_layer(inputs, size) for name, size in GROUPS.items()}
        previous = llama.CONFIGS["moe-tiny"]
        llama.CONFIGS["moe-tiny"] = dataclasses.replace(previous, **CONFIG)
        try:
            single = llama_train.run(llama_train.parse_args(args))["losses"]
        finally:
            llama.CONFIGS["moe-tiny"] = previous
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    result = {name: [json.loads((tmp / f"{name}.{r}").read_text()) for r in range(n)]
              for name, (_, n) in groups.items()}
    result.update(single=single, jax=jax_result, inputs=inputs)
    return result


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _dropped(inputs, group_size):
    """How many (token, routing rank) routes lose their slot over the whole
    sequence."""
    cfg = dataclasses.replace(llama.CONFIGS["moe-tiny"], dtype=torch.float32,
                              param_dtype=torch.float32, capacity_factor=CAPACITY,
                              moe_group_size=group_size)
    moe = llama.MoE(cfg, device="cpu")
    moe.router.weight.data.copy_(torch.from_numpy(inputs["router"].T))
    routing = moe.route(torch.from_numpy(inputs["x"]))
    offsets = llama.slot_offsets(routing.counts()[None], 0, 1)
    kept = sum(int(((oh.cumsum(1) - oh + offsets[j][:, None]) < routing.cap)[oh > 0].sum())
               for j, oh in enumerate(routing.onehot.unbind(2)))
    return routing.onehot.sum().item() - kept


@pytest.mark.parametrize("case", sorted(GROUPS))
def test_moe_layer_over_sp_matches_jax(runs, case):
    assert _dropped(runs["inputs"], GROUPS[case]) > 0  # the capacity drops tokens
    y, aux, grads = runs["jax"][case]
    ranks = [r["layers"][case] for r in runs["pair"]]
    # One group spans both ranks' pieces; groups of 16 lie inside each.
    assert [r["span"] for r in ranks] == ([2, 2] if case == "whole" else [1, 1])
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks], 1), y, rtol=1e-5,
                               atol=1e-5 * np.abs(y).max())
    for r in ranks:
        assert r["aux"] == pytest.approx(aux, rel=1e-5)
    world = len(ranks)
    got = {
        "dx": np.concatenate([r["dx"] for r in ranks], 1) / world,
        **{n: np.mean([r[n] for r in ranks], axis=0) for n in
           ("router", "experts_w1", "experts_w3", "experts_w2")},
    }
    for name, g in got.items():
        assert rel_err(g, grads[name]) < 1e-4, name
        assert np.linalg.norm(grads[name]) > 0, name


@pytest.mark.parametrize("group_size,n", [(0, 2), (0, 4), (16, 4), (32, 4), (8, 2)])
def test_virtual_sp_ranks_give_the_whole_layer(group_size, n):
    cfg = dataclasses.replace(llama.CONFIGS["moe-tiny"], dtype=torch.float32,
                              param_dtype=torch.float32, capacity_factor=CAPACITY,
                              moe_group_size=group_size)
    inputs = _layer_inputs()
    moe = llama.MoE(cfg, device="cpu")
    moe.router.weight.data.copy_(torch.from_numpy(inputs["router"].T))
    for name in ("experts_w1", "experts_w3", "experts_w2"):
        getattr(moe, name).data.copy_(torch.from_numpy(inputs[name]))
    w = torch.from_numpy(inputs["w"])

    def run(layer):
        x = torch.from_numpy(inputs["x"]).requires_grad_()
        for p in moe.parameters():
            p.grad = None
        y, aux = layer(x)
        ((y * w).sum() + aux).backward()
        return [y, aux, x.grad, *(p.grad.clone() for p in moe.parameters())]

    whole, virtual = run(moe), run(lambda x: moe_over_sp(moe, x, n))
    for got, want in zip(virtual, whole):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("group_size,n", [(0, 2), (0, 4), (32, 4)])
def test_a_rank_runs_the_experts_on_its_own_kept_routes(group_size, n):
    """Where a routing group spans sp ranks, each rank's experts run on as
    many slots as it keeps routes to one expert at most, not on the
    group's capacity: counted here from the whole layer's kept routes."""
    cfg = dataclasses.replace(llama.CONFIGS["moe-tiny"], dtype=torch.float32,
                              param_dtype=torch.float32, capacity_factor=CAPACITY,
                              moe_group_size=group_size)
    inputs = _layer_inputs()
    moe = llama.MoE(cfg, device="cpu")
    moe.router.weight.data.copy_(torch.from_numpy(inputs["router"].T))
    x = torch.from_numpy(inputs["x"])
    routing = moe.route(x)
    offsets = llama.slot_offsets(routing.counts()[None], 0, 1)
    kept = sum(((oh.cumsum(1) - oh + offsets[j][:, None]) < routing.cap) & (oh > 0)
               for j, oh in enumerate(routing.onehot.unbind(2)))  # [groups, length, e]
    per_rank = kept.reshape(LAYER_BATCH, LAYER_SEQ, -1).chunk(n, 1)
    want = [int(part.sum(1).max()) for part in per_rank]
    slots, experts = [], moe._experts
    moe._experts = lambda h: slots.append(h.shape[2]) or experts(h)
    moe_over_sp(moe, x, n)
    assert llama.routing_groups(cfg, LAYER_SEQ // n, n)[1] > 1
    assert slots == want
    assert sum(slots) < n * routing.cap  # fewer than every rank on the group's capacity


def test_a_group_split_no_rule_covers_is_refused():
    cfg = dataclasses.replace(llama.CONFIGS["moe-tiny"], moe_group_size=24)
    # 3 ranks of 16 positions: groups of 24 straddle them.
    with pytest.raises(ValueError, match="moe_group_size=24 over 3 sp ranks of 16 positions"):
        llama.routing_groups(cfg, 16, 3)
    assert llama.routing_groups(cfg, 16, 4) == (64, 4)  # 64 % 24: one group, as JAX
    assert llama.routing_groups(llama.CONFIGS["moe-125m"], 2048, 4) == (256, 1)
    assert llama.routing_groups(dataclasses.replace(cfg, moe_group_size=0), 2048, 4) == \
        (8192, 4)


@pytest.mark.parametrize("layout", sorted(MESHES))
def test_moe_losses_over_sp_match_one_process(runs, layout):
    single = np.array(runs["single"])
    assert single[-1] < single[0] - 0.05  # the updates moved the weights
    ranks = [r[layout] for r in runs["pair" if layout == "sp" else "quad"]]
    assert ranks[0]["mesh"] == MESHES[layout]
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], single, rtol=1e-5)
