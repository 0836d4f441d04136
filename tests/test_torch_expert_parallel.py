"""The port's MoE over several processes (``parallel/sharding.py``
``expert_layout``/``place_experts``, ``parallel/experts.py``) on the CPU,
against one process and against the JAX package.

- ``resolve_expert_axis``/``moe_expert_axes`` against the JAX package's
  for the meshes of ``tests/test_bench_check.py``'s expert-axis cases and a
  few more.
- fp32 moe-tiny under remat "dots+rope+norms" through the ``llama_train``
  entry point from a seeded token file, over ep=2 (JAXJob env), fsdp=2
  (the expert axis is fsdp: 4 experts divide it) and tp=2 (no expert axis:
  each expert's f split over tp), all on 2-process gloo, and over ep=2 x
  tp=2 on 4-process gloo (each expert of a rank's two split over tp): the
  born-sharded weights bit-equal to the unsharded init, and 5 losses
  equal to one process's at 1e-5 relative (only the order of the sums
  differs; the lr warms up in 1 step, so the last 3 losses follow updates
  of the sharded gradients, and a missing factor on the expert gradient
  would show there). The ep, fsdp and ep x tp runs go through the
  all-to-all: 6 a layer and step (the forward, the remat replay's
  forward, the backward); the tp ones sum the experts' partial products
  over tp, 3 a layer and step under ep x tp.
- One MoE layer over ep=2 (each process half the batch and half the
  experts) against the JAX ``MoE`` under a 2-device ``Mesh`` with
  ``use_mesh``, and over ep=2 x tp=2 (each ep rank's half of the batch on
  both of its tp ranks, each expert's f split over tp) against it under a
  4-device ``Mesh`` {"ep": 2, "tp": 2}, from seeded numpy weights: the
  output and the aux loss at 1e-5 relative, and the gradients of
  ``sum(y * w) + aux`` (the router's, every expert's, the input's) at
  1e-4 relative in L2.
- The port's expert placement over ep=2 x tp=2 is the JAX package's
  ``spec_for_param`` for ``experts_w1`` and ``experts_w2`` on that mesh.
- An ep=2 state saved through DCP after 3 steps and resumed to 6 gives the
  uninterrupted run's losses.
- The sharded global norm counts FSDP2's ``_StridedShard`` (the fsdp shard
  of a tp-sharded dim) as a shard.

The two process pairs and the 4-process world are spawned once,
together, for the whole file.
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
from tf_operator_tpu.parallel import sharding as jax_sharding
from tf_operator_tpu.parallel.mesh import use_mesh
from tf_operator_tpu_torch.models import llama
from tf_operator_tpu_torch.parallel import sharding
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import data, llama_train

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--model", "moe-tiny", "--device", "cpu", "--batch", "4", "--seq", "32",
        "--log-every", "100", "--lr", "3e-3"]
CONFIG = dict(dtype=torch.float32, param_dtype=torch.float32, remat=True,
              remat_policy="dots+rope+norms")
LAYER_BATCH, LAYER_SEQ = 4, 32
# The one MoE layer's meshes: over ep on 2 processes, over ep x tp on 4.
LAYER_MESHES = {"ep": {"ep": 2}, "eptp": {"ep": 2, "tp": 2}}
WORKER = r"""
import dataclasses, json, os, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from tf_operator_tpu_torch.models import llama
llama.CONFIGS["moe-tiny"] = dataclasses.replace(
    llama.CONFIGS["moe-tiny"], dtype=torch.float32, param_dtype=torch.float32, remat=True,
    remat_policy="dots+rope+norms")
from tf_operator_tpu_torch.parallel import experts, sharding
from tf_operator_tpu_torch.train import llama_train, train_step

out_path, role, args = sys.argv[1], sys.argv[2], sys.argv[3:]
rank = None
result = {}


def train(spec, extra):
    os.environ["JAX_MESH_SPEC"] = spec
    argv = llama_train.parse_args(args + extra)
    s = llama_train.setup(argv)
    ref = llama.Llama(s.config, device="cpu", generator=torch.Generator().manual_seed(0))
    named = list(s.state.model.named_parameters())
    init_equal = all(torch.equal(p.full_tensor(), r)
                     for (_, p), r in zip(named, ref.parameters()))
    placements = {n: [repr(x) for x in p.placements] for n, p in named if "experts" in n}
    meshes = {n: list(p.device_mesh.mesh_dim_names) for n, p in named if "experts" in n}
    del s, ref, named
    experts.reset_counts()
    out = llama_train.run(argv)
    return {"init_equal": init_equal, "placements": placements, "meshes": meshes,
            "losses": out["losses"], "mesh": out["mesh"], **experts.COUNTS}


def layer(tp=1):
    # One MoE layer over ep=2 (x tp): this ep rank's half of the batch and
    # of the experts, each expert's f split over its tp group.
    ep = dist.get_world_size() // tp
    ref = np.load(os.environ["LAYER_INPUTS"])
    cfg = llama.CONFIGS["moe-tiny"]
    moe = llama.MoE(dataclasses.replace(cfg, remat=False), device="cpu")
    moe.router.weight.data.copy_(torch.from_numpy(ref["router"].T))
    for name in ("experts_w1", "experts_w3", "experts_w2"):
        getattr(moe, name).data.copy_(torch.from_numpy(ref[name]))
    shape, names = ((1, ep), ("fsdp", "ep")) if tp == 1 else ((1, ep, tp), ("fsdp", "ep", "tp"))
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    sharding.place_experts(moe, mesh)
    r = mesh.get_local_rank("ep")
    rows = slice(r * LAYER_BATCH // ep, (r + 1) * LAYER_BATCH // ep)
    x = torch.from_numpy(ref["x"][rows]).requires_grad_()
    y, aux = moe(x)
    # This rank's share of sum(y * w) + aux, times the data ranks: the mean
    # of their objectives is the global one, as the mean of their losses.
    (ep * (y * torch.from_numpy(ref["w"][rows])).sum() + aux).backward()
    return {"y": y.detach().tolist(), "aux": aux.item(), "dx": x.grad.tolist(),
            "router": moe.router.weight.grad.tolist(),
            **{n: getattr(moe, n).grad.to_local().tolist()
               for n in ("experts_w1", "experts_w3", "experts_w2")}}


def strided_norm():
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard
    mesh = init_device_mesh("cpu", (dist.get_world_size(),), mesh_dim_names=("fsdp",))
    g = DTensor.from_local(torch.ones(2, 3), mesh, [_StridedShard(0, split_factor=2)])
    return train_step.global_norm([g]).item()


if role == "ep":
    result["ep"] = train('{"ep": 2}', ["--steps", "5", "--warmup", "1", "--data",
                                       os.environ["TOKENS"]])
    rank = dist.get_rank()
    ckpt = os.environ["CKPT"]
    resume = ["--warmup", "6", "--data", os.environ["TOKENS"]]
    os.environ["JAX_MESH_SPEC"] = '{"ep": 2}'
    whole = llama_train.run(llama_train.parse_args(args + resume + ["--steps", "6"]))
    first = llama_train.run(llama_train.parse_args(
        args + resume + ["--steps", "3", "--checkpoint-dir", ckpt]))
    again = llama_train.run(llama_train.parse_args(
        args + resume + ["--steps", "6", "--checkpoint-dir", ckpt]))
    result["dcp"] = {"whole": whole["losses"], "first": first["losses"],
                     "resumed": again["losses"], "start_step": again["start_step"],
                     "restore": [again["restore"].path, again["restore"].cause,
                                 again["restore"].step],
                     "listing": sorted(os.listdir(ckpt))}
    result["layer"] = layer()
elif role == "eptp":
    result["eptp"] = train('{"ep": 2, "tp": 2}', ["--steps", "5", "--warmup", "1", "--data",
                                                  os.environ["TOKENS"]])
    rank = dist.get_rank()
    result["layer"] = layer(tp=2)
else:
    for spec, name in (('{"fsdp": 2}', "fsdp"), ('{"tp": 2}', "tp")):
        result[name] = train(spec, ["--steps", "5", "--warmup", "1", "--data",
                                    os.environ["TOKENS"]])
    rank = dist.get_rank()
    result["strided_norm"] = strided_norm()
with open(out_path + ".%d" % rank, "w") as fh:
    json.dump(result, fh)
dist.destroy_process_group()
""".replace("LAYER_BATCH", str(LAYER_BATCH))


# ------------------------------------------------------------------ rules
def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())),
                             tuple(axes))


@pytest.mark.parametrize("axes,n_experts", [
    ({"fsdp": 4, "ep": 2}, 8), ({"fsdp": 4}, 8), ({"fsdp": 4}, 6), ({"ep": 1}, 4),
    ({"fsdp": 2, "tp": 2}, 4), ({"dp": 2, "fsdp": 2}, 3), ({"dp": 2, "ep": 4}, 8),
    ({"tp": 2}, 4), ({"fsdp": 1}, 8),
], ids=lambda v: json.dumps(v) if isinstance(v, dict) else str(v))
def test_expert_axis_resolves_as_in_the_jax_package(axes, n_experts):
    mesh = _jax_mesh(axes)
    want = jax_sharding.moe_expert_axes(mesh, n_experts)
    assert sharding.moe_expert_axes(axes, n_experts) == want
    assert sharding.resolve_expert_axis(axes, n_experts) == \
        jax_sharding._resolve_expert_axis(mesh, n_experts)
    assert sharding.moe_expert_axes(None, n_experts) == jax_sharding.moe_expert_axes(
        None, n_experts)


# ------------------------------------------------------------ 2 processes
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _layer_inputs():
    """Seeded fp32 weights (the flax layout: the router's kernel [d, e]),
    input [b, s, d] and the objective's weights [b, s, d] of moe-tiny."""
    cfg = llama.CONFIGS["moe-tiny"]
    e, d, f = cfg.n_experts, cfg.dim, cfg.ffn_dim
    rng = np.random.default_rng(5)

    def normal(*shape, scale=0.02):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"router": normal(d, e, scale=0.5), "experts_w1": normal(e, d, f),
            "experts_w3": normal(e, d, f), "experts_w2": normal(e, f, d),
            "x": normal(LAYER_BATCH, LAYER_SEQ, d, scale=1.0),
            "w": normal(LAYER_BATCH, LAYER_SEQ, d, scale=1.0)}


def _jax_layer(inputs, axes):
    """(y, aux, gradients) of sum(y * w) + aux through the JAX MoE under a
    mesh of ``axes``."""
    jcfg = dataclasses.replace(jax_llama.CONFIGS["moe-tiny"], dtype=jnp.float32,
                               param_dtype=jnp.float32)
    moe = jax_llama.MoE(jcfg)
    params = {"params": {"router": {"kernel": inputs["router"]},
                         **{n: inputs[n] for n in ("experts_w1", "experts_w3", "experts_w2")}}}

    def objective(params, x):
        y, mutated = moe.apply(params, x, mutable=["losses"])
        aux = sum(jnp.sum(leaf) for leaf in jax.tree.leaves(mutated["losses"]))
        return jnp.sum(y * inputs["w"]) + aux, (y, aux)

    with use_mesh(_jax_mesh(axes)):
        # XLA's backend optimisations cost compile time and buy nothing here.
        (_, (y, aux)), (grads, dx) = jax.jit(
            jax.value_and_grad(objective, argnums=(0, 1), has_aux=True),
            compiler_options={"xla_backend_optimization_level": 0})(params, inputs["x"])
    grads = jax.tree.map(np.asarray, grads)["params"]
    return np.asarray(y), float(aux), {
        "router": grads["router"]["kernel"].T, "dx": np.asarray(dx),
        **{n: grads[n] for n in ("experts_w1", "experts_w3", "experts_w2")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ep": [rank 0, rank 1], "other": [...], "eptp": [ranks 0-3],
    "single": losses, "jax": {layout: the JAX layer's (y, aux, grads)},
    "inputs": the layer's inputs}."""
    tmp = tmp_path_factory.mktemp("expert_parallel")
    tokens = tmp / "tokens.bin"
    data.write_token_file(str(tokens), np.random.default_rng(0).integers(
        0, 16, 50_000).astype(np.int32))
    inputs = _layer_inputs()
    np.savez(tmp / "layer.npz", **inputs)
    ep_port, other_port, eptp_port = _free_port(), _free_port(), _free_port()
    envs = {
        "ep": [{"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{ep_port}",
                "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(r)} for r in range(2)],
        "other": [{"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(other_port),
                   "WORLD_SIZE": "2", "RANK": str(r)} for r in range(2)],
        "eptp": [{"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(eptp_port),
                  "WORLD_SIZE": "4", "RANK": str(r)} for r in range(4)],
    }
    common = {"OMP_NUM_THREADS": "1", "TOKENS": str(tokens), "CKPT": str(tmp / "ckpt"),
              "LAYER_INPUTS": str(tmp / "layer.npz")}
    procs = []
    try:
        for role, pair in envs.items():
            for env in pair:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", WORKER, str(tmp / role), role, *ARGS], cwd=ROOT,
                    env={**os.environ, **common, **env}, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        jax_result = {layout: _jax_layer(inputs, axes) for layout, axes in LAYER_MESHES.items()}
        previous = llama.CONFIGS["moe-tiny"]
        llama.CONFIGS["moe-tiny"] = dataclasses.replace(previous, **CONFIG)
        try:
            single = llama_train.run(llama_train.parse_args(
                [*ARGS, "--steps", "5", "--warmup", "1", "--data", str(tokens)]))["losses"]
        finally:
            llama.CONFIGS["moe-tiny"] = previous
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    result = {role: [json.loads((tmp / f"{role}.{r}").read_text()) for r in range(len(pair))]
              for role, pair in envs.items()}
    result.update(single=single, jax=jax_result, inputs=inputs)
    return result


def _layout(runs, layout):
    return runs[layout if layout in ("ep", "eptp") else "other"]


@pytest.mark.parametrize("layout", ["ep", "fsdp", "tp", "eptp"])
def test_born_sharded_init_is_bit_equal(runs, layout):
    for rank in _layout(runs, layout):
        assert rank[layout]["init_equal"]


@pytest.mark.parametrize("layout", ["ep", "fsdp", "tp", "eptp"])
def test_losses_match_one_process(runs, layout):
    single = np.array(runs["single"])
    # The updates moved the weights: the later losses fall well below the
    # first ones, so a wrong sharded gradient would show in them.
    assert single[-1] < single[0] - 0.05
    for rank in _layout(runs, layout):
        np.testing.assert_allclose(rank[layout]["losses"], single, rtol=1e-5)


def test_expert_layouts_and_all_to_alls(runs):
    ep, fsdp, tp = runs["ep"][0]["ep"], runs["other"][0]["fsdp"], runs["other"][0]["tp"]
    w1, w2 = "layers.0.feed_forward.experts_w1", "layers.0.feed_forward.experts_w2"
    assert ep["mesh"] == {"fsdp": 1, "ep": 2}
    # Over the expert axis each rank keeps 2 of the 4 experts whole.
    assert ep["placements"][w1] == ["Shard(dim=0)"] and ep["meshes"][w1] == ["ep"]
    assert fsdp["placements"][w1] == ["Shard(dim=0)"] and fsdp["meshes"][w1] == ["fsdp"]
    # Under tp (no expert axis) f is split: w1 [e, d, f] on dim 2, w2
    # [e, f, d] on dim 1, the block's FSDP2 shard on dim 0.
    assert tp["meshes"][w1] == ["fsdp", "tp"]
    assert tp["placements"][w1][1] == "Shard(dim=2)"
    assert tp["placements"][w2][1] == "Shard(dim=1)"
    # Forward, remat replay and backward: 2 all-to-alls each, a layer.
    per_run = 5 * llama.CONFIGS["moe-tiny"].n_layers * 6
    assert ep["all_to_all"] == fsdp["all_to_all"] == per_run
    assert tp["all_to_all"] == 0


def _spec(placements, mesh_dims, sizes, ndim):
    """A DTensor's placements as a PartitionSpec's entries: each dim's mesh
    axis (None where no axis of size above 1 splits it)."""
    spec = [None] * ndim
    for placement, axis in zip(placements, mesh_dims):
        if placement.startswith("Shard(") and sizes[axis] > 1:
            spec[int(placement[len("Shard(dim="):-1])] = axis
    return tuple(spec)


def test_expert_placement_over_ep_x_tp_is_the_jax_spec(runs):
    eptp = runs["eptp"][0]["eptp"]
    assert eptp["mesh"] == {"fsdp": 1, "ep": 2, "tp": 2}
    mesh = _jax_mesh(eptp["mesh"])
    cfg = llama.CONFIGS["moe-tiny"]
    e, d, f = cfg.n_experts, cfg.dim, cfg.ffn_dim
    got, want = {}, {}
    for name, shape in (("experts_w1", (e, d, f)), ("experts_w3", (e, d, f)),
                        ("experts_w2", (e, f, d))):
        key = f"layers.0.feed_forward.{name}"
        got[name] = _spec(eptp["placements"][key], eptp["meshes"][key], eptp["mesh"], 3)
        spec = jax_sharding.spec_for_param(f"params/layers_0/feed_forward/{name}", 3, mesh,
                                           shape=shape)
        want[name] = tuple(a if a is not None and eptp["mesh"][a] > 1 else None for a in spec)
    assert got == want
    # The experts over ep, f over tp: w1 and w3 [e, d, f], w2 [e, f, d].
    assert want == {"experts_w1": ("ep", None, "tp"), "experts_w3": ("ep", None, "tp"),
                    "experts_w2": ("ep", "tp", None)}


def test_ep_x_tp_runs_the_all_to_alls_and_the_tp_sums(runs):
    layers = llama.CONFIGS["moe-tiny"].n_layers
    for rank in runs["eptp"]:
        # 6 all-to-alls a layer as over ep alone; the w2 product summed over
        # tp in the forward and its replay, the input's gradient in the
        # backward.
        assert rank["eptp"]["all_to_all"] == 5 * layers * 6
        assert rank["eptp"]["tp"] == 5 * layers * 3


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


@pytest.mark.parametrize("layout", ["ep", "eptp"])
def test_moe_layer_over_ep_matches_jax(runs, layout):
    y, aux, grads = runs["jax"][layout]
    tp = LAYER_MESHES[layout].get("tp", 1)
    # [ep][tp]: rank r is ep rank r // tp, tp rank r % tp.
    ranks = [[r["layer"] for r in runs[layout][i:i + tp]]
             for i in range(0, len(runs[layout]), tp)]
    for name in ("y", "dx", "router"):  # the same on every rank of a tp group
        for group in ranks:
            for r in group[1:]:
                np.testing.assert_allclose(r[name], group[0][name], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.concatenate([g[0]["y"] for g in ranks]), y, rtol=1e-5,
                               atol=1e-5 * np.abs(y).max())
    for group in ranks:
        for r in group:
            assert r["aux"] == pytest.approx(aux, rel=1e-5)
    ep = len(ranks)
    # An expert block [e/ep, d, f/tp] (w2 [e/ep, f/tp, d]): f joined over
    # tp, the experts over ep.
    f_dim = {"experts_w1": 2, "experts_w3": 2, "experts_w2": 1}
    got = {
        "dx": np.concatenate([g[0]["dx"] for g in ranks]) / ep,
        "router": np.mean([g[0]["router"] for g in ranks], axis=0),
        **{n: np.concatenate([np.concatenate([r[n] for r in g], axis=f) for g in ranks])
           for n, f in f_dim.items()},
    }
    for name, g in got.items():
        assert rel_err(g, grads[name]) < 1e-4, name
        assert np.linalg.norm(grads[name]) > 0, name


def test_ep_state_resumes_through_dcp(runs):
    for rank in runs["ep"]:
        dcp = rank["dcp"]
        assert dcp["listing"] == ["dcp", "model_meta.json"]  # sharded: no manifest store
        assert dcp["restore"] == ["storage", "ok", 3] and dcp["start_step"] == 3
        np.testing.assert_allclose(dcp["first"], dcp["whole"][:3], rtol=1e-6)
        np.testing.assert_allclose(dcp["resumed"], dcp["whole"][3:], rtol=1e-6)


def test_global_norm_counts_strided_shards(runs):
    # Two ranks hold 2x3 ones each, sharded (not replicated): sqrt(12).
    for rank in runs["other"]:
        assert rank["strided_norm"] == pytest.approx(np.sqrt(12.0), rel=1e-6)
