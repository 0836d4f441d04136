"""The port's pipeline (``parallel/pipeline.py``) and the ``pp`` axis of
``llama_train`` on the CPU, against the JAX package and one process.

- ``pipeline_apply`` over 2- and 4-process gloo ``pp`` groups on the JAX
  test's toy stages (``tanh(x @ w)``, 8 layers of 16 x 16, batch 8), with
  M = pp and M = 2 pp microbatches, against the JAX ``pipeline_apply``
  under an 8-device mesh (skipped as ``tests/test_pipeline.py`` skips where
  partial-manual ``shard_map`` is missing) and against the sequential
  fallback (no group): the last stage's output and the gradients of
  ``sum(out ** 2)`` in every stage's weights and in x at fp32; the other
  stages' output is zeros; 2 (M + pp - 2) permutes a step.
- fp32 llama-tiny with 4 layers under remat "dots" through the
  ``llama_train`` entry point from a seeded token file over ``{"pp": 2}``
  (2 processes), ``{"pp": 2, "fsdp": 2}`` and ``{"pp": 2, "tp": 2}``
  (4 processes): each stage holds its own layers under their unsharded
  names, 5 losses within 1e-5 relative of one process's, and the clip's
  global norm of every step equal (1e-5).
- A ``{"pp": 2}`` state saved through DCP after 3 steps, restored in one
  process with no pipeline, continues with the uninterrupted run's
  losses.
- The refusals: MoE + pp and ring + pp with the JAX model's reasons,
  layers or a batch that the stages or microbatches do not divide.

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

from tf_operator_tpu.parallel.compat import supports_partial_manual
from tf_operator_tpu_torch.models import llama
from tf_operator_tpu_torch.parallel import pipeline
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import data, llama_train, train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--device", "cpu", "--batch", "4", "--seq", "32", "--log-every", "1", "--lr", "3e-3"]
TINY4 = dataclasses.replace(llama.CONFIGS["llama-tiny"], dtype=torch.float32,
                            param_dtype=torch.float32, remat=True, n_layers=4)
TOY_LAYERS, TOY_DIM, TOY_BATCH = 8, 16, 8
WORKER = r"""
import dataclasses, json, os, sys
import numpy as np, torch, torch.distributed as dist
from tf_operator_tpu_torch.models import llama
llama.CONFIGS["llama-tiny"] = dataclasses.replace(
    llama.CONFIGS["llama-tiny"], dtype=torch.float32, param_dtype=torch.float32, remat=True,
    n_layers=4)
from tf_operator_tpu_torch.parallel import collectives, pipeline
from tf_operator_tpu_torch.train import llama_train, train_step

out_path, specs, args = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3:]
norms = []
real_norm = train_step.global_norm


def recording(grads, stages=1):
    norm = real_norm(grads, stages)
    norms.append(norm.item())
    return norm


train_step.global_norm = recording
result = {}
for spec in specs:
    os.environ["JAX_MESH_SPEC"] = spec
    norms.clear()
    argv = llama_train.parse_args(args + ["--steps", "5", "--warmup", "1",
                                          "--data", os.environ["TOKENS"]])
    s = llama_train.setup(argv)
    names = [n for n, _ in s.state.model.named_parameters()]
    collectives.reset_counts()
    out = llama_train.run(argv, s)
    result[spec] = {"losses": out["losses"], "mesh": out["mesh"], "norms": list(norms),
                    "names": names, "ppermute": collectives.COUNTS["ppermute"]}
    del s
rank, world = dist.get_rank(), dist.get_world_size()

toy = np.load(os.environ["TOY_INPUTS"])
per = toy["w"].shape[0] // world
weights = torch.from_numpy(toy["w"][rank * per:(rank + 1) * per]).requires_grad_()


def stage_fn(stage, x):
    for w in weights:
        x = torch.tanh(x @ w)
    return x


for m in (world, 2 * world):
    x = torch.from_numpy(toy["x"]).requires_grad_()
    collectives.reset_counts()
    out = pipeline.pipeline_apply(stage_fn, x, num_microbatches=m, group=dist.group.WORLD)
    (out ** 2).sum().backward()
    result[f"toy/{m}"] = {"out": out.tolist(), "dw": weights.grad.tolist(),
                          "dx": x.grad.tolist(), "ppermute": collectives.COUNTS["ppermute"]}
    weights.grad = None
try:
    pipeline.pipeline_apply(stage_fn, torch.from_numpy(toy["x"])[:7], num_microbatches=world,
                            group=dist.group.WORLD)
except ValueError as err:
    result["indivisible_batch"] = str(err)
if world == 2:
    os.environ["JAX_MESH_SPEC"] = specs[0]
    dcp = llama_train.run(llama_train.parse_args(
        args + ["--steps", "3", "--warmup", "6", "--data", os.environ["TOKENS"],
                "--checkpoint-dir", os.environ["CKPT"]]))
    result["dcp_first"] = dcp["losses"]
with open(out_path + ".%d" % rank, "w") as fh:
    json.dump(result, fh)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _toy_inputs():
    rng = np.random.default_rng(0)
    return {"w": (rng.standard_normal((TOY_LAYERS, TOY_DIM, TOY_DIM)) * 0.2).astype(np.float32),
            "x": rng.standard_normal((TOY_BATCH, 4, TOY_DIM)).astype(np.float32)}


def _toy_sequential(toy, pp, m):
    """(out, dw, dx) through the port's fallback: the pp stages in sequence."""
    w = torch.from_numpy(toy["w"]).requires_grad_()
    x = torch.from_numpy(toy["x"]).requires_grad_()
    stages = pipeline.split_stages(range(TOY_LAYERS), pp)

    def stage_fn(stage, h):
        for i in stages[stage]:
            h = torch.tanh(h @ w[i])
        return h

    out = pipeline.pipeline_apply(stage_fn, x, num_microbatches=m, n_stages=pp)
    (out ** 2).sum().backward()
    return out.detach().numpy(), w.grad.numpy(), x.grad.numpy()


def _toy_jax(toy, pp, m):
    from tf_operator_tpu.parallel.mesh import standard_mesh
    from tf_operator_tpu.parallel.pipeline import pipeline_apply, split_stages

    def stage_fn(p_stage, x):
        def body(carry, w):
            return jnp.tanh(carry @ w), None

        return jax.lax.scan(body, x, p_stage)[0]

    mesh = standard_mesh(8, pp=pp)

    def loss(stages, x):
        return (pipeline_apply(stage_fn, stages, x, num_microbatches=m, mesh=mesh) ** 2).sum()

    stages = split_stages(jnp.asarray(toy["w"]), pp)
    out = jax.jit(lambda s, x: pipeline_apply(stage_fn, s, x, num_microbatches=m,
                                              mesh=mesh))(stages, toy["x"])
    gs, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(stages, toy["x"])
    return np.asarray(out), np.asarray(gs).reshape(toy["w"].shape), np.asarray(gx)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"pair": [2 ranks], "quad": [4 ranks], "single": one process's
    losses and norms, "whole"/"resumed": the uninterrupted and restored
    one-process runs of 6 steps, "toy": the toy inputs}."""
    tmp = tmp_path_factory.mktemp("pipeline")
    tokens = tmp / "tokens.bin"
    data.write_token_file(str(tokens), np.random.default_rng(0).integers(
        0, 16, 50_000).astype(np.int32))
    toy = _toy_inputs()
    np.savez(tmp / "toy.npz", **toy)
    ckpt = tmp / "ckpt"
    groups = {"pair": (['{"pp": 2}'], 2),
              "quad": (['{"pp": 2, "fsdp": 2}', '{"pp": 2, "tp": 2}'], 4)}
    common = {"OMP_NUM_THREADS": "1", "TOKENS": str(tokens), "TOY_INPUTS": str(tmp / "toy.npz"),
              "CKPT": str(ckpt)}
    procs = []
    try:
        for name, (specs, n) in groups.items():
            port = _free_port()
            for r in range(n):
                env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "WORLD_SIZE": str(n), "RANK": str(r), **common}
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", WORKER, str(tmp / name), json.dumps(specs), *ARGS],
                    cwd=ROOT, env={**os.environ, **env}, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        previous = llama.CONFIGS["llama-tiny"]
        llama.CONFIGS["llama-tiny"] = TINY4
        norms = []
        real_norm = train_step.global_norm

        def recording(grads, stages=1):
            norm = real_norm(grads, stages)
            norms.append(norm.item())
            return norm

        train_step.global_norm = recording
        try:
            single = llama_train.run(llama_train.parse_args(
                [*ARGS, "--steps", "5", "--warmup", "1", "--data", str(tokens)]))["losses"]
            single_norms = list(norms)
            resume = [*ARGS, "--steps", "6", "--warmup", "6", "--data", str(tokens)]
            whole = llama_train.run(llama_train.parse_args(resume))["losses"]
            outs = [p.communicate(timeout=240)[0] for p in procs]
            resumed = llama_train.run(llama_train.parse_args(
                [*resume, "--checkpoint-dir", str(ckpt)]))
        finally:
            llama.CONFIGS["llama-tiny"] = previous
            train_step.global_norm = real_norm
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    result = {name: [json.loads((tmp / f"{name}.{r}").read_text()) for r in range(n)]
              for name, (_, n) in groups.items()}
    result.update(single=single, single_norms=single_norms, whole=whole, resumed=resumed,
                  toy=toy)
    return result


SPECS = {"pp2": ("pair", '{"pp": 2}'), "pp2_fsdp2": ("quad", '{"pp": 2, "fsdp": 2}'),
         "pp2_tp2": ("quad", '{"pp": 2, "tp": 2}')}


@pytest.mark.parametrize("layout", list(SPECS))
def test_losses_and_norms_over_pp_match_one_process(runs, layout):
    group, spec = SPECS[layout]
    single = np.array(runs["single"])
    assert single[-1] < single[0] - 0.05  # the updates moved the weights
    for rank in runs[group]:
        got = rank[spec]
        np.testing.assert_allclose(got["losses"], single, rtol=1e-5)
        np.testing.assert_allclose(got["norms"], runs["single_norms"], rtol=1e-5)


@pytest.mark.parametrize("layout", list(SPECS))
def test_each_stage_holds_its_layers_under_their_names(runs, layout):
    group, spec = SPECS[layout]
    whole = [n for n, _ in llama.Llama(TINY4, device="meta").named_parameters()]
    ranks = runs[group]
    mesh = ranks[0][spec]["mesh"]
    assert mesh["pp"] == 2
    stage = [r * 2 // len(ranks) for r in range(len(ranks))]  # pp is the outer axis
    for rank, s in zip(ranks, stage):
        names = rank[spec]["names"]
        layers = {n.split(".")[1] for n in names if n.startswith("layers.")}
        assert layers == ({"0", "1"} if s == 0 else {"2", "3"})
        assert ("tok_embeddings.weight" in names) == (s == 0)
        assert ("output.weight" in names) == (s == 1)
        assert all(n in whole for n in names)
        # M = pp = 2 microbatches: T = 3 ticks, 2 permutes forward and 2
        # backward a step.
        assert rank[spec]["ppermute"] == 5 * 2 * 2
    union = {n for rank in ranks for n in rank[spec]["names"]}
    assert union == set(whole)


@pytest.mark.parametrize("pp,m", [(2, 2), (2, 4), (4, 4), (4, 8)])
def test_pipeline_apply_matches_sequential_and_jax(runs, pp, m):
    toy = runs["toy"]
    out, dw, dx = _toy_sequential(toy, pp, m)
    ranks = runs["pair" if pp == 2 else "quad"]
    per = TOY_LAYERS // pp
    for r, rank in enumerate(ranks):
        got = rank[f"toy/{m}"]
        if r == pp - 1:
            np.testing.assert_allclose(got["out"], out, rtol=1e-5, atol=1e-6)
        else:
            assert not np.any(got["out"])
        np.testing.assert_allclose(got["dw"], dw[r * per:(r + 1) * per], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["dx"], dx if r == 0 else np.zeros_like(dx),
                                   rtol=1e-4, atol=1e-6)
        assert got["ppermute"] == 2 * (m + pp - 2)
    ref = toy["x"]
    for w in toy["w"]:
        ref = np.tanh(ref @ w)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    if not supports_partial_manual():
        pytest.skip("partial-manual shard_map (axis_names=) unsupported on this jax")
    j_out, j_dw, j_dx = _toy_jax(toy, pp, m)
    np.testing.assert_allclose(out, j_out, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dw, j_dw, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dx, j_dx, rtol=1e-4, atol=1e-6)


def test_pp_state_restores_in_one_process(runs):
    whole, resumed = runs["whole"], runs["resumed"]
    for rank in runs["pair"]:
        np.testing.assert_allclose(rank["dcp_first"], whole[:3], rtol=1e-5)
    assert (resumed["restore"].path, resumed["restore"].cause,
            resumed["restore"].step) == ("storage", "ok", 3)
    np.testing.assert_allclose(resumed["losses"], whole[3:], rtol=1e-5)


def test_refusals(runs):
    tiny = llama.CONFIGS["llama-tiny"]
    with pytest.raises(NotImplementedError, match="sown aux losses don't cross the pipeline"):
        llama.Llama(llama.CONFIGS["moe-tiny"], device="meta", pp=2)
    with pytest.raises(NotImplementedError, match="illegal inside the pp-manual region"):
        llama.Llama(dataclasses.replace(tiny, attention_impl="ring"), device="meta", pp=2)
    with pytest.raises(ValueError, match="not divisible by 2 pipeline stages"):
        llama.Llama(dataclasses.replace(tiny, n_layers=3), device="meta", pp=2)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.split_stages(range(TOY_LAYERS), 3)
    for rank in runs["pair"] + runs["quad"]:
        assert "batch 7 not divisible by" in rank["indivisible_batch"]
