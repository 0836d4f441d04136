"""The embedding and the head over ``tp`` (``parallel/sharding.py``
``_vocab_parallel``, ``models/llama.py`` ``Llama.tp_mesh``,
``ops/cross_entropy.py`` ``vocab_parallel_cross_entropy``) on the CPU,
against the JAX package and against one process.

- The vocab-parallel chunked loss over a 2-rank gloo ``tp`` group, each
  rank with half of the head's 256 rows, against the JAX
  ``chunked_cross_entropy`` (``tf_operator_tpu/train/train_step.py``) on
  the whole head, from seeded fp32 numpy inputs at chunk 16 over 40
  positions (one chunk padded), with ``ignore_id`` targets among them:
  the loss within 1e-5 relative, the hidden state's gradient (summed over
  tp) and each rank's rows of the head's gradient within 1e-5 relative in
  L2. The same form over 2 and 4 shards stacked in one process
  (``StackedShards``, as ``chip_smoke.py`` phase s runs it) against the
  port's unsharded chunked loss.
- fp32 llama-tiny under remat "dots" through the ``llama_train`` entry
  point from a seeded token file on 4 gloo processes over ``{"fsdp": 2,
  "tp": 2}``, ``{"sp": 2, "tp": 2}`` and ``{"pp": 2, "tp": 2}``: the
  embedding's d and the head's vocab over tp (and fsdp), the born-sharded
  weights bit-equal to the unsharded init, and 5 losses within 1e-5
  relative of one process's. An ``{"fsdp": 2, "tp": 2}`` state saved
  through DCP after 3 steps and resumed to 6 gives the uninterrupted
  run's losses.

The four processes are spawned once, together, for the whole file.
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

from tf_operator_tpu.train import train_step as jax_ts
from tf_operator_tpu_torch.models import llama
from tf_operator_tpu_torch.ops import cross_entropy
from tf_operator_tpu_torch.train import data, llama_train

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--device", "cpu", "--batch", "4", "--seq", "32", "--log-every", "100", "--lr",
        "3e-3"]
FP32_TINY = dataclasses.replace(llama.CONFIGS["llama-tiny"], dtype=torch.float32,
                                param_dtype=torch.float32, remat=True)
LAYOUTS = {"fsdp_tp": '{"fsdp": 2, "tp": 2}', "sp_tp": '{"sp": 2, "tp": 2}',
           "pp_tp": '{"pp": 2, "tp": 2}'}
LOSS_SHAPE = dict(b=3, s=40, d=32, vocab=256, chunk=16)
WORKER = r"""
import dataclasses, json, os, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from tf_operator_tpu_torch.models import llama
llama.CONFIGS["llama-tiny"] = dataclasses.replace(
    llama.CONFIGS["llama-tiny"], dtype=torch.float32, param_dtype=torch.float32, remat=True)
from tf_operator_tpu_torch.ops import cross_entropy
from tf_operator_tpu_torch.train import llama_train

out_path, args = sys.argv[1], sys.argv[2:]
tokens = ["--data", os.environ["TOKENS"]]
result = {}


def train(spec):
    os.environ["JAX_MESH_SPEC"] = spec
    argv = llama_train.parse_args(args + tokens + ["--steps", "5", "--warmup", "1"])
    s = llama_train.setup(argv)
    ref = llama.Llama(s.config, device="cpu", generator=torch.Generator().manual_seed(0))
    whole = dict(ref.named_parameters())
    named = list(s.state.model.named_parameters())
    out = {"init_equal": [torch.equal(p.full_tensor(), whole[n]) for n, p in named],
           "held": sorted(n for n, _ in named),
           "placements": {n: [repr(x) for x in p.placements] for n, p in named
                          if n in ("tok_embeddings.weight", "output.weight")},
           "mesh_dims": {n: list(p.device_mesh.mesh_dim_names) for n, p in named
                         if n in ("tok_embeddings.weight", "output.weight")}}
    del s, ref, named
    run = llama_train.run(argv)
    out.update(losses=run["losses"], mesh=run["mesh"])
    return out


for name, spec in LAYOUTS.items():
    result[name] = train(spec)
rank = dist.get_rank()

# A DCP save under the new layout restores into it.
os.environ["JAX_MESH_SPEC"] = LAYOUTS["fsdp_tp"]
resume = args + tokens + ["--warmup", "6"]
ckpt = os.environ["CKPT"]
whole = llama_train.run(llama_train.parse_args(resume + ["--steps", "6"]))
first = llama_train.run(llama_train.parse_args(resume + ["--steps", "3", "--checkpoint-dir",
                                                         ckpt]))
again = llama_train.run(llama_train.parse_args(resume + ["--steps", "6", "--checkpoint-dir",
                                                         ckpt]))
result["dcp"] = {"whole": whole["losses"], "first": first["losses"],
                 "resumed": again["losses"],
                 "restore": [again["restore"].path, again["restore"].cause,
                             again["restore"].step]}

# The vocab-parallel loss over the tp group of a {"fsdp": 2, "tp": 2} mesh.
ref = np.load(os.environ["LOSS_INPUTS"])
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("fsdp", "tp"))
tp = mesh["tp"]
rows = ref["weight"].shape[0] // tp.size()
mine = slice(tp.get_local_rank() * rows, (tp.get_local_rank() + 1) * rows)
h = torch.from_numpy(ref["hidden"]).requires_grad_()
w = torch.from_numpy(ref["weight"][mine]).requires_grad_()
loss = cross_entropy.vocab_parallel_cross_entropy(
    h, w, torch.from_numpy(ref["targets"]).long(), cross_entropy.VocabGroup(tp.get_group()),
    chunk=CHUNK)
loss.backward()
result["loss"] = {"tp_rank": tp.get_local_rank(), "loss": loss.item(),
                  "dh": h.grad.tolist(), "dw": w.grad.tolist()}
with open(out_path + ".%d" % rank, "w") as fh:
    json.dump(result, fh)
dist.destroy_process_group()
""".replace("LAYOUTS", repr(LAYOUTS)).replace("CHUNK", str(LOSS_SHAPE["chunk"]))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _loss_inputs():
    """Seeded fp32 hidden [b, s, d], head [vocab, d] (the Linear layout)
    and targets [b, s], every fifth an ``ignore_id`` (-1)."""
    b, s, d, v = (LOSS_SHAPE[x] for x in ("b", "s", "d", "vocab"))
    rng = np.random.default_rng(3)
    targets = rng.integers(0, v, (b, s))
    targets[:, ::5] = -1
    return {"hidden": rng.standard_normal((b, s, d)).astype(np.float32),
            "weight": (0.3 * rng.standard_normal((v, d))).astype(np.float32),
            "targets": targets.astype(np.int32)}


def _jax_loss(inputs):
    """(loss, d hidden, d head [vocab, d]) of the JAX chunked loss on the
    whole head (its kernel [d, vocab])."""
    def loss(hidden, kernel):
        return jax_ts.chunked_cross_entropy(hidden, kernel, jnp.asarray(inputs["targets"]),
                                            chunk=LOSS_SHAPE["chunk"])

    value, (dh, dk) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        inputs["hidden"], inputs["weight"].T)
    return float(value), np.asarray(dh), np.asarray(dk).T


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": [4 ranks], "single": losses, "jax": the JAX loss's (loss,
    dh, dw)}."""
    tmp = tmp_path_factory.mktemp("vocab_parallel")
    tokens = tmp / "tokens.bin"
    data.write_token_file(str(tokens), np.random.default_rng(0).integers(
        0, 16, 50_000).astype(np.int32))
    inputs = _loss_inputs()
    np.savez(tmp / "loss.npz", **inputs)
    port = _free_port()
    procs = []
    try:
        for r in range(4):
            env = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": "4",
                   "JAX_PROCESS_ID": str(r), "OMP_NUM_THREADS": "1", "TOKENS": str(tokens),
                   "CKPT": str(tmp / "ckpt"), "LOSS_INPUTS": str(tmp / "loss.npz")}
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(tmp / "rank"), *ARGS], cwd=ROOT,
                env={**os.environ, **env}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        jax_result = _jax_loss(inputs)
        previous = llama.CONFIGS["llama-tiny"]
        llama.CONFIGS["llama-tiny"] = FP32_TINY
        try:
            single = llama_train.run(llama_train.parse_args(
                [*ARGS, "--data", str(tokens), "--steps", "5", "--warmup", "1"]))["losses"]
        finally:
            llama.CONFIGS["llama-tiny"] = previous
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    ranks = [json.loads((tmp / f"rank.{r}").read_text()) for r in range(4)]
    return {"ranks": ranks, "single": single, "jax": jax_result, "inputs": inputs}


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def test_vocab_parallel_loss_matches_jax(runs):
    loss, dh, dw = runs["jax"]
    rows = LOSS_SHAPE["vocab"] // 2
    for rank in runs["ranks"]:
        got = rank["loss"]
        r = got["tp_rank"]
        assert got["loss"] == pytest.approx(loss, rel=1e-5)
        assert rel_err(got["dh"], dh) < 1e-5
        assert rel_err(got["dw"], dw[r * rows:(r + 1) * rows]) < 1e-5
    # The ignored targets' rows give the head nothing: their hidden
    # gradient is 0 in both.
    assert np.abs(dh[:, ::5]).max() == 0.0
    assert np.abs(np.asarray(runs["ranks"][0]["loss"]["dh"])[:, ::5]).max() == 0.0


@pytest.mark.parametrize("shards", [2, 4])
def test_stacked_shards_give_the_unsharded_chunked_loss(shards):
    inputs = _loss_inputs()
    targets = torch.from_numpy(inputs["targets"]).long()

    def grads(fn, weight):
        h = torch.from_numpy(inputs["hidden"]).requires_grad_()
        w = weight.clone().requires_grad_()
        value = fn(h, w)
        value.backward()
        return value, h.grad, w.grad

    whole = torch.from_numpy(inputs["weight"])
    want = grads(lambda h, w: cross_entropy.chunked_cross_entropy(
        h, w, targets, chunk=LOSS_SHAPE["chunk"]), whole)
    got = grads(lambda h, w: cross_entropy.vocab_parallel_cross_entropy(
        h, w, targets, cross_entropy.StackedShards(shards), chunk=LOSS_SHAPE["chunk"]),
        whole.view(shards, -1, whole.shape[1]))
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(got[2].view_as(whole), want[2], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_born_sharded_init_is_bit_equal(runs, layout):
    for rank in runs["ranks"]:
        assert rank[layout]["init_equal"] and all(rank[layout]["init_equal"])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_losses_match_one_process(runs, layout):
    single = np.array(runs["single"])
    assert single[-1] < single[0] - 0.05  # the updates moved the weights
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank[layout]["losses"], single, rtol=1e-5)


def test_embedding_and_head_split_over_tp(runs):
    for rank in runs["ranks"]:
        fsdp = rank["fsdp_tp"]
        assert fsdp["mesh"] == {"fsdp": 2, "tp": 2}
        # The head's vocab (dim 0) and the embedding's d (dim 1) over tp,
        # both over fsdp too, as the JAX rules' (fsdp, tp).
        assert fsdp["mesh_dims"]["output.weight"] == ["fsdp", "tp"]
        assert fsdp["placements"]["output.weight"][1] == "Shard(dim=0)"
        assert fsdp["placements"]["tok_embeddings.weight"][1] == "Shard(dim=1)"
        # A pipeline stage holds the embedding (stage 0) or the head (the
        # last), each split over tp.
        pp = rank["pp_tp"]
        held = {n for n in ("tok_embeddings.weight", "output.weight") if n in pp["held"]}
        assert len(held) == 1
        name = held.pop()
        assert pp["placements"][name][-1] == ("Shard(dim=0)" if name == "output.weight"
                                              else "Shard(dim=1)")


def test_tp_state_resumes_through_dcp(runs):
    for rank in runs["ranks"]:
        dcp = rank["dcp"]
        assert dcp["restore"] == ["storage", "ok", 3]
        np.testing.assert_allclose(dcp["first"], dcp["whole"][:3], rtol=1e-6)
        np.testing.assert_allclose(dcp["resumed"], dcp["whole"][3:], rtol=1e-6)
