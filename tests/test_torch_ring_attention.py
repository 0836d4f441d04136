"""The port's ring attention (``ops/ring_attention.py``) and the sequence
axis of ``llama_train`` on the CPU, against the JAX package.

- The ring over 2- and 4-process gloo ``sp`` groups, causal, with 4 query
  and 4 KV heads and with llama-tiny's 4 query to 2 KV heads, from seeded
  numpy inputs, against the JAX ``ring_attention`` under ``shard_map`` on
  the conftest's 8 host devices, with ``block_impl="xla"`` and with
  ``"flash_interpret"`` (the Pallas kernels in interpret mode): the output
  within 1e-5 relative, the gradients of ``sum(o * do)`` in q, k and v
  within 1e-4 relative in L2, at fp32. The K/V rotations: one a step of
  the ring forward, and one a step of its backward.
- fp32 llama-tiny under remat "dots" through the ``llama_train`` entry
  point from a seeded token file over ``{"sp": 2}`` (2 processes) and
  ``{"sp": 2, "fsdp": 2}`` (4 processes): 5 losses within 1e-5 relative of
  one process's (the lr warms up in 1 step, so the last 3 follow updates of
  the ring's gradients); "pallas" over sp is refused, the mesh's sp picks
  the ring, and the rotations number 2 a layer and step (forward and
  backward: the "dots" tape keeps the received blocks for the replay).
- The positions of sp rank r: the rope kernel's path (``ops/rope.rope``)
  takes the table's rows ``[r * s, (r + 1) * s)``.

The six processes are spawned once, together, for the whole file.
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
from functools import partial

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tf_operator_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from tf_operator_tpu.parallel.compat import rep_check_kwarg, shard_map
from tf_operator_tpu.parallel.mesh import standard_mesh as jax_standard_mesh
from tf_operator_tpu_torch.models import llama
from tf_operator_tpu_torch.ops import ring_attention
from tf_operator_tpu_torch.parallel import sharding
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import data, llama_train

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--device", "cpu", "--steps", "5", "--batch", "4", "--seq", "32", "--log-every", "1",
        "--lr", "3e-3", "--warmup", "1"]
FP32_TINY = dataclasses.replace(llama.CONFIGS["llama-tiny"], dtype=torch.float32,
                                param_dtype=torch.float32, remat=True)
RING_SHAPE = dict(b=2, s=64, h=4, d=16)
HEADS = {"mha": 4, "gqa": 2}  # KV heads
WORKER = r"""
import dataclasses, json, os, sys
import numpy as np, torch, torch.distributed as dist
from tf_operator_tpu_torch.models import llama
llama.CONFIGS["llama-tiny"] = dataclasses.replace(
    llama.CONFIGS["llama-tiny"], dtype=torch.float32, param_dtype=torch.float32, remat=True)
from tf_operator_tpu_torch.ops.ring_attention import ring_attention
from tf_operator_tpu_torch.parallel import collectives
from tf_operator_tpu_torch.train import llama_train

out_path, spec, args = sys.argv[1], sys.argv[2], sys.argv[3:]
os.environ["JAX_MESH_SPEC"] = spec
collectives.reset_counts()
out = llama_train.run(llama_train.parse_args(args))
rank, world = dist.get_rank(), dist.get_world_size()
result = {"losses": out["losses"], "mesh": out["mesh"],
          "ppermute": collectives.COUNTS["ppermute"]}
if world == 4:
    inputs = np.load(os.environ["RING_INPUTS"])
    for n in (2, 4):
        groups = [dist.new_group(list(range(i, i + n))) for i in range(0, world, n)]
        group, r = groups[rank // n], rank % n
        for case in ("mha", "gqa"):
            q, k, v, do = (torch.from_numpy(inputs[f"{case}_{x}"]) for x in "qkvo")
            piece = slice(r * q.shape[1] // n, (r + 1) * q.shape[1] // n)
            q, k, v = (t[:, piece].clone().requires_grad_() for t in (q, k, v))
            collectives.reset_counts()
            o = ring_attention(q, k, v, group)
            (o * do[:, piece]).sum().backward()
            result[f"{n}/{case}"] = {"o": o.tolist(), "dq": q.grad.tolist(),
                                     "dk": k.grad.tolist(), "dv": v.grad.tolist(),
                                     "ppermute": collectives.COUNTS["ppermute"]}
with open(out_path + ".%d" % rank, "w") as fh:
    json.dump(result, fh)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ring_inputs():
    rng = np.random.default_rng(7)
    b, s, h, d = (RING_SHAPE[x] for x in "bshd")
    out = {}
    for case, kvh in HEADS.items():
        for name, heads in (("q", h), ("k", kvh), ("v", kvh), ("o", h)):
            out[f"{case}_{name}"] = rng.standard_normal((b, s, heads, d)).astype(np.float32)
    return out


def _jax_ring(inputs, case, n, impl):
    """(o, (dq, dk, dv)) of sum(o * do) through the JAX ring over an
    ``sp=n`` mesh of the 8 host devices."""
    q, k, v, do = (inputs[f"{case}_{x}"] for x in "qkvo")
    spec = P(None, "sp", None, None)
    # The Pallas interpreter does not carry the varying-axes marks through
    # its dynamic slices (tests/test_flash_pallas.py relaxes the same check).
    relax = {rep_check_kwarg(): False} if impl == "flash_interpret" else {}
    ring = shard_map(partial(jax_ring_attention, axis_name="sp", block_impl=impl),
                     mesh=jax_standard_mesh(8, sp=n), in_specs=(spec,) * 3, out_specs=spec,
                     **relax)

    def both(q, k, v):  # the output and its pullback of do, in one program
        out, pullback = jax.vjp(ring, q, k, v)
        return out, pullback(do)

    # XLA's backend optimisations cost compile time and buy nothing here.
    out, grads = jax.jit(both).lower(q, k, v).compile(
        {"xla_backend_optimization_level": 0})(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"pair": [2 ranks], "quad": [4 ranks], "single": losses, "inputs": the
    ring's inputs}."""
    tmp = tmp_path_factory.mktemp("ring")
    tokens = tmp / "tokens.bin"
    data.write_token_file(str(tokens), np.random.default_rng(0).integers(
        0, 16, 50_000).astype(np.int32))
    inputs = _ring_inputs()
    np.savez(tmp / "ring.npz", **inputs)
    args = [*ARGS, "--data", str(tokens)]
    groups = {"pair": ('{"sp": 2}', 2), "quad": ('{"sp": 2, "fsdp": 2}', 4)}
    procs = []
    try:
        for name, (spec, n) in groups.items():
            port = _free_port()
            for r in range(n):
                env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "WORLD_SIZE": str(n), "RANK": str(r), "OMP_NUM_THREADS": "1",
                       "RING_INPUTS": str(tmp / "ring.npz")}
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", WORKER, str(tmp / name), spec, *args], cwd=ROOT,
                    env={**os.environ, **env}, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        previous = llama.CONFIGS["llama-tiny"]
        llama.CONFIGS["llama-tiny"] = FP32_TINY
        try:
            single = llama_train.run(llama_train.parse_args(args))["losses"]
        finally:
            llama.CONFIGS["llama-tiny"] = previous
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    result = {name: [json.loads((tmp / f"{name}.{r}").read_text()) for r in range(n)]
              for name, (_, n) in groups.items()}
    result.update(single=single, inputs=inputs)
    return result


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


@pytest.mark.parametrize("impl", ["xla", "flash_interpret"])
@pytest.mark.parametrize("case", ["mha", "gqa"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_ring_attention(runs, n, case, impl):
    o_ref, grads_ref = _jax_ring(runs["inputs"], case, n, impl)
    ranks = [r[f"{n}/{case}"] for r in runs["quad"][:n]]
    o = np.concatenate([r["o"] for r in ranks], axis=1)
    err = np.abs(o - o_ref).max() / np.abs(o_ref).max()
    assert err <= 1e-5, err
    for name, ref in zip(("dq", "dk", "dv"), grads_ref):
        got = np.concatenate([r[name] for r in ranks], axis=1)
        assert rel_err(got, ref) <= 1e-4, name
        assert np.linalg.norm(ref) > 0
    # n - 1 rotations of the stacked K/V forward, as many backward.
    assert [r["ppermute"] for r in ranks] == [2 * (n - 1)] * n


@pytest.mark.parametrize("layout", ["pair", "quad"])
def test_losses_over_sp_match_one_process(runs, layout):
    single = np.array(runs["single"])
    assert single[-1] < single[0] - 0.05  # the updates moved the weights
    for rank in runs[layout]:
        np.testing.assert_allclose(rank["losses"], single, rtol=1e-5)


def test_sp_layouts_and_rotations(runs):
    assert runs["pair"][0]["mesh"] == {"fsdp": 1, "sp": 2}
    assert runs["quad"][0]["mesh"] == {"fsdp": 2, "sp": 2}
    # 5 steps x 2 layers x (1 forward + 1 backward) rotations; the replay's
    # are served by the "dots" tape.
    for rank in runs["pair"] + runs["quad"]:
        assert rank["ppermute"] == 5 * FP32_TINY.n_layers * 2


def test_the_mesh_picks_the_ring_and_refuses_other_attention():
    axes = {"fsdp": 1, "sp": 2}
    assert llama_train.pick_attention(FP32_TINY, axes).attention_impl == "ring"
    assert llama_train.pick_attention(FP32_TINY, {"fsdp": 2}).attention_impl == "pallas"
    for impl in ("pallas", "xla"):
        with pytest.raises(ValueError, match="over sp the model runs attention_impl='ring'"):
            sharding.check_shardable(dataclasses.replace(FP32_TINY, attention_impl=impl), axes)
    sharding.check_shardable(dataclasses.replace(FP32_TINY, attention_impl="ring"), axes)
    # An MoE model trains over sp too, on the ring; any other attention is
    # refused for it as for a dense model.
    sharding.check_shardable(dataclasses.replace(
        llama.CONFIGS["moe-tiny"], attention_impl="ring"), axes)
    with pytest.raises(ValueError, match="over sp the model runs attention_impl='ring'"):
        sharding.check_shardable(llama.CONFIGS["moe-tiny"], axes)


def test_sp_rank_positions_take_the_rope_kernel_path(monkeypatch):
    cfg = dataclasses.replace(FP32_TINY, max_seq_len=32)
    model = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    calls = []
    real = llama.rope

    def recording(x, cos, sin, tag=None):
        calls.append((cos, sin))
        return real(x, cos, sin, tag)

    monkeypatch.setattr(llama, "rope", recording)
    cos, sin = llama.rope_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 16))).long()
    for rank in (0, 1):
        calls.clear()
        model.sp_rank, model.sp_size = rank, 2
        model(tokens)
        # q and k of each layer, through the kernel's wrapper, on rows
        # [16 r, 16 (r + 1)) of the tables.
        assert len(calls) == 2 * cfg.n_layers
        for c, s in calls:
            torch.testing.assert_close(c, cos[16 * rank:16 * (rank + 1)], rtol=0, atol=0)
            torch.testing.assert_close(s, sin[16 * rank:16 * (rank + 1)], rtol=0, atol=0)


def test_no_sp_group_is_causal_flash():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 32, 4, 16)).astype(np.float32))
               for _ in range(3))
    from tf_operator_tpu_torch.ops.flash import flash_attention

    torch.testing.assert_close(ring_attention.ring_attention(q, k, v),
                               flash_attention(q, k, v, causal=True), rtol=0, atol=0)
    # The block choice of the JAX module's switch.
    assert [ring_attention.block_mode(i, 2) for i in range(4)] == [
        ring_attention.FULL, ring_attention.FULL, ring_attention.DIAGONAL, ring_attention.SKIP]
