"""The port's sharding (``parallel/mesh.py``, ``parallel/sharding.py``,
``train_step.init_sharded_train_state``) on the CPU.

The tensor-parallel rules put tp where the JAX package's ``_PARAM_RULES``
put it on every block weight, the embedding and the head. Every axis of
the JAX package is kept, ``ep``, ``sp`` and ``pp`` at size 1 too; only
the JAX package's own refusals remain. Two
2-process gloo runs of the ``llama_train`` entry point on llama-tiny at
fp32 under remat "dots", from a token file, one with mesh fsdp=2 (from
the JAXJob env) and one with tp=2 (from a PyTorchJob's c10d env): the born-sharded weights
are bit-equal to the unsharded init, and the loss sequence of 5 steps is
the single-process one (1e-5 relative: only the order of the sums
differs). The lr warms up in 1 step, so the last 3 losses come from
weights that 1-3 updates of the sharded gradients, norm and AdamW moved.
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
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tf_operator_tpu.parallel.sharding import spec_for_param
from tf_operator_tpu_torch.models import bert, llama
from tf_operator_tpu_torch.parallel import mesh as port_mesh
from tf_operator_tpu_torch.parallel import sharding
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import data, llama_train

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--device", "cpu", "--steps", "5", "--batch", "4", "--seq", "32",
        "--log-every", "1", "--lr", "3e-3", "--warmup", "1"]
FP32_TINY = dataclasses.replace(llama.CONFIGS["llama-tiny"], dtype=torch.float32,
                                param_dtype=torch.float32, remat=True)
WORKER = r"""
import dataclasses, json, sys
import torch, torch.distributed as dist
from tf_operator_tpu_torch.models import llama
llama.CONFIGS["llama-tiny"] = dataclasses.replace(
    llama.CONFIGS["llama-tiny"], dtype=torch.float32, param_dtype=torch.float32, remat=True)
from tf_operator_tpu_torch.parallel.sharding import data_coords
from tf_operator_tpu_torch.train import llama_train

args = llama_train.parse_args(sys.argv[2:])
s = llama_train.setup(args)
ref = llama.Llama(s.config, device="cpu", generator=torch.Generator().manual_seed(0))
sharded = list(s.state.model.named_parameters())
result = {
    "names": [n for n, _ in sharded],
    "ref_names": [n for n, _ in ref.named_parameters()],
    "init_equal": [torch.equal(p.full_tensor(), r)
                   for (_, p), r in zip(sharded, ref.parameters())],
    "placements": {n: [repr(x) for x in p.placements] for n, p in sharded},
    "mesh_dims": {n: list(p.device_mesh.mesh_dim_names) for n, p in sharded},
    "data_coords": list(data_coords(s.mesh)),
    "local_batch": s.local_batch,
}
out = llama_train.run(args)
result.update(losses=out["losses"], mesh=out["mesh"])
with open(sys.argv[1] + ".%d" % dist.get_rank(), "w") as fh:
    json.dump(result, fh)
dist.destroy_process_group()
"""


# ------------------------------------------------------------------ rules
def _jax_style(path, shape, inputs, mesh):
    """Where the JAX rules put tp on a kernel: on an input axis ("rowwise"),
    an output axis ("colwise"), or nowhere (None)."""
    spec = tuple(spec_for_param(path, len(shape), mesh, shape=shape))
    if "tp" not in spec:
        return None
    return "rowwise" if spec.index("tp") in inputs else "colwise"


def test_tp_rules_match_the_jax_rules():
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("fsdp", "tp"))
    cases = {  # port name: (JAX path, kernel shape, its input axes)
        "layers.0.attention.wq.weight": ("params/layers/attention/wq/kernel", (2, 64, 4, 16), {1}),
        "layers.0.attention.wk.weight": ("params/layers/attention/wk/kernel", (2, 64, 2, 16), {1}),
        "layers.0.attention.wv.weight": ("params/layers/attention/wv/kernel", (2, 64, 2, 16), {1}),
        "layers.0.attention.wo.weight": ("params/layers/attention/wo/kernel", (2, 4, 16, 64), {1, 2}),
        "layers.1.feed_forward.w1.weight": ("params/layers/feed_forward/w1/kernel", (2, 64, 128), {1}),
        "layers.1.feed_forward.w3.weight": ("params/layers/feed_forward/w3/kernel", (2, 64, 128), {1}),
        "layers.1.feed_forward.w2.weight": ("params/layers/feed_forward/w2/kernel", (2, 128, 64), {1}),
        "layers.1.attention_norm.scale": ("params/layers/attention_norm/scale", (2, 64), set()),
        "norm.scale": ("params/norm/scale", (64,), set()),
        # The embedding [vocab, d] splits its d over tp, the head [d, vocab]
        # its vocab: the output axis of each, torch's colwise split of an
        # Embedding and of a Linear.
        "tok_embeddings.weight": ("params/tok_embeddings/embedding", (256, 64), {0}),
        "output.weight": ("params/output/kernel", (64, 256), {0}),
    }
    for name, (path, shape, inputs) in cases.items():
        assert sharding.tp_style(name) == _jax_style(path, shape, inputs, mesh), name
    model = llama.Llama(FP32_TINY, device="meta")
    names = {n for n, _ in model.named_parameters()}
    styled = {n for n in names if sharding.tp_style(n)}
    assert len(styled) == 7 * FP32_TINY.n_layers + 2
    assert sharding.DATA_AXES == ("slice", "dp", "fsdp", "ep")


def test_unported_axes_are_refused():
    # Every axis of the JAX package is ported: sp and pp are kept in the
    # DeviceMesh, in AXIS_ORDER, as the JAX make_mesh keeps them.
    assert not hasattr(port_mesh, "NOT_PORTED")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        kept = [port_mesh.mesh_axes(port_mesh.make_mesh(port_mesh.MeshSpec(axes), "cpu"))
                for axes in ({"sp": 1}, {"pp": 1, "fsdp": 1})]
        standard = port_mesh.mesh_axes(port_mesh.standard_mesh(1, device_type="cpu"))
    finally:
        dist.destroy_process_group()
    assert kept == [{"fsdp": 1, "sp": 1}, {"pp": 1, "fsdp": 1}]
    assert standard == {"fsdp": 1}
    with pytest.raises(ValueError, match="not divisible by slice\\*pp\\*dp\\*ep\\*sp\\*tp=4"):
        port_mesh.standard_mesh(6, sp=2, pp=2, device_type="cpu")
    # The refusals that remain are the JAX package's own: MoE and ring
    # attention under a pipeline (models/llama.py). BERT trains on any
    # mesh, data parallel over the whole world, as the JAX example does.
    for axes in ({"fsdp": 1, "sp": 2}, {"pp": 2, "fsdp": 1}, {"fsdp": 2, "tp": 2}):
        sharding.check_shardable(bert.CONFIGS["bert-tiny"], axes)
    with pytest.raises(ValueError, match="vocab_size=256 over tp=3"):
        sharding.check_shardable(llama.CONFIGS["llama-tiny"], {"fsdp": 1, "tp": 3})
    ring = dataclasses.replace(llama.CONFIGS["llama-tiny"], attention_impl="ring")
    sharding.check_shardable(ring, {"fsdp": 2, "sp": 2})
    sharding.check_shardable(llama.CONFIGS["llama-tiny"], {"pp": 2, "fsdp": 2})
    with pytest.raises(ValueError, match="unknown mesh axis"):
        port_mesh.MeshSpec({"model": 2})
    # ep is ported: a declared ep is kept, at size 1 too, as the JAX
    # make_mesh keeps it; an MoE model's experts go over ep or tp.
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        mesh = port_mesh.make_mesh(port_mesh.MeshSpec({"ep": 1}), "cpu")
    finally:
        dist.destroy_process_group()
    assert port_mesh.mesh_axes(mesh) == {"fsdp": 1, "ep": 1}
    ring_moe = dataclasses.replace(llama.CONFIGS["moe-tiny"], attention_impl="ring")
    for axes in ({"fsdp": 1, "tp": 2}, {"fsdp": 2, "ep": 2}):
        sharding.check_shardable(llama.CONFIGS["moe-tiny"], axes)
    for axes in ({"fsdp": 1, "sp": 2}, {"fsdp": 1, "ep": 2, "sp": 2}, {"sp": 2, "tp": 2}):
        sharding.check_shardable(ring_moe, axes)
    sharding.check_shardable(llama.CONFIGS["llama-tiny"], {"fsdp": 1, "tp": 2})
    assert port_mesh.AXIS_ORDER == ("slice", "pp", "dp", "fsdp", "ep", "sp", "tp")


# ------------------------------------------------------------ 2 processes
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"fsdp": [rank 0, rank 1], "tp": [...], "single": losses}."""
    tmp = tmp_path_factory.mktemp("sharding")
    tokens = tmp / "tokens.bin"
    # Ids from 16 of the 256: a distribution the first updates learn, so
    # the loss falls from step to step.
    data.write_token_file(str(tokens), np.random.default_rng(0).integers(
        0, 16, 50_000).astype(np.int32))
    args = [*ARGS, "--data", str(tokens)]
    fsdp_port, tp_port = _free_port(), _free_port()
    envs = {
        "fsdp": [{"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{fsdp_port}",
                  "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(r),
                  "JAX_MESH_SPEC": '{"fsdp": 2}'} for r in range(2)],
        "tp": [{"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(tp_port),
                "WORLD_SIZE": "2", "RANK": str(r), "JAX_MESH_SPEC": '{"tp": 2}'}
               for r in range(2)],
    }
    procs = []
    try:
        for name, pair in envs.items():
            for env in pair:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", WORKER, str(tmp / name), *args], cwd=ROOT,
                    env={**os.environ, "OMP_NUM_THREADS": "1", **env},
                    stdout=subprocess.PIPE,
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
    result = {name: [json.loads((tmp / f"{name}.{r}").read_text()) for r in range(2)]
              for name in envs}
    result["single"] = single
    return result


@pytest.mark.parametrize("layout", ["fsdp", "tp"])
def test_born_sharded_init_is_bit_equal(runs, layout):
    for rank in runs[layout]:
        assert rank["names"] == rank["ref_names"]
        assert all(rank["init_equal"])


@pytest.mark.parametrize("layout", ["fsdp", "tp"])
def test_loss_sequence_matches_single_process(runs, layout):
    single = np.array(runs["single"])
    # The updates moved the weights: the later losses fall well below the
    # first ones, so a wrong sharded gradient would show in them.
    assert single[-1] < single[0] - 0.05
    for rank in runs[layout]:
        np.testing.assert_allclose(rank["losses"], single, rtol=1e-5)


def test_layouts(runs):
    fsdp, tp = runs["fsdp"][0], runs["tp"][0]
    assert fsdp["mesh"] == {"fsdp": 2} and tp["mesh"] == {"fsdp": 1, "tp": 2}
    wq, wo = "layers.0.attention.wq.weight", "layers.0.attention.wo.weight"
    assert fsdp["placements"][wq] == ["Shard(dim=0)"] and fsdp["mesh_dims"][wq] == ["fsdp"]
    assert tp["mesh_dims"][wq] == ["fsdp", "tp"]
    assert tp["placements"][wq][1] == "Shard(dim=0)"  # output features over tp
    assert tp["placements"][wo][1] == "Shard(dim=1)"  # input features over tp
    # The head's vocab and the embedding's d over tp, both also over fsdp.
    assert tp["mesh_dims"]["output.weight"] == ["fsdp", "tp"]
    assert tp["placements"]["output.weight"][1] == "Shard(dim=0)"
    assert tp["placements"]["tok_embeddings.weight"][1] == "Shard(dim=1)"
    # Data ranks: fsdp ranks read disjoint halves; tp ranks the same batch.
    assert [r["data_coords"] for r in runs["fsdp"]] == [[0, 2], [1, 2]]
    assert [r["data_coords"] for r in runs["tp"]] == [[0, 1], [0, 1]]
    assert [r["local_batch"] for r in runs["fsdp"] + runs["tp"]] == [2, 2, 4, 4]
