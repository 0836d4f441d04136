"""The port's BERT (``models/bert.py``, ``train/bert_train.py``) against the
JAX package's, on the CPU: fp32 bert-tiny from the same weights, carried
across by ``models/convert.py``, at batch 2 and seq 32. The weights are the
JAX init's with every bias and LayerNorm parameter (zeros and ones there)
moved by seeded noise, so that a swapped or dropped one shows.

Tolerances, fp32: logits, with and without a padding mask, 1e-5 relative
to the largest logit (the frameworks sum in other orders; the port's plain
flash recurrence against JAX's XLA attention); the loss of the shared
``loss_fn`` (the chunked cross entropy over the tied head with its bias) to
1e-5 relative, and each gradient to 1e-4 relative in L2. The attention key
bias adds q.b to every score of a query's row, which the softmax cancels:
its exact gradient is 0, and both packages' are held to 1e-4 of the query
bias's gradient norm. Two AdamW steps of ``train_step.adamw`` on the JAX
gradients (the second scaled by -0.5, so that the moments' decay rates
show) against ``optax.adamw(1e-4, weight_decay=0.01)``: each parameter
within 1e-3 of its change plus two units in the last place of its fp32
value (the rounding of p + change, which the two order differently).
Remat against no remat: 1e-6 (the replay recomputes the same fp32
operations).
"""

import dataclasses
import functools
import importlib.util
import json
import math
import os
import pathlib
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tf_operator_tpu.models import bert as jax_bert
from tf_operator_tpu.train import train_step as jax_ts
from tf_operator_tpu_torch.models import bert, convert
from tf_operator_tpu_torch.ops import flash
from tf_operator_tpu_torch.parallel import sharding
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import bert_train
from tf_operator_tpu_torch.train import train_step as ts

EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples/jax/bert/bert_train.py"
SEQ, BATCH = 32, 2
TOKENS = np.random.default_rng(1).integers(0, 256, (BATCH, SEQ), np.int32)
LM_BATCH = np.random.default_rng(2).integers(0, 256, (BATCH, SEQ + 1), np.int32)
MASK = np.ones((BATCH, SEQ), bool)
MASK[1, 20:] = False  # the second sequence padded after 20 tokens
ADAMW = dict(learning_rate=1e-4, weight_decay=0.01)
GRAD_SCALES = (1.0, -0.5)  # the gradients of each AdamW step


def configs(**changes):
    """(JAX config, port config) of fp32 bert-tiny with ``changes``."""
    jcfg = dataclasses.replace(jax_bert.CONFIGS["bert-tiny"], dtype=jnp.float32,
                               param_dtype=jnp.float32, **changes)
    tcfg = dataclasses.replace(bert.CONFIGS["bert-tiny"], dtype=torch.float32,
                               param_dtype=torch.float32, **changes)
    return jcfg, tcfg


def moved(params):
    """Every bias and LayerNorm scale moved by seeded noise."""
    rng = np.random.default_rng(3)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = []
    for path, leaf in flat:
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("bias", "scale", "mlm_bias"):
            leaf = leaf + 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
        leaves.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, leaves)


@functools.cache
def reference():
    """The JAX side, in one compiled call: logits with and without the
    padding mask, the train step's ``loss_fn`` and its gradients, and the
    parameters after an update of optax.adamw on those gradients for each
    of GRAD_SCALES. Returned as numpy, parameter trees as the port's
    state_dicts."""
    jmodel = jax_bert.Bert(configs()[0])
    params = moved({"params": jax.tree.map(
        np.asarray, jax_bert.init_params(jmodel, jax.random.PRNGKey(0), seq=SEQ))})
    tx = optax.adamw(ADAMW["learning_rate"], weight_decay=ADAMW["weight_decay"])

    def run(params):
        logits = jmodel.apply(params, TOKENS)
        masked = jmodel.apply(params, TOKENS, attention_mask=MASK)
        loss, grads = jax.value_and_grad(lambda p: jax_ts.loss_fn(jmodel, p, LM_BATCH))(params)
        stepped, opt_state = params, tx.init(params)
        for scale in GRAD_SCALES:
            scaled = jax.tree.map(lambda g: scale * g, grads)
            updates, opt_state = tx.update(scaled, opt_state, stepped)
            stepped = optax.apply_updates(stepped, updates)
        return logits, masked, loss, grads, stepped

    # XLA's backend optimisations cost compile time and buy nothing here.
    compiled = jax.jit(run).lower(params).compile({"xla_backend_optimization_level": 0})
    logits, masked, loss, grads, stepped = compiled(params)

    def state(tree):
        return convert.bert_flax_to_state_dict(jax.tree.map(np.asarray, tree))

    return {"params": params, "state": state(params), "logits": np.asarray(logits),
            "masked": np.asarray(masked), "loss": float(loss), "grads": state(grads),
            "stepped": state(stepped)}


def build(**changes):
    model = bert.Bert(configs(**changes)[1], device="cpu")
    model.load_state_dict(reference()["state"])
    return model


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def assert_logits(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def assert_grads(grads, ref, tol=1e-4):
    for name, g in grads.items():
        if name.endswith(".key.bias"):  # exactly 0: rounding noise on both sides
            scale = np.linalg.norm(ref[name.replace(".key.", ".query.")])
            assert np.linalg.norm(g) <= 1e-4 * scale, name
            assert np.linalg.norm(ref[name]) <= 1e-4 * scale, name
            continue
        assert rel_err(g, ref[name]) < tol, name


def port_loss_and_grads(model):
    loss = ts.loss_fn(model, torch.from_numpy(LM_BATCH).long())
    loss.backward()
    return loss.item(), {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def test_converter_maps_every_flax_leaf_to_one_parameter():
    params = reference()["params"]
    state = reference()["state"]
    model = bert.Bert(bert.CONFIGS["bert-tiny"], device="cpu")
    assert len(jax.tree.leaves(params)) == len(state)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    p = params["params"]
    q = p["layer_1"]["attention"]["query"]
    np.testing.assert_array_equal(state["layers.1.attention.query.weight"].numpy(),
                                  q["kernel"].reshape(q["kernel"].shape[0], -1).T)
    np.testing.assert_array_equal(state["layers.1.attention.query.bias"].numpy(),
                                  q["bias"].reshape(-1))
    np.testing.assert_array_equal(state["layers.0.ffn_in.weight"].numpy(),
                                  p["layer_0"]["ffn_in"]["kernel"].T)
    np.testing.assert_array_equal(state["mlm_bias"].numpy(), p["mlm_bias"])
    # LayerNorms and the MLM bias stay fp32 whatever param_dtype says.
    assert model.layers[0].ln_attn.scale.dtype == torch.float32
    assert model.mlm_bias.dtype == torch.float32
    assert model.layers[0].ffn_in.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "padding_mask"])
def test_logits_match_jax(masked):
    model = build()
    with torch.no_grad():
        if masked:
            logits = model(torch.from_numpy(TOKENS).long(),
                           attention_mask=torch.from_numpy(MASK))
        else:
            logits = model(torch.from_numpy(TOKENS).long())
    assert logits.dtype == torch.float32
    assert_logits(logits.numpy(), reference()["masked" if masked else "logits"])


def test_padding_mask_changes_the_padded_sequence_only():
    ref = reference()
    np.testing.assert_array_equal(ref["masked"][0], ref["logits"][0])
    assert rel_err(ref["masked"][1], ref["logits"][1]) > 1e-3


def test_exact_gelu_would_fail_the_parity(monkeypatch):
    """Flax's nn.gelu is the tanh approximation; F.gelu's default is exact."""
    monkeypatch.setattr(bert, "gelu", F.gelu)
    with torch.no_grad():
        logits = build()(torch.from_numpy(TOKENS).long()).numpy()
    with pytest.raises(AssertionError):
        assert_logits(logits, reference()["logits"])


def test_loss_fn_loss_and_grads_match_jax():
    """The bench's loss: next-token CE through the chunked head with the
    MLM bias (JAX: loss_fn via head_kernel_and_bias)."""
    loss, grads = port_loss_and_grads(build())
    assert loss == pytest.approx(reference()["loss"], rel=1e-5)
    assert_grads(grads, {n: t.numpy() for n, t in reference()["grads"].items()})
    assert np.linalg.norm(grads["mlm_bias"]) > 0


def test_adamw_steps_match_optax():
    """train_step.adamw is optax.adamw: constant learning rate, no clip,
    b2 0.999, eps 1e-8, decay on every parameter."""
    model = build()
    opt = ts.adamw(**ADAMW)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    before = {n: p.detach().clone().numpy() for n, p in zip(names, params)}
    grads = [reference()["grads"][n] for n in names]
    state = opt.init(params)
    for scale in GRAD_SCALES:
        state = opt.update_(params, [scale * g for g in grads], state)
    assert state.count == len(GRAD_SCALES)
    assert opt.schedule(0) == opt.schedule(1000) == ADAMW["learning_rate"]
    for n, p in zip(names, params):
        want = reference()["stepped"][n].numpy()
        bound = 1e-3 * np.abs(want - before[n]) + 2 * np.spacing(np.abs(before[n]))
        assert (np.abs(p.detach().numpy() - want) <= bound).all(), n
        assert np.abs(want - before[n]).max() > 1e-5, n


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_remat_gives_the_no_remat_grads_and_replays_flash(monkeypatch, policy):
    """BERT's "dots" keeps the products only (JAX's dots_with_no_batch_
    dims_saveable): the flash forward runs again in each layer's replay."""
    calls = []
    plain = flash.flash_forward_plain
    monkeypatch.setattr(flash, "flash_forward_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    loss, grads = port_loss_and_grads(build())
    no_remat_calls = len(calls)
    model = build(remat=True, remat_policy=policy)
    assert "flash" not in model.layers[0].saves
    calls.clear()
    rloss, rgrads = port_loss_and_grads(model)
    n_layers = bert.CONFIGS["bert-tiny"].n_layers
    assert (no_remat_calls, len(calls)) == (n_layers, 2 * n_layers)
    assert rloss == pytest.approx(loss, rel=1e-6)
    for name, g in rgrads.items():
        np.testing.assert_allclose(g, grads[name], rtol=1e-6, atol=1e-9, err_msg=name)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        build(remat=True, remat_policy="dots+rope")


def test_mlm_batch_is_the_example_recipe(monkeypatch):
    """The example's own loop, run until it hands its first batch to
    shard_batch, draws the arrays mlm_batch draws from the same seed."""
    import tf_operator_tpu.train.data as jax_data

    spec = importlib.util.spec_from_file_location("jax_bert_train", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)

    seen = []

    class Taken(Exception):
        pass

    def take(x, sharding):
        seen.append(np.asarray(x))
        if len(seen) == 3:
            raise Taken

    monkeypatch.setattr(jax_data, "shard_batch", take)
    with pytest.raises(Taken):
        example.main(["--model", "bert-tiny", "--batch", "4", "--seq", "16",
                      "--mask-prob", "0.3", "--steps", "1"])
    ours = bert_train.mlm_batch(np.random.default_rng(0), 256, 4, 16, 0.3)
    for got, want in zip(ours, seen):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    assert (ours[1] >= 0).any() and (ours[0] == bert_train.MASK_ID).any()


def test_bert_train_prints_finite_losses(capsys):
    assert bert_train.main(["--device", "cpu", "--steps", "3", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[4]) for line in out.splitlines()
              if line.startswith("[bert] step ")]
    assert "[bert] bert-tiny process 0/1" in out and "[bert] done" in out
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert abs(losses[0] - math.log(256)) < 0.5


def test_multi_card_bert_is_refused(monkeypatch):
    """No mesh refuses BERT any more: its step is data parallel over the
    whole world whatever axes the mesh declares, as the JAX example shards
    its batch over every mesh axis (``data_parallel_group``)."""
    monkeypatch.setattr(sharding.dist, "get_world_size", lambda group=None: 4)
    for axes in ({"fsdp": 2, "tp": 2}, {"fsdp": 2}, {"dp": 2, "fsdp": 2}, {"sp": 4},
                 {"slice": 2, "ep": 2, "tp": 1}, {"pp": 2, "tp": 2}):
        sharding.check_shardable(bert.CONFIGS["bert-base"], axes)
        mesh = types.SimpleNamespace(mesh_dim_names=tuple(axes),
                                     mesh=types.SimpleNamespace(shape=tuple(axes.values())))
        group = sharding.data_parallel_group(bert.CONFIGS["bert-base"], mesh)
        assert group == (sharding.dist.group.WORLD, 4)


# ------------------------------------------------- data parallel, 2 processes
DP_STEPS, DP_BATCH, DP_MASK, DP_LR = 3, 4, 0.3, 1e-3
DP_ARGS = ["--device", "cpu", "--steps", str(DP_STEPS), "--batch", str(DP_BATCH), "--seq",
           str(SEQ), "--mask-prob", str(DP_MASK), "--lr", str(DP_LR), "--log-every", "1"]
MESH_TP = '{"fsdp": 1, "tp": 2}'
DP_WORKER = r"""
import dataclasses, json, sys
import torch, torch.distributed as dist
from tf_operator_tpu_torch.models import bert
bert.CONFIGS["bert-tiny"] = dataclasses.replace(
    bert.CONFIGS["bert-tiny"], dtype=torch.float32, param_dtype=torch.float32)
state = torch.load(sys.argv[2])
bert.Bert.init_weights = lambda self, generator=None: self.load_state_dict(state)
from tf_operator_tpu_torch.train import bert_train
out = bert_train.run(bert_train.parse_args(sys.argv[3:]))
with open(sys.argv[1] + ".%d" % dist.get_rank(), "w") as fh:
    json.dump(out["losses"], fh)
dist.destroy_process_group()
"""


def global_batches():
    """The global batch of each step, as the 2 processes of the
    data-parallel run draw it: process r's rows from default_rng(r)."""
    rngs = [np.random.default_rng(r) for r in range(2)]
    for _ in range(DP_STEPS):
        parts = [bert_train.mlm_batch(rng, 256, DP_BATCH // 2, SEQ, DP_MASK) for rng in rngs]
        yield tuple(np.concatenate(arrays) for arrays in zip(*parts))


def example_losses():
    """The JAX example's own train_step on the global batches, from the
    reference's weights at fp32: its init and its shard_batch replaced,
    its jitted step's losses read as it returns them."""
    import tf_operator_tpu.train.data as jax_data

    spec = importlib.util.spec_from_file_location("jax_bert_train", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    arrays = iter([x for batch in global_batches() for x in batch])
    losses, jit = [], jax.jit

    def recording_jit(fn, *args, **kwargs):
        compiled = jit(fn, *args, **kwargs)
        if fn.__name__ != "train_step":
            return compiled

        def call(*step_args):
            out = compiled(*step_args)
            losses.append(float(out[2]))
            return out
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_bert.CONFIGS, "bert-tiny", configs()[0])
        mp.setattr(jax_bert, "init_params",
                   lambda *a, **k: jax.tree.map(jnp.asarray, reference()["params"]["params"]))
        mp.setattr(jax_data, "shard_batch", lambda x, sharding: next(arrays))
        mp.setattr(jax, "jit", recording_jit)
        example.main(["--model", "bert-tiny", *DP_ARGS[2:]])
    return losses


@pytest.fixture(scope="module")
def data_parallel(tmp_path_factory):
    """{"ranks": [losses of rank 0, rank 1], "tp_ranks": the same over mesh
    MESH_TP, "single": one process on the same global batches, "example":
    the JAX example's step, "unmoved": the last batch's loss on the
    initial weights}."""
    tmp = tmp_path_factory.mktemp("bert_dp")
    state_path = tmp / "state.pt"
    torch.save(reference()["state"], state_path)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    # The same run over a mesh with a tp axis: data parallel over the world.
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        tp_port = sock.getsockname()[1]
    runs = (("losses", port, {}), ("tp_losses", tp_port, {"JAX_MESH_SPEC": MESH_TP}))
    procs = [subprocess.Popen(
        [sys.executable, "-c", DP_WORKER, str(tmp / name), str(state_path), *DP_ARGS],
        cwd=EXAMPLE.parents[3], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1", "JAX_COORDINATOR_ADDRESS":
             f"127.0.0.1:{run_port}", "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(r),
             **extra})
        for name, run_port, extra in runs for r in range(2)]
    try:
        model = build()
        opt = ts.adamw(DP_LR, weight_decay=0.01)
        state, step = ts.init_train_state(model, opt), ts.make_train_step(
            opt, loss=bert_train.mlm_loss)
        single = []
        for batch in global_batches():
            state, loss = step(state, batch)
            single.append(loss.item())
        with torch.no_grad():  # the last batch's loss before any update
            unmoved = bert_train.mlm_loss(build(), tuple(torch.as_tensor(x).long()
                                                         for x in batch)).item()
        example = example_losses()
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    ranks = [json.loads((tmp / f"losses.{r}").read_text()) for r in range(2)]
    tp_ranks = [json.loads((tmp / f"tp_losses.{r}").read_text()) for r in range(2)]
    return {"ranks": ranks, "tp_ranks": tp_ranks, "single": single, "example": example,
            "unmoved": unmoved}


def test_data_parallel_bert_train_matches_one_process(data_parallel):
    single = data_parallel["single"]
    # The processes' masked counts differ, so the mean of their own means
    # would not be the global batch's loss.
    counts = [[(labels[r * 2:(r + 1) * 2] >= 0).sum() for r in range(2)]
              for _, labels, _ in global_batches()]
    assert any(a != b for a, b in counts)
    assert abs(single[-1] - data_parallel["unmoved"]) > 1e-3  # the updates moved it
    for losses in data_parallel["ranks"]:
        np.testing.assert_allclose(losses, single, rtol=1e-5)


def test_data_parallel_bert_train_matches_the_jax_example_step(data_parallel):
    np.testing.assert_allclose(data_parallel["example"], data_parallel["single"], rtol=1e-5)
    for losses in data_parallel["ranks"]:
        np.testing.assert_allclose(losses, data_parallel["example"], rtol=1e-5)


def test_bert_over_a_tp_mesh_gives_the_data_parallel_losses(data_parallel):
    # Over {"fsdp": 1, "tp": 2} the two processes are two data replicas,
    # as the JAX example makes them: the dp=2 run's losses, bit for bit.
    assert data_parallel["tp_ranks"] == data_parallel["ranks"]


def test_config_accounting_matches():
    assert 105e6 < bert.CONFIGS["bert-base"].param_count() < 115e6
    for name, jcfg in jax_bert.CONFIGS.items():
        tcfg = bert.CONFIGS[name]
        assert tcfg.head_dim == jcfg.head_dim, name
        assert tcfg.param_count() == jcfg.param_count(), name
        assert tcfg.flops_per_token(512) == jcfg.flops_per_token(512), name
    assert {c.head_dim for c in bert.CONFIGS.values()} == {16, 64}
