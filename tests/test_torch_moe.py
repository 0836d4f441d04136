"""The port's MoE layer (``models/llama.py`` ``MoE``) against the JAX
package's, on the CPU: fp32 moe-tiny from the same weights, carried across
by ``models/convert.py``, at seq 32 and batch 2.

Against JAX, for the einsum routing, grouped dispatch (groups of 8) and
overflow (capacity factor 0.5, so that tokens drop: it pins the rank-major
slot race): logits to 1e-4 relative (1e-5 absolute), the summed aux loss to
1e-5 relative, and every parameter gradient of ``sum(logits * w) + aux`` to
1e-4 relative in L2 (the two frameworks sum in other orders). The port's
gather routing against its einsum routing at the same tolerances; remat
against no remat at 1e-6 (the replay recomputes the same fp32 operations),
the router's gradient under the aux loss alone included; one train step
(loss_fn and one AdamW update) against JAX's; the llama_train entry point
on moe-tiny, unsharded, resumed from a checkpoint, and FSDP2-sharded on a
one-rank gloo group.
"""

import dataclasses
import functools
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from tf_operator_tpu.models import llama as jax_llama
from tf_operator_tpu.train import train_step as jax_ts
from tf_operator_tpu_torch.models import convert, llama
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import llama_train
from tf_operator_tpu_torch.train import train_step as ts

SEQ, BATCH = 32, 2
# Routing settings: none changes the parameter tree.
VARIANTS = {
    "einsum": {},
    "grouped": dict(moe_group_size=8),
    "overflow": dict(capacity_factor=0.5),
}
OPT = dict(learning_rate=1e-2, warmup_steps=0, decay_steps=10)


def configs(**changes):
    """(JAX config, port config) of fp32 moe-tiny with ``changes``."""
    jcfg = dataclasses.replace(jax_llama.CONFIGS["moe-tiny"], dtype=jnp.float32,
                               param_dtype=jnp.float32, **changes)
    tcfg = dataclasses.replace(llama.CONFIGS["moe-tiny"], dtype=torch.float32,
                               param_dtype=torch.float32, **changes)
    return jcfg, tcfg


def tokens(seq=SEQ):
    return np.random.default_rng(1).integers(0, 256, (BATCH, seq), np.int32)


WEIGHTS = np.random.default_rng(2).standard_normal((BATCH, SEQ, 256)).astype(np.float32)


@functools.cache
def reference():
    """The JAX side, in one compiled call (compiling each piece alone
    costs more than the tests' whole budget): the params, initialised
    once, and from them, for each variant, (logits, aux, gradients of
    ``sum(logits * w) + aux``), and the train step's ``loss_fn`` with the
    parameters after one AdamW update. Returned as numpy, parameter trees
    as the port's state_dicts."""
    jmodel = jax_llama.Llama(configs()[0])
    batch = jnp.asarray(tokens(SEQ + 1))

    def objective(model):
        def f(params):
            logits, mutated = model.apply(params, tokens(), mutable=["losses"])
            aux = sum(jnp.sum(leaf) for leaf in jax.tree.leaves(mutated["losses"]))
            return jnp.sum(logits * WEIGHTS) + aux, (logits, aux)
        return jax.value_and_grad(f, has_aux=True)

    optimizer = jax_ts.make_optimizer(**OPT)

    def run(rng):
        params = jax_llama.init_params(jmodel, rng, seq=SEQ)
        variants = {name: objective(jax_llama.Llama(configs(**changes)[0]))(params)
                    for name, changes in VARIANTS.items()}
        loss, grads = jax.value_and_grad(lambda p: jax_ts.loss_fn(jmodel, p, batch))(params)
        updates, _ = optimizer.update(grads, optimizer.init(params), params)
        return params, variants, (loss, optax.apply_updates(params, updates))

    # XLA's backend optimisations cost a third of the compile and buy
    # nothing at these sizes.
    key = jax.random.PRNGKey(0)
    compiled = jax.jit(run).lower(key).compile({"xla_backend_optimization_level": 0})
    params, variants, step = compiled(key)

    def state(tree):
        return convert.flax_to_state_dict(jax.tree.map(np.asarray, tree))

    return {
        "params": params,
        "state": state(params),
        "variants": {name: (np.asarray(logits), float(aux), state(grads))
                     for name, ((_, (logits, aux)), grads) in variants.items()},
        "step": (float(step[0]), state(step[1])),
    }


def build(**changes):
    model = llama.Llama(configs(**changes)[1], device="cpu")
    model.load_state_dict(reference()["state"])
    return model


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def port_run(model):
    """(logits, aux, {name: gradient of sum(logits * w) + aux})."""
    logits, aux = model(torch.from_numpy(tokens()).long(), return_aux=True)
    ((logits * torch.from_numpy(WEIGHTS)).sum() + aux).backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    return logits.detach().numpy(), aux.item(), grads


def test_converter_carries_the_experts_and_the_fp32_router():
    params = jax.tree.map(np.asarray, reference()["params"])["params"]["layers"]["feed_forward"]
    state = reference()["state"]
    model = llama.Llama(llama.CONFIGS["moe-tiny"], device="meta")
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    router = model.layers[0].feed_forward.router.weight
    assert router.dtype == torch.float32 and model.layers[0].feed_forward.experts_w1.dtype \
        == torch.bfloat16  # fp32 router whatever param_dtype says
    np.testing.assert_array_equal(state["layers.1.feed_forward.router.weight"].numpy(),
                                  params["router"]["kernel"][1].T)
    for name in ("experts_w1", "experts_w2", "experts_w3"):
        np.testing.assert_array_equal(state[f"layers.0.feed_forward.{name}"].numpy(),
                                      params[name][0])


@pytest.mark.parametrize("variant", VARIANTS)
def test_logits_aux_and_grads_match_jax(variant):
    logits, aux, grads = port_run(build(**VARIANTS[variant]))
    jlogits, jaux, jgrads = reference()["variants"][variant]
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-5)
    assert aux == pytest.approx(jaux, rel=1e-5)
    # The load-balance loss is at least its weight per layer (uniform routing).
    assert aux >= 0.9 * llama.CONFIGS["moe-tiny"].router_aux_weight * 2
    for name, g in grads.items():
        assert rel_err(g, jgrads[name].numpy()) < 1e-4, name
    assert np.linalg.norm(grads["layers.0.feed_forward.router.weight"]) > 0


def test_overflow_drops_tokens():
    """Capacity factor 0.5 leaves 8 slots an expert for 64 routes over 4
    experts: half the routes at least are dropped, and the output differs
    from the einsum variant's, which keeps nearly all."""
    cfg = configs(**VARIANTS["overflow"])[1]
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = max(1, int(cfg.capacity_factor * SEQ * k / e))
    assert cap * e < SEQ * k
    jax_logits = {name: v[0] for name, v in reference()["variants"].items()}
    assert rel_err(jax_logits["overflow"], jax_logits["einsum"]) > 1e-3


@pytest.mark.parametrize("variant", VARIANTS)
def test_gather_routing_matches_einsum(variant):
    logits, aux, grads = port_run(build(**VARIANTS[variant]))
    glogits, gaux, ggrads = port_run(build(moe_impl="gather", **VARIANTS[variant]))
    np.testing.assert_allclose(glogits, logits, rtol=1e-4, atol=1e-5)
    assert gaux == pytest.approx(aux, rel=1e-5)
    for name, g in ggrads.items():
        assert rel_err(g, grads[name]) < 1e-4, name


def test_unknown_moe_impl_raises():
    with pytest.raises(ValueError, match="unknown moe_impl"):
        build(moe_impl="scatter")


def loss_and_grads(model, aux_only=False):
    batch = torch.from_numpy(tokens(SEQ + 1)).long()
    if aux_only:
        loss = model(batch, return_aux=True)[1]
    else:
        loss = ts.loss_fn(model, batch)
    loss.backward()
    # A parameter that the loss does not reach has no gradient, or zeros
    # from the checkpoint's backward: the same gradient.
    return loss.item(), {n: np.zeros(p.shape) if p.grad is None else p.grad.numpy().copy()
                         for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots+rope+norms"])
def test_remat_gives_the_no_remat_loss_and_grads(policy):
    """Under the reentrant checkpoint the aux loss is an output of the
    checkpointed block: kept on the module, it would have no graph and the
    router would lose its gradient without a sound."""
    for aux_only in (False, True):
        ref_loss, ref = loss_and_grads(build(), aux_only)
        loss, grads = loss_and_grads(build(remat=True, remat_policy=policy), aux_only)
        assert loss == pytest.approx(ref_loss, rel=1e-6)
        for name, g in grads.items():
            assert rel_err(g, ref[name]) <= 1e-6, (aux_only, name)
        router = grads["layers.1.feed_forward.router.weight"]
        assert np.linalg.norm(router) > 0, aux_only


def test_one_train_step_matches_jax():
    """train_step.loss_fn (CE + aux) and the parameters after one AdamW
    update (lr 1e-2 from the first update, clipped) against JAX's, the
    parameters to 1e-4 relative in L2: the first Adam step divides each
    gradient by its own size, so it carries the gradients' error."""
    jloss, jnew = reference()["step"]
    model = build()
    optim = ts.make_optimizer(**OPT)
    _, loss = ts.make_train_step(optim)(ts.init_train_state(model, optim), tokens(SEQ + 1))
    assert loss.item() == pytest.approx(jloss, rel=1e-5)
    moved = 0.0
    for name, p in model.named_parameters():
        ref = jnew[name].numpy()
        assert rel_err(p.detach().numpy(), ref) < 1e-4, name
        moved = max(moved, rel_err(ref, reference()["state"][name].numpy()))
    assert moved > 1e-2  # the update moved the weights


ARGS = ["--model", "moe-tiny", "--device", "cpu", "--batch", "2", "--seq", "32",
        "--log-every", "1", "--warmup", "1"]


def test_llama_train_trains_checkpoints_and_resumes_moe_tiny(tmp_path):
    out = llama_train.run(llama_train.parse_args([*ARGS, "--steps", "2",
                                                  "--checkpoint-dir", str(tmp_path)]))
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert out["config"].n_experts == 4
    resumed = llama_train.run(llama_train.parse_args([*ARGS, "--steps", "3",
                                                      "--checkpoint-dir", str(tmp_path)]))
    restore = resumed["restore"]
    assert (restore.path, restore.cause, restore.step) == ("storage", "ok", 2)
    assert resumed["start_step"] == 2 and len(resumed["losses"]) == 1
    assert np.isfinite(resumed["losses"][0])


def test_fsdp2_on_one_rank_matches_unsharded(monkeypatch):
    """The sharded entry point (a one-rank gloo group, mesh fsdp=1, the
    fp32 router in its own FSDP2 group) gives the unsharded run's losses."""
    single = llama_train.run(llama_train.parse_args([*ARGS, "--steps", "3"]))["losses"]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    monkeypatch.setenv("JAX_MESH_SPEC", '{"fsdp": 1}')
    try:
        out = llama_train.run(llama_train.parse_args([*ARGS, "--steps", "3"]))
    finally:
        dist.destroy_process_group()
    assert out["mesh"] == {"fsdp": 1}
    assert single[-1] != single[0]
    np.testing.assert_allclose(out["losses"], single, rtol=1e-5)

