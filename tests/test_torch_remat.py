"""Remat policies (the port's ``models/llama.py`` ``_remat_policy`` and its
remat tape, ``ops/remat.py``) on the CPU, llama-tiny at fp32 with remat
on, weights carried across from the JAX model by ``models/convert.py``.

Every policy string gives the loss and gradients of the port's remat=False
run (1e-6 relative: the replay recomputes the same fp32 operations) and of
the JAX model under the same policy (the fp32 tolerance of
``test_torch_llama.py``: 1e-4 relative, in norm for the gradients). The
backward replays what the policy leaves unsaved, and nothing else.
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tf_operator_tpu.models import llama as jax_llama
from tf_operator_tpu.train import train_step as jax_ts
from tf_operator_tpu_torch.models import convert, llama
from tf_operator_tpu_torch.ops import flash, rope
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import train_step as ts

POLICIES = ["nothing", "dots", "dots+rope", "dots+act", "dots+norms",
            "dots+rope+act+norms"]
SEQ, BATCH = 32, 2


def configs(policy, remat=True):
    jcfg = dataclasses.replace(jax_llama.CONFIGS["llama-tiny"], dtype=jnp.float32,
                               param_dtype=jnp.float32, remat=remat, remat_policy=policy)
    tcfg = dataclasses.replace(llama.CONFIGS["llama-tiny"], dtype=torch.float32,
                               param_dtype=torch.float32, remat=remat, remat_policy=policy)
    return jcfg, tcfg


@functools.cache
def jax_params():
    model = jax_llama.Llama(configs("dots", remat=False)[0])
    params = jax_llama.init_params(model, jax.random.PRNGKey(0), seq=SEQ)
    return params, convert.flax_to_state_dict(jax.tree.map(np.asarray, params))


def tokens():
    return np.random.default_rng(1).integers(0, 256, (BATCH, SEQ + 1), np.int32)


def port_model(policy, remat=True):
    model = llama.Llama(configs(policy, remat)[1], device="cpu")
    model.load_state_dict(jax_params()[1])
    return model


def port_loss_and_grads(model):
    loss = ts.loss_fn(model, torch.from_numpy(tokens()).long())
    loss.backward()
    return loss.item(), {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


@functools.cache
def unremat_run():
    return port_loss_and_grads(port_model("nothing", remat=False))


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_no_remat_and_jax(policy):
    loss, grads = port_loss_and_grads(port_model(policy))
    ref_loss, ref_grads = unremat_run()
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    for name, g in grads.items():
        assert rel_err(g, ref_grads[name]) <= 1e-6, name

    jmodel = jax_llama.Llama(configs(policy)[0])
    params = jax_params()[0]
    # XLA's backend optimisations cost compile time and buy nothing here.
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_ts.loss_fn(jmodel, p, jnp.asarray(tokens()))),
        compiler_options={"xla_backend_optimization_level": 0})(params)
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    jgrads = convert.flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
    for name, g in grads.items():
        assert rel_err(g, jgrads[name].numpy()) < 1e-4, name


def test_unknown_policy_raises():
    for bad in ("everything", "dots+bogus", "rope+dots", ""):
        with pytest.raises(ValueError, match="unknown remat_policy"):
            port_model(bad)


def test_default_policy_is_dots():
    assert llama.LlamaConfig().remat_policy == "dots"
    assert llama.CONFIGS["llama-400m"].remat_policy == "dots"


class _CountOps(TorchDispatchMode):
    """Counts the ops dispatched while it is active. An op whose output
    the remat tape serves to the replay never reaches it."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def count_calls(monkeypatch, policy, remat=True):
    """(flash forward calls and rope calls in one train step, matmuls
    dispatched in its backward)."""
    calls = collections.Counter()

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(flash, "flash_forward_plain",
                        counting("flash_fwd", flash.flash_forward_plain))
    monkeypatch.setattr(rope, "rope_plain", counting("rope", rope.rope_plain))
    model = port_model(policy, remat)
    loss = ts.loss_fn(model, torch.from_numpy(tokens()).long())
    with _CountOps() as ops:
        loss.backward()
    monkeypatch.undo()
    return calls, ops.counts[torch.ops.aten.mm.default]


def test_replays_follow_the_policy(monkeypatch):
    layers = llama.CONFIGS["llama-tiny"].n_layers
    plain, mm_plain = count_calls(monkeypatch, "nothing", remat=False)
    nothing, mm_nothing = count_calls(monkeypatch, "nothing")
    dots, mm_dots = count_calls(monkeypatch, "dots")
    dots_rope, _ = count_calls(monkeypatch, "dots+rope")
    # The flash forward runs once per layer under "dots" (o/lse saved) and
    # twice under "nothing" (replayed in the backward).
    assert plain["flash_fwd"] == dots["flash_fwd"] == layers
    assert nothing["flash_fwd"] == 2 * layers
    # rope: q and k forward, their backward, and a replay unless saved.
    assert plain["rope"] == dots_rope["rope"] == 4 * layers
    assert nothing["rope"] == dots["rope"] == 6 * layers
    # "dots" replays no matrix product; "nothing" replays them.
    assert mm_dots == mm_plain < mm_nothing
