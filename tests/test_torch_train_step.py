"""The port's train step against the JAX package's, on the CPU: the
optimizer against optax (each place where a port drifts tested on its
own), the chunked loss, a 10-step fp32 loss sequence on llama-tiny, and
the llama_train entry point.

Tolerances: 1e-6 for optimizer updates on a small fp32 tree (the two sides
round the same fp32 operations in other orders); 1e-5 for the chunked
loss and its gradients; 1e-4 relative for the 10-step loss sequence (the
model's sums run in other orders, and the error grows over the steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import llama as jax_llama
from tf_operator_tpu.parallel.mesh import standard_mesh
from tf_operator_tpu.train import train_step as jax_ts
from tf_operator_tpu.train.data import SyntheticTokens as JaxSyntheticTokens
from tf_operator_tpu_torch.models import convert, llama
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import llama_train
from tf_operator_tpu_torch.train import train_step as ts
from tf_operator_tpu_torch.train.data import SyntheticTokens

OPT = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=6)


def small_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((4, 3)).astype(np.float32),
        "b": rng.standard_normal((5,)).astype(np.float32),
        "scale": np.ones((3,), np.float32),
    }


def run_both(grads_seq, **opt):
    """Apply the same gradient sequence through optax and the port;
    returns both parameter trajectories."""
    params = small_tree()
    joptim = jax_ts.make_optimizer(**opt)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = joptim.init(jparams)
    toptim = ts.make_optimizer(**opt)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = toptim.init(list(tparams.values()))
    jtraj, ttraj = [], []
    for grads in grads_seq:
        updates, jstate = joptim.update({k: jnp.asarray(g) for k, g in grads.items()},
                                        jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tstate = toptim.update_(list(tparams.values()),
                                [torch.tensor(grads[k]) for k in tparams], tstate)
        jtraj.append({k: np.asarray(v) for k, v in jparams.items()})
        ttraj.append({k: v.numpy().copy() for k, v in tparams.items()})
    return jtraj, ttraj


def grads_seq(n, scale, seed=1):
    rng = np.random.default_rng(seed)
    tree = small_tree()
    return [{k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in tree.items()} for _ in range(n)]


def test_schedule_matches_optax():
    optim = ts.make_optimizer(**OPT)
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6)
    for count in range(10):
        assert optim.schedule(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12)
    # decay_steps counts the warmup and is held above it.
    assert ts.make_optimizer(warmup_steps=5, decay_steps=3).decay_steps == 6


def test_first_update_runs_at_lr_zero():
    jtraj, ttraj = run_both(grads_seq(1, 1.0), **OPT)
    for k, v in small_tree().items():
        np.testing.assert_array_equal(ttraj[0][k], v)
        np.testing.assert_array_equal(jtraj[0][k], v)


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_updates_match_optax(scale):
    """Bias correction, clipping and the schedule over warmup and decay."""
    jtraj, ttraj = run_both(grads_seq(8, scale), **OPT)
    for j, t in zip(jtraj, ttraj):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_weight_decay_reaches_every_leaf():
    """A norm scale with zero gradient still decays (optax decays every leaf)."""
    seq = grads_seq(3, 0.1)
    for g in seq:
        g["scale"] = np.zeros_like(g["scale"])
    jtraj, ttraj = run_both(seq, **OPT)
    assert np.all(ttraj[-1]["scale"] < 1.0)
    np.testing.assert_allclose(ttraj[-1]["scale"], jtraj[-1]["scale"], rtol=1e-6)


def test_clip_has_no_epsilon():
    """At a tiny clip the +1e-6 of clip_grad_norm_ would show."""
    opt = dict(OPT, grad_clip=1e-5)
    jtraj, ttraj = run_both(grads_seq(3, 1e-5), **opt)
    for k in jtraj[-1]:
        np.testing.assert_allclose(ttraj[-1][k], jtraj[-1][k], rtol=1e-6, atol=1e-7)


def test_chunked_cross_entropy_with_padding():
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, 37, 16)).astype(np.float32)
    kernel = (0.1 * rng.standard_normal((16, 50))).astype(np.float32)
    targets = rng.integers(0, 50, (2, 37)).astype(np.int32)
    targets[0, :5] = -1  # ignored positions

    def jloss(h, w):
        return jax_ts.chunked_cross_entropy(h, w, jnp.asarray(targets), chunk=8)

    jval, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(kernel))

    th = torch.tensor(hidden, requires_grad=True)
    tw = torch.tensor(kernel.T.copy(), requires_grad=True)
    val = ts.chunked_cross_entropy(th, tw, torch.from_numpy(targets).long(), chunk=8)
    val.backward()
    full = ts.cross_entropy_loss(torch.from_numpy(hidden) @ torch.from_numpy(kernel),
                                 torch.from_numpy(targets).long())
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    np.testing.assert_allclose(val.item(), full.item(), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw).T, rtol=1e-5, atol=1e-6)


def test_synthetic_tokens_are_byte_identical():
    a, b = SyntheticTokens(2, 16, 256, seed=5), JaxSyntheticTokens(2, 16, 256, seed=5)
    for _ in range(3):
        assert next(a).tobytes() == next(b).tobytes()


def test_ten_step_loss_sequence_matches_jax():
    jcfg = dataclasses.replace(jax_llama.CONFIGS["llama-tiny"], dtype=jnp.float32,
                               param_dtype=jnp.float32)
    tcfg = dataclasses.replace(llama.CONFIGS["llama-tiny"], dtype=torch.float32,
                               param_dtype=torch.float32)
    opt = dict(learning_rate=3e-3, warmup_steps=2, decay_steps=10)

    jmodel = jax_llama.Llama(jcfg)
    joptim = jax_ts.make_optimizer(**opt)
    jstate = jax_ts.init_train_state(jmodel, jax.random.PRNGKey(0), joptim, seq=32)
    mesh = standard_mesh(1, devices=jax.devices()[:1])
    jstep, _ = jax_ts.make_train_step(jmodel, joptim, mesh, jstate)

    tmodel = llama.Llama(tcfg, device="cpu")
    tmodel.load_state_dict(convert.flax_to_state_dict(
        jax.tree.map(np.asarray, jstate.params)))
    toptim = ts.make_optimizer(**opt)
    tstate = ts.init_train_state(tmodel, toptim)
    tstep = ts.make_train_step(toptim)

    data = SyntheticTokens(2, 32, tcfg.vocab_size, seed=0)
    # XLA's backend optimisations cost compile time and buy nothing here.
    jstep = jstep.lower(jstate, jnp.zeros((2, 33), jnp.int32)).compile(
        {"xla_backend_optimization_level": 0})
    jlosses, tlosses = [], []
    for _ in range(10):
        batch = next(data)
        jstate, jl = jstep(jstate, jnp.asarray(batch))
        tstate, tl = tstep(tstate, batch)
        jlosses.append(float(jl))
        tlosses.append(float(tl))
    assert tlosses[0] != tlosses[-1]  # the model trained
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)


def test_llama_train_main_prints_step_lines(capsys):
    assert llama_train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                             "--seq", "32", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "[llama] step 0 loss " in out and "[llama] step 1 loss " in out
    assert "tokens/sec" in out and "[llama] done" in out


def test_llama_train_refuses_unported_flags():
    # Every flag of the JAX script is ported now, the checkpoint flags
    # with its cadence; a flag the port does not have is refused.
    args = llama_train.parse_args(["--checkpoint-dir", "/tmp/x"])
    assert (args.checkpoint_dir, args.checkpoint_every) == ("/tmp/x", 200)
    with pytest.raises(SystemExit):
        llama_train.parse_args(["--pipeline-stages", "2"])
