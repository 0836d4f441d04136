"""The port's MNIST ConvNet (``models/mnist.py``, ``train/mnist_train.py``)
against the JAX package's, on the CPU: ``MnistCNN`` from the JAX init's
weights with every bias (zeros there) moved by seeded noise, carried
across by ``models/convert.py``.

Tolerances, fp32: logits 1e-5 relative to the largest; the loss 1e-5
relative and the accuracy equal; each gradient 1e-4 relative in L2; three
steps of the entry point against the JAX example's own jitted step on the
same draws, losses 1e-5. bf16 against the JAX model in bf16: logits 5e-2
of the largest. The NHWC flatten is pinned: an NCHW flatten of the same
numbers fails the parity. The data-parallel run is in
``test_torch_resnet.py`` (one 2-process group trains both models).
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tf_operator_tpu.models import mnist as jax_mnist
from tf_operator_tpu_torch.models import convert, mnist
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import mnist_train
from test_torch_resnet import example_main

EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples/jax/mnist/mnist_train.py"


@functools.lru_cache(maxsize=None)
def initial():
    model = jax_mnist.MnistCNN(jax_mnist.MnistConfig(dtype=jnp.float32))
    return jax.jit(functools.partial(jax_mnist.init_params, model))(jax.random.PRNGKey(0))


def params():
    """The JAX init's params (seed 0) with every bias moved by N(0, 0.05)."""
    rng = np.random.default_rng(0)
    p = jax.tree.map(np.asarray, initial())
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
        if path[-1].key == "bias" else a, p)


def build(dtype=torch.float32):
    """(JAX model, params, the port model holding them) in ``dtype``."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    p = params()
    model = mnist.MnistCNN(mnist.MnistConfig(dtype=dtype), device="cpu")
    model.load_state_dict(convert.mnist_flax_to_state_dict(p), strict=True)
    return jax_mnist.MnistCNN(jax_mnist.MnistConfig(dtype=jdtype)), p, model


def rel_max(got, ref):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_synthetic_mnist_is_the_reference_generator():
    for seed in (0, 7919):
        ours, ref = mnist.SyntheticMnist(16, seed), jax_mnist.SyntheticMnist(16, seed)
        for _ in range(2):
            (x, y), (rx, ry) = next(ours), next(ref)
            assert x.tobytes() == rx.tobytes() and y.tobytes() == ry.tobytes()
            assert x.dtype == np.float32 and y.dtype == np.int32 and x.shape == (16, 28, 28, 1)


@pytest.mark.parametrize("shape", [(8, 28, 28, 1), (8, 28, 28)])
def test_logits_match_jax(shape):
    jmodel, p, model = build()
    x, _ = next(mnist.SyntheticMnist(8, seed=3))
    x = x.reshape(shape)
    assert rel_max(model(torch.from_numpy(x)), jmodel.apply({"params": p}, x)) <= 1e-5


def test_an_nchw_flatten_fails_the_parity(monkeypatch):
    """The reference flattens [b, 7, 7, 64] channel-last; a plain NCHW
    flatten orders the same numbers differently."""
    jmodel, p, model = build()
    x, _ = next(mnist.SyntheticMnist(8, seed=3))
    ref = jmodel.apply({"params": p}, x)
    nchw = model.dense0.forward
    monkeypatch.setattr(model.dense0, "forward", lambda h: nchw(
        h.view(h.shape[0], 7, 7, 64).permute(0, 3, 1, 2).reshape(h.shape[0], -1)))
    assert rel_max(model(torch.from_numpy(x)), ref) > 1e-2


def test_one_step_loss_accuracy_and_grads_match_jax():
    jmodel, p, model = build()
    x, y = next(mnist.SyntheticMnist(16, seed=5))
    (loss, acc), grads = jax.jit(jax.value_and_grad(
        functools.partial(jax_mnist.loss_and_accuracy, jmodel), has_aux=True))(p, x, y)
    got, got_acc = mnist.loss_and_accuracy(model, torch.from_numpy(x), torch.from_numpy(y).long())
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss))
    assert got_acc.item() == float(acc)
    ref = convert.mnist_flax_to_state_dict(jax.tree.map(np.asarray, grads))
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(ref)
    for name, prm in named.items():
        err = (prm.grad - ref[name]).norm() / ref[name].norm()
        assert err <= 1e-4, name


def test_bf16_logits_within_bf16_rounding():
    jmodel, p, model = build(torch.bfloat16)
    x, _ = next(mnist.SyntheticMnist(8, seed=3))
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert all(prm.dtype == torch.float32 for prm in model.parameters())
    assert rel_max(got, jmodel.apply({"params": p}, x)) <= 5e-2


def example_losses(argv):
    """The JAX example's own jitted step from ``params()`` at fp32, its
    losses and accuracies as the step returns them."""
    start = jax.tree.map(jnp.asarray, params())
    outs = example_main(EXAMPLE, argv, [
        (jax_mnist, "make_model",
         lambda: jax_mnist.MnistCNN(jax_mnist.MnistConfig(dtype=jnp.float32))),
        (jax_mnist, "init_params", lambda *a, **k: start)])
    return [float(o[2]) for o in outs], [float(o[3]) for o in outs]


def test_mnist_train_matches_the_jax_example_step(monkeypatch, capsys):
    argv = ["--steps", "3", "--batch", "16"]
    state = convert.mnist_flax_to_state_dict(params())
    monkeypatch.setattr(mnist, "MnistConfig", functools.partial(mnist.MnistConfig,
                                                                dtype=torch.float32))
    monkeypatch.setattr(mnist.MnistCNN, "init_weights",
                        lambda self, generator=None: self.load_state_dict(state))
    out = mnist_train.run(mnist_train.parse_args([*argv, "--device", "cpu"]))
    text = capsys.readouterr().out
    assert "[mnist] step 2 loss" in text and "[mnist] done final_acc=" in text
    losses, accuracies = example_losses(argv)
    assert losses[-1] != losses[0]
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(out["accuracies"], accuracies, rtol=1e-6)


def test_mnist_train_exit_code_follows_the_target(monkeypatch, capsys):
    """The manifest's target, 0.95, missed after one step and reached after
    30 (fp32, from the port's own seed-0 init: bf16 convolutions are slow
    on the CPU)."""
    monkeypatch.setattr(mnist, "MnistConfig", functools.partial(mnist.MnistConfig,
                                                                dtype=torch.float32))
    args = ["--device", "cpu", "--batch", "64", "--target-accuracy", "0.95"]
    assert mnist_train.main([*args, "--steps", "1"]) == 1
    assert "[mnist] FAIL: accuracy" in capsys.readouterr().out
    assert mnist_train.main([*args, "--steps", "30"]) == 0
