"""The port's ResNet (``models/resnet.py``, ``train/resnet_train.py``)
against the JAX package's, on the CPU: resnet-tiny from the same weights,
carried across by ``models/convert.py``. The weights are the JAX init's
with every BatchNorm scale, bias and running value (ones and zeros there,
and the zero scale of each block's last BatchNorm) moved by seeded noise,
so that a swapped or dropped one shows.

Tolerances, fp32: logits 1e-5 relative to the largest logit (the
frameworks sum in other orders); the loss 1e-5 relative; each gradient
1e-4 relative in L2; running statistics 1e-5; the entry point's losses
1e-5 against the JAX example's own jitted step. bf16 (the card's compute
dtype) against the JAX model in bf16: logits 5e-2 of the largest (each
layer rounds its output to bf16, 2^-8 relative, and the two round at other
places). A resnet50-shaped stem and first two stages at 64x64 hold the
"SAME" padding where a stride-2 layer meets an even size; symmetric
padding there fails it.

The data-parallel pin: ``resnet_train`` (and ``mnist_train``) over a
2-process gloo group at a global batch of 4 (the entry point's CPU cap of 2
rows a process, as the JAX script's), against one process on the same
global batch and against the JAX example's jitted step on that global
array: losses 1e-5 and running statistics 1e-5. Per-rank BatchNorm
statistics fail it.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import tf_operator_tpu.train.data as jax_data
from tf_operator_tpu.models import resnet as jax_resnet
from tf_operator_tpu_torch.models import convert, mnist, resnet
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import mnist_train, resnet_train

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "jax"
TINY = "resnet-tiny"
# XLA's backend optimisations cost the JAX references' applies compile time
# and buy nothing here.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def configs(name=TINY, dtype=jnp.float32, **changes):
    """(JAX config, port config) of ``name`` in ``dtype``."""
    jcfg = dataclasses.replace(jax_resnet.CONFIGS[name], dtype=dtype, **changes)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return jcfg, dataclasses.replace(resnet.CONFIGS[name], dtype=tdtype, **changes)


def moved(variables, seed=0):
    """The init's variables with every BatchNorm leaf moved by seeded
    noise: scales and biases by N(0, 0.1) (the zero scales to 0.5 + that),
    means by N(0, 0.1), variances to 0.5 + |N(0, 0.1)|."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if leaf.ndim != 1:
            return leaf
        noise = rng.normal(0.0, 0.1, leaf.shape)
        if name == "var":
            return (0.5 + np.abs(noise)).astype(np.float32)
        if name == "scale" and not leaf.any():
            noise += 0.5
        return (leaf + noise).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, jax.tree.map(np.asarray, variables))


def init(jmodel, image_size=32):
    """``init_variables`` of the JAX package, jitted."""
    return jax.jit(functools.partial(jax_resnet.init_variables, jmodel,
                                     image_size=image_size))(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def reference(name=TINY, dtype=jnp.float32, image_size=32, changes=()):
    """The JAX model of ``name`` in ``dtype``, its moved variables, and its
    jitted training-mode apply (with the updated batch_stats), eval-mode
    apply and loss-and-gradient (``jax_loss_fn``), made once a config."""
    jmodel = jax_resnet.ResNet(configs(name, dtype, **dict(changes))[0])
    train = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]),
                    compiler_options=FAST_COMPILE)
    evaluate = jax.jit(lambda v, x: jmodel.apply(v, x, train=False),
                       compiler_options=FAST_COMPILE)
    grad = jax.jit(jax.value_and_grad(functools.partial(jax_loss_fn, jmodel), has_aux=True),
                   compiler_options=FAST_COMPILE)
    return moved(init(jmodel, image_size)), train, evaluate, grad


def build(name=TINY, dtype=jnp.float32, image_size=32, **changes):
    """(the JAX reference's variables and functions, the port model holding
    those variables)."""
    ref = reference(name, dtype, image_size, tuple(sorted(changes.items())))
    model = resnet.ResNet(configs(name, dtype, **changes)[1], device="cpu")
    model.load_state_dict(convert.resnet_flax_to_state_dict(ref[0]), strict=True)
    return ref, model


def images(batch=4, size=32, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (batch, size, size, 3)).astype(np.float32),
            rng.integers(0, 8, (batch,)).astype(np.int32))


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def assert_logits(got, ref, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"logits differ by {err:.3e} of the largest (tol {tol})"


def jax_loss_fn(jmodel, params, batch_stats, x, y):
    """The JAX example's loss: mean cross-entropy, the updated stats as aux."""
    logits, mut = jmodel.apply({"params": params, "batch_stats": batch_stats}, x,
                               train=True, mutable=["batch_stats"])
    one_hot = jax.nn.one_hot(y, logits.shape[-1])
    loss = -jnp.mean(jnp.sum(one_hot * jax.nn.log_softmax(logits), axis=-1))
    return loss, mut["batch_stats"]


# ------------------------------------------------------------------ model
def test_converter_maps_every_flax_leaf_to_one_parameter():
    """Every config's tree (its width cut to 8 filters): the blocks'
    names, the projections and the head."""
    for name in resnet.CONFIGS:
        jcfg, tcfg = configs(name, num_filters=8)
        variables = jax.eval_shape(lambda: init(jax_resnet.ResNet(jcfg)))
        leaves = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), variables)
        sd = convert.resnet_flax_to_state_dict(leaves)
        port = resnet.ResNet(tcfg, device="cpu").state_dict()
        assert sorted(sd) == sorted(port), name
        assert len(sd) == len(jax.tree.leaves(variables)), name
        for key, t in sd.items():
            assert tuple(t.shape) == tuple(port[key].shape), key


def test_configs_match_the_reference():
    for name, jcfg in jax_resnet.CONFIGS.items():
        tcfg = resnet.CONFIGS[name]
        for field in ("stage_sizes", "num_classes", "num_filters", "bottleneck",
                      "sync_bn_axis"):
            assert getattr(tcfg, field) == getattr(jcfg, field), (name, field)
        assert tcfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    # ResNet-50's forward at 224x224: 4.1e9 multiply-adds.
    assert 8.1e9 < resnet.CONFIGS["resnet50"].forward_flops(224) < 8.3e9


@pytest.mark.parametrize("train", [True, False])
def test_logits_match_jax(train):
    (variables, jax_train, jax_eval, _), model = build()
    x, _ = images()
    model.train(train)
    ref = jax_train(variables, x)[0] if train else jax_eval(variables, x)
    assert_logits(model(torch.from_numpy(x)), ref)


def test_one_step_loss_grads_stats_and_eval_logits_match_jax():
    (variables, _, jax_eval, jax_grad), model = build()
    x, y = images()
    (loss, stats), grads = jax_grad(variables["params"], variables["batch_stats"], x, y)
    got = F.cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y).long())
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss))

    ref = convert.resnet_flax_to_state_dict(
        jax.tree.map(np.asarray, {"params": grads, "batch_stats": stats}))
    params = dict(model.named_parameters())
    assert len(params) == len(jax.tree.leaves(grads))
    for name, p in params.items():
        assert rel_err(p.grad, ref[name]) <= 1e-4, name
    buffers = dict(model.named_buffers())
    assert len(buffers) == len(jax.tree.leaves(stats))
    for name, b in buffers.items():
        # At 1e-5 this holds the biased batch variance: the unbiased one is
        # n / (n - 1) of it, from 1 + 1/1023 (the stem's 4 x 16 x 16) to
        # 1 + 1/63 (the last stage's 4 x 4 x 4).
        np.testing.assert_allclose(b.numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-7)

    # One optax SGD step (Nesterov) against torch's, then eval mode.
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    new = {"params": optax.apply_updates(variables["params"], updates), "batch_stats": stats}
    torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, nesterov=True).step()
    model.eval()
    x2, _ = images(seed=2)
    assert_logits(model(torch.from_numpy(x2)), jax_eval(new, x2))


def test_stride_two_same_padding_on_an_even_size(monkeypatch):
    """resnet50's stem and its first two stages (one bottleneck each, 64
    filters) at 64x64: the max-pool meets 32x32 and the second stage's
    3x3 stride-2 convolution 16x16. Symmetric padding fails it."""
    (variables, _, jax_eval, _), model = build("resnet50", stage_sizes=(1, 1), num_classes=10,
                                               image_size=64)
    x, _ = images(batch=2, size=64)
    ref = jax_eval(variables, x)
    model.eval()
    assert_logits(model(torch.from_numpy(x)), ref)
    # Torch's own padding: 1 on each side of the 3x3 stride-2 layers.
    monkeypatch.setattr(resnet, "same_pads", lambda size, k, s: ((k - 1) // 2,) * 2)
    with pytest.raises(AssertionError, match="logits differ"):
        assert_logits(model(torch.from_numpy(x)), ref)


def test_bf16_logits_and_loss_within_bf16_rounding():
    (variables, jax_train, _, jax_grad), model = build(dtype=jnp.bfloat16)
    x, y = images()
    ref, _ = jax_train(variables, x)
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert_logits(got, ref, tol=5e-2)
    ref_loss = float(jax_grad(variables["params"], variables["batch_stats"], x, y)[0][0])
    loss = F.cross_entropy(got, torch.from_numpy(y).long()).item()
    assert abs(loss - ref_loss) <= 5e-2 * abs(ref_loss)
    # Parameters and running statistics stay fp32; activations run channels_last.
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert model.conv_init.weight.is_contiguous(memory_format=torch.channels_last)


# ------------------------------------------------------------ entry point
def example_main(path, argv, patches):
    """Run the JAX example at ``path`` with its ``train_step``'s jit
    recorded: returns each step's outputs as the jitted step returns them."""
    spec = importlib.util.spec_from_file_location(path.stem + "_example", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    outs, jit = [], jax.jit

    def recording_jit(fn, *args, **kwargs):
        compiled = jit(fn, *args, **kwargs)
        if fn.__name__ != "train_step":
            return compiled

        def call(*step_args):
            outs.append(compiled(*step_args))
            return outs[-1]
        return call

    with pytest.MonkeyPatch.context() as mp:
        for target, name, value in patches:
            mp.setattr(target, name, value)
        mp.setattr(jax, "jit", recording_jit)
        assert example.main(argv) == 0
    return outs


def resnet_example(variables, argv, arrays=None):
    """(losses, final batch_stats) of the JAX ResNet example at fp32 from
    ``variables``; its batches are its own draws, or ``arrays`` in place
    of its shard_batch's."""
    jcfg = configs()[0]
    feed = iter(arrays or ())
    patches = [(jax_resnet, "init_variables", lambda *a, **k: jax.tree.map(jnp.asarray,
                                                                           variables)),
               (jax_data, "shard_batch", (lambda x, sharding: next(feed)) if arrays
                else (lambda x, sharding: x))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_resnet.CONFIGS, TINY, jcfg)
        outs = example_main(EXAMPLES / "resnet" / "resnet_train.py", argv, patches)
    return [float(o[3]) for o in outs], jax.tree.map(np.asarray, outs[-1][1])


def patch_port(monkeypatch, state):
    monkeypatch.setitem(resnet.CONFIGS, TINY, configs()[1])
    monkeypatch.setattr(resnet.ResNet, "init_weights",
                        lambda self, generator=None: self.load_state_dict(state))


def assert_stats(buffers, variables, stats):
    """The port's running statistics ``buffers`` against the JAX
    ``batch_stats``, at 1e-5."""
    ref = convert.resnet_flax_to_state_dict({"params": variables["params"],
                                             "batch_stats": stats})
    names = [n for n in ref if n.endswith(("running_mean", "running_var"))]
    assert len(names) == len(buffers)
    for name in names:
        np.testing.assert_allclose(np.asarray(buffers[name]), ref[name].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_resnet_train_matches_the_jax_example_step(monkeypatch, capsys):
    """Three steps of the entry point (the CPU defaults: resnet-tiny, the
    image capped at 32x32) against the example's jitted step on the same
    draws."""
    variables = reference()[0]
    argv = ["--steps", "3", "--batch", "2", "--log-every", "1"]
    patch_port(monkeypatch, convert.resnet_flax_to_state_dict(variables))
    out = resnet_train.run(resnet_train.parse_args([*argv, "--device", "cpu"]))
    text = capsys.readouterr().out
    assert "[resnet] resnet-tiny process 0/1 devices=1 batch=2" in text
    assert "[resnet] step 2 loss" in text and "[resnet] done" in text
    assert out["window_steps"] == 2 and out["images_per_step"] == 2
    losses, stats = resnet_example(variables, argv)
    assert losses[-1] != losses[0]
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
    assert_stats(dict(out["model"].named_buffers()), variables, stats)


def test_resnet_train_refuses_the_cpu_unasked():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resnet_train.main(["--steps", "1"])


# ------------------------------------------- data parallel, 2 processes
DP_ARGS = ["--device", "cpu", "--steps", "3", "--batch", "4", "--log-every", "1"]
MNIST_ARGS = ["--device", "cpu", "--steps", "3", "--batch", "8"]
# The worker: resnet_train, then mnist_train, in one 2-process group; it
# writes its rank's losses and running statistics.
DP_WORKER = r"""
import dataclasses, functools, json, sys
import torch, torch.distributed as dist
from tf_operator_tpu_torch.models import mnist, resnet
resnet.CONFIGS["resnet-tiny"] = dataclasses.replace(resnet.CONFIGS["resnet-tiny"],
                                                    dtype=torch.float32)
state = torch.load(sys.argv[2])
resnet.ResNet.init_weights = lambda self, generator=None: self.load_state_dict(state)
from tf_operator_tpu_torch.train import mnist_train, resnet_train
args = json.loads(sys.argv[3])
out = resnet_train.run(resnet_train.parse_args(args["resnet"]))
buffers = {k: v.tolist() for k, v in out["model"].named_buffers()}
mnist.MnistConfig = functools.partial(mnist.MnistConfig, dtype=torch.float32)
digits = mnist_train.run(mnist_train.parse_args(args["mnist"]))
with open(sys.argv[1] + ".%d" % dist.get_rank(), "w") as fh:
    json.dump({"losses": out["losses"], "buffers": buffers, "mnist": digits["losses"],
               "mnist_acc": digits["accuracies"]}, fh)
dist.destroy_process_group()
"""


def resnet_global_batches(steps=3, rows=2):
    """Each step's global batch of the 2-process run: process r's rows
    from default_rng(r), rank-major, as JAX assembles the global array."""
    parts = [resnet_train.batches(r, rows, 32, 8) for r in range(2)]
    for _ in range(steps):
        yield tuple(np.concatenate(a) for a in zip(*(next(p) for p in parts)))


def mnist_global_batches(steps=3, rows=4):
    parts = [mnist.SyntheticMnist(rows, seed=r * 7919) for r in range(2)]
    for _ in range(steps):
        yield tuple(np.concatenate(a) for a in zip(*(next(p) for p in parts)))


@pytest.fixture(scope="module")
def data_parallel(tmp_path_factory):
    """The 2 ranks' results, one process's on the same global batches, and
    the JAX ResNet example's on that global array."""
    tmp = tmp_path_factory.mktemp("resnet_dp")
    variables = reference()[0]
    state = convert.resnet_flax_to_state_dict(variables)
    torch.save(state, tmp / "state.pt")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    args = json.dumps({"resnet": DP_ARGS, "mnist": MNIST_ARGS})
    procs = [subprocess.Popen(
        [sys.executable, "-c", DP_WORKER, str(tmp / "out"), str(tmp / "state.pt"), args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1", "JAX_COORDINATOR_ADDRESS":
             f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(r)})
        for r in range(2)]
    try:
        with pytest.MonkeyPatch.context() as mp:
            patch_port(mp, state)
            single = resnet_train.run(resnet_train.parse_args(DP_ARGS),
                                      data=resnet_global_batches())
            mp.setattr(mnist, "MnistConfig", functools.partial(mnist.MnistConfig,
                                                               dtype=torch.float32))
            digits = mnist_train.run(mnist_train.parse_args(MNIST_ARGS),
                                     data=mnist_global_batches())
        arrays = [a for batch in resnet_global_batches() for a in batch]
        example, example_stats = resnet_example(variables, DP_ARGS[2:], arrays)
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    ranks = [json.loads((tmp / f"out.{r}").read_text()) for r in range(2)]
    return {"ranks": ranks, "single": single, "example": example, "variables": variables,
            "example_stats": example_stats, "mnist": digits}


def test_data_parallel_resnet_train_matches_one_process(data_parallel):
    single = data_parallel["single"]
    assert single["losses"][-1] != single["losses"][0]
    buffers = {k: v.numpy() for k, v in single["model"].named_buffers()}
    for rank in data_parallel["ranks"]:
        np.testing.assert_allclose(rank["losses"], single["losses"], rtol=1e-5)
        for name, ref in buffers.items():
            np.testing.assert_allclose(rank["buffers"][name], ref, rtol=1e-5, atol=1e-7,
                                       err_msg=name)


def test_data_parallel_resnet_train_matches_the_jax_example_step(data_parallel):
    """The global-batch BatchNorm pin: the JAX example's one jitted step
    over the global array reduces the statistics over both processes'
    rows."""
    np.testing.assert_allclose(data_parallel["single"]["losses"], data_parallel["example"],
                               rtol=1e-5)
    for rank in data_parallel["ranks"]:
        np.testing.assert_allclose(rank["losses"], data_parallel["example"], rtol=1e-5)
        assert_stats(rank["buffers"], data_parallel["variables"],
                     data_parallel["example_stats"])


def test_data_parallel_mnist_train_matches_one_process(data_parallel):
    digits = data_parallel["mnist"]
    for rank in data_parallel["ranks"]:
        np.testing.assert_allclose(rank["mnist"], digits["losses"], rtol=1e-5)
        np.testing.assert_allclose(rank["mnist_acc"], digits["accuracies"], rtol=1e-6)
