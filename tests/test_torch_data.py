"""The port's input pipeline (``train/data.py``) against the JAX package's,
on the CPU: the same token file, window skip and process split give
byte-equal batches on the native loader and on the Python path, and the
device prefetch stage changes when batches move, never which batches or
the losses they give."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tf_operator_tpu.train import data as jax_data
from tf_operator_tpu_torch.models import llama
from tf_operator_tpu_torch.native import build as native_build
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train import data
from tf_operator_tpu_torch.train import train_step as ts


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tokens") / "shard.bin"
    rng = np.random.default_rng(7)
    data.write_token_file(str(path), rng.integers(0, 256, 20_000).astype(np.uint16))
    return str(path)


def test_write_token_file_matches_jax(tmp_path):
    tokens = np.random.default_rng(0).integers(0, 1000, 333).astype(np.int32)
    data.write_token_file(str(tmp_path / "a"), tokens)
    jax_data.write_token_file(str(tmp_path / "b"), tokens)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    with pytest.raises(ValueError, match="dtype"):
        data.write_token_file(str(tmp_path / "c"), tokens.astype(np.int64))


@pytest.mark.parametrize("force_python", [False, True], ids=["native", "python"])
@pytest.mark.parametrize("split", [(0, 1, 0), (1, 2, 0), (0, 2, 5), (2, 3, 7)],
                         ids=lambda s: "pid%d-of%d-skip%d" % s)
def test_batches_byte_equal_to_jax(token_file, force_python, split):
    pid, nproc, skip = split
    kw = dict(dtype="uint16", process_id=pid, num_processes=nproc, skip_windows=skip)
    port = data.TokenFileDataset(token_file, 3, 64, force_python=force_python, **kw)
    ref = jax_data.TokenFileDataset(token_file, 3, 64, force_python=force_python, **kw)
    if not force_python:
        assert port.native and ref.native, "g++ is present: the native loaders must run"
    assert port.n_tokens == ref.n_tokens == 20_000
    for _ in range(4):
        got, want = next(port), next(ref)
        assert got.dtype == want.dtype == np.int32
        assert got.tobytes() == want.tobytes()
    port.close()
    ref.close()


def test_native_build_dir_is_private():
    st = os.stat(native_build._build_dir())
    assert st.st_uid == os.getuid() and not st.st_mode & 0o022


def test_prefetch_passes_batches_through_on_the_cpu():
    host = [np.full((2, 5), i, np.int32) for i in range(5)]
    pf = data.DevicePrefetch(iter(host), "cpu", depth=2)
    got = list(pf)
    assert [g.tolist() for g in got] == [h.tolist() for h in host]
    assert all(isinstance(g, torch.Tensor) and g.device.type == "cpu" for g in got)
    assert pf.in_flight == 0
    with pytest.raises(ValueError, match="depth"):
        data.DevicePrefetch(iter(host), "cpu", depth=0)


def test_loss_sequence_identical_with_prefetch_on_and_off(token_file):
    cfg = dataclasses.replace(llama.CONFIGS["llama-tiny"], dtype=torch.float32,
                              param_dtype=torch.float32)

    def run(prefetch):
        model = llama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        optimizer = ts.make_optimizer(learning_rate=3e-3, warmup_steps=1, decay_steps=10)
        state, step = ts.init_train_state(model, optimizer), ts.make_train_step(optimizer)
        batches = data.TokenFileDataset(token_file, 2, 32, dtype="uint16")
        if prefetch:
            batches = data.DevicePrefetch(batches, "cpu", depth=2)
        losses = []
        for _ in range(3):
            state, loss = step(state, next(batches))
            losses.append(loss.item())
        return losses

    off, on = run(False), run(True)
    assert on == off
    assert on[0] != on[-1]
