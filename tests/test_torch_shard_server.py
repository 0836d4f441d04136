"""The port's peer-restore wire (``tf_operator_tpu_torch/runtime/shard_server.py``)
against the JAX package's (``tf_operator_tpu/runtime/shard_server.py``) on
the CPU: the same values give byte-equal ``.npy`` payloads and checksums in
fp32, bf16 (``ml_dtypes`` in this test only: the port has none) and int32,
bundles and ownership partitions agree, the decoder takes its dtype from
the target and refuses what does not fit it, and the endpoints answer over
real HTTP with the JAX module's status codes."""

import json
import urllib.request

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tf_operator_tpu.runtime import shard_server as jax_wire
from tf_operator_tpu_torch.runtime import shard_server as wire
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)
from tf_operator_tpu_torch.train.checkpoint import HostSnapshot
from tf_operator_tpu_torch.train.restore import http_fetch

CASES = {  # name: (numpy array as the JAX package holds it, torch dtype)
    "fp32": (np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32), torch.float32),
    "bf16": (np.random.default_rng(1).standard_normal((4, 2, 3)).astype(ml_dtypes.bfloat16),
             torch.bfloat16),
    "bf16-0d": (np.asarray(1.5, dtype=ml_dtypes.bfloat16), torch.bfloat16),
    "int32-0d": (np.asarray(7, dtype=np.int32), torch.int32),
    "int32": (np.arange(6, dtype=np.int32), torch.int32),
}


def to_torch(array, dtype):
    """The same values as a torch tensor (bf16 by its 2-byte words)."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(array.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(array.copy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_payload_byte_equal_to_the_jax_package(case):
    array, dtype = CASES[case]
    ours = wire.encode_shard(to_torch(array, dtype))
    theirs = jax_wire.encode_shard(jnp.asarray(array))
    assert ours == theirs
    assert wire.shard_checksum(ours) == jax_wire.shard_checksum(theirs)
    header, data = wire.encode_parts(to_torch(array, dtype))
    assert header + data.tobytes() == ours and len(header) % 64 == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_by_the_target_dtype_round_trips_exactly(case):
    array, dtype = CASES[case]
    tensor = to_torch(array, dtype)
    # The JAX package's own bytes, read by the port.
    got = wire.decode_shard(jax_wire.encode_shard(jnp.asarray(array)), dtype, tensor.shape)
    assert got.dtype == dtype and got.shape == tensor.shape
    assert torch.equal(got.reshape(-1).view(torch.uint8), tensor.reshape(-1).view(torch.uint8))


def test_the_reference_cannot_decode_its_own_bf16_payload():
    """The fault the port does not copy: the JAX package decodes a bf16
    payload as raw 2-byte voids, and its restore's astype(bfloat16) has no
    cast from them."""
    array, _ = CASES["bf16"]
    decoded = jax_wire.decode_shard(jax_wire.encode_shard(jnp.asarray(array)))
    assert decoded.dtype.kind == "V"
    with pytest.raises(ValueError, match="cast"):
        decoded.astype(ml_dtypes.bfloat16)


def test_decode_refuses_what_does_not_fit_the_target():
    payload = wire.encode_shard(torch.ones(4, 4))
    with pytest.raises(ValueError, match="target is torch.bfloat16"):
        wire.decode_shard(payload, torch.bfloat16)  # f4 words are not bf16
    with pytest.raises(ValueError, match="target is torch.int32"):
        wire.decode_shard(payload, torch.int32)  # same size, other type
    with pytest.raises(ValueError, match="shape"):
        wire.decode_shard(payload, torch.float32, (2, 8))
    with pytest.raises(ValueError, match="bytes"):
        wire.decode_shard(payload[:-4], torch.float32)
    with pytest.raises(ValueError, match="npy"):
        wire.decode_shard(b"not a payload", torch.float32)


def test_meta_dtype_names_match_the_jax_package():
    for array, dtype in CASES.values():
        assert wire.dtype_name(dtype) == str(np.asarray(jnp.asarray(array)).dtype)


def test_partition_and_bundle_framing_agree():
    names = [f"opt/mu/layers.{i}.w" for i in range(7)] + ["step", "model/w"]
    for n in (1, 2, 3, 4):
        for k in range(n):
            assert wire.partition_shard_names(names, k, n) == \
                jax_wire.partition_shard_names(names, k, n)
    body = b"".join(len(n).to_bytes(4, "big") + n + len(p).to_bytes(8, "big") + p
                    for n, p in ((b"a", b"xyz"), (b"b/c", b"")))
    assert wire.parse_bundle(body) == jax_wire.parse_bundle(body) == {"a": b"xyz", "b/c": b""}
    for broken in (body[:-1], body[:6]):
        with pytest.raises(OSError):
            wire.parse_bundle(broken)


def test_flatten_state_names_follow_named_parameters():
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.train.train_step import init_train_state, make_optimizer

    model = llama.Llama(llama.CONFIGS["llama-tiny"], device="cpu",
                        generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, make_optimizer())
    state.step, state.opt_state.count = 3, 2
    flat = wire.flatten_state(state)
    params = [n for n, _ in model.named_parameters()]
    assert list(flat) == (["step"] + [f"model/{n}" for n in params] + ["opt/count"]
                          + [f"opt/mu/{n}" for n in params] + [f"opt/nu/{n}" for n in params])
    assert flat["step"].dtype == flat["opt/count"].dtype == torch.int32
    assert flat["step"].shape == () and int(flat["step"]) == 3 and int(flat["opt/count"]) == 2
    # The state's own tensors, not copies: a restore writes through them.
    assert flat["model/norm.scale"].data_ptr() == model.norm.scale.data_ptr()
    assert flat[f"opt/nu/{params[0]}"] is state.opt_state.nu[0]


# ------------------------------------------------------------------ HTTP
def snapshot(step, scale):
    return HostSnapshot(step=step, model_meta={"dim": 4}, tree={
        "step": torch.tensor(step, dtype=torch.int32),
        "model/w": torch.full((4, 4), scale, dtype=torch.bfloat16),
        "opt/mu/w": torch.zeros(4, 4, dtype=torch.bfloat16),
        "opt/nu/w": torch.zeros(4, 4, dtype=torch.bfloat16),
    })


@pytest.fixture()
def served():
    snap = {"value": None}
    server = wire.SnapshotShardServer(lambda: snap["value"],
                                      owned=lambda names: names[::2]).start()
    yield snap, server
    server.stop()


def get(server, path):
    return http_fetch(server.address, path, 5.0)


def test_endpoints_over_http(served):
    snap, server = served
    for path in ("/v1/meta", "/v1/manifest", "/v1/shard/step", "/v1/bundle"):
        assert get(server, path)[0] == 503
    snap["value"] = snapshot(5, 1.5)
    status, _, body = get(server, "/v1/meta")
    meta = json.loads(body)
    assert status == 200 and meta["step"] == 5 and meta["model_meta"] == {"dim": 4}
    w = meta["shards"]["model/w"]
    assert (w["dtype"], w["shape"]) == ("bfloat16", [4, 4])
    status, headers, body = get(server, "/v1/shard/model%2Fw?step=5")
    assert status == 200 and headers["X-Step"] == "5"
    assert headers["X-Checksum"] == w["checksum"] == wire.shard_checksum(body)
    assert body == jax_wire.encode_shard(jnp.full((4, 4), 1.5, jnp.bfloat16))
    assert torch.equal(wire.decode_shard(body, torch.bfloat16),
                       torch.full((4, 4), 1.5, dtype=torch.bfloat16))
    manifest = json.loads(get(server, "/v1/manifest")[2])
    assert manifest["owned"] == ["model/w", "opt/nu/w"]  # the seam's stride
    assert get(server, "/v1/shard/nope?step=5")[0] == 404
    assert get(server, "/v1/nope")[0] == 404
    # Rotation mid-fetch: a client still on step 5 is refused, never served
    # a step-6 shard under a step-5 plan.
    snap["value"] = snapshot(6, 2.5)
    status, _, body = get(server, "/v1/shard/model%2Fw?step=5")
    assert status == 409 and json.loads(body) == {"error": "step-rotated", "step": 6}
    assert get(server, "/v1/bundle?step=5")[0] == 409


def test_bundle_and_have_filter(served):
    snap, server = served
    snap["value"] = snapshot(5, 1.5)
    meta = json.loads(get(server, "/v1/meta")[2])
    status, _, body = get(server, "/v1/bundle?step=5")
    frames = jax_wire.parse_bundle(body)  # the JAX client reads our framing
    assert status == 200 and sorted(frames) == sorted(meta["shards"])
    for name, payload in frames.items():
        assert wire.shard_checksum(payload) == meta["shards"][name]["checksum"]
    # The have-list matches per name: opt/mu/w and opt/nu/w share a checksum
    # (both zero), and holding one must not drop the other.
    mu = meta["shards"]["opt/mu/w"]["checksum"]
    _, _, body = get(server, f"/v1/bundle?step=5&have=opt%2Fmu%2Fw:{mu},junk")
    assert sorted(wire.parse_bundle(body)) == ["model/w", "opt/nu/w", "step"]


def test_start_shard_server_owns_what_its_stream_persisted(tmp_path):
    from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

    class Src:
        persisted_shard_names = None

        def host_snapshot(self):
            return snapshot(5, 1.0)

    names = sorted(snapshot(5, 1.0).tree)
    server = wire.start_shard_server(Src(), slice_index=1, num_slices=2)
    try:
        with urllib.request.urlopen(f"http://{server.address}/v1/manifest") as resp:
            owned = json.loads(resp.read())["owned"]
    finally:
        server.stop()
    assert owned == wire.partition_shard_names(names, 1, 2)  # no manifest: the stride
    mgr = CheckpointManager(str(tmp_path / "c"))
    assert mgr.persisted_shard_names() == ()
