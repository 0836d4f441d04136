"""The port's Lease client (``cluster/kube.py``) against the JAX package's
HTTP stub apiserver (``tf_operator_tpu/testing/stub_apiserver.py``), and
the in-cluster heartbeat of ``runtime/heartbeat.py`` ``start_from_env``:

- the client creates a heartbeat Lease, then renews it; a wrong bearer
  token is an error; a rotated token file is read again on a 401;
- with only the in-cluster env (``KUBERNETES_SERVICE_HOST``/``_PORT``, the
  service account's ``token`` and ``ca.crt``) the heartbeat publishes the
  step and the durable checkpoint step into the Lease over verified TLS,
  with the same annotations as the JAX package's publisher under the same
  env.
"""

import shutil
import ssl
import subprocess
import time

import pytest

from tf_operator_tpu.cluster import kube as jax_kube
from tf_operator_tpu.core import constants
from tf_operator_tpu.runtime import heartbeat as jax_heartbeat
from tf_operator_tpu.testing.stub_apiserver import StubApiServer
from tf_operator_tpu_torch.cluster import kube
from tf_operator_tpu_torch.runtime import heartbeat
from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def stub():
    server = StubApiServer(required_token="sa-token")
    yield server
    server.shutdown()


def test_creates_then_renews_the_lease(stub):
    client = kube.KubeCluster(base_url=stub.url, token="sa-token")
    with pytest.raises(kube.NotFound):
        client.get_lease("ns", "w-0-hb")
    assert heartbeat.publish_heartbeat(client, "ns", "w-0-hb", "w-0", step=3,
                                       tokens_per_sec=12.5, clock=lambda: 100.0)
    first = stub.mem.get_lease("ns", "w-0-hb")
    assert first["spec"]["holderIdentity"] == "w-0"
    assert heartbeat.publish_heartbeat(client, "ns", "w-0-hb", "w-0", step=4,
                                       checkpoint_step=2, clock=lambda: 101.5)
    second = client.get_lease("ns", "w-0-hb")
    assert second["spec"]["renewTime"] != first["spec"]["renewTime"]
    assert int(second["metadata"]["resourceVersion"]) > int(first["metadata"]["resourceVersion"])
    assert second["metadata"]["annotations"] == {
        constants.ANNOTATION_HEARTBEAT_STEP: "4",
        constants.ANNOTATION_HEARTBEAT_TPS: "12.5",
        constants.ANNOTATION_HEARTBEAT_CKPT: "2",
    }
    # A write from a stale read loses the optimistic-concurrency round.
    with pytest.raises(kube.Conflict):
        client.update_lease(first)
    methods = [m for m, path, _ in stub.requests if "/leases" in path]
    assert methods == ["GET", "GET", "POST", "GET", "PUT", "GET", "PUT"]


def test_a_wrong_token_is_an_error(stub):
    client = kube.KubeCluster(base_url=stub.url, token="not-the-token")
    with pytest.raises(kube.ApiError) as err:
        client.get_lease("ns", "w-0-hb")
    assert err.value.status == 401
    # A beat never raises: it reports that it did not land.
    assert not heartbeat.publish_heartbeat(client, "ns", "w-0-hb", "w-0", step=1)
    with pytest.raises(KeyError):
        stub.mem.get_lease("ns", "w-0-hb")


def test_a_rotated_token_file_is_read_again(stub, tmp_path):
    token = tmp_path / "token"
    token.write_text("sa-token\n")
    client = kube.KubeCluster(base_url=stub.url, token_file=str(token))
    assert heartbeat.publish_heartbeat(client, "ns", "w-0-hb", "w-0", step=1)
    stub.set_required_token("rotated")
    token.write_text("rotated\n")
    assert heartbeat.publish_heartbeat(client, "ns", "w-0-hb", "w-0", step=2)
    assert stub.mem.get_lease("ns", "w-0-hb")["metadata"]["annotations"][
        constants.ANNOTATION_HEARTBEAT_STEP] == "2"


def test_not_in_a_pod_without_a_base_url():
    with pytest.raises(RuntimeError, match="KUBERNETES_SERVICE_HOST"):
        kube.KubeCluster(env={})


# ------------------------------------------------------------ in-cluster
@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """A CA, and a server certificate for 127.0.0.1 that it signed."""
    if shutil.which("openssl") is None:
        pytest.fail("the openssl binary is needed to make the test's certificates")
    tmp = tmp_path_factory.mktemp("pki")

    def run(*args):
        subprocess.run(args, check=True, capture_output=True)

    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout",
        str(tmp / "ca.key"), "-out", str(tmp / "ca.crt"), "-days", "1", "-subj", "/CN=stub-ca")
    run("openssl", "req", "-newkey", "rsa:2048", "-nodes", "-keyout", str(tmp / "srv.key"),
        "-out", str(tmp / "srv.csr"), "-subj", "/CN=127.0.0.1")
    (tmp / "san.cnf").write_text("subjectAltName=IP:127.0.0.1\n")
    run("openssl", "x509", "-req", "-in", str(tmp / "srv.csr"), "-CA", str(tmp / "ca.crt"),
        "-CAkey", str(tmp / "ca.key"), "-CAcreateserial", "-days", "1", "-extfile",
        str(tmp / "san.cnf"), "-out", str(tmp / "srv.crt"))
    return tmp


@pytest.fixture
def in_cluster(pki, tmp_path, monkeypatch):
    """A TLS stub apiserver and a pod's view of it: the service env, and a
    service-account directory with the token and the CA."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(str(pki / "srv.crt"), str(pki / "srv.key"))
    server = StubApiServer(required_token="sa-token", ssl_context=ctx)
    sa = tmp_path / "serviceaccount"
    sa.mkdir()
    (sa / "token").write_text("sa-token")
    shutil.copy(pki / "ca.crt", sa / "ca.crt")
    monkeypatch.setattr(kube, "SA_DIR", str(sa))
    monkeypatch.setattr(jax_kube, "_SA_DIR", str(sa))
    # The JAX package's client reads the service env from the process.
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", str(server.port))
    heartbeat.stop()
    jax_heartbeat.stop()
    yield server
    heartbeat.stop()
    jax_heartbeat.stop()
    server.shutdown()


def pod_env(server, lease):
    return {"KUBERNETES_SERVICE_HOST": "127.0.0.1", "KUBERNETES_SERVICE_PORT": str(server.port),
            heartbeat.ENV_HEARTBEAT_LEASE: lease, heartbeat.ENV_HEARTBEAT_NAMESPACE: "ns",
            heartbeat.ENV_HEARTBEAT_INTERVAL: "0.05", "HOSTNAME": lease[:-3]}


def published(server, lease, want, timeout=20):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            annotations = server.mem.get_lease("ns", lease)["metadata"].get("annotations") or {}
        except KeyError:
            annotations = {}
        if all(annotations.get(k) == v for k, v in want.items()):
            return annotations
        time.sleep(0.02)
    raise AssertionError(f"{lease} never showed {want}")


def test_start_from_env_publishes_in_cluster_as_the_jax_package_does(in_cluster):
    want = {constants.ANNOTATION_HEARTBEAT_STEP: "7", constants.ANNOTATION_HEARTBEAT_CKPT: "5"}
    seen = {}
    for module, lease in ((heartbeat, "w-0-hb"), (jax_heartbeat, "w-1-hb")):
        publisher = module.start_from_env(env=pod_env(in_cluster, lease))
        assert publisher is not None
        module.record_progress(step=7, tokens_per_sec=12.5)
        module.record_checkpoint(5)
        seen[module] = published(in_cluster, lease, want)
        module.stop()
        assert in_cluster.mem.get_lease("ns", lease)["spec"]["holderIdentity"] == lease[:-3]
    assert seen[heartbeat] == seen[jax_heartbeat] == {
        **want, constants.ANNOTATION_HEARTBEAT_TPS: "12.5"}


def test_start_from_env_without_a_cluster_starts_no_sink(in_cluster):
    # A lease env outside a pod: no service host, no file bridge, no sink.
    env = pod_env(in_cluster, "w-0-hb")
    del env["KUBERNETES_SERVICE_HOST"]
    assert heartbeat.start_from_env(env=env) is None
    # A client that cannot be set up logs and starts nothing.
    env["KUBERNETES_SERVICE_HOST"] = ""
    assert heartbeat.start_from_env(env=env) is None
