"""The port's Lease client: the three calls the heartbeat makes
(``runtime/heartbeat.py`` ``publish_heartbeat``) against the Kubernetes
``coordination.k8s.io/v1`` API, named after the JAX package's
``cluster/kube.py`` ``KubeCluster``, of which it keeps the Lease verbs and
the service-account auth only.

In a pod it reads the apiserver from ``KUBERNETES_SERVICE_HOST`` and
``KUBERNETES_SERVICE_PORT``, and the bearer token and the CA from
``token`` and ``ca.crt`` under ``SA_DIR``; constructor arguments override
each. The standard library does the HTTP (``http.client``) and the TLS
(``ssl``, verified against the CA file). The token file is read again on a
401, since bound service-account tokens rotate under a long run.

Errors as the heartbeat reads them, by class name: ``NotFound`` (404) and
``Conflict`` (409, a lost optimistic-concurrency round); any other answer
raises ``ApiError`` with its status.
"""

from __future__ import annotations

import http.client
import json
import os
import ssl
import urllib.parse
from typing import Dict, Optional

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
_LEASES = "/apis/coordination.k8s.io/v1/namespaces/{namespace}/leases"
_TIMEOUT = 10.0  # seconds a request may take: a beat comes every few seconds


class NotFound(KeyError):
    """The Lease does not exist (404)."""


class Conflict(Exception):
    """A write lost an optimistic-concurrency round (409)."""


class ApiError(RuntimeError):
    """Any other answer but 2xx."""

    def __init__(self, status: int, message: str):
        super().__init__(f"apiserver answered {status}: {message}")
        self.status = status


class KubeCluster:
    """``get_lease``, ``create_lease`` and ``update_lease`` over HTTPS with a
    bearer token; one connection a request (a beat comes every few
    seconds)."""

    def __init__(self, base_url: Optional[str] = None, token: Optional[str] = None,
                 ca_file: Optional[str] = None, token_file: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None):
        env = os.environ if env is None else env
        if base_url is None:
            host = env.get("KUBERNETES_SERVICE_HOST")
            if not host:
                raise RuntimeError("KubeCluster: no base_url and KUBERNETES_SERVICE_HOST "
                                   "is unset (not in a pod)")
            port = env.get("KUBERNETES_SERVICE_PORT", "443")
            host = f"[{host}]" if ":" in host else host  # an IPv6 service address
            base_url = f"https://{host}:{port}"
        if token is None and token_file is None and os.path.exists(f"{SA_DIR}/token"):
            token_file = f"{SA_DIR}/token"
        if ca_file is None and os.path.exists(f"{SA_DIR}/ca.crt"):
            ca_file = f"{SA_DIR}/ca.crt"
        self._url = urllib.parse.urlparse(base_url)
        self._token_file = token_file
        self._token = token if token is not None else self._read_token()
        self._ssl = (ssl.create_default_context(cafile=ca_file)
                     if self._url.scheme == "https" else None)

    def _read_token(self) -> Optional[str]:
        if self._token_file is None:
            return None
        with open(self._token_file) as f:
            return f.read().strip()

    def _connect(self) -> http.client.HTTPConnection:
        host, port = self._url.hostname, self._url.port
        if self._ssl is not None:
            return http.client.HTTPSConnection(host, port or 443, timeout=_TIMEOUT,
                                               context=self._ssl)
        return http.client.HTTPConnection(host, port or 80, timeout=_TIMEOUT)

    def _send(self, method: str, path: str, body: Optional[dict]):
        headers = {"Accept": "application/json"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        conn = self._connect()
        try:
            conn.request(method, path, body=data, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def _request(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        status, raw = self._send(method, path, body)
        if status == 401 and self._token_file is not None:
            fresh = self._read_token()
            if fresh != self._token:  # the token rotated under us
                self._token = fresh
                status, raw = self._send(method, path, body)
        if status == 404:
            raise NotFound(path)
        if status == 409:
            raise Conflict(raw.decode(errors="replace"))
        if not 200 <= status < 300:
            raise ApiError(status, raw.decode(errors="replace"))
        return json.loads(raw) if raw else {}

    def _path(self, namespace: str, name: str = "") -> str:
        base = _LEASES.format(namespace=namespace)
        return f"{base}/{name}" if name else base

    def get_lease(self, namespace: str, name: str) -> dict:
        return self._request("GET", self._path(namespace, name))

    def create_lease(self, lease: dict) -> dict:
        meta = lease.get("metadata", {})
        return self._request("POST", self._path(meta.get("namespace", "default")), lease)

    def update_lease(self, lease: dict) -> dict:
        meta = lease.get("metadata", {})
        return self._request("PUT", self._path(meta.get("namespace", "default"), meta["name"]),
                             lease)
