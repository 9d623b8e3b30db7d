"""Minimal Kubernetes API client: what the agent needs, on the standard
library.

The port's copy of ``elastic_tpu_agent/kube/client.py``, written on
``http.client`` with an ``ssl`` context instead of ``requests``: get/list/
watch pods filtered to one node, get node, list every pod, merge-patch a
pod's annotations, post an Event, and the raw GET/POST/PUT/DELETE that the
ElasticTPU client (``crd.py``) builds on. The agent's
URLs, query parameters, pagination, watch-line handling and errors are
kept: ``KubeError`` on an unexpected status, ``None`` on a 404 where the
agent answers ``None``.

Connection: in-cluster (the service account's bearer token and CA) or a
kubeconfig (token, token file or client certificate, files or inline
``*-data``). A kubeconfig is YAML; where PyYAML is not installed, a
kubeconfig written as JSON (which kubectl also reads) is parsed with
``json``. Without a CA the server's certificate is not verified, as the
agent's ``verify=False``.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import ssl
from typing import Dict, Iterator, Optional, Tuple
from urllib.parse import urlencode, urlsplit

logger = logging.getLogger(__name__)

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeError(Exception):
    pass


class _Response:
    """A finished request: the status and the body."""

    def __init__(self, status_code: int, body: bytes) -> None:
        self.status_code = status_code
        self.body = body

    def json(self):
        return json.loads(self.body)


def _load_kubeconfig(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return json.loads(text)
    return yaml.safe_load(text)


class KubeClient:
    # Default (connect, read) timeout for every request: a black-holed
    # apiserver connection must surface as an exception, not a forever-hung
    # thread. watch_pods passes its own window-sized read timeout.
    DEFAULT_TIMEOUT = (5.0, 30.0)

    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        ca_cert: Optional[str] = None,
        client_cert: Optional[Tuple[str, str]] = None,
    ) -> None:
        parts = urlsplit(base_url.rstrip("/"))
        self._https = parts.scheme == "https"
        self._host = parts.hostname or "localhost"
        self._port = parts.port or (443 if self._https else 80)
        self._prefix = parts.path
        self._headers = {"Accept": "application/json"}
        if token:
            self._headers["Authorization"] = f"Bearer {token}"
        self._ssl: Optional[ssl.SSLContext] = None
        if self._https:
            if ca_cert:
                ctx = ssl.create_default_context(cafile=ca_cert)
            else:
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            if client_cert:
                ctx.load_cert_chain(*client_cert)
            self._ssl = ctx

    # -- constructors ---------------------------------------------------------

    @classmethod
    def in_cluster(cls) -> "KubeClient":
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise KubeError("not running in-cluster (no KUBERNETES_SERVICE_HOST)")
        token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
        ca_path = os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
        with open(token_path) as f:
            token = f.read().strip()
        ca = ca_path if os.path.exists(ca_path) else None
        return cls(f"https://{host}:{port}", token=token, ca_cert=ca)

    @classmethod
    def from_kubeconfig(cls, path: str) -> "KubeClient":
        """The common kubeconfig shapes: token, token-file or client-cert
        auth, with file paths or inline base64 ``*-data``."""
        import base64
        import tempfile

        def materialize(data_b64: str, suffix: str) -> str:
            f = tempfile.NamedTemporaryFile(
                prefix="elastic-tpu-kubeconfig-", suffix=suffix, delete=False
            )
            f.write(base64.b64decode(data_b64))
            f.close()
            return f.name

        cfg = _load_kubeconfig(path)
        ctx_name = cfg.get("current-context")
        ctx = next(
            c["context"] for c in cfg["contexts"] if c["name"] == ctx_name
        )
        cluster = next(
            c["cluster"] for c in cfg["clusters"] if c["name"] == ctx["cluster"]
        )
        user = next(u["user"] for u in cfg["users"] if u["name"] == ctx["user"])
        token = user.get("token")
        if not token and user.get("token-file"):
            with open(user["token-file"]) as tf:
                token = tf.read().strip()
        cert = user.get("client-certificate")
        key = user.get("client-key")
        if not cert and user.get("client-certificate-data"):
            cert = materialize(user["client-certificate-data"], ".crt")
        if not key and user.get("client-key-data"):
            key = materialize(user["client-key-data"], ".key")
        ca = cluster.get("certificate-authority")
        if not ca and cluster.get("certificate-authority-data"):
            ca = materialize(cluster["certificate-authority-data"], ".ca.crt")
        return cls(
            cluster["server"], token=token, ca_cert=ca,
            client_cert=(cert, key) if cert and key else None,
        )

    @classmethod
    def auto(cls, kubeconfig: str = "") -> "KubeClient":
        if kubeconfig:
            return cls.from_kubeconfig(kubeconfig)
        return cls.in_cluster()

    # -- request plumbing -----------------------------------------------------

    def _open(self, method: str, path: str, params: Optional[Dict] = None,
              body: Optional[dict] = None, content_type: str = "",
              timeout=None) -> Tuple[http.client.HTTPConnection,
                                     http.client.HTTPResponse]:
        connect_s, read_s = timeout or self.DEFAULT_TIMEOUT
        if self._https:
            conn = http.client.HTTPSConnection(
                self._host, self._port, timeout=connect_s,
                context=self._ssl)
        else:
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=connect_s)
        url = self._prefix + path
        if params:
            url += "?" + urlencode(params)
        headers = dict(self._headers)
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = content_type or "application/json"
        try:
            conn.connect()
            conn.sock.settimeout(read_s)
            conn.request(method, url, body=data, headers=headers)
            return conn, conn.getresponse()
        except Exception:
            conn.close()
            raise

    def _call(self, method: str, path: str, params: Optional[Dict] = None,
              body: Optional[dict] = None, content_type: str = "",
              timeout=None) -> _Response:
        conn, resp = self._open(method, path, params, body, content_type,
                                timeout)
        try:
            return _Response(resp.status, resp.read())
        finally:
            conn.close()

    def _get(self, path: str, params: Optional[Dict] = None) -> _Response:
        return self._call("GET", path, params)

    def _post(self, path: str, body: dict) -> _Response:
        return self._call("POST", path, body=body)

    def _put(self, path: str, body: dict) -> _Response:
        return self._call("PUT", path, body=body)

    def _delete(self, path: str) -> _Response:
        return self._call("DELETE", path)

    # -- API surface ----------------------------------------------------------

    def get_pod(self, namespace: str, name: str) -> Optional[dict]:
        """The pod's manifest, or None on 404 (an apiserver NotFound is a
        GC decision input)."""
        r = self._get(f"/api/v1/namespaces/{namespace}/pods/{name}")
        if r.status_code == 404:
            return None
        if r.status_code != 200:
            raise KubeError(f"get pod {namespace}/{name}: {r.status_code}")
        return r.json()

    def get_node(self, name: str) -> Optional[dict]:
        r = self._get(f"/api/v1/nodes/{name}")
        if r.status_code == 404:
            return None
        if r.status_code != 200:
            raise KubeError(f"get node {name}: {r.status_code}")
        return r.json()

    def list_pods(
        self, node_name: str, page_limit: int = 500
    ) -> Tuple[list, str]:
        """Every pod bound to ``node_name`` and the list's
        resourceVersion. Paginated: apiservers cap pages server-side, and
        a list that ignored ``continue`` would truncate the sitter's
        cache on a busy node."""
        items: list = []
        cont = ""
        while True:
            params = {
                "fieldSelector": f"spec.nodeName={node_name}",
                "limit": str(page_limit),
            }
            if cont:
                params["continue"] = cont
            r = self._get("/api/v1/pods", params=params)
            if r.status_code != 200:
                raise KubeError(f"list pods: {r.status_code}")
            body = r.json()
            items.extend(body.get("items", []))
            meta = body.get("metadata", {}) or {}
            rv = meta.get("resourceVersion", "")
            cont = meta.get("continue", "")
            if not cont:
                return items, rv

    def list_all_pods(self, page_limit: int = 500) -> list:
        """Every pod in the cluster (no node fieldSelector), paginated."""
        items: list = []
        cont = ""
        while True:
            params = {"limit": str(page_limit)}
            if cont:
                params["continue"] = cont
            r = self._get("/api/v1/pods", params=params)
            if r.status_code != 200:
                raise KubeError(f"list all pods: {r.status_code}")
            body = r.json()
            items.extend(body.get("items", []))
            cont = (body.get("metadata") or {}).get("continue", "")
            if not cont:
                return items

    def patch_pod_annotations(
        self, namespace: str, name: str, annotations: Dict[str, Optional[str]]
    ) -> Optional[dict]:
        """Merge-patch a pod's metadata.annotations (a None value deletes
        the key); None on 404, so that a caller retrying a cleanup can
        tell "gone" from "failed"."""
        r = self._call(
            "PATCH", f"/api/v1/namespaces/{namespace}/pods/{name}",
            body={"metadata": {"annotations": annotations}},
            content_type="application/merge-patch+json",
        )
        if r.status_code == 404:
            return None
        if r.status_code != 200:
            raise KubeError(
                f"patch pod {namespace}/{name}: {r.status_code}"
            )
        return r.json()

    def create_event(self, namespace: str, event: dict) -> dict:
        """POST a core/v1 Event (kube/events.py)."""
        r = self._post(f"/api/v1/namespaces/{namespace}/events", event)
        if r.status_code not in (200, 201):
            raise KubeError(f"create event: {r.status_code}")
        return r.json()

    def watch_pods(
        self, node_name: str, resource_version: str, timeout_s: int = 60
    ) -> Iterator[dict]:
        """Stream watch events ({"type": ..., "object": pod}) until the
        server closes the window. The caller re-lists on an error."""
        conn, resp = self._open(
            "GET", "/api/v1/pods",
            params={
                "watch": "true",
                "fieldSelector": f"spec.nodeName={node_name}",
                "resourceVersion": resource_version,
                "timeoutSeconds": str(timeout_s),
            },
            timeout=(self.DEFAULT_TIMEOUT[0], timeout_s + 10),
        )
        try:
            if resp.status != 200:
                raise KubeError(f"watch pods: {resp.status}")
            while True:
                line = resp.readline()
                if not line:
                    return
                line = line.strip()
                if line:
                    yield json.loads(line)
        finally:
            conn.close()
