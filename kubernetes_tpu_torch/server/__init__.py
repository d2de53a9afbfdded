"""L2 — the API server surface: the REST front-end (rest.py) with its watch
mux, admission, auth, audit, APF flow control and server-side apply, the
client and informer (client.py), the leader-elected control plane
(controlplane.py) and the metric registry (metrics.py). The counterpart of
`kubernetes_tpu/server/`, with the same export list."""

from .client import APIError, Informer, RESTClient  # noqa: F401
from .metrics import Registry, global_registry  # noqa: F401
from .rest import APIServer  # noqa: F401
