"""HTTP gateway: the network front over the multi-job transform
service (docs/SERVING.md).

The scheduler (``serve/``) holds the hard service parts — shared-pool scheduling, WFQ
fairness, quarantine, drain, crash recovery — behind the in-process
:class:`~adam_tpu_torch.api.transform_service.TransformService` seam; this
package puts a wire protocol over exactly that seam, dependency-free
(stdlib ``http.server`` + threads, the repo's no-new-deps discipline):

* :mod:`adam_tpu_torch.gateway.protocol` — the shared wire vocabulary:
  routes, limits, header names, Range parsing, the Retry-After
  derivation from the WFQ grant cadence, error-document shape.
* :mod:`adam_tpu_torch.gateway.server` — :class:`GatewayServer`, a threaded
  HTTP front: idempotency-keyed ``PUT /v1/jobs/<job>`` submission,
  typed back-pressure (``Busy(capacity)`` -> 429, ``Busy(draining)``
  -> 503, both with Retry-After), chunked NDJSON heartbeat streaming
  resumable from a line cursor, and Range-resumable part fetch with
  whole-part sha256 integrity.
* :mod:`adam_tpu_torch.gateway.client` — :class:`GatewayClient`, the typed
  stdlib client: submission with Retry-After-honoring backoff
  (utils/retry.RetryPolicy + seeded jitter), event-stream following
  that reconnects at its cursor, and byte-exact resumable downloads
  (the network twin of the journal's resume contract).

The CLI verbs (``adam-tpu serve --listen`` / ``submit`` / ``status`` /
``fetch`` / ``cancel`` and ``adam-tpu top --url``) are thin fronts
over these two classes.

The port's copy of ``adam_tpu/gateway/__init__.py`` (stdlib and numpy code, no JAX): the
wire formats, schemas and file layouts are JAX's, byte for byte.
"""

from adam_tpu_torch.gateway.client import GatewayBusy, GatewayClient, GatewayError
from adam_tpu_torch.gateway.protocol import parse_listen, retry_after_s
from adam_tpu_torch.gateway.server import GatewayServer

__all__ = [
    "GatewayBusy",
    "GatewayClient",
    "GatewayError",
    "GatewayServer",
    "parse_listen",
    "retry_after_s",
]
