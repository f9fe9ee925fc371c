"""Wire vocabulary shared by the gateway server and client
(docs/SERVING.md is the operator-facing reference).

Everything both sides must agree on lives here so neither can drift:
route prefixes, body/size limits, the custom header names, HTTP Range
parsing, the error-document schema, and the Retry-After derivation
from the scheduler's WFQ grant cadence.  The module is deliberately
transport-only — it imports nothing from the serve/ scheduler, so the
client stays importable on machines that never run a service.

The port's copy of ``adam_tpu/gateway/protocol.py`` (stdlib and numpy code, no JAX): the
wire formats, schemas and file layouts are JAX's, byte for byte.
"""

from __future__ import annotations

import re
import time
from typing import Optional

#: Discovery document the server durably writes at
#: ``<run-root>/gateway.json`` on bind (scripts and `adam-tpu submit`
#: read the URL from it when the operator used ``--listen host:0``).
GATEWAY_SCHEMA = "adam_tpu.gateway/1"

#: JSON body every non-2xx response carries.
ERROR_SCHEMA = "adam_tpu.gateway_error/1"

#: Route prefix; the full surface is documented in docs/SERVING.md:
#:   PUT    /v1/jobs/<job>                submit (idempotency-keyed;
#:                                        mints + echoes trace_id)
#:   GET    /v1/jobs                      service status
#:   GET    /v1/jobs/<job>                job status
#:   DELETE /v1/jobs/<job>                cancel at a window boundary
#:   GET    /v1/jobs/<job>/events         NDJSON heartbeat stream
#:   GET    /v1/jobs/<job>/trace          Chrome-trace JSON of the
#:                                        job's trace (fan-in links
#:                                        across fused batches)
#:   GET    /v1/jobs/<job>/parts          part listing (name/bytes/sha)
#:   GET    /v1/jobs/<job>/parts/<part>   part bytes (Range-resumable)
#:   GET    /metrics                      Prometheus text exposition
#:   GET    /incidents                    incident-bundle summaries
#:   GET    /slo                          SLO compliance + error-budget
#:                                        burn (utils/slo.py)
JOBS_PREFIX = "/v1/jobs"

#: Top-level observability routes (docs/OBSERVABILITY.md).
METRICS_PATH = "/metrics"
INCIDENTS_PATH = "/incidents"
SLO_PATH = "/slo"

#: JSON body of ``GET /incidents`` (``incidents`` holds
#: utils/incidents.summarize_bundle rows, oldest first).
INCIDENTS_SCHEMA = "adam_tpu.incidents/1"

#: JSON body of ``GET /slo``: ``enabled`` plus, when an engine is
#: armed, the utils/slo.py status document (per-objective compliance,
#: short/long burn rates, budget remaining).
SLO_STATUS_SCHEMA = "adam_tpu.slo_status/1"

#: Submission-manifest body cap: a JobSpec document is a few hundred
#: bytes; anything past this is a client bug or an attack, refused
#: with 413 before the body is read into memory.
MAX_MANIFEST_BYTES = 1 << 20

#: Part-fetch response chunk size (one ``gateway.fetch`` fault-point
#: arrival and one ``gateway.bytes_out`` increment per chunk).
FETCH_CHUNK_BYTES = 64 * 1024

#: Whole-part sha256 (lowercase hex), present on every part response —
#: full and ranged alike, always the digest of the ENTIRE part — so a
#: client that assembled a part across any number of resumed Range
#: fetches can verify the final bytes against one stable value.
HDR_PART_SHA256 = "X-Adam-Part-Sha256"

#: Total part size in bytes (rides every part response next to the
#: sha, so a ranged client knows when assembly is complete).
HDR_PART_SIZE = "X-Adam-Part-Size"

#: Line cursor an event-stream response STARTS at; the client's next
#: cursor is this plus the number of NDJSON lines it received.
HDR_EVENT_CURSOR = "X-Adam-Event-Cursor"

NDJSON_MIME = "application/x-ndjson"

#: Control line the event stream interleaves with the verbatim
#: heartbeat lines: ``{"schema": <this>, "cursor": N}`` declares that
#: the NEXT heartbeat line is line N of the current file.  One is sent
#: at stream start (echoing the effective start position) and another
#: whenever the server resets to 0 (heartbeat rotation, or a poll
#: cursor that overshoots the rotated file) — without it the client's
#: cursor would silently diverge after a rotation: polls would
#: re-download the whole file forever and follow-mode reconnects would
#: skip real lines.  Control lines are not heartbeat lines: consumers
#: keying on the heartbeat schema ignore them for free.
EVENTS_CTRL_SCHEMA = "adam_tpu.gateway_events/1"


def events_ctrl_line(cursor: int) -> dict:
    return {"schema": EVENTS_CTRL_SCHEMA, "cursor": int(cursor)}

#: Typed back-pressure mapping (docs/SERVING.md): the scheduler's
#: ``Busy.kind`` to the HTTP status the gateway answers with.  429 is
#: "come back later, the refusal is about YOU" — either ``capacity``
#: (slots full; Retry-After from the WFQ grant cadence) or ``quota``
#: (the tenant spent its rolling-window budget; Retry-After is
#: budget-derived, carried on the Busy itself) — clients branch on the
#: error document's ``kind``.  503 is "going away (drain) or
#: transiently unhealthy".  All carry Retry-After.
BUSY_HTTP_STATUS = {"capacity": 429, "quota": 429, "draining": 503}

#: Part names the gateway will serve: the ``part-r-NNNNN.parquet``
#: writer contract (io/parquet.py) plus the realigned-tail part —
#: conservatively, any ``part-``-prefixed simple filename.  No path
#: separators, no dotfiles, nothing outside the output directory.
_PART_NAME_RE = re.compile(r"^part-[A-Za-z0-9][A-Za-z0-9._-]*$")

_RANGE_RE = re.compile(r"^bytes=(\d*)-(\d*)$")


def part_name_ok(name: str) -> bool:
    return bool(_PART_NAME_RE.match(name or "")) and ".." not in name


def parse_listen(text: str) -> tuple[str, int]:
    """``HOST:PORT`` -> (host, port); port 0 asks the OS for a free
    one (the bound address is then published in ``gateway.json``)."""
    host, sep, port = (text or "").rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"--listen wants HOST:PORT (got {text!r}); use 127.0.0.1:0 "
            "for an OS-assigned port"
        )
    try:
        p = int(port)
    except ValueError:
        raise ValueError(
            f"--listen port {port!r} is not an integer"
        ) from None
    if not 0 <= p <= 65535:
        raise ValueError(f"--listen port {p} out of range 0..65535")
    return host, p


class RangeError(ValueError):
    """Unsatisfiable/malformed Range header (HTTP 416)."""


def parse_range(header: Optional[str], size: int) -> Optional[tuple]:
    """``Range: bytes=start-[end]`` -> inclusive ``(start, end)``.

    None means "no range: serve the whole part".  Suffix ranges
    (``bytes=-N``, last N bytes) are supported for completeness; a
    start at or past the part size — the resumed-download client whose
    partial file somehow outgrew the part — raises :class:`RangeError`
    so the server answers 416 with the real size and the client can
    restart clean instead of assembling garbage.  Multipart ranges are
    refused (one resuming client needs exactly one open-ended range).
    """
    if not header:
        return None
    m = _RANGE_RE.match(header.strip())
    if not m:
        raise RangeError(
            f"unsupported Range {header!r} (want bytes=start-[end])"
        )
    start_s, end_s = m.groups()
    if not start_s and not end_s:
        raise RangeError(f"empty Range {header!r}")
    if not start_s:  # suffix: last N bytes
        n = int(end_s)
        if n <= 0:
            raise RangeError(f"zero-length suffix Range {header!r}")
        return max(0, size - n), size - 1
    start = int(start_s)
    end = int(end_s) if end_s else size - 1
    if start >= size or end < start:
        raise RangeError(
            f"Range {header!r} unsatisfiable for a {size}-byte part"
        )
    return start, min(end, size - 1)


#: Retry-After bounds (seconds): never tell a client "now" (it just
#: lost a capacity race; hammering doesn't free slots) and never park
#: it past half a minute (slots turn over at job granularity; the
#: client re-probes cheaply).
RETRY_AFTER_MIN_S = 1
RETRY_AFTER_MAX_S = 30
_RETRY_AFTER_DEFAULT_S = 2

#: How many window grants a freed slot is assumed to trail the current
#: cadence by: a refused submission waits roughly one in-flight job's
#: worth of recent window throughput, not one window.
_GRANT_BATCH = 8


def retry_after_s(grant_times: list, now: Optional[float] = None) -> int:
    """Derive the Retry-After hint from the WFQ grant history.

    The fairness interleaver stamps every window grant
    (serve/fairness.WeightedInterleaver.grant_times); the median
    inter-grant gap over the recent ring is the service's live window
    cadence.  A capacity-refused client is told to come back after
    ``_GRANT_BATCH`` windows' worth of that cadence — if windows are
    draining fast, retries come fast; if the pool is grinding, clients
    back off instead of dogpiling — clamped to
    [:data:`RETRY_AFTER_MIN_S`, :data:`RETRY_AFTER_MAX_S`].  With
    fewer than 2 grants (cold service, stalled pool) the conservative
    default applies.  ``now`` widens the newest gap so a service that
    stopped granting (wedged pool) decays toward the max instead of
    advertising its last healthy cadence forever.
    """
    times = sorted(grant_times or [])[-64:]
    if len(times) < 2:
        return _RETRY_AFTER_DEFAULT_S
    gaps = sorted(b - a for a, b in zip(times, times[1:]))
    cadence = gaps[len(gaps) // 2]
    if now is not None:
        # a pool that stopped granting is slower than its history
        # says: the time since the newest grant overrides the median
        # once it exceeds it, decaying the hint toward the cap
        cadence = max(cadence, now - times[-1])
    est = cadence * _GRANT_BATCH
    return int(min(RETRY_AFTER_MAX_S, max(RETRY_AFTER_MIN_S, round(est))))


def error_doc(status: int, kind: str, message: str,
              retry_after: Optional[int] = None) -> dict:
    """The JSON body of every non-2xx response (stable shape: clients
    branch on ``kind``, humans read ``error``)."""
    doc = {
        "schema": ERROR_SCHEMA,
        "status": int(status),
        "kind": kind,
        "error": message,
    }
    if retry_after is not None:
        doc["retry_after_s"] = int(retry_after)
    return doc


def now_monotonic() -> float:
    """Seam for tests to pin the Retry-After clock."""
    return time.monotonic()
