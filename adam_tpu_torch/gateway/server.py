"""``GatewayServer`` — the threaded HTTP front over
:class:`~adam_tpu_torch.api.transform_service.TransformService`.

Dependency-free by design (stdlib ``http.server`` + threads): the
gateway is a thin wire adapter, and every hard property it advertises
is one the scheduler already proves in-process — admission stays
bounded because ``JobScheduler.submit`` is, drain stays graceful
because ``RunCancelled`` is, resume stays byte-exact because parts
publish atomically.  What the gateway ADDS is the protocol surface
(docs/SERVING.md):

* **Idempotency-keyed submission** — ``PUT /v1/jobs/<job>`` with a
  JobSpec-document body.  The job id in the path is the idempotency
  key: re-PUTting an identical document returns the job's current
  state (200) whether the first attempt's response was lost to the
  network or the whole gateway restarted in between (``recover()``
  re-registers every durably recorded job); a conflicting document
  under a taken id is 409, never a silent overwrite.
* **Typed back-pressure** — scheduler ``Busy(capacity)`` maps to 429,
  ``Busy(draining)`` (and a gateway that stopped accepting ahead of a
  drain) to 503; both carry ``Retry-After`` derived from the WFQ
  grant cadence (gateway/protocol.retry_after_s), so clients back off
  at the pace the pool is actually draining windows.
* **Resumable event streaming** — ``GET /v1/jobs/<job>/events`` tails
  the job's ``adam_tpu.heartbeat/7`` NDJSON stream as a chunked
  response, resumable from a line ``cursor`` (a tailer that
  reconnects re-requests from its last count; a heartbeat-file
  rotation resets the cursor, exactly like ``adam-tpu top``'s
  shrink-means-fresh rule).  Torn trailing lines are never shipped.
* **Resumable part fetch** — ``GET /v1/jobs/<job>/parts/<part>``
  honors ``Range`` and stamps every response with the whole-part
  sha256 + size, so a client SIGKILLed mid-download resumes byte-exact
  and verifies the assembly (the network twin of the journal's resume
  contract).
* **Observability surfaces** (docs/OBSERVABILITY.md) — submission
  mints the job's trace context (``trace_id`` echoed in the 201 and
  persisted via JOB.json); ``GET /metrics`` serves Prometheus text
  exposition off the live tracer snapshot; ``GET /v1/jobs/<job>/trace``
  serves the job's Chrome-trace view across the fused-batch boundary;
  ``GET /incidents`` lists the run root's incident bundles.

Full citizenship in the cross-cutting subsystems: ``gateway.accept``/
``gateway.stream``/``gateway.fetch`` fault points (a ``transient``
clause at accept surfaces as a 503 the client policy absorbs; a
``kill`` at fetch is the chaos harness's mid-download gateway death),
``gateway.requests``/``gateway.busy``/``gateway.bytes_out`` counters +
the ``gateway.request.seconds`` histogram, and SIGTERM drain ordering
owned by the CLI: stop accepting -> 503 -> scheduler drain -> settled
-> exit 0.

The port's copy of ``adam_tpu/gateway/server.py`` (stdlib and numpy code, no JAX): the
wire formats, schemas and file layouts are JAX's, byte for byte.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from adam_tpu_torch.gateway import protocol
from adam_tpu_torch.serve.job import JobSpec, Admitted, Busy
from adam_tpu_torch.serve.job import _JOB_ID_RE as JOB_ID_RE
from adam_tpu_torch.utils import faults
from adam_tpu_torch.utils import telemetry as tele
from adam_tpu_torch.utils.durability import atomic_write_json
from adam_tpu_torch.utils.faults import PermanentFault, TransientFault

log = logging.getLogger(__name__)

#: How often a following event stream re-polls the heartbeat file.
_STREAM_POLL_S = 0.2

GATEWAY_JSON = "gateway.json"


class _HTTPError(Exception):
    """Internal routing error -> one JSON error response."""

    def __init__(self, status: int, kind: str, message: str,
                 retry_after: Optional[int] = None,
                 headers: Optional[dict] = None):
        super().__init__(message)
        self.status = status
        self.kind = kind
        self.message = message
        self.retry_after = retry_after
        self.headers = dict(headers or {})


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1: persistent connections + chunked responses for the
    # event stream (1.0 has no chunked encoding at all)
    protocol_version = "HTTP/1.1"
    server_version = "adam-tpu-gateway/1"

    # ---- plumbing ------------------------------------------------------
    @property
    def gw(self) -> "GatewayServer":
        return self.server.gateway  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # stderr-per-request is noise
        log.debug("gateway %s: " + fmt, self.client_address[0], *args)

    def do_GET(self):
        self._dispatch("GET")

    def do_PUT(self):
        self._dispatch("PUT")

    def do_DELETE(self):
        self._dispatch("DELETE")

    def end_headers(self):
        # once headers are on the wire, an error can no longer become
        # a JSON error response — _dispatch aborts the connection
        # instead of corrupting the framed body with a second status
        # line (the client resumes via Range / its line cursor)
        self._sent_headers = True
        super().end_headers()

    def _dispatch(self, method: str) -> None:
        t0 = time.monotonic()
        self._sent_headers = False
        split = urlsplit(self.path)
        segs = [s for s in split.path.split("/") if s]
        query = parse_qs(split.query)
        # fault attribution: the job id when the route names one, else
        # the raw path — a clause can target one tenant's wire traffic
        target = segs[2] if len(segs) > 2 else split.path
        try:
            try:
                faults.point("gateway.accept", device=target)
                self._route(method, segs, query)
            except _HTTPError:
                raise
            except protocol.RangeError:
                raise  # _serve_part re-raises with the size attached
            except TransientFault as e:
                # injected wire flake: surface as retryable 503 so the
                # client-side policy (Retry-After + backoff) absorbs it
                raise _HTTPError(
                    503, "transient", str(e),
                    retry_after=protocol.RETRY_AFTER_MIN_S,
                ) from e
            except PermanentFault as e:
                raise _HTTPError(500, "permanent", str(e)) from e
            except (BrokenPipeError, ConnectionResetError):
                raise
            except Exception as e:  # noqa: BLE001 — wire boundary
                log.exception("gateway: unhandled error on %s %s",
                              method, self.path)
                raise _HTTPError(
                    500, "internal", f"{type(e).__name__}: {e}"
                ) from e
        except _HTTPError as e:
            if self._sent_headers:
                # mid-body failure (an injected gateway.fetch/stream
                # fault, a part unreadable under us): the response is
                # already framed, so ABORT — the client sees a short
                # read and resumes via Range / its cursor, instead of
                # parsing an interleaved error document as part bytes
                log.warning("gateway: aborting in-flight response "
                            "(%s %s): %s", method, self.path, e.message)
                self.close_connection = True
            else:
                try:
                    self._send_error(e)
                except (BrokenPipeError, ConnectionResetError):
                    pass
        except (BrokenPipeError, ConnectionResetError):
            # the client went away mid-response; its retry will resume
            pass
        finally:
            tele.TRACE.count(tele.C_GW_REQUESTS)
            tele.TRACE.observe(
                tele.H_GW_REQUEST_SECONDS, time.monotonic() - t0
            )

    # ---- routing -------------------------------------------------------
    def _route(self, method: str, segs: list, query: dict) -> None:
        if segs == ["metrics"]:
            if method != "GET":
                raise _HTTPError(405, "method", f"{method} on /metrics")
            self._metrics()
            return
        if segs == ["incidents"]:
            if method != "GET":
                raise _HTTPError(405, "method",
                                 f"{method} on /incidents")
            self._incidents()
            return
        if segs == ["slo"]:
            if method != "GET":
                raise _HTTPError(405, "method", f"{method} on /slo")
            self._slo()
            return
        if segs[:2] != ["v1", "jobs"]:
            raise _HTTPError(
                404, "not_found",
                f"unknown route {self.path!r} (the surface is "
                f"{protocol.JOBS_PREFIX}[/<job>[/events|/trace|/parts"
                "[/<part>]]], /metrics, /incidents and /slo; "
                "docs/SERVING.md)",
            )
        rest = segs[2:]
        if not rest:
            if method != "GET":
                raise _HTTPError(405, "method", f"{method} on /v1/jobs")
            self._send_json(200, self.gw.service.status())
            return
        job = rest[0]
        if not JOB_ID_RE.match(job):
            raise _HTTPError(
                400, "bad_job_id",
                f"job id {job!r} must match {JOB_ID_RE.pattern}",
            )
        if len(rest) == 1:
            if method == "PUT":
                self._submit(job)
            elif method == "GET":
                self._send_json(200, self._job_view(job))
            elif method == "DELETE":
                self._cancel(job)
            else:
                raise _HTTPError(405, "method", f"{method} on a job")
            return
        if method != "GET":
            raise _HTTPError(405, "method",
                             f"{method} on {'/'.join(rest[1:])}")
        if rest[1] == "events" and len(rest) == 2:
            self._stream_events(job, query)
        elif rest[1] == "trace" and len(rest) == 2:
            self._job_trace(job)
        elif rest[1] == "parts" and len(rest) == 2:
            self._list_parts(job)
        elif rest[1] == "parts" and len(rest) == 3:
            self._serve_part(job, rest[2])
        else:
            raise _HTTPError(404, "not_found",
                             f"unknown job route {self.path!r}")

    # ---- submission (idempotency-keyed) --------------------------------
    def _submit(self, job: str) -> None:
        body = self._read_body()
        try:
            doc = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise _HTTPError(
                400, "bad_manifest", f"manifest body is not JSON: {e}"
            ) from None
        if not isinstance(doc, dict):
            raise _HTTPError(
                400, "bad_manifest",
                "manifest body must be one JSON job object",
            )
        if doc.get("job_id") not in (None, job):
            raise _HTTPError(
                400, "bad_manifest",
                f"body job_id {doc['job_id']!r} contradicts the path "
                f"job id {job!r} (the path is the idempotency key)",
            )
        doc = dict(doc, job_id=job)
        unknown = set(doc) - set(JobSpec.__dataclass_fields__)
        if unknown:
            raise _HTTPError(
                400, "bad_manifest",
                f"unknown manifest field(s) {sorted(unknown)}",
            )
        try:
            spec = JobSpec.from_doc(doc)
        except (TypeError, ValueError) as e:
            raise _HTTPError(400, "bad_manifest", str(e)) from None
        if self._idempotent_reply(job, spec):
            return
        if not self.gw.accepting:
            # drain ordering step 1 (docs/SERVING.md): the gateway
            # stops accepting BEFORE the scheduler drains, so a
            # submission racing a SIGTERM still gets the typed 503
            self._send_busy(
                Busy("gateway is draining; not accepting jobs",
                     kind="draining"),
            )
            return
        # trace context is minted HERE (docs/OBSERVABILITY.md): the
        # gateway is the job's entry point, so its submit span is the
        # trace root; the id persists via JOB.json (spec round-trip)
        # and is echoed below so the client can correlate
        if spec.trace_id is None:
            spec.trace_id = tele.mint_trace_id()
        with tele.TRACE.span(tele.SPAN_GW_SUBMIT, job=job,
                             tenant=spec.tenant, trace=spec.trace_id):
            got = self.gw.service.submit(spec)
        if isinstance(got, Admitted):
            self._send_json(201, {
                "job_id": job,
                "state": "pending",
                "trace_id": spec.trace_id,
            })
            return
        if got.kind == "duplicate":
            # lost a submit race with another client retry: answer
            # idempotently off the now-registered record
            if self._idempotent_reply(job, spec):
                return
            raise _HTTPError(
                409, "conflict",
                f"job {job!r} is registered but its record is not "
                "readable yet; retry",
                retry_after=protocol.RETRY_AFTER_MIN_S,
            )
        self._send_busy(got)

    def _idempotent_reply(self, job: str, spec: JobSpec) -> bool:
        """200 when ``job`` is already tracked with an IDENTICAL spec
        (a duplicate-safe client retry — across gateway restarts too,
        because ``recover()`` re-registers every durable JOB.json);
        409 on a different spec under the same id.  False when the job
        is unknown (a genuinely new submission) — or interrupted/
        quarantined: those terminal states are the ones a deliberate
        re-PUT RESUMES (the cancel verb promises exactly that), so
        they fall through to ``submit``, which re-admits against the
        job's journal."""
        view = self.gw.service.status()["jobs"].get(job)
        if view is None:
            return False
        stored = dict(view.get("spec") or {})
        incoming = spec.to_doc()
        if incoming.get("trace_id") is None:
            # the gateway minted the stored trace_id — a client retry
            # that never saw the first response cannot echo it, so an
            # absent incoming trace_id matches any stored one (an
            # EXPLICIT mismatched trace_id is still a conflict)
            stored.pop("trace_id", None)
            incoming.pop("trace_id", None)
        if stored == incoming:
            if view["state"] in ("interrupted", "quarantined"):
                # deliberate re-PUT resume: keep the job's ORIGINAL
                # trace — one job is one trace however many attempts
                if spec.trace_id is None:
                    spec.trace_id = (
                        (view.get("spec") or {}).get("trace_id")
                    )
                return False
            self._send_json(200, {
                "job_id": job,
                "state": view["state"],
                "duplicate": True,
                "trace_id": (view.get("spec") or {}).get("trace_id"),
            })
            return True
        raise _HTTPError(
            409, "conflict",
            f"job id {job!r} is taken by a different spec "
            "(idempotent re-PUT requires an identical manifest)",
        )

    def _send_busy(self, busy: Busy) -> None:
        status = protocol.BUSY_HTTP_STATUS.get(busy.kind, 429)
        # the quota leg carries its own budget-derived hint (when the
        # tenant's rolling window frees enough spend, serve/quota.py)
        # — it OVERRIDES the grant-cadence estimate, which describes
        # slot turnover, not budget refill
        retry = getattr(busy, "retry_after_s", None)
        if retry is None:
            retry = protocol.retry_after_s(
                self.gw.service.scheduler.grant_times(),
                now=protocol.now_monotonic(),
            )
        tele.TRACE.count(tele.C_GW_BUSY)
        self._send_json(
            status,
            protocol.error_doc(status, busy.kind, busy.reason,
                               retry_after=retry),
            headers={"Retry-After": str(retry)},
        )

    # ---- observability surfaces ----------------------------------------
    def _metrics(self) -> None:
        """``GET /metrics``: Prometheus text exposition rendered from
        the live global tracer snapshot.  The scrape counter bumps
        BEFORE the snapshot, so a scraper always sees its own scrape
        counted — two consecutive scrapes read strictly increasing
        ``adam_tpu_gateway_metrics_scrapes`` (the smoke test's
        monotonicity probe)."""
        from adam_tpu_torch.gateway import metrics as metrics_mod
        from adam_tpu_torch.utils import slo as slo_mod

        tele.TRACE.count(tele.C_GW_SCRAPES)
        body = metrics_mod.render_prometheus(
            tele.TRACE.snapshot(), slo_status=slo_mod.status()
        ).encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type",
                         metrics_mod.PROMETHEUS_CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        tele.TRACE.count(tele.C_GW_BYTES_OUT, len(body))

    def _incidents(self) -> None:
        """``GET /incidents``: bundle summaries under the scheduler's
        run root (the dir utils/incidents.py is armed on in serve
        mode), oldest first."""
        from adam_tpu_torch.utils import incidents as incidents_mod

        rows = incidents_mod.list_bundles(
            self.gw.service.scheduler.run_root
        )
        self._send_json(200, {
            "schema": protocol.INCIDENTS_SCHEMA,
            "incidents": rows,
        })

    def _slo(self) -> None:
        """``GET /slo``: the armed SLO engine's compliance document —
        per-objective compliance, short/long-window burn rates, and
        error-budget remaining (utils/slo.py).  Always 200: a service
        running without ``--slo`` answers ``enabled: false`` so a
        fleet prober needs no per-service configuration to ask."""
        from adam_tpu_torch.utils import slo as slo_mod

        status = slo_mod.status()
        doc = {
            "schema": protocol.SLO_STATUS_SCHEMA,
            "enabled": status is not None,
        }
        if status is not None:
            doc["slo"] = status
        self._send_json(200, doc)

    def _job_trace(self, job: str) -> None:
        """``GET /v1/jobs/<job>/trace``: the job's trace as Chrome
        trace-event JSON — events stamped with its trace_id plus fused
        coalescer dispatches whose fan-in ``links`` name it, so the
        view crosses the fused-batch boundary (submit -> fused
        dispatch -> part write)."""
        view = self.gw.service.status()["jobs"].get(job)
        if view is None:
            raise _HTTPError(404, "not_found", f"no job {job!r}")
        trace_id = (view.get("spec") or {}).get("trace_id")
        if not trace_id:
            raise _HTTPError(
                404, "not_found",
                f"job {job!r} carries no trace context (submitted "
                "before tracing existed?)",
            )
        doc = tele.TRACE.to_chrome_trace(trace_id)
        doc["job_id"] = job
        doc["trace_id"] = trace_id
        self._send_json(200, doc)

    # ---- status / cancel -----------------------------------------------
    def _job_view(self, job: str) -> dict:
        view = self.gw.service.status()["jobs"].get(job)
        if view is None:
            raise _HTTPError(404, "not_found", f"no job {job!r}")
        return dict(view, job_id=job)

    def _cancel(self, job: str) -> None:
        view = self.gw.service.status()["jobs"].get(job)
        if view is None:
            raise _HTTPError(404, "not_found", f"no job {job!r}")
        if self.gw.service.cancel(job):
            self._send_json(202, {"job_id": job, "cancelling": True})
            return
        raise _HTTPError(
            409, "conflict",
            f"job {job!r} is already {view['state']}; nothing to cancel",
        )

    # ---- event streaming -----------------------------------------------
    def _stream_events(self, job: str, query: dict) -> None:
        path = self.gw.service.scheduler.heartbeat_path(job)
        known = job in self.gw.service.status()["jobs"]
        if not known and not os.path.isfile(path):
            raise _HTTPError(404, "not_found", f"no job {job!r}")
        try:
            cursor = max(0, int(query.get("cursor", ["0"])[0]))
        except ValueError:
            raise _HTTPError(
                400, "bad_cursor",
                f"cursor {query['cursor'][0]!r} is not an integer",
            ) from None
        follow = query.get("follow", ["1"])[0] != "0"
        self.send_response(200)
        self.send_header("Content-Type", protocol.NDJSON_MIME)
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header(protocol.HDR_EVENT_CURSOR, str(cursor))
        self.end_headers()
        # declare the effective start position in-stream: it is the
        # only channel that can also announce a mid-stream reset
        # (rotation), so the client's cursor never silently diverges
        self._write_ctrl(cursor)
        pos = 0
        buf = ""
        seen = 0  # complete lines observed in the current file
        done = False
        while True:
            faults.point("gateway.stream", device=job)
            try:
                size = os.path.getsize(path)
            except OSError:
                size = None
            if size is not None:
                if size < pos:
                    # heartbeat rotation (ADAM_TPU_PROGRESS_MAX_BYTES):
                    # the file restarted — so does the line cursor,
                    # the same shrink-means-fresh rule `adam-tpu top`
                    # applies to its local tail
                    pos, buf, seen, cursor = 0, "", 0, 0
                    self._write_ctrl(0)
                if size > pos:
                    with open(path, "rb") as fh:
                        fh.seek(pos)
                        chunk = fh.read()
                        pos = fh.tell()
                    buf += chunk.decode("utf-8", errors="replace")
                    while True:
                        nl = buf.find("\n")
                        if nl < 0:
                            break  # torn tail: never shipped
                        line, buf = buf[:nl + 1], buf[nl + 1:]
                        seen += 1
                        if seen <= cursor:
                            continue
                        self._write_chunk(line.encode("utf-8"))
                        try:
                            if json.loads(line).get("done"):
                                done = True
                        except ValueError:
                            pass
            if not follow and size is not None and seen < cursor:
                # the heartbeat rotated between two non-follow polls:
                # the file now holds fewer lines than the client's
                # cursor.  Re-deliver from the top, announcing the
                # reset so the client re-anchors its cursor —
                # starving the poller forever would be worse
                pos, buf, seen, cursor = 0, "", 0, 0
                self._write_ctrl(0)
                continue
            if done or (not follow) or self.gw.stopping:
                break
            time.sleep(_STREAM_POLL_S)
        self._write_chunk(b"")  # terminal chunk

    # ---- part listing / fetch ------------------------------------------
    def _parts_dir(self, job: str) -> tuple:
        """(output dir, status view) — one status() pass serves both
        the routing and the response's state field."""
        view = self.gw.service.status()["jobs"].get(job)
        if view is None or not view.get("spec"):
            raise _HTTPError(404, "not_found", f"no job {job!r}")
        return os.path.abspath(view["spec"]["output"]), view

    def _list_parts(self, job: str) -> None:
        out_dir, view = self._parts_dir(job)
        parts = []
        try:
            names = sorted(os.listdir(out_dir))
        except OSError:
            names = []  # nothing published yet
        for name in names:
            if not protocol.part_name_ok(name):
                continue
            path = os.path.join(out_dir, name)
            if not os.path.isfile(path):
                continue
            parts.append({
                "name": name,
                "bytes": os.path.getsize(path),
                "sha256": self.gw.part_sha256(path),
            })
        self._send_json(200, {
            "job_id": job,
            "state": view["state"],
            "parts": parts,
        })

    def _serve_part(self, job: str, name: str) -> None:
        if not protocol.part_name_ok(name):
            raise _HTTPError(
                404, "not_found",
                f"{name!r} is not a servable part name",
            )
        out_dir, _view = self._parts_dir(job)
        path = os.path.join(out_dir, name)
        # belt and braces on top of the name regex: the resolved path
        # must stay inside the job's output directory
        if os.path.dirname(os.path.abspath(path)) != out_dir or \
                not os.path.isfile(path):
            raise _HTTPError(404, "not_found",
                             f"job {job!r} has no part {name!r}")
        size = os.path.getsize(path)
        try:
            rng = protocol.parse_range(self.headers.get("Range"), size)
        except protocol.RangeError as e:
            raise _HTTPError(
                416, "bad_range", str(e),
                headers={"Content-Range": f"bytes */{size}"},
            ) from None
        start, end = rng if rng is not None else (0, size - 1)
        n = max(0, end - start + 1)
        sha = self.gw.part_sha256(path)
        self.send_response(206 if rng is not None else 200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(n))
        self.send_header("Accept-Ranges", "bytes")
        self.send_header(protocol.HDR_PART_SHA256, sha)
        self.send_header(protocol.HDR_PART_SIZE, str(size))
        if rng is not None:
            self.send_header("Content-Range",
                             f"bytes {start}-{end}/{size}")
        self.end_headers()
        with open(path, "rb") as fh:
            fh.seek(start)
            left = n
            while left > 0:
                faults.point("gateway.fetch", device=job)
                chunk = fh.read(min(protocol.FETCH_CHUNK_BYTES, left))
                if not chunk:
                    break  # truncated underneath us; client sha check
                self.wfile.write(chunk)
                tele.TRACE.count(tele.C_GW_BYTES_OUT, len(chunk))
                left -= len(chunk)

    # ---- response/body primitives --------------------------------------
    def _write_ctrl(self, cursor: int) -> None:
        self._write_chunk(
            (json.dumps(protocol.events_ctrl_line(cursor)) + "\n")
            .encode("utf-8")
        )

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):X}\r\n".encode("ascii"))
        self.wfile.write(data)
        self.wfile.write(b"\r\n")
        self.wfile.flush()
        if data:
            tele.TRACE.count(tele.C_GW_BYTES_OUT, len(data))

    def _send_json(self, status: int, doc: dict,
                   headers: Optional[dict] = None) -> None:
        body = (json.dumps(doc, default=str) + "\n").encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_error(self, e: _HTTPError) -> None:
        headers = dict(e.headers)
        if e.retry_after is not None:
            headers.setdefault("Retry-After", str(e.retry_after))
        # error paths may leave the request body unread (the 413 cap
        # refuses BEFORE reading it): answering on the keep-alive
        # connection would let the unread bytes parse as the next
        # request line, so every error response closes the connection
        headers["Connection"] = "close"
        self.close_connection = True
        self._send_json(
            e.status,
            protocol.error_doc(e.status, e.kind, e.message,
                               retry_after=e.retry_after),
            headers=headers,
        )

    def _read_body(self) -> bytes:
        """Read the request body: Content-Length or chunked, capped at
        :data:`protocol.MAX_MANIFEST_BYTES` (413 past it, 400 on a
        truncated/malformed body — the fuzz surface)."""
        if self.headers.get("Transfer-Encoding", "").lower() == "chunked":
            return self._read_chunked_body()
        raw_len = self.headers.get("Content-Length")
        if raw_len is None:
            raise _HTTPError(411, "length_required",
                             "Content-Length (or chunked) required")
        try:
            length = int(raw_len)
        except ValueError:
            raise _HTTPError(
                400, "bad_manifest",
                f"Content-Length {raw_len!r} is not an integer",
            ) from None
        if length < 0:
            raise _HTTPError(400, "bad_manifest",
                             "negative Content-Length")
        if length > protocol.MAX_MANIFEST_BYTES:
            raise _HTTPError(
                413, "too_large",
                f"manifest body of {length} bytes exceeds the "
                f"{protocol.MAX_MANIFEST_BYTES}-byte cap",
            )
        body = self.rfile.read(length)
        if len(body) != length:
            raise _HTTPError(
                400, "bad_manifest",
                f"truncated body: got {len(body)} of {length} bytes",
            )
        return body

    def _read_chunked_body(self) -> bytes:
        out = b""
        while True:
            size_line = self.rfile.readline(32)
            if not size_line.endswith(b"\r\n"):
                raise _HTTPError(400, "bad_manifest",
                                 "truncated chunked body (size line)")
            try:
                size = int(size_line.strip().split(b";")[0], 16)
            except ValueError:
                raise _HTTPError(
                    400, "bad_manifest",
                    f"bad chunk size line {size_line!r}",
                ) from None
            if size == 0:
                # swallow any trailers up to the final blank line
                while True:
                    t = self.rfile.readline(1024)
                    if t in (b"\r\n", b"\n", b""):
                        break
                return out
            if len(out) + size > protocol.MAX_MANIFEST_BYTES:
                raise _HTTPError(
                    413, "too_large",
                    "chunked manifest body exceeds the "
                    f"{protocol.MAX_MANIFEST_BYTES}-byte cap",
                )
            chunk = self.rfile.read(size)
            if len(chunk) != size:
                raise _HTTPError(
                    400, "bad_manifest",
                    f"truncated chunk: got {len(chunk)} of {size} bytes",
                )
            out += chunk
            crlf = self.rfile.read(2)
            if crlf != b"\r\n":
                raise _HTTPError(400, "bad_manifest",
                                 "chunk missing its trailing CRLF")


class GatewayServer:
    """One HTTP listener over one :class:`TransformService`.

    Lifecycle: :meth:`start` binds and publishes the discovery
    document (``<run-root>/gateway.json``, durably — a restarted
    client finds the address where a crashed gateway's clients did);
    :meth:`stop_accepting` flips submissions to 503 (drain step 1);
    :meth:`close` ends event streams and joins the listener.  The
    service itself is NOT owned: the CLI drains and closes it after
    the gateway stops accepting (docs/SERVING.md drain ordering).
    """

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self._host = host
        self._port = port
        self._lock = threading.Lock()
        self._accepting = True
        self._stop_ev = threading.Event()
        self._sha_cache: dict = {}  # (path, size, mtime_ns) -> hex sha
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> tuple:
        """Bind, publish ``gateway.json``, serve on a daemon thread;
        returns the bound ``(host, port)`` (port 0 resolves here)."""
        httpd = ThreadingHTTPServer((self._host, self._port), _Handler)
        httpd.daemon_threads = True
        httpd.gateway = self  # type: ignore[attr-defined]
        with self._lock:
            self._httpd = httpd
            self._host, self._port = httpd.server_address[:2]
        atomic_write_json(
            os.path.join(self.service.scheduler.run_root, GATEWAY_JSON),
            {
                "schema": protocol.GATEWAY_SCHEMA,
                "url": self.url,
                "host": self._host,
                "port": self._port,
                "pid": os.getpid(),
            },
        )
        t = threading.Thread(
            target=httpd.serve_forever, name="adam-tpu-gateway",
            daemon=True,
        )
        with self._lock:
            self._thread = t
        t.start()
        log.info("gateway listening on %s", self.url)
        return self._host, self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}"

    @property
    def accepting(self) -> bool:
        with self._lock:
            return self._accepting

    @property
    def stopping(self) -> bool:
        return self._stop_ev.is_set()

    def stop_accepting(self) -> None:
        """Drain step 1: every subsequent submission answers 503
        (draining) while live event streams and part fetches keep
        flowing — clients finish their downloads, new work bounces."""
        with self._lock:
            self._accepting = False

    def close(self) -> None:
        """Stop the listener: ends follow-mode event streams, joins
        the serve thread, releases the socket (idempotent)."""
        self._stop_ev.set()
        with self._lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=10)

    # ---- shared helpers ------------------------------------------------
    def part_sha256(self, path: str) -> str:
        """Whole-part sha256, cached by (path, size, mtime): parts are
        immutable once published (atomic rename), so the cache only
        ever re-hashes a name the writer re-published."""
        st = os.stat(path)
        key = (path, st.st_size, st.st_mtime_ns)
        with self._lock:
            hit = self._sha_cache.get(key)
        if hit is not None:
            return hit
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
        sha = h.hexdigest()
        with self._lock:
            if len(self._sha_cache) > 4096:
                self._sha_cache.clear()
            self._sha_cache[key] = sha
        return sha
