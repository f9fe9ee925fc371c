"""``GatewayClient`` — the typed stdlib client for the adam-tpu
gateway (docs/SERVING.md).

Three behaviors make it a *service* client rather than a URL fetcher:

* **Back-pressure honoring** — 429/503 raise :class:`GatewayBusy`
  carrying the server's ``Retry-After``; :meth:`submit_with_retry`
  sleeps the LARGER of that hint and the local
  :class:`~adam_tpu_torch.utils.retry.RetryPolicy` backoff (with its
  seeded per-site jitter), so a fleet of refused clients decorrelates
  instead of re-colliding on the server's hint tick.
* **Resumable event following** — :meth:`events` streams the job's
  NDJSON heartbeat and, on any connection loss or stall, reconnects
  *from its line cursor* — the tailer's position lives client-side,
  so a bounced gateway or a flaky link costs a reconnect, not a
  restart of the stream.
* **Byte-exact resumable fetch** — :meth:`fetch_part` downloads into
  a ``.fetch-tmp`` staging file, resumes a partial download with
  ``Range: bytes=<have>-``, verifies the assembled bytes against the
  server's whole-part sha256 (restarting clean once on a mismatch —
  a stale partial must produce a re-download, never a corrupt part),
  and publishes via the durability helpers — the network twin of the
  journal's resume contract: SIGKILL the client mid-download, rerun, get
  identical bytes.

The port's copy of ``adam_tpu/gateway/client.py`` (stdlib and numpy code, no JAX): the
wire formats, schemas and file layouts are JAX's, byte for byte.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import socket
import time
from http.client import HTTPConnection, HTTPException
from typing import Iterator, Optional
from urllib.parse import quote, urlsplit

from adam_tpu_torch.gateway import protocol
from adam_tpu_torch.utils.durability import fsync_dir, publish_file
from adam_tpu_torch.utils.retry import RetryPolicy, jitter_factor

log = logging.getLogger(__name__)

#: Terminal job states (mirrors serve.job.TERMINAL_STATES; duplicated
#: string-side so the client never imports the scheduler stack).
TERMINAL_STATES = frozenset({"done", "quarantined", "interrupted"})


class GatewayError(Exception):
    """Non-2xx gateway response (or a broken protocol invariant)."""

    def __init__(self, message: str, status: int = 0,
                 kind: str = "error",
                 retry_after: Optional[int] = None):
        super().__init__(message)
        self.status = status
        self.kind = kind
        self.retry_after = retry_after


class GatewayBusy(GatewayError):
    """Typed back-pressure: 429 (capacity) / 503 (draining or
    transiently unhealthy), with the server's Retry-After hint."""


def _raise_for(status: int, headers, body: bytes) -> None:
    kind, message, retry_after = "error", "", None
    try:
        doc = json.loads(body.decode("utf-8"))
        kind = doc.get("kind", kind)
        message = doc.get("error", "")
        retry_after = doc.get("retry_after_s")
    except (ValueError, UnicodeDecodeError):
        message = body.decode("utf-8", errors="replace")[:200]
    if retry_after is None:
        ra = headers.get("Retry-After") if headers is not None else None
        if ra is not None:
            try:
                retry_after = int(ra)
            except ValueError:
                pass
    cls = GatewayBusy if status in (429, 503) else GatewayError
    raise cls(
        f"gateway answered {status} ({kind}): {message}",
        status=status, kind=kind, retry_after=retry_after,
    )


class GatewayClient:
    """Typed client for one gateway URL (``http://host:port``)."""

    def __init__(self, url: str, timeout_s: float = 30.0):
        split = urlsplit(url if "//" in url else f"http://{url}")
        if split.scheme not in ("", "http"):
            raise ValueError(
                f"gateway URL {url!r}: only http:// is supported"
            )
        if not split.hostname or not split.port:
            raise ValueError(
                f"gateway URL {url!r} needs host and port "
                "(http://host:port)"
            )
        self.host = split.hostname
        self.port = split.port
        self.timeout_s = timeout_s

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ---- transport -----------------------------------------------------
    def _connect(self, timeout: Optional[float] = None) -> HTTPConnection:
        return HTTPConnection(
            self.host, self.port,
            timeout=self.timeout_s if timeout is None else timeout,
        )

    def _request_json(self, method: str, path: str,
                      doc: Optional[dict] = None,
                      headers: Optional[dict] = None) -> dict:
        body = (json.dumps(doc).encode("utf-8")
                if doc is not None else None)
        hdrs = dict(headers or {})
        if body is not None:
            hdrs["Content-Type"] = "application/json"
        conn = self._connect()
        try:
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status >= 400:
                _raise_for(resp.status, resp.headers, data)
            try:
                return json.loads(data.decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                raise GatewayError(
                    f"gateway returned non-JSON for {method} {path}: {e}"
                ) from None
        finally:
            conn.close()

    @staticmethod
    def _job_path(job: str, *rest: str) -> str:
        segs = [protocol.JOBS_PREFIX, quote(job, safe="")]
        segs += [quote(r, safe="") for r in rest]
        return "/".join(segs)

    # ---- submission ----------------------------------------------------
    def submit(self, job_id: str, doc: dict) -> dict:
        """One idempotency-keyed ``PUT /v1/jobs/<job_id>``.  Raises
        :class:`GatewayBusy` on 429/503 (carrying Retry-After) and
        :class:`GatewayError` on everything else non-2xx; a duplicate
        re-PUT of an identical spec is a SUCCESS (the response carries
        ``duplicate: true`` and the job's current state)."""
        return self._request_json("PUT", self._job_path(job_id), doc=doc)

    def submit_with_retry(self, job_id: str, doc: dict, *,
                          policy: Optional[RetryPolicy] = None,
                          deadline_s: Optional[float] = None,
                          sleep=time.sleep) -> dict:
        """Submit, honoring typed back-pressure until admitted.

        429/503 wait ``max(server Retry-After, local backoff *
        seeded jitter)`` — the server's hint is a floor, never a
        synchronization tick — bounded only by ``deadline_s``.
        Transport failures (connection refused/reset, timeouts: the
        gateway may be mid-restart) retry on the policy's attempt
        budget.  Raises the last :class:`GatewayBusy`/transport error
        when the deadline or budget runs out."""
        policy = policy or RetryPolicy.from_env()
        deadline = (
            time.monotonic() + deadline_s if deadline_s is not None
            else None
        )
        backoff = max(policy.backoff_s, 0.001)
        attempt = 1
        transport_failures = 0
        while True:
            try:
                return self.submit(job_id, doc)
            except GatewayBusy as e:
                last = e
                wait_s = max(
                    float(e.retry_after or 0),
                    backoff * jitter_factor(
                        "gateway.submit", attempt,
                        seed=policy.jitter_seed, amount=policy.jitter,
                    ),
                )
                transport_failures = 0
            except (ConnectionError, socket.timeout, HTTPException,
                    OSError) as e:
                last = e
                transport_failures += 1
                if transport_failures >= policy.attempts:
                    raise
                wait_s = backoff * jitter_factor(
                    "gateway.submit", attempt,
                    seed=policy.jitter_seed, amount=policy.jitter,
                )
                log.warning(
                    "gateway submit transport failure (%s); retrying "
                    "in %.2fs", e, wait_s,
                )
            if deadline is not None and \
                    time.monotonic() + wait_s > deadline:
                raise last
            sleep(wait_s)
            backoff = min(backoff * 2, policy.max_backoff_s)
            attempt += 1

    # ---- status / cancel -----------------------------------------------
    def status(self, job: Optional[str] = None) -> dict:
        if job is None:
            return self._request_json("GET", protocol.JOBS_PREFIX)
        return self._request_json("GET", self._job_path(job))

    def cancel(self, job: str) -> dict:
        return self._request_json("DELETE", self._job_path(job))

    def wait(self, job: str, deadline_s: Optional[float] = None,
             poll_s: float = 0.5) -> dict:
        """Poll until the job reaches a terminal state; returns its
        final status view (raises :class:`GatewayError` past the
        deadline)."""
        deadline = (
            time.monotonic() + deadline_s if deadline_s is not None
            else None
        )
        while True:
            view = self.status(job)
            if view.get("state") in TERMINAL_STATES:
                return view
            if deadline is not None and time.monotonic() >= deadline:
                raise GatewayError(
                    f"job {job!r} still {view.get('state')!r} after "
                    f"{deadline_s:.1f}s"
                )
            time.sleep(poll_s)

    # ---- observability surfaces ----------------------------------------
    def metrics(self) -> str:
        """``GET /metrics``: the Prometheus text exposition body,
        verbatim (it is NOT JSON — scrapers and the smoke test parse
        the exposition format directly)."""
        conn = self._connect()
        try:
            conn.request("GET", protocol.METRICS_PATH)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status >= 400:
                _raise_for(resp.status, resp.headers, data)
            return data.decode("utf-8", errors="replace")
        finally:
            conn.close()

    def job_trace(self, job: str) -> dict:
        """``GET /v1/jobs/<job>/trace``: the job's Chrome-trace JSON
        (``traceEvents`` + ledger sections + ``trace_id``), spanning
        submit -> fused dispatch -> part write via fan-in links."""
        return self._request_json("GET", self._job_path(job, "trace"))

    def incidents(self) -> dict:
        """``GET /incidents``: incident-bundle summaries under the
        service's run root (oldest first)."""
        return self._request_json("GET", protocol.INCIDENTS_PATH)

    def slo(self) -> dict:
        """``GET /slo``: the service's SLO compliance document —
        ``enabled`` plus, when an engine is armed, per-objective
        compliance, burn rates, and error-budget remaining."""
        return self._request_json("GET", protocol.SLO_PATH)

    # ---- event streaming -----------------------------------------------
    def poll_events(self, job: str, cursor: int = 0) -> tuple:
        """One non-following poll: ``(next_cursor, lines)`` of every
        complete heartbeat line past ``cursor`` (``adam-tpu top
        --url``'s building block).  The stream's control lines
        (:data:`protocol.EVENTS_CTRL_SCHEMA`) re-anchor the cursor, so
        a server-side rotation reset moves ours instead of silently
        diverging (a diverged cursor would re-download the whole file
        on every poll forever)."""
        conn = self._connect()
        try:
            conn.request(
                "GET",
                self._job_path(job, "events")
                + f"?cursor={int(cursor)}&follow=0",
            )
            resp = conn.getresponse()
            if resp.status >= 400:
                _raise_for(resp.status, resp.headers, resp.read())
            lines = []
            cursor = int(cursor)
            for raw in resp.read().splitlines():
                if not raw.strip():
                    continue
                try:
                    line = json.loads(raw)
                except ValueError:
                    cursor += 1  # the server counted it; so must we
                    continue
                if isinstance(line, dict) and \
                        line.get("schema") == protocol.EVENTS_CTRL_SCHEMA:
                    cursor = int(line.get("cursor", cursor))
                    continue
                cursor += 1
                lines.append(line)
            return cursor, lines
        finally:
            conn.close()

    def events(self, job: str, cursor: int = 0, *,
               reconnect_s: float = 0.5,
               max_reconnects: int = 60,
               stall_timeout_s: float = 60.0) -> Iterator[tuple]:
        """Follow the job's heartbeat stream, yielding
        ``(cursor, line)`` with ``cursor`` = lines consumed so far —
        the resume token.  The stream ends after a ``done=true`` line.
        Connection losses and stalls reconnect FROM THE CURSOR (the
        resumable-stream contract); ``max_reconnects`` consecutive
        failures without a single new line raise the last error."""
        cursor = int(cursor)
        idle_failures = 0
        while True:
            got_line = False
            conn = self._connect(timeout=stall_timeout_s)
            try:
                conn.request(
                    "GET",
                    self._job_path(job, "events")
                    + f"?cursor={cursor}&follow=1",
                )
                resp = conn.getresponse()
                if resp.status >= 400:
                    _raise_for(resp.status, resp.headers, resp.read())
                while True:
                    raw = resp.readline()
                    if not raw:
                        break  # stream closed (gateway drain/restart)
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        line = json.loads(raw)
                    except ValueError:
                        cursor += 1  # count it: the server did
                        continue
                    if isinstance(line, dict) and line.get("schema") \
                            == protocol.EVENTS_CTRL_SCHEMA:
                        # stream-start echo or a mid-stream rotation
                        # reset: re-anchor so the NEXT reconnect
                        # resumes at the position the server means
                        cursor = int(line.get("cursor", cursor))
                        continue
                    cursor += 1
                    got_line = True
                    idle_failures = 0
                    yield cursor, line
                    if line.get("done"):
                        return
            except GatewayError:
                raise
            except (ConnectionError, socket.timeout, HTTPException,
                    OSError) as e:
                if not got_line:
                    idle_failures += 1
                    if idle_failures >= max_reconnects:
                        raise GatewayError(
                            f"event stream for {job!r} unreachable "
                            f"after {idle_failures} reconnects: {e}"
                        ) from e
                log.debug("event stream dropped (%s); resuming at "
                          "cursor %d", e, cursor)
            finally:
                conn.close()
            time.sleep(reconnect_s)

    # ---- resumable part fetch ------------------------------------------
    def list_parts(self, job: str) -> dict:
        return self._request_json("GET", self._job_path(job, "parts"))

    def _part_meta(self, job: str, name: str) -> tuple:
        """(sha256, size) of a part without transferring it: a
        1-byte ranged GET — every part response carries both headers."""
        conn = self._connect()
        try:
            conn.request("GET", self._job_path(job, "parts", name),
                         headers={"Range": "bytes=0-0"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status >= 400:
                _raise_for(resp.status, resp.headers, data)
            return (
                resp.headers.get(protocol.HDR_PART_SHA256, ""),
                int(resp.headers.get(protocol.HDR_PART_SIZE, "-1")),
            )
        finally:
            conn.close()

    #: Download attempts per part: transport aborts RESUME the partial
    #: (progress is monotone), so the bound only caps pathological
    #: corruption/flap loops.
    _FETCH_ATTEMPTS = 3

    def fetch_part(self, job: str, name: str, dest_dir: str) -> str:
        """Download one part byte-exactly into ``dest_dir``.

        Resumable: an existing ``<name>.fetch-tmp`` staging file (a
        previous attempt SIGKILLed mid-download, or a mid-body
        transport abort — the gateway dying mid-response included)
        resumes with ``Range: bytes=<have>-``; a partial that already
        holds the WHOLE part (killed between the last byte and the
        publish) verifies and publishes without re-transfer.  The
        assembled file must match the server's whole-part sha256 and
        size — a mismatch discards the partial and restarts clean;
        corrupt bytes are never published.  The verified file
        publishes durably (fsync + atomic rename) under its final
        name; an existing final file that already matches the
        server's sha is kept untouched."""
        os.makedirs(dest_dir, exist_ok=True)
        fsync_dir(dest_dir)
        final = os.path.join(dest_dir, name)
        tmp = final + ".fetch-tmp"
        path = self._job_path(job, "parts", name)
        note = "no attempt made"
        for _attempt in range(self._FETCH_ATTEMPTS):
            start = (
                os.path.getsize(tmp) if os.path.isfile(tmp) else 0
            )
            headers = {"Range": f"bytes={start}-"} if start else {}
            sha, total = "", -1
            conn = self._connect()
            try:
                conn.request("GET", path, headers=headers)
                resp = conn.getresponse()
                if resp.status == 416:
                    resp.read()
                    m = re.match(
                        r"bytes \*/(\d+)$",
                        resp.headers.get("Content-Range", ""),
                    )
                    if m and start == int(m.group(1)):
                        # the partial is exactly part-sized: a client
                        # killed between its last byte and the publish
                        # — verify and publish with zero re-transfer
                        sha, total = self._part_meta(job, name)
                        if start == total and sha and \
                                _sha256_file(tmp) == sha:
                            publish_file(tmp, final)
                            return final
                    # genuinely stale partial: restart clean
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    note = "stale partial discarded"
                    continue
                if resp.status >= 400:
                    _raise_for(resp.status, resp.headers, resp.read())
                sha = resp.headers.get(protocol.HDR_PART_SHA256, "")
                total = int(
                    resp.headers.get(protocol.HDR_PART_SIZE, "-1")
                )
                if os.path.isfile(final) and sha and \
                        _sha256_file(final) == sha:
                    return final  # already fetched and verified
                if resp.status == 200 and start:
                    start = 0  # server ignored the range: rewrite
                with open(tmp, "ab" if start else "wb") as fh:
                    while True:
                        chunk = resp.read(protocol.FETCH_CHUNK_BYTES)
                        if not chunk:
                            break
                        fh.write(chunk)
            except (ConnectionError, socket.timeout, HTTPException,
                    OSError) as e:
                # transport abort, possibly mid-body (a bounced or
                # fault-killed gateway): KEEP the partial — the next
                # attempt resumes it from its new length
                log.warning("part %s/%s transfer interrupted (%s); "
                            "resuming from the partial", job, name, e)
                note = f"transport: {e}"
                time.sleep(0.2)
                continue
            finally:
                conn.close()
            got = os.path.getsize(tmp) if os.path.isfile(tmp) else 0
            if total >= 0 and got == total and \
                    (not sha or _sha256_file(tmp) == sha):
                publish_file(tmp, final)
                return final
            if total < 0 or got < total:
                # silent truncation (server closed cleanly early):
                # progress is preserved, resume on the next attempt
                note = f"short read ({got} of {total} bytes)"
                continue
            # full length but wrong bytes: corrupt — never publish,
            # restart from scratch
            log.warning("part %s/%s failed sha256 verification; "
                        "restarting clean", job, name)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            note = "sha256 mismatch discarded"
        raise GatewayError(
            f"part {name!r} of job {job!r} did not verify within "
            f"{self._FETCH_ATTEMPTS} attempts (last: {note}); "
            "refusing to publish unverified bytes"
        )

    def fetch(self, job: str, dest_dir: str) -> dict:
        """Fetch every published part of ``job`` into ``dest_dir``;
        returns ``{name: local path}``, each byte-verified."""
        listing = self.list_parts(job)
        out = {}
        for part in listing.get("parts", []):
            out[part["name"]] = self.fetch_part(
                job, part["name"], dest_dir
            )
        return out


def resolve_url(text: str) -> str:
    """CLI convenience: ``text`` is either a gateway URL
    (``http://host:port`` / ``host:port``) or a serve RUN-ROOT
    directory, in which case the address comes from the
    ``gateway.json`` discovery document the server durably publishes
    on bind."""
    if os.path.isdir(text):
        path = os.path.join(text, "gateway.json")
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as e:
            raise ValueError(
                f"{text} is a directory but {path} is unreadable ({e}); "
                "is an 'adam-tpu serve --listen' running on this root?"
            ) from None
        url = doc.get("url") if isinstance(doc, dict) else None
        if not url:
            raise ValueError(f"{path} carries no gateway url")
        return url
    return text


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
