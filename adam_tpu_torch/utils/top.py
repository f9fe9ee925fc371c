"""``top`` — live terminal dashboard over heartbeat streams (copied
from ``adam_tpu/utils/top.py``; the frames are the same strings for the
same heartbeat lines).

The streamed pipeline's ``--progress PATH`` heartbeat
(utils/telemetry.Heartbeat) emits one NDJSON line per sample; this
module tails that file and renders a refreshing one-screen dashboard —
the per-job progress view.  It is a pure *consumer*: it holds the file
read-only, attaches to a run that is already mid-flight, survives the
heartbeat's size-capped rotation (``ADAM_TPU_PROGRESS_MAX_BYTES`` — a
truncate-to-zero reads as a fresh file), tolerates a torn last line
(only newline-terminated lines are parsed; the line-buffered writer
makes tears transient), accepts every ``adam_tpu.heartbeat/1``–``/7``
line, and exits 0 when the stream carries ``done=true`` (non-zero when
that final line says ``ok=false``).  On the card the ``hbm`` line shows
the CUDA caching allocator's live bytes per card, keyed by its index
(``utils/telemetry.sample_hbm``); a run without a card shows the
"unsupported backend" line.

**Multi-job mode**: pointed at a *directory* (a ``serve`` run-root),
top discovers every ``<job>/heartbeat.ndjson`` under it and renders one
aggregated dashboard — a per-job state/progress/ETA row plus pool-wide
totals.  Jobs appearing mid-watch join the board on the next poll;
finished jobs stay on it with their final state.  Job-scoped fields
(windows, parts, reads, bytes written, per-job eviction counts) SUM
across jobs; nothing process-global rides in a paced job's stream, so
the totals never double-count.  ``--url`` feeds the same board from a
remote run-root's gateway (``gateway/client.py``).

Split renderer/follower so the dashboard is unit-testable without a
terminal: :func:`render_frame` / :func:`render_multi_frame` are pure
``dict -> str`` and :func:`follow` / :func:`follow_root` own the
tail-loop/TTY behavior.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

from adam_tpu_torch.utils.telemetry import format_bytes as _fmt_bytes

#: Heartbeat schema tags this dashboard understands (missing /2–/5
#: fields render as "-"; unknown future fields are ignored).
ACCEPTED_SCHEMAS = (
    "adam_tpu.heartbeat/1", "adam_tpu.heartbeat/2", "adam_tpu.heartbeat/3",
    "adam_tpu.heartbeat/4", "adam_tpu.heartbeat/5", "adam_tpu.heartbeat/6",
    "adam_tpu.heartbeat/7",
)

_CLEAR = "\x1b[H\x1b[2J"


def parse_heartbeat_text(text: str) -> list:
    """NDJSON text -> parsed heartbeat lines, in order.

    Only newline-terminated lines parse (the last line of a live file
    may still be mid-write — the next poll completes it); non-JSON or
    non-heartbeat lines are skipped rather than fatal, so a corrupt
    line in a multi-hour stream costs one sample, not the dashboard."""
    out = []
    for raw in text.splitlines(keepends=True):
        if not raw.endswith("\n"):
            break  # torn tail: re-read on the next poll
        raw = raw.strip()
        if not raw:
            continue
        try:
            line = json.loads(raw)
        except ValueError:
            continue
        if (
            isinstance(line, dict)
            and line.get("schema") in ACCEPTED_SCHEMAS
        ):
            out.append(line)
    return out


def _bar(frac, width: int = 24) -> str:
    if frac is None:
        return "[" + "?" * width + "]"
    frac = min(max(float(frac), 0.0), 1.0)
    n = int(round(frac * width))
    return "[" + "#" * n + "-" * (width - n) + "]"


def _fmt_s(v) -> str:
    if not isinstance(v, (int, float)):
        return "-"
    if v >= 3600:
        return f"{int(v) // 3600}h{(int(v) % 3600) // 60:02d}m"
    if v >= 60:
        return f"{int(v) // 60}m{int(v) % 60:02d}s"
    return f"{v:.1f}s"


def render_frame(line: dict, source: str = "") -> str:
    """One dashboard frame from one heartbeat line (pure function)."""
    done = bool(line.get("done"))
    ok = line.get("ok", True)
    if not done:
        state = "RUNNING"
    else:
        state = "DONE" if ok else "FAILED"
    wt = line.get("windows_total")
    wi = line.get("windows_ingested", 0)
    frac = (wi / wt) if wt else None
    mode = line.get("partitioner")
    out = [
        f"adam-tpu top — {source or 'heartbeat'}   "
        f"{line.get('schema', '?')}  seq {line.get('seq', '-')}",
        f"state    {state:<8} elapsed {_fmt_s(line.get('elapsed_s')):<9}"
        f" eta {_fmt_s(line.get('eta_s'))}"
        + (f"   mode {mode}" if mode else ""),
        f"windows  {_bar(frac)} {wi}/{wt if wt is not None else '?'}"
        f"   resumed {line.get('windows_resumed', 0)}"
        f"   parts {line.get('parts_written', 0)}",
        f"reads    {line.get('reads_ingested', 0):,}"
        f"  ({line.get('reads_per_s', 0):,.0f} reads/s)",
        f"bytes    written {_fmt_bytes(line.get('bytes_written'))}"
        f"   h2d {_fmt_bytes(line.get('h2d_bytes'))}"
        f"   d2h {_fmt_bytes(line.get('d2h_bytes'))}",
    ]
    per_dev = line.get("inflight_per_device") or {}
    inflight = line.get("inflight", 0)
    if per_dev:
        # depth bars against the double-buffer depth of 2 per device
        devs = "  ".join(
            f"{dev}:{_bar(min(n, 2) / 2.0, 6)}{n}"
            for dev, n in sorted(per_dev.items())
        )
        out.append(f"inflight {inflight} total   {devs}")
    else:
        out.append(f"inflight {inflight} total")
    hbm = line.get("hbm_bytes_in_use")
    if hbm:
        peak = line.get("hbm_peak_bytes")
        devs = "  ".join(
            f"{dev}:{_fmt_bytes(b)}" for dev, b in sorted(hbm.items())
        )
        out.append(f"hbm      {devs}   peak {_fmt_bytes(peak)}")
    elif "hbm_bytes_in_use" in line:
        out.append("hbm      (unsupported backend — no memory stats)")
    fill = line.get("batch_fill")
    if fill is not None:
        # cross-job batching (/4): running grid fill + the last fused
        # dispatch's distinct-job count
        out.append(
            f"batching {_bar(fill, 12)} fill {fill:.0%}"
            f"   jobs/dispatch {line.get('batched_jobs', '-')}"
        )
    dh = line.get("device_health")
    if dh:
        # device-health scoreboard (/5): only non-healthy chips are
        # worth a cell each; an all-healthy fleet renders one word
        bad = {d: s for d, s in sorted(dh.items()) if s != "healthy"}
        if bad:
            out.append(
                "health   "
                + "  ".join(f"{d}:{s}" for d, s in bad.items())
            )
        else:
            out.append(f"health   all {len(dh)} device(s) healthy")
    if "active_traces" in line or line.get("last_incident"):
        # observability cell (/6): live trace count, /metrics scrape
        # activity, and the newest incident bundle with its age
        li = line.get("last_incident")
        out.append(
            f"observe  traces {line.get('active_traces', 0)}"
            f"   scrapes {line.get('metrics_scrapes', 0)}"
            + (
                f"   incident {li}"
                f" ({_fmt_s(line.get('last_incident_age_s'))} ago)"
                if li else "   incidents none"
            )
        )
    burn = line.get("slo_worst_burn")
    if burn is not None or line.get("perf_regressions"):
        # judgment cell (/7): worst error-budget burn across armed SLO
        # objectives + perf keys the ledger sentinel flagged
        out.append(
            "slo      "
            + (f"burn {burn:.1f}x" if burn is not None else "no slo")
            + f"   perf regressions {line.get('perf_regressions', 0)}"
        )
    out.append(
        f"events   retries {line.get('retries', 0)}"
        f"   faults {line.get('faults', 0)}"
        f"   evicted {line.get('devices_evicted', 0)}"
    )
    if done:
        out.append(
            "run complete — output is final" if ok else
            "RUN FAILED — the final heartbeat carries ok=false"
        )
    return "\n".join(out)


class _StreamTail:
    """Incremental reader for one heartbeat NDJSON file: remembers the
    byte position and the torn tail, survives rotation (shrink = reread
    from the top) and disappearance (a job dir mid-creation)."""

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._buf = ""
        self.last: Optional[dict] = None

    def poll(self) -> bool:
        """Read any new bytes; True when a newer complete line landed."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return False
        if size < self._pos:
            self._pos = 0  # rotated/truncated
            self._buf = ""
        if size <= self._pos:
            return False
        with open(self.path, "rb") as fh:
            fh.seek(self._pos)
            chunk = fh.read()
            self._pos = fh.tell()
        self._buf += chunk.decode("utf-8", errors="replace")
        lines = parse_heartbeat_text(self._buf)
        nl = self._buf.rfind("\n")
        self._buf = self._buf[nl + 1:] if nl >= 0 else self._buf
        if lines:
            self.last = lines[-1]
            return True
        return False


def discover_streams(root: str) -> dict:
    """Job heartbeat streams under a serve run-root:
    ``{job name: <root>/<job>/heartbeat.ndjson}`` for every job
    subdirectory that has one (the scheduler's layout).  The service's
    own pool-wide stream (``<root>/heartbeat.ndjson``) is deliberately
    not a job."""
    out = {}
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    for name in names:
        p = os.path.join(root, name, "heartbeat.ndjson")
        if os.path.isfile(p):
            out[name] = p
    return out


def _job_disk_state(root: str, job: str) -> Optional[str]:
    """The scheduler's durable per-job state (JOB.json), when present —
    it distinguishes ``interrupted``/``quarantined`` from plain failure,
    which the heartbeat alone cannot."""
    try:
        with open(os.path.join(root, job, "JOB.json")) as fh:
            doc = json.load(fh)
        if isinstance(doc, dict):
            state = doc.get("state")
            return str(state) if state else None
    except (OSError, ValueError):
        pass
    return None


def render_multi_frame(jobs: dict, root: str = "",
                       pool: Optional[dict] = None,
                       states: Optional[dict] = None) -> str:
    """One aggregated dashboard frame (pure function).

    ``jobs`` maps job name -> its newest heartbeat line; ``pool`` is
    the service stream's newest line (process-global counters: tunnel
    bytes, retries, faults), ``states`` maps job name -> the JOB.json
    state string when known.  Job-scoped numbers SUM across jobs;
    nothing global rides in a paced job's stream, so the totals cannot
    double-count."""
    states = states or {}
    rows = [
        f"adam-tpu top — multi-job {root or 'run-root'}   "
        f"{len(jobs)} job(s)",
        f"{'JOB':<16} {'STATE':<12} {'WINDOWS':<34} {'PARTS':>5} "
        f"{'READS/S':>9} {'ETA':>7}",
    ]
    tot = {"reads": 0, "bytes": 0, "parts": 0, "inflight": 0,
           "rps": 0.0, "evicted": 0, "running": 0, "done": 0,
           "failed": 0}
    hbm_per_dev: dict = {}
    for name in sorted(jobs):
        line = jobs[name]
        done = bool(line.get("done"))
        ok = line.get("ok", True)
        state = states.get(name)
        if state is None:
            state = ("RUNNING" if not done
                     else ("DONE" if ok else "FAILED"))
        else:
            state = state.upper()
        wt = line.get("windows_total")
        wi = line.get("windows_ingested", 0)
        frac = (wi / wt) if wt else None
        rows.append(
            f"{name[:16]:<16} {state[:12]:<12} "
            f"{_bar(frac)} {wi}/{wt if wt is not None else '?':<4} "
            f"{line.get('parts_written', 0):>5} "
            f"{line.get('reads_per_s', 0) or 0:>9,.0f} "
            f"{_fmt_s(line.get('eta_s')):>7}"
        )
        tot["reads"] += line.get("reads_ingested", 0) or 0
        tot["bytes"] += line.get("bytes_written", 0) or 0
        tot["parts"] += line.get("parts_written", 0) or 0
        tot["inflight"] += line.get("inflight", 0) or 0
        tot["evicted"] += line.get("devices_evicted", 0) or 0
        if not done:
            tot["running"] += 1
            tot["rps"] += line.get("reads_per_s", 0) or 0
        elif ok:
            tot["done"] += 1
        else:
            tot["failed"] += 1
        for dev, b in (line.get("hbm_bytes_in_use") or {}).items():
            if isinstance(b, (int, float)):
                hbm_per_dev[dev] = max(hbm_per_dev.get(dev, 0), b)
    rows.append(
        f"jobs     {tot['running']} running  {tot['done']} done  "
        f"{tot['failed']} stopped/failed   parts {tot['parts']}   "
        f"reads {tot['reads']:,} ({tot['rps']:,.0f}/s)"
    )
    rows.append(
        f"pool     written {_fmt_bytes(tot['bytes'])}   "
        f"inflight {tot['inflight']}   evicted {tot['evicted']}"
    )
    if hbm_per_dev:
        devs = "  ".join(
            f"{d}:{_fmt_bytes(b)}" for d, b in sorted(hbm_per_dev.items())
        )
        rows.append(f"hbm      {devs}")
    if pool:
        fill = pool.get("batch_fill")
        rows.append(
            f"global   h2d {_fmt_bytes(pool.get('h2d_bytes'))}   "
            f"d2h {_fmt_bytes(pool.get('d2h_bytes'))}   "
            f"retries {pool.get('retries', 0)}   "
            f"faults {pool.get('faults', 0)}"
            + (
                # cross-job batching fill rate (the service stream is
                # the one that carries it — the coalescer is shared)
                f"   fill {fill:.0%}"
                f" ({pool.get('batched_jobs', '-')} jobs/dispatch)"
                if fill is not None else ""
            )
        )
        if "active_traces" in pool or pool.get("last_incident"):
            li = pool.get("last_incident")
            rows.append(
                f"observe  traces {pool.get('active_traces', 0)}   "
                f"scrapes {pool.get('metrics_scrapes', 0)}"
                + (
                    f"   incident {li}"
                    f" ({_fmt_s(pool.get('last_incident_age_s'))} ago)"
                    if li else "   incidents none"
                )
            )
        burn = pool.get("slo_worst_burn")
        if burn is not None or pool.get("perf_regressions"):
            rows.append(
                "slo      "
                + (f"burn {burn:.1f}x" if burn is not None
                   else "no slo")
                + f"   perf regressions {pool.get('perf_regressions', 0)}"
            )
    if jobs and all(j.get("done") for j in jobs.values()):
        rows.append(
            "all jobs finished" if not tot["failed"] else
            f"all jobs finished — {tot['failed']} stopped or failed"
        )
    return "\n".join(rows)


def follow_root(root: str, interval: float = 0.5, out=None,
                once: bool = False, clear: Optional[bool] = None,
                max_wait_s: Optional[float] = None) -> int:
    """Aggregate every job heartbeat under a serve run-root into one
    refreshing dashboard (module doc).  Jobs appearing mid-watch join
    on the next poll; the watch ends when every discovered job stream
    carries ``done=true``.

    Exit codes mirror :func:`follow`: 0 when all jobs finished ok (or
    ``once`` with at least one line), 1 when all finished but some
    FAILED, 2 when no heartbeat lines appear within the wait bound.
    Two service-layer refinements: a job whose durable ``JOB.json``
    says ``interrupted`` is a clean graceful-drain stop, not a failure
    (its final heartbeat line carries ``ok=false``, which alone cannot
    tell a drain from a crash), and while the service's own pool
    stream is still live the watch continues — the scheduler may yet
    admit manifest jobs whose heartbeat files don't exist, so
    "every discovered stream is done" is not "the service is done"."""
    out = out if out is not None else sys.stdout
    if clear is None:
        clear = hasattr(out, "isatty") and out.isatty() and not once
    t0 = time.monotonic()
    tails: dict = {}
    service: Optional[_StreamTail] = None

    def expired() -> bool:
        return (
            max_wait_s is not None
            and time.monotonic() - t0 > max_wait_s
        )

    while True:
        for name, path in discover_streams(root).items():
            if name not in tails:
                tails[name] = _StreamTail(path)
        if service is None:
            sp = os.path.join(root, "heartbeat.ndjson")
            if os.path.isfile(sp):
                service = _StreamTail(sp)
        changed = False
        for tail in tails.values():
            changed = tail.poll() or changed
        if service is not None:
            changed = service.poll() or changed
        jobs = {n: t.last for n, t in tails.items() if t.last is not None}
        if jobs and (changed or once):
            frame = render_multi_frame(
                jobs, root=root,
                pool=service.last if service is not None else None,
                states={n: _job_disk_state(root, n) for n in jobs},
            )
            if clear:
                out.write(_CLEAR)
            out.write(frame + "\n")
            if not clear:
                out.write("\n")
            out.flush()
        if jobs:
            all_done = all(j.get("done") for j in jobs.values())
            # the service stream still live = more jobs may be coming
            # (capacity-queued manifest entries have no stream yet)
            service_live = (
                service is not None and service.last is not None
                and not service.last.get("done")
            )
            if all_done and not service_live:
                states = {n: _job_disk_state(root, n) for n in jobs}
                failed = [
                    n for n, j in jobs.items()
                    if not j.get("ok", True)
                    and states.get(n) != "interrupted"
                ]
                return 1 if failed else 0
            if once:
                return 0
        elif once:
            print(f"top: no job heartbeat lines under {root}",
                  file=sys.stderr)
            return 2
        if expired():
            print(
                f"top: jobs still live after {max_wait_s:.0f}s "
                f"(or no streams under {root})", file=sys.stderr,
            )
            return 2
        time.sleep(interval)


def follow_url(url: str, interval: float = 0.5, out=None,
               once: bool = False, clear: Optional[bool] = None,
               max_wait_s: Optional[float] = None) -> int:
    """Tail a REMOTE serve run-root through its HTTP gateway
    (``top --url http://host:port``): the same aggregated
    multi-job dashboard as :func:`follow_root`, fed by the gateway's
    resumable NDJSON event streams instead of local files.  Each job's
    stream is polled incrementally from a line cursor
    (``GET /v1/jobs/<job>/events?cursor=N&follow=0``), so a network
    blip or a bounced gateway costs a re-poll, not a restart; jobs
    joining mid-watch appear on the next status poll; heartbeat-file
    rotation server-side resets the cursor (re-delivery, never loss)
    exactly like a local shrink does in :func:`follow`.

    Exit codes keep the 0/1/2 contract: 0 when every job finished ok
    (a JOB.json ``interrupted`` is a clean drain stop, not a failure),
    1 when any finished failed/quarantined, 2 when no heartbeat lines
    arrive within the wait bound (or the gateway is unreachable and
    nothing terminal was seen)."""
    from adam_tpu_torch.gateway.client import (
        TERMINAL_STATES,
        GatewayClient,
        GatewayError,
    )

    out = out if out is not None else sys.stdout
    if clear is None:
        clear = hasattr(out, "isatty") and out.isatty() and not once
    t0 = time.monotonic()
    try:
        client = GatewayClient(url)
    except ValueError as e:
        print(f"top: {e}", file=sys.stderr)
        return 2

    def expired() -> bool:
        return (
            max_wait_s is not None
            and time.monotonic() - t0 > max_wait_s
        )

    cursors: dict = {}
    last: dict = {}
    states: dict = {}

    def verdict() -> int:
        # judged over STATES, not just heartbeat lines: a job that
        # quarantined before its first heartbeat (bad input path) has
        # no line at all, and must still fail the watch
        failed = {
            n for n, s in states.items() if s == "quarantined"
        }
        failed.update(
            n for n, line in last.items()
            if (line.get("ok", True) is False
                and states.get(n) != "interrupted")
        )
        return 1 if failed else 0

    while True:
        try:
            status = client.status()
        except (GatewayError, OSError):
            # gateway gone: clean end iff everything we saw finished
            if last and all(l.get("done") for l in last.values()):
                return verdict()
            if once or expired():
                print(f"top: gateway at {url} unreachable",
                      file=sys.stderr)
                return 2
            time.sleep(interval)
            continue
        jobs_view = status.get("jobs", {})
        changed = False
        for name, view in jobs_view.items():
            states[name] = view.get("state")
            try:
                cur, lines = client.poll_events(
                    name, cursors.get(name, 0)
                )
            except (GatewayError, OSError):
                continue
            if lines:
                cursors[name] = cur
                last[name] = lines[-1]
                changed = True
        if last and (changed or once):
            frame = render_multi_frame(
                last, root=url,
                states={n: states.get(n) for n in last},
            )
            if clear:
                out.write(_CLEAR)
            out.write(frame + "\n")
            if not clear:
                out.write("\n")
            out.flush()
        all_term = bool(jobs_view) and all(
            v.get("state") in TERMINAL_STATES
            for v in jobs_view.values()
        )
        if last:
            if all_term and all(l.get("done") for l in last.values()):
                return verdict()
            if once:
                return 0
        elif all_term:
            # every job terminal yet none ever emitted a heartbeat
            # line (e.g. all quarantined before their first window):
            # the watch is over — judge on states alone
            return verdict()
        elif once:
            print(f"top: no job heartbeat lines from {url}",
                  file=sys.stderr)
            return 2
        if expired():
            print(
                f"top: jobs still live after {max_wait_s:.0f}s "
                f"(or no streams at {url})", file=sys.stderr,
            )
            return 2
        time.sleep(interval)


def follow(path: str, interval: float = 0.5, out=None,
           once: bool = False, clear: Optional[bool] = None,
           max_wait_s: Optional[float] = None) -> int:
    """Tail a heartbeat file and render frames until ``done=true``.

    * attaches mid-run: the first frame renders the newest line already
      in the file;
    * survives rotation: a file that shrinks (the heartbeat moved it to
      ``<path>.1`` and started fresh) re-reads from the top;
    * ``once`` renders a single frame from the newest line and exits
      (scripting/CI mode — no TTY needed);
    * ``max_wait_s`` bounds the wait for the file/new lines (None =
      wait forever, the interactive default).

    Exit codes: 0 on ``done=true, ok=true`` (or ``once``), 1 on a final
    line with ``ok=false``, 2 when the file never appeared / carried no
    heartbeat lines within the wait bound.
    """
    out = out if out is not None else sys.stdout
    if clear is None:
        clear = hasattr(out, "isatty") and out.isatty() and not once
    t0 = time.monotonic()
    last: Optional[dict] = None
    pos = 0
    buf = ""

    def expired() -> bool:
        return (
            max_wait_s is not None
            and time.monotonic() - t0 > max_wait_s
        )

    while True:
        try:
            size = os.path.getsize(path)
        except OSError:
            size = None
        if size is None:
            if once or expired():
                print(f"top: no heartbeat file at {path}",
                      file=sys.stderr)
                return 2
            time.sleep(interval)
            continue
        if size < pos:
            pos = 0  # rotated/truncated: the writer started fresh
            buf = ""
        if size > pos:
            with open(path, "rb") as fh:
                fh.seek(pos)
                chunk = fh.read()
                pos = fh.tell()
            buf += chunk.decode("utf-8", errors="replace")
            lines = parse_heartbeat_text(buf)
            # keep only the unterminated tail for the next poll
            nl = buf.rfind("\n")
            buf = buf[nl + 1:] if nl >= 0 else buf
            if lines:
                last = lines[-1]
                frame = render_frame(last, source=path)
                if clear:
                    out.write(_CLEAR)
                out.write(frame + "\n")
                if not clear:
                    out.write("\n")
                out.flush()
        if last is not None:
            if last.get("done"):
                return 0 if last.get("ok", True) else 1
            if once:
                return 0
        elif once:
            print(f"top: no heartbeat lines in {path}", file=sys.stderr)
            return 2
        if expired():
            print(
                f"top: no done=true within {max_wait_s:.0f}s "
                f"(run still live, or stream stalled)", file=sys.stderr,
            )
            return 2
        time.sleep(interval)
