"""The port's HTTP gateway (``adam_tpu_torch/gateway``) against the JAX
package's: the wire-protocol helpers and the Prometheus exposition equal
JAX's on the same inputs; every pairing of the two packages' clients and
servers gives the same replies to one scripted exchange (idempotent
submit, conflict, typed errors, status, the event stream, part listing
and a Range-resumed fetch, cancel, incidents); the ``gateway.*`` fault
sites fire; and two clients on two tenants drive the real pipeline on
the CPU through the port's gateway to their solo runs' bytes.

The admission-only legs ride a stub in place of the streamed pipeline
(timing-free).  Every server, service and client thread a test starts is
closed in a ``finally`` with a bounded join."""

import hashlib
import json
import os
import pathlib
import sys
import threading
import time

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _parts(d) -> dict:
    return {f: _sha((pathlib.Path(d) / f).read_bytes())
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


def _pkg(name):
    """The gateway, service and scheduler modules of one package."""
    import importlib

    root = "adam_tpu" if name == "jax" else "adam_tpu_torch"
    return {m: importlib.import_module(f"{root}.{path}") for m, path in (
        ("protocol", "gateway.protocol"), ("metrics", "gateway.metrics"),
        ("server", "gateway.server"), ("client", "gateway.client"),
        ("service", "api.transform_service"), ("sched", "serve.scheduler"),
        ("incidents", "utils.incidents"), ("tele", "utils.telemetry"),
        ("faults", "utils.faults"))}


# --------------------------------------------------------------------------
# the protocol helpers and the exposition, against JAX's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("text", ["127.0.0.1:0", "0.0.0.0:8765", "[::1]:80", "", "8765",
                                  "host:", "host:x", "host:70000", "localhost:443"])
def test_parse_listen_equals_jax(text):
    outs = []
    for pkg in ("port", "jax"):
        try:
            outs.append(_pkg(pkg)["protocol"].parse_listen(text))
        except ValueError as e:
            outs.append(("ValueError", str(e)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("header", [None, "bytes=0-", "bytes=10-19", "bytes=90-500",
                                    "bytes=-25", "bytes=100-", "bytes=5-2", "bytes=-0",
                                    "bytes=", "octets=1-2", "bytes=1-2,5-6", "bytes=99-99"])
def test_parse_range_equals_jax(header):
    outs = []
    for pkg in ("port", "jax"):
        proto = _pkg(pkg)["protocol"]
        try:
            outs.append(proto.parse_range(header, 100))
        except proto.RangeError as e:
            outs.append(("RangeError", str(e)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("times,now", [
    ([], None), ([5.0], None), ([i * 0.1 for i in range(20)], 2.0),
    ([i * 2.0 for i in range(20)], 38.5), ([i * 0.1 for i in range(3)], 1000.0),
    ([i * 0.37 for i in range(40)], 50.0),
])
def test_retry_after_s_equals_jax(times, now):
    port, jax = _pkg("port")["protocol"], _pkg("jax")["protocol"]
    assert port.retry_after_s(times, now=now) == jax.retry_after_s(times, now=now)


@pytest.mark.parametrize("name", ["part-r-00000.parquet", "part-realigned.parquet", "",
                                  "x.parquet", "part-", "part-a/b", "part-..",
                                  "_metadata", ".part-hidden"])
def test_part_name_ok_equals_jax(name):
    assert _pkg("port")["protocol"].part_name_ok(name) == \
        _pkg("jax")["protocol"].part_name_ok(name)


def test_error_and_ctrl_documents_equal_jax():
    port, jax = _pkg("port")["protocol"], _pkg("jax")["protocol"]
    for args in ((404, "not_found", "no such job"), (429, "capacity", "full", 7)):
        assert port.error_doc(*args) == jax.error_doc(*args)
    assert port.events_ctrl_line(12) == jax.events_ctrl_line(12)
    assert port.BUSY_HTTP_STATUS == jax.BUSY_HTTP_STATUS


def _snapshot(tele):
    tr = tele.Tracer(recording=True)
    tr.count(tele.C_SCHED_ADMITTED, 3)
    tr.count(tele.C_BATCH_DISPATCHES, 5)
    tr.count(tele.C_GW_BYTES_OUT, 1 << 20)
    tr.gauge(tele.G_SCHED_ACTIVE, 2)
    tr.observe(tele.H_BATCH_FILL, 0.75)
    tr.observe(tele.H_BATCH_FILL, 0.25)
    tr.record_quota("tenantA", nbytes=4096, compute_s=0.5, budget_bytes=1 << 20)
    tr.record_health("0", "suspect", 2.5, "retried failure")
    tr.add_span(tele.SPAN_SCHED_JOB, 0, 2_000_000_000)
    return tr.snapshot()


def test_render_prometheus_equals_jax():
    port, jax = _pkg("port"), _pkg("jax")
    snap = _snapshot(jax["tele"])
    slo = {"enabled": True, "objectives": [
        {"tenant": "A", "objective": "avail>=0.99", "kind": "avail", "target": 0.99,
         "compliance": 1.0, "budget_remaining": 1.0, "burn_short": 0.0, "burn_long": 0.0,
         "events": 3}]}
    want = jax["metrics"].render_prometheus(snap, slo)
    assert port["metrics"].render_prometheus(snap, slo) == want
    # the port's own tracer renders the same exposition
    assert port["metrics"].render_prometheus(_snapshot(port["tele"]), slo) == want
    assert "adam_tpu_sched_batch_dispatches" in want


# --------------------------------------------------------------------------
# one scripted exchange over every client/server pairing
# --------------------------------------------------------------------------
def _stub(monkeypatch, pkg):
    """A gate-controlled stub in place of the pipeline: it writes two
    parts whose bytes depend on the job alone, and a two-line heartbeat
    whose last line is ``done`` (which ends a followed event stream)."""
    release = threading.Event()

    def fake(inp, out, **kw):
        assert release.wait(30), "stub never released"
        with open(kw["progress"], "w") as fh:
            for done in (False, True):
                fh.write(json.dumps({"schema": "adam_tpu.heartbeat/7", "done": done,
                                     "ok": True}) + "\n")
        os.makedirs(out, exist_ok=True)
        seed = hashlib.sha256(os.path.basename(out).encode()).digest()
        big = (seed * ((200_000 // len(seed)) + 1))[:200_000]
        for name, data in (("part-r-00000.parquet", big),
                           ("part-r-00001.parquet", seed * 2048)):
            with open(os.path.join(out, name), "wb") as fh:
                fh.write(data)
        return {"n_reads": 0, "windows_fresh": 2}

    monkeypatch.setattr(pkg["sched"].streamed_mod, "transform_streamed", fake)
    return release


def _exchange(client_pkg, server_pkg, root, out_dir, fetch_dir, release):
    """The scripted exchange -> its replies, volatile fields normalised."""
    cl = client_pkg["client"]
    c = cl.GatewayClient(cl.resolve_url(str(root)))
    got = []

    def norm(doc):
        text = json.dumps(doc, sort_keys=True, default=str)
        text = text.replace(str(root), "<root>").replace(str(out_dir), "<out>")
        doc = json.loads(text)
        if isinstance(doc, dict):
            for k in ("trace_id",):
                if k in doc:
                    doc[k] = "<tid>" if doc[k] else doc[k]
            if isinstance(doc.get("spec"), dict) and doc["spec"].get("trace_id"):
                doc["spec"]["trace_id"] = "<tid>"
        return doc

    def call(fn, *a):
        try:
            got.append(("ok", norm(fn(*a))))
        except cl.GatewayError as e:
            got.append((type(e).__name__, e.status, e.kind, e.retry_after))

    doc = {"input": "in.sam", "output": str(out_dir), "tenant": "A", "window_reads": 512}
    call(c.submit, "ja", doc)
    call(c.submit, "ja", doc)
    call(c.submit, "ja", dict(doc, tenant="B"))
    call(c.submit, "bad id!", doc)
    call(c.submit, "jb", {"input": "in.sam"})
    call(c.submit, "jb", dict(doc, output=str(out_dir) + "-b"))  # capacity: max_jobs 1
    call(c.status, "nope")
    call(c.cancel, "nope")
    call(c.list_parts, "nope")
    release.set()
    view = c.wait("ja", deadline_s=60, poll_s=0.05)
    got.append(("final", view["state"], view["attempts"]))
    listing = c.list_parts("ja")
    got.append(("parts", listing["state"],
                sorted((p["name"], p["bytes"], p["sha256"]) for p in listing["parts"])))
    # a SIGKILLed fetch left the first 50,000 bytes: the rerun resumes by Range
    name = "part-r-00000.parquet"
    os.makedirs(fetch_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "rb") as fh:
        head = fh.read(50_000)
    with open(os.path.join(fetch_dir, name + ".fetch-tmp"), "wb") as fh:
        fh.write(head)
    fetched = c.fetch("ja", str(fetch_dir))
    got.append(("fetched", {n: _sha(open(p, "rb").read()) for n, p in fetched.items()}))
    call(c.cancel, "ja")
    events = [line for _cur, line in c.events("ja")]
    got.append(("events", len(events)))
    st = c.status()
    got.append(("service", st["max_jobs"], st["draining"], st["batching"],
                {j: v["state"] for j, v in st["jobs"].items()}))
    inc = c.incidents()
    got.append(("incidents", inc["schema"], inc["incidents"]))
    got.append(("slo", c.slo()))
    return got


@pytest.fixture()
def pairing(monkeypatch, tmp_path):
    """Run the exchange for (client package, server package)."""
    started = []

    def run(client, server):
        srv = _pkg(server)
        release = _stub(monkeypatch, srv)
        root = tmp_path / f"{client}-{server}" / "root"
        kw = {} if server == "jax" else {"device": "cpu"}
        svc = srv["service"].TransformService(str(root), max_jobs=1, **kw)
        gw = srv["server"].GatewayServer(svc)
        started.append((gw, svc, release))
        gw.start()
        srv["incidents"]._reset_for_tests()
        srv["incidents"].install(str(root))
        return _exchange(_pkg(client), srv, root, tmp_path / f"{client}-{server}" / "out",
                        tmp_path / f"{client}-{server}" / "fetched", release)

    try:
        yield run
    finally:
        for gw, svc, release in started:
            release.set()
            gw.close()
            svc.wait(timeout=30)
            svc.close()


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_exchange_replies_equal_across_pairings(pairing, client, server):
    want = pairing("jax", "jax")
    got = pairing(client, server)
    assert got == want
    # and the exchange said what a gateway should
    assert want[0][0] == "ok" and want[0][1]["state"] == "pending"
    assert want[1][1]["duplicate"] is True
    assert want[2][:3] == ("GatewayError", 409, "conflict")
    assert want[5][:3] == ("GatewayBusy", 429, "capacity")
    assert want[6][:2] == ("GatewayError", 404)
    assert ("final", "done", 0) in want


# --------------------------------------------------------------------------
# the gateway's fault sites, and its other surfaces
# --------------------------------------------------------------------------
@pytest.fixture()
def port_gateway(monkeypatch, tmp_path):
    pkg = _pkg("port")
    release = _stub(monkeypatch, pkg)
    svc = pkg["service"].TransformService(str(tmp_path / "root"), max_jobs=2, device="cpu")
    gw = pkg["server"].GatewayServer(svc)
    gw.start()
    try:
        yield {"gw": gw, "svc": svc, "release": release, "tmp": tmp_path,
               "client": pkg["client"].GatewayClient(gw.url), "root": tmp_path / "root"}
    finally:
        pkg["faults"].clear()
        release.set()
        gw.close()
        svc.wait(timeout=30)
        svc.close()


def test_gateway_json_is_published_and_resolves(port_gateway):
    from adam_tpu.gateway.client import resolve_url as jax_resolve

    from adam_tpu_torch.gateway.client import resolve_url

    doc = json.loads((port_gateway["root"] / "gateway.json").read_text())
    assert doc["schema"] == "adam_tpu.gateway/1" and doc["url"] == port_gateway["gw"].url
    assert resolve_url(str(port_gateway["root"])) == jax_resolve(str(port_gateway["root"])) \
        == port_gateway["gw"].url


def test_gateway_accept_transient_is_a_503_the_client_retries(port_gateway):
    from adam_tpu_torch.gateway import GatewayBusy
    from adam_tpu_torch.utils import faults
    from adam_tpu_torch.utils import telemetry as tele

    c, tmp = port_gateway["client"], port_gateway["tmp"]
    doc = {"input": "in.sam", "output": str(tmp / "a.adam")}
    faults.install("gateway.accept=transient,device=fa,times=1")
    with pytest.raises(GatewayBusy) as e:
        c.submit("fa", doc)
    assert e.value.status == 503 and e.value.kind == "transient"
    faults.install("gateway.accept=transient,device=fb,times=2")
    n0 = tele.TRACE.counters_and_gauges()[0].get("fault.injected", 0)
    got = c.submit_with_retry("fb", dict(doc, output=str(tmp / "b.adam")), deadline_s=30)
    assert got["state"] == "pending"
    assert tele.TRACE.counters_and_gauges()[0]["fault.injected"] - n0 == 2


def test_gateway_stream_and_fetch_faults_resume(port_gateway):
    """A fault mid-stream or mid-part aborts the response; the client's
    cursor and Range resume it to the whole part, sha256-verified."""
    from adam_tpu_torch.utils import faults

    c, tmp = port_gateway["client"], port_gateway["tmp"]
    out = tmp / "s.adam"
    c.submit("sj", {"input": "in.sam", "output": str(out)})
    port_gateway["release"].set()
    assert port_gateway["svc"].wait(timeout=30)
    faults.install("gateway.fetch=permanent,device=sj,after=1,times=1;"
                   "gateway.stream=permanent,device=sj,times=1")
    fetched = c.fetch("sj", str(tmp / "dest"))
    assert {n: _sha(open(p, "rb").read()) for n, p in fetched.items()} == _parts(out)
    lines = [line for _cur, line in c.events("sj")]
    assert faults.ENABLED and all(cl._fired for cl in faults._CLAUSES)
    assert isinstance(lines, list)


def test_incidents_endpoint_lists_run_root_bundles(port_gateway, monkeypatch):
    """JAX's twin fails when run after another test of its process fired
    the same trigger inside the 30 s cooldown (the cooldown is process
    state): here the recorder is reset and the cooldown is 0."""
    from adam_tpu_torch.gateway import protocol
    from adam_tpu_torch.utils import incidents

    monkeypatch.setenv("ADAM_TPU_INCIDENT_COOLDOWN_S", "0")
    incidents._reset_for_tests()
    incidents.install(str(port_gateway["root"]))
    c = port_gateway["client"]
    empty = c.incidents()
    assert empty["schema"] == protocol.INCIDENTS_SCHEMA and empty["incidents"] == []
    path = incidents.maybe_record("hedge.fired", reason="wire-visibility probe")
    assert path is not None
    rows = c.incidents()["incidents"]
    assert [r["trigger"] for r in rows] == ["hedge.fired"]
    assert rows[0]["reason"] == "wire-visibility probe"


def test_metrics_and_trace_surfaces(port_gateway):
    import re

    from adam_tpu_torch.utils import telemetry as tele

    c, tmp = port_gateway["client"], port_gateway["tmp"]
    got = c.submit("tj", {"input": "in.sam", "output": str(tmp / "t.adam")})
    tid = got["trace_id"]
    assert re.fullmatch(r"[0-9a-f]{16}", tid)
    port_gateway["release"].set()
    assert port_gateway["svc"].wait(timeout=30)
    text = c.metrics()
    assert "adam_tpu_sched_jobs_admitted" in text and "adam_tpu_gateway_requests" in text
    doc = c.job_trace("tj")
    assert doc["trace_id"] == tid
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {tele.SPAN_GW_SUBMIT, tele.SPAN_SCHED_JOB} <= names


# --------------------------------------------------------------------------
# two clients, two tenants, the real pipeline on the CPU
# --------------------------------------------------------------------------
def test_two_clients_two_tenants_end_to_end(tmp_path):
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.api.transform_service import TransformService
    from adam_tpu_torch.gateway import GatewayClient, GatewayServer
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    path = str(tmp_path / "in.sam")
    make_wgs(path, 1536, 100, n_contigs=2, contig_len=20_000, seed=8)
    transform_streamed(path, str(tmp_path / "solo"), window_reads=256, device="cpu")
    baseline = _parts(tmp_path / "solo")
    svc = TransformService(str(tmp_path / "root"), max_jobs=2, batching=True, device="cpu")
    gw = GatewayServer(svc)
    gw.start()
    outs = {jid: str(tmp_path / f"{jid}.adam") for jid in ("ga", "gb")}
    results, errors = {}, []

    def one_client(jid, tenant, weight):
        try:
            c = GatewayClient(gw.url)
            got = c.submit_with_retry(jid, {"input": path, "output": outs[jid],
                                            "tenant": tenant, "weight": weight,
                                            "window_reads": 256}, deadline_s=120)
            again = c.submit(jid, {"input": path, "output": outs[jid], "tenant": tenant,
                                   "weight": weight, "window_reads": 256})
            assert again["duplicate"] is True and again["trace_id"] == got["trace_id"]
            final = None
            for _cur, line in c.events(jid):
                final = line
            assert final and final.get("done") and final.get("ok") is True, final
            fetched = c.fetch(jid, str(tmp_path / f"fetched-{jid}"))
            results[jid] = {n: _sha(open(p, "rb").read()) for n, p in fetched.items()}
        except Exception as e:  # surfaced by the main thread
            errors.append((jid, e))

    threads = [threading.Thread(target=one_client, args=("ga", "A", 2.0)),
               threading.Thread(target=one_client, args=("gb", "B", 1.0))]
    try:
        for t in threads:
            t.start()
    finally:
        for t in threads:
            t.join(300)
        alive = any(t.is_alive() for t in threads)
        gw.close()
        svc.wait(timeout=60)
        svc.close()
    assert not alive, "client thread hung"
    assert not errors, errors
    for jid in outs:
        assert _parts(outs[jid]) == baseline == results[jid], jid
