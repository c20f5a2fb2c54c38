"""The port's metrics exporters against the reference's.

Twins of tests/test_telemetry.py:167, :185 and :491 (the scrape server,
the OTLP shipper's final flush, ``loop --metrics-port``) and of
tests/test_otel_lanes.py's lane cases (:77-137, :209: the payload, a
plain lane, a lane over mTLS, the minted infra certs, the logging
handler, ``build_lanes``), plus loopd's metrics port (settings
``loopd.metrics_port``), ``loop`` shipping over settings
``telemetry.otlp`` to a stub collector, and the port's one departure: an
``https://`` lane on a host without ``cryptography`` raises a
``ConfigError`` that names the package.  The scrape bodies of two
registries holding the same series are the same bytes; the OTLP payloads
are the same bytes with the wall clock fixed through each ``otel``
module's ``time`` (or with ``timeUnixNano`` removed where a real lane
stamps it).

The netlogger's two lane cases (tests/test_otel_lanes.py:164, :188)
ship one drained event each over a plain lane and over a prebuilt mTLS
lane: the same bodies, their stamps removed.
"""

from __future__ import annotations

import json
import logging
import ssl
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path
from types import SimpleNamespace

import pytest
from click.testing import CliRunner

import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.controlplane.otel as ref_otel
import clawker_tpu.firewall.pki as ref_pki
import clawker_tpu.telemetry as ref_telemetry
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.controlplane.otel as port_otel
import clawker_tpu_torch.errors as port_errors
import clawker_tpu_torch.firewall as port_firewall
import clawker_tpu_torch.firewall.pki as port_pki
import clawker_tpu_torch.telemetry as port_telemetry
from test_torch_loopd import (  # noqa: F401
    _time_limit,
    daemon,
    driver_with,
    free_port,
    run_to_done,
    side,
    twin,
)

PKGS = {
    "ref": SimpleNamespace(telemetry=ref_telemetry, otel=ref_otel,
                           pki=ref_pki),
    "port": SimpleNamespace(telemetry=port_telemetry, otel=port_otel,
                            pki=port_pki),
}


def both(fn):
    return fn(PKGS["ref"]), fn(PKGS["port"])


def fill(registry) -> None:
    """The same series in either package's registry."""
    c = registry.counter("t_scraped_total", "scrape me")
    c.inc(7)
    g = registry.gauge("anomaly_score", "z per agent", labels=("agent",))
    g.labels("clawker.p.loop-abc-5").set(4.1234)
    g.labels('a"b\\c\nd').set(-0.5)
    h = registry.histogram("lane_seconds", "", labels=("worker",),
                           buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.labels("fake-0").observe(v)
    registry.counter("t_unlabelled_total")      # no series: not exported


def scrape(port: int, path: str = "/metrics"):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


# ----------------------------------------------------------- scrape server


def test_metrics_server_serves_exposition():
    def run(m):
        reg = m.telemetry.MetricsRegistry()
        fill(reg)
        srv = m.telemetry.MetricsServer(0, registry=reg).start()
        try:
            got = [scrape(srv.port, p) for p in ("/metrics", "/",
                                                  "/metrics?x=1")]
            with pytest.raises(urllib.error.HTTPError) as e:
                scrape(srv.port, "/nope")
            return got, e.value.code
        finally:
            srv.stop()

    want, got = both(run)
    assert got == want
    (status, ctype, body), *_ = got[0]
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    assert "t_scraped_total 7" in body
    assert 'anomaly_score{agent="clawker.p.loop-abc-5"} 4.1234' in body
    assert got[1] == 404


def test_metrics_server_stops_and_frees_its_port():
    port = free_port()
    srv = port_telemetry.MetricsServer(port).start()
    assert srv.port == port and scrape(port)[0] == 200
    srv.stop()
    with pytest.raises(OSError):
        scrape(port)
    srv.stop()                                  # idempotent


# ------------------------------------------------------------ otlp shipper


def test_otlp_shipper_ships_snapshots_and_final_flush():
    def run(m):
        reg = m.telemetry.MetricsRegistry()
        fill(reg)
        batches: list[list[dict]] = []

        class Lane:
            def ship(self, records):
                batches.append(records)
                return True

        shipper = m.telemetry.MetricsOtlpShipper(Lane(), registry=reg,
                                                 interval_s=3600.0)
        shipper.start()
        shipper.start()                         # a second start: no-op
        shipper.stop()
        return batches, shipper.shipped_batches

    want, got = both(run)
    assert got == want
    batches, shipped = got
    assert shipped == 1
    rec = next(r for r in batches[-1] if r["metric"] == "t_scraped_total")
    assert rec["value"] == 7 and rec["kind"] == "counter"


def test_otlp_shipper_never_raises_into_the_run():
    class Down:
        def ship(self, records):
            raise OSError("collector down")

    def run(m):
        empty = m.telemetry.MetricsOtlpShipper(
            Down(), registry=m.telemetry.MetricsRegistry())
        reg = m.telemetry.MetricsRegistry()
        fill(reg)
        down = m.telemetry.MetricsOtlpShipper(Down(), registry=reg)
        return (empty.ship_once(), down.ship_once(), down.shipped_batches)

    want, got = both(run)
    assert got == want == (False, False, 0)


def test_shipper_interval_ships_on_its_thread():
    def run(m):
        reg = m.telemetry.MetricsRegistry()
        fill(reg)
        batches = []
        lane = SimpleNamespace(ship=lambda recs: batches.append(recs) or True)
        shipper = m.telemetry.MetricsOtlpShipper(lane, registry=reg,
                                                 interval_s=0.05).start()
        deadline = time.monotonic() + 5
        while len(batches) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        shipper.stop()
        return len(batches) >= 3, batches[0]

    want, got = both(run)
    assert got == want and got[0]


# ----------------------------------------------------------------- lanes


class Collector:
    """Tiny OTLP/HTTP sink; optionally TLS with REQUIRED client certs."""

    def __init__(self, tmp: Path, *, mtls: bool, pki=port_pki):
        self.bodies: list[dict] = []
        col = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                col.bodies.append(json.loads(self.rfile.read(n)))
                col.paths.append(self.path)
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.paths: list[str] = []
        self.srv = HTTPServer(("127.0.0.1", 0), H)
        self.scheme = "http"
        if mtls:
            ca = pki.ensure_ca(tmp / "pki")
            pair = pki._issue(ca, "127.0.0.1", dns_names=["localhost"],
                              server=True)
            (tmp / "srv.crt").write_bytes(pair.cert_pem)
            (tmp / "srv.key").write_bytes(pair.key_pem)
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(str(tmp / "srv.crt"), str(tmp / "srv.key"))
            ctx.verify_mode = ssl.CERT_REQUIRED
            ctx.load_verify_locations(cadata=ca.cert_pem.decode())
            self.srv.socket = ctx.wrap_socket(self.srv.socket,
                                              server_side=True)
            self.scheme = "https"
        self.port = self.srv.server_address[1]
        self.t = threading.Thread(target=self.srv.serve_forever,
                                  kwargs={"poll_interval": 0.05}, daemon=True)
        self.t.start()

    @property
    def endpoint(self) -> str:
        host = "localhost" if self.scheme == "https" else "127.0.0.1"
        return f"{self.scheme}://{host}:{self.port}"

    def stop(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.t.join(2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def unstamped(body: dict) -> dict:
    """An OTLP logs body without its wall-clock stamps: each record's
    ``timeUnixNano``, and the ``@timestamp`` a netlogger record carries
    in its body (two runs a second apart differ there too)."""
    body = json.loads(json.dumps(body))
    for rl in body["resourceLogs"]:
        for sl in rl["scopeLogs"]:
            for rec in sl["logRecords"]:
                rec.pop("timeUnixNano")
                inner = rec["body"]["stringValue"]
                try:
                    doc = json.loads(inner)
                except json.JSONDecodeError:
                    continue
                if isinstance(doc, dict) and "@timestamp" in doc:
                    doc.pop("@timestamp")
                    rec["body"]["stringValue"] = json.dumps(doc)
    return body


RECORDS = [{"qname": "x.com", "verdict": "NXDOMAIN"},
           {"metric": "anomaly_score", "labels": {"agent": "a"},
            "value": 4.5, "kind": "gauge"}]


@pytest.mark.parametrize("severity", [None, "WARN"])
def test_payload_bytes_with_the_clock_fixed(monkeypatch, severity):
    fixed = SimpleNamespace(time_ns=lambda: 1_700_000_000_123_456_789)
    for m in PKGS.values():
        monkeypatch.setattr(m.otel, "time", fixed)
    sev = (lambda r: severity) if severity else None
    want, got = both(lambda m: m.otel.otlp_logs_payload(
        "clawker-dnsgate", RECORDS, severity_of=sev))
    assert got == want
    body = json.loads(got)
    rl = body["resourceLogs"][0]
    assert rl["resource"]["attributes"][0]["value"]["stringValue"] == \
        "clawker-dnsgate"
    rec = rl["scopeLogs"][0]["logRecords"][0]
    assert rec["severityText"] == (severity or "INFO")
    assert rec["timeUnixNano"] == "1700000000123456789"


def test_plain_http_lane_ships(tmp_path):
    def run(m):
        with Collector(tmp_path, mtls=False) as col:
            lane = m.otel.OtlpLane(col.endpoint + "/", "clawkercp")
            shipped = (lane.ship(RECORDS), lane.ship([]),
                       m.otel.OtlpLane("", "x").ship(RECORDS))
            return shipped, [unstamped(b) for b in col.bodies], col.paths

    want, got = both(run)
    assert got == want
    assert got[0] == (True, False, False) and got[2] == ["/v1/logs"]


def test_lane_to_a_downed_collector_returns_false():
    port = free_port()
    want, got = both(lambda m: m.otel.OtlpLane(
        f"http://127.0.0.1:{port}", "c", timeout=1.0).ship(RECORDS))
    assert got == want is False


def test_mtls_lane_requires_client_cert(tmp_path):
    def run(m):
        base = tmp_path / m.otel.__name__.split(".")[0]
        with Collector(base, mtls=True, pki=m.pki) as col:
            cert, key, ca = m.otel.mint_infra_cert(base / "pki",
                                                   "clawkercp")
            bare = m.otel.OtlpLane(col.endpoint, "clawkercp", ca=ca)
            refused = (bare.ship([{"message": "nope"}]), len(col.bodies))
            lane = m.otel.OtlpLane(col.endpoint, "clawkercp",
                                   client_cert=cert, client_key=key, ca=ca)
            return refused, lane.ship([{"message": "hello"}]), [
                unstamped(b) for b in col.bodies]

    want, got = both(run)
    assert got == want
    assert got[0] == (False, 0) and got[1] is True and len(got[2]) == 1


def test_mint_infra_cert_is_stable(tmp_path):
    def run(m):
        pki_dir = tmp_path / m.otel.__name__.split(".")[0] / "pki"
        c1 = m.otel.mint_infra_cert(pki_dir, "ebpf-egress")
        c2 = m.otel.mint_infra_cert(pki_dir, "ebpf-egress")
        other = m.otel.mint_infra_cert(pki_dir, "clawkercp")
        return ([p.relative_to(pki_dir).as_posix() for p in (*c1, *other)],
                c1 == c2, c1[0].read_bytes() == c2[0].read_bytes())

    want, got = both(run)
    assert got == want
    assert got[0][:3] == ["infra/ebpf-egress.crt", "infra/ebpf-egress.key",
                          "ca.crt"]


def _drain_one_event(m, tmp: Path, **lane_kw) -> int:
    """One ``NO_DNS_ENTRY`` deny drained by the package's netlogger."""
    maps = m.maps.FakeMaps()
    nl = m.netlogger.NetLogger(maps, out_path=tmp / "egress.jsonl",
                               **lane_kw)
    maps.emit_event(m.model.EgressEvent(
        ts_ns=1, cgroup_id=1, dst_ip="1.2.3.4", dst_port=443, zone_hash=0,
        verdict=m.model.Action.DENY, proto=6,
        reason=m.model.Reason.NO_DNS_ENTRY))
    return nl.drain_once()


def _with_netlogger(m):
    from importlib import import_module

    root = m.otel.__name__.split(".")[0]
    return SimpleNamespace(
        maps=import_module(f"{root}.firewall.maps"),
        model=import_module(f"{root}.firewall.model"),
        netlogger=import_module(f"{root}.monitor.netlogger"))


def test_netlogger_rides_the_lane(tmp_path):
    def run(m):
        base = tmp_path / m.otel.__name__.split(".")[0]
        base.mkdir()
        with Collector(base, mtls=False) as col:
            n = _drain_one_event(_with_netlogger(m), base,
                                 otlp_endpoint=col.endpoint + "/")
            return n, [unstamped(b) for b in col.bodies], col.paths

    want, got = both(run)
    assert got == want
    n, bodies, paths = got
    assert n == 1 and paths == ["/v1/logs"]
    assert "ebpf-egress" in json.dumps(bodies[0])
    rec = bodies[0]["resourceLogs"][0]["scopeLogs"][0]["logRecords"][0]
    assert rec["severityText"] == "WARN"


def test_netlogger_accepts_prebuilt_mtls_lane(tmp_path):
    """The lane handed in carries the mTLS material, and the netlogger
    takes its endpoint from it."""
    def run(m):
        base = tmp_path / m.otel.__name__.split(".")[0]
        with Collector(base, mtls=True, pki=m.pki) as col:
            cert, key, ca = m.otel.mint_infra_cert(base / "pki",
                                                   "ebpf-egress")
            lane = m.otel.OtlpLane(col.endpoint, "ebpf-egress",
                                   client_cert=cert, client_key=key, ca=ca)
            n = _drain_one_event(_with_netlogger(m), base, lane=lane)
            return n, [unstamped(b) for b in col.bodies]

    want, got = both(run)
    assert got == want
    assert got[0] == 1 and "ebpf-egress" in json.dumps(got[1][0])


def test_mint_infra_cert_reads_the_references_ca(tmp_path):
    """One deployment PKI: a CA the reference minted signs the port's
    infra certs, and the reverse."""
    from cryptography import x509

    for first, second in (("ref", "port"), ("port", "ref")):
        pki_dir = tmp_path / first / "pki"
        PKGS[first].otel.mint_infra_cert(pki_dir, "clawkercp")
        cert, _, ca = PKGS[second].otel.mint_infra_cert(pki_dir,
                                                        "clawker-telemetry")
        leaf = x509.load_pem_x509_certificate(cert.read_bytes())
        root = x509.load_pem_x509_certificate(ca.read_bytes())
        assert leaf.issuer == root.subject
        assert (pki_dir / "ca.key").stat().st_mode & 0o777 == 0o600


def _wait(cond, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_logging_handler_batches_off_caller_thread(tmp_path):
    def run(m):
        with Collector(tmp_path, mtls=False) as col:
            lane = m.otel.OtlpLane(col.endpoint, "clawkercp")
            h = lane.handler(batch=3, flush_s=0.2)
            logger = logging.getLogger(f"test.otel.{m.otel.__name__}")
            logger.setLevel(logging.INFO)
            logger.propagate = False
            logger.addHandler(h)
            try:
                for msg in ("one", "two", "three"):
                    logger.info(msg)
                assert _wait(lambda: len(col.bodies) == 1)
                logger.warning("quiet-period straggler")
                assert _wait(lambda: len(col.bodies) == 2)
            finally:
                logger.removeHandler(h)
                h.close()
            out = []
            for b in col.bodies:
                recs = b["resourceLogs"][0]["scopeLogs"][0]["logRecords"]
                out.append([(r["severityText"],
                             json.loads(r["body"]["stringValue"])["message"])
                            for r in recs])
            return out

    want, got = both(run)
    assert got == want == [[("INFO", "one"), ("INFO", "two"),
                            ("INFO", "three")],
                           [("WARNING", "quiet-period straggler")]]


def test_build_lanes_gating(tmp_path, monkeypatch):
    def scenario(s):
        m = PKGS[s.pkg]
        monkeypatch.delenv("CLAWKER_TPU_OTLP", raising=False)
        none = m.otel.build_lanes(s.cfg)
        monkeypatch.setenv("CLAWKER_TPU_OTLP", "http://127.0.0.1:1")
        lanes = m.otel.build_lanes(s.cfg)
        plain = {k: (v.endpoint, v.service, v._ctx is None)
                 for k, v in lanes.items()}
        tlane = m.telemetry.telemetry_lane(s.cfg)
        monkeypatch.setenv("CLAWKER_TPU_OTLP", "https://127.0.0.1:1")
        tls = m.otel.build_lanes(s.cfg, ("clawkercp",))
        minted = (s.cfg.data_dir / "pki" / "infra" / "clawkercp.crt").exists()
        monkeypatch.delenv("CLAWKER_TPU_OTLP")
        return (none, plain, (tlane.endpoint, tlane.service),
                tls["clawkercp"]._ctx is not None, minted,
                m.telemetry.telemetry_lane(s.cfg))

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == {} and set(got[1]) == {"clawkercp", "ebpf-egress",
                                            "clawker-dnsgate"}
    assert got[2] == ("http://127.0.0.1:1", "clawker-telemetry")
    assert got[3] and got[4] and got[5] is None


def test_build_lanes_use_the_local_stack_when_monitoring_is_on(tmp_path,
                                                                monkeypatch):
    monkeypatch.delenv("CLAWKER_TPU_OTLP", raising=False)

    def scenario(s):
        lanes = PKGS[s.pkg].otel.build_lanes(s.cfg, ("clawker-telemetry",))
        return {k: v.endpoint for k, v in lanes.items()}

    want, got = twin(tmp_path, scenario, "monitoring:\n  enable: true\n")
    assert got == want == {"clawker-telemetry": "http://127.0.0.1:4318"}


def test_http_lane_loads_no_pki_and_https_names_cryptography(tmp_path,
                                                              monkeypatch):
    """The port's departure: ``pki`` (and ``cryptography``) load only
    for an ``https://`` lane, which without the package raises a
    ConfigError naming it and never ships in the clear."""
    monkeypatch.setitem(sys.modules, "cryptography", None)
    monkeypatch.delitem(sys.modules, "clawker_tpu_torch.firewall.pki")
    monkeypatch.delattr(port_firewall, "pki")
    cfg = SimpleNamespace(data_dir=tmp_path,
                          settings=SimpleNamespace(
                              monitoring=SimpleNamespace(enable=False)))
    monkeypatch.setenv("CLAWKER_TPU_OTLP", "http://127.0.0.1:1")
    lanes = port_otel.build_lanes(cfg)
    assert set(lanes) == {"clawkercp", "ebpf-egress", "clawker-dnsgate"}
    assert "clawker_tpu_torch.firewall.pki" not in sys.modules
    monkeypatch.setenv("CLAWKER_TPU_OTLP", "https://127.0.0.1:1")
    with pytest.raises(port_errors.ConfigError, match="'cryptography'"):
        port_otel.build_lanes(cfg)
    with pytest.raises(port_errors.ConfigError, match="clawker-telemetry"):
        port_telemetry.telemetry_lane(cfg)
    assert not (tmp_path / "pki").exists()


# ------------------------------------------------------------------ loopd


def test_loopd_serves_its_metrics_port(tmp_path):
    """``metrics_port`` (settings ``loopd.metrics_port``): the daemon
    serves its registry while it runs, the status RPC reports the port,
    and a stop frees it."""
    def scenario(s):
        port = free_port()
        with daemon(s, driver_with(s.m, 2), metrics_port=port) as srv:
            with s.m.client.LoopdClient(srv.sock_path) as c:
                run_to_done(c, {"parallel": 2, "iterations": 1})
            with s.m.client.LoopdClient(srv.sock_path) as c:
                doc = c.status()
            status, _, body = scrape(port)
        with pytest.raises(OSError):
            scrape(port)
        return (status, doc["settings"]["metrics_port"] == port,
                "loop_lane_execute_seconds" in body,
                "loopd_runs_total" in body)

    want, got = twin(tmp_path, scenario)
    assert got == want == (200, True, True, True)


def test_loopd_metrics_port_from_settings(tmp_path):
    port = free_port()

    def scenario(s):
        with daemon(s, driver_with(s.m, 1)) as srv:
            with s.m.client.LoopdClient(srv.sock_path) as c:
                doc = c.status()
            return doc["settings"]["metrics_port"], scrape(port)[0]

    want, got = twin(tmp_path, scenario,
                     f"loopd:\n  metrics_port: {port}\n")
    assert got == want == (port, 200)


def test_loopd_without_a_metrics_port_serves_none(tmp_path):
    def scenario(s):
        with daemon(s, driver_with(s.m, 1)) as srv:
            with s.m.client.LoopdClient(srv.sock_path) as c:
                doc = c.status()
            return doc["settings"]["metrics_port"], srv._metrics_server

    want, got = twin(tmp_path, scenario)
    assert got == want == (0, None)


# -------------------------------------------------------------------- loop


def _loop_cli(s, drv, args: list[str], monkeypatch):
    if s.pkg == "ref":
        return CliRunner().invoke(
            ref_root.cli, ["loop", *args, "--no-daemon", "--no-workerd"],
            obj=ref_factory.Factory(cwd=s.proj, driver=drv),
            catch_exceptions=False)
    monkeypatch.setenv(port_cli.DEVICE_ENV, "cpu")
    return CliRunner().invoke(
        port_cli.cli, ["loop", *args],
        obj=port_cli.Factory(cwd=s.proj, driver=drv),
        catch_exceptions=False)


def _scrape_until(port: int, needle, out: list, stop: threading.Event):
    """Scrape ``port`` until a body holds ``needle`` (a string, or a
    predicate on the body) or ``stop``."""
    done = needle if callable(needle) else (lambda body: needle in body)
    while not stop.is_set():
        try:
            body = scrape(port)[2]
        except OSError:
            time.sleep(0.02)
            continue
        out.append(body)
        if done(body):
            return
        time.sleep(0.02)


SCORED_TICKS = 'sentinel_ticks_total{result="scored"}'


def _scored_ticks(body: str) -> float:
    """The scored-tick counter in an exposition body (0 before any)."""
    for line in body.splitlines():
        if line.startswith(SCORED_TICKS + " "):
            return float(line.split()[-1])
    return 0.0


@pytest.mark.parametrize("how", ["flag", "setting"])
def test_cli_loop_metrics_port_serves_scrape_during_run(tmp_path,
                                                        monkeypatch, how):
    port = free_port()
    settings = f"telemetry:\n  metrics_port: {port}\n" if how == "setting" \
        else ""
    args = ["--metrics-port", str(port)] if how == "flag" else []

    def scenario(s):
        m = s.m
        drv = driver_with(m, 1, behavior=m.fake.exit_behavior(
            b"", 0, delay=0.2))
        scraped: list[str] = []
        stop = threading.Event()
        t = threading.Thread(target=_scrape_until, daemon=True, args=(
            port, "loop_lane_execute_seconds", scraped, stop))
        t.start()
        try:
            res = _loop_cli(s, drv, ["--parallel", "1", "--iterations", "2",
                                     *args, "--json"], monkeypatch)
        finally:
            stop.set()
            t.join(10)
        with pytest.raises(OSError):
            scrape(port)                        # stopped with the run
        return (res.exit_code,
                f"metrics: http://127.0.0.1:{port}/metrics" in res.stderr,
                any("loop_lane_execute_seconds" in b for b in scraped),
                json.loads(res.stdout)["agents"][0]["status"])

    want, got = twin(tmp_path, scenario, settings)
    assert got == want == (0, True, True, "done")


def test_cli_loop_ships_registry_over_otlp(tmp_path, monkeypatch):
    """Settings ``telemetry.otlp`` with ``CLAWKER_TPU_OTLP`` naming a
    stub collector: the run's registry lands as ``clawker-telemetry``
    batches, the last one the final flush of ``stop()``."""
    def scenario(s):
        m = s.m
        with Collector(tmp_path, mtls=False) as col:
            monkeypatch.setenv("CLAWKER_TPU_OTLP", col.endpoint)
            res = _loop_cli(s, driver_with(m, 2), ["-p", "2", "-n", "1",
                                                   "--json"], monkeypatch)
            monkeypatch.delenv("CLAWKER_TPU_OTLP")
        services, metrics = set(), set()
        for body in col.bodies:
            rl = body["resourceLogs"][0]
            services.add(rl["resource"]["attributes"][0]["value"][
                "stringValue"])
        for rec in col.bodies[-1]["resourceLogs"][0]["scopeLogs"][0][
                "logRecords"]:
            metrics.add(json.loads(rec["body"]["stringValue"])["metric"])
        return (res.exit_code, len(col.bodies) >= 1, services,
                {"loop_iterations_total", "loop_lane_execute_seconds"}
                <= metrics)

    want, got = twin(tmp_path, scenario, "telemetry:\n  otlp: true\n")
    assert got == want == (0, True, {"clawker-telemetry"}, True)


def test_cli_loop_otlp_with_no_collector_runs_on(tmp_path, monkeypatch):
    """No endpoint and no local stack: no lane, and the run runs."""
    monkeypatch.delenv("CLAWKER_TPU_OTLP", raising=False)

    def scenario(s):
        res = _loop_cli(s, driver_with(s.m, 1), ["-p", "1", "-n", "1",
                                                 "--json"], monkeypatch)
        return res.exit_code, json.loads(res.stdout)["agents"][0]["status"]

    want, got = twin(tmp_path, scenario, "telemetry:\n  otlp: true\n")
    assert got == want == (0, "done")


def test_cli_loop_metrics_port_carries_the_sentinels_scores(tmp_path,
                                                             monkeypatch):
    """The port's sentinel on the CPU: a scrape during the run carries
    ``anomaly_score`` for an agent and ``sentinel_ticks_total{result=
    "scored"}``."""
    from test_torch_loop_anomaly import _egress, _write

    port = free_port()
    settings = "sentinel:\n  interval_s: 0.01\n  train_steps: 4\n"
    with side("port", tmp_path, settings, proxy=False) as s:
        drv = driver_with(s.m, 4, behavior=s.m.fake.exit_behavior(
            b"", 0, delay=0.3))
        agents = [f"loop-{'x' * 6}-{i}" for i in range(8)]
        for wid, recs in _egress(agents, agents[5]).items():
            _write(s.cfg.logs_dir / f"ebpf-egress-{wid}.jsonl", recs)
        scraped: list[str] = []
        stop = threading.Event()
        # the registry is process-wide: an earlier test in this worker
        # may have scored ticks already, so wait for this run's
        before = _scored_ticks(port_telemetry.REGISTRY.exposition())
        t = threading.Thread(target=_scrape_until, daemon=True, args=(
            port, lambda body: _scored_ticks(body) > before, scraped, stop))
        t.start()
        try:
            res = _loop_cli(s, drv, ["-p", "4", "-n", "2", "--sentinel",
                                     "--metrics-port", str(port), "--json"],
                            monkeypatch)
        finally:
            stop.set()
            t.join(10)
    assert res.exit_code == 0, res.output
    body = scraped[-1]
    assert _scored_ticks(body) > before
    assert 'anomaly_score{agent="clawker.twin.' in body
