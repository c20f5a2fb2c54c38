"""The port's monitor stack and netlogger against the reference's.

Twins of tests/test_monitor_units.py (the bootstrap corpus, monitoring
units, the units ledger) and tests/test_monitor.py (compose rendering,
the stack's lifecycle over the runner seam, the netlogger, the
``monitor`` verbs): the same inputs go through both packages and the
rendered files, the corpus trees, the ledger, the runner's argv, the
netlogger's records and the CLI's output are compared byte for byte.
Each package runs under its own ``TestEnv``; paths under it read
``<BASE>``.  The clocks that reach an output are pinned in both
packages: the ledger's ``seeded_at`` and the netlogger's ``@timestamp``.

Then the slice end to end on the CPU: chip_smoke's seeded
``egress_traffic`` through each package's policy, DNS gate and
netlogger writes the same file, and each package's
``analytics.runtime.score_file`` (the port's on ``device="cpu"``, both
drawing the same params and noise) flags the same agents in the same
order, the z within the fitted scores' tolerance.

``handler_resolvers`` is held over a real ``build_handler`` handler
(``test_monitor.py::test_handler_resolvers``) and, beside it, over a
stub handler that counts the rule reads its cache saves.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from test_torch_runtime import injected  # noqa: F401

import chip_smoke
import clawker_tpu.bundle.resolver as ref_resolver
import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.config as ref_config
import clawker_tpu.config.schema as ref_schema
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.firewall.dnsgate as ref_dnsgate
import clawker_tpu.firewall.hashes as ref_hashes
import clawker_tpu.firewall.maps as ref_maps
import clawker_tpu.firewall.model as ref_model
import clawker_tpu.firewall.policy as ref_policy
import clawker_tpu.monitor.corpus as ref_corpus
import clawker_tpu.monitor.ledger as ref_ledger
import clawker_tpu.monitor.netlogger as ref_netlogger
import clawker_tpu.monitor.stack as ref_stack
import clawker_tpu.monitor.unit as ref_unit
import clawker_tpu.testenv as ref_testenv
import clawker_tpu_torch.bundle.resolver as port_resolver
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.config.schema as port_schema
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.firewall.dnsgate as port_dnsgate
import clawker_tpu_torch.firewall.hashes as port_hashes
import clawker_tpu_torch.firewall.maps as port_maps
import clawker_tpu_torch.firewall.model as port_model
import clawker_tpu_torch.firewall.policy as port_policy
import clawker_tpu_torch.monitor.corpus as port_corpus
import clawker_tpu_torch.monitor.ledger as port_ledger
import clawker_tpu_torch.monitor.netlogger as port_netlogger
import clawker_tpu_torch.monitor.stack as port_stack
import clawker_tpu_torch.monitor.unit as port_unit
import clawker_tpu_torch.testenv as port_testenv
from clawker_tpu.analytics import runtime as ref_art
from clawker_tpu_torch.analytics import runtime as art

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

PKGS = {
    "ref": SimpleNamespace(
        corpus=ref_corpus, unit=ref_unit, ledger=ref_ledger, stack=ref_stack,
        netlogger=ref_netlogger, maps=ref_maps, model=ref_model,
        hashes=ref_hashes, policy=ref_policy, dnsgate=ref_dnsgate,
        schema=ref_schema, config=ref_config, testenv=ref_testenv,
        resolver=ref_resolver, drivers=ref_drivers, cli=ref_root.cli,
        Factory=ref_factory.Factory),
    "port": SimpleNamespace(
        corpus=port_corpus, unit=port_unit, ledger=port_ledger,
        stack=port_stack, netlogger=port_netlogger, maps=port_maps,
        model=port_model, hashes=port_hashes, policy=port_policy,
        dnsgate=port_dnsgate, schema=port_schema, config=port_config,
        testenv=port_testenv, resolver=port_resolver,
        drivers=port_drivers, cli=port_cli.cli, Factory=port_cli.Factory),
}
NOW = 1_785_000_000          # the pinned clocks: a Unix second
PROXY_OFF = "host_proxy:\n  enable: false\n"


@pytest.fixture(autouse=True)
def pinned_clocks(monkeypatch):
    """``Ledger.seed``'s ``seeded_at`` and ``NetLogger.enrich``'s
    ``@timestamp`` read ``NOW`` in both packages (``clock[0]`` moves
    it); ``handler_resolvers``' cache TTL keeps the real monotonic."""
    clock = [NOW]
    for m in PKGS.values():
        monkeypatch.setattr(m.ledger, "time", SimpleNamespace(
            time=lambda: float(clock[0])))
        monkeypatch.setattr(m.netlogger, "time", SimpleNamespace(
            gmtime=lambda: time.gmtime(clock[0]), strftime=time.strftime,
            monotonic=time.monotonic))
    return clock


def both(fn):
    """``fn(m, tag)`` in the reference, then in the port: -> (want, got)."""
    return fn(PKGS["ref"], "ref"), fn(PKGS["port"], "port")


def tree(root: Path) -> dict[str, bytes]:
    """Every file under ``root``: relative path -> bytes."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


@contextlib.contextmanager
def side(tag: str, tmp_path: Path):
    m = PKGS[tag]
    with m.testenv.TestEnv(base=tmp_path / tag) as tenv:
        tenv.write_settings(PROXY_OFF)
        proj = tenv.base / "p"
        proj.mkdir()
        (proj / ".clawker.yaml").write_text("project: mon\n")
        yield SimpleNamespace(m=m, tenv=tenv, proj=proj,
                              cfg=m.config.load_config(proj))


def twin(tmp_path: Path, scenario):
    """``scenario(s)`` under each package's ``TestEnv``, its base path
    replaced by ``<BASE>``: -> (want, got)."""
    out = []
    for tag in ("ref", "port"):
        with side(tag, tmp_path) as s:
            out.append(_based(scenario(s), str(s.tenv.base)))
    return tuple(out)


def _based(value, base: str):
    if isinstance(value, bytes):
        return value.replace(base.encode(), b"<BASE>")
    if isinstance(value, str):
        return value.replace(base, "<BASE>")
    if isinstance(value, dict):
        return {_based(k, base): _based(v, base) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_based(v, base) for v in value)
    return value


def make_unit(root, name="synthetic", index="synthetic", extra=""):
    d = root / name
    (d / "index-templates").mkdir(parents=True)
    (d / "monitoring.yaml").write_text(
        f"name: {name}\n"
        "description: test unit\n"
        "logs:\n"
        f"  - index: {index}\n"
        f"    service_names: [{index}-svc]\n"
        "    retention: short\n" + extra)
    (d / "index-templates" / f"{index}.json").write_text(
        json.dumps({"index_patterns": [index], "template": {}}))
    return d


def raised(fn) -> str:
    """The message of the ``UnitError`` ``fn`` raises."""
    try:
        fn()
    except (ref_unit.UnitError, port_unit.UnitError) as e:
        return f"{type(e).__name__}: {e}"
    raise AssertionError("no UnitError")


# ------------------------------------------------------------------ corpus

def test_corpus_builders_match_reference():
    want, got = both(lambda m, _: (
        m.corpus.component_template_common(), m.corpus.index_templates(),
        m.corpus.ingest_pipelines(), m.corpus.saved_objects(),
        m.corpus.to_ndjson(m.corpus.saved_objects()), m.corpus.RETENTIONS))
    assert got == want


def test_corpus_templates_compose_common():
    for name, tmpl in port_corpus.index_templates().items():
        assert tmpl["composed_of"] == ["clawker-common"], name
        assert tmpl["template"]["settings"]["index"]["final_pipeline"] == \
            "envelope-normalize", name


def test_corpus_pipelines_mark_failures():
    for name, pipe in port_corpus.ingest_pipelines().items():
        fields = [p["set"]["field"] for p in pipe["on_failure"]]
        assert "_normalize_failed" in fields, name


@pytest.mark.parametrize("age", ["7d", "2d", "30d"])
def test_ism_policy_deletes_after_age(age):
    want, got = both(lambda m, _: m.corpus.ism_policy(["clawker-*"], age=age))
    assert got == want
    pol = got["policy"]
    hot = next(s for s in pol["states"] if s["name"] == "hot")
    assert hot["transitions"][0]["conditions"]["min_index_age"] == age
    assert pol["ism_template"][0]["index_patterns"] == ["clawker-*"]


def test_saved_objects_include_dashboard_with_resolvable_panels():
    by_id = {o["id"]: o for o in port_corpus.saved_objects()}
    for ref in by_id["clawker-egress"]["references"]:
        assert ref["id"] in by_id, f"dashboard references missing {ref['id']}"


def test_write_bootstrap_tree_layout(tmp_path):
    def run(m, tag):
        written = m.corpus.write_bootstrap_tree(tmp_path / tag)
        return ([str(p.relative_to(tmp_path / tag)) for p in written],
                tree(tmp_path / tag))

    want, got = both(run)
    assert got == want
    rels = set(got[0])
    assert {"component-templates/clawker-common.json",
            "ism-policies/clawker-retention.json",
            "saved-objects/clawker.ndjson"} <= rels
    for rel, body in got[1].items():
        if rel.endswith(".json"):
            json.loads(body)


# ------------------------------------------------------------------- units

def test_load_floor_claude_code_unit():
    def run(m, _):
        unit = m.unit.load_unit(
            "claude-code", m.resolver.FLOOR_DIR / "monitoring" / "claude-code")
        return (unit.manifest.name, unit.manifest.description,
                [vars(lane) for lane in unit.manifest.logs],
                sorted(p.name for p in unit.artifact_files()),
                unit.content_hash())

    want, got = both(run)
    assert got == want
    assert [lane["index"] for lane in got[2]] == ["claude-code"]
    assert {"claude-code.json", "claude-code-normalize.json",
            "claude-code.ndjson"} <= set(got[3])
    assert got[4]


@pytest.mark.parametrize("index,match", [("clawker-cli", "reserved"),
                                         ("Bad_Index", "not a valid"),
                                         ("traces", "reserved")])
def test_unit_rejects_reserved_and_bad_indices(tmp_path, index, match):
    def run(m, tag):
        d = make_unit(tmp_path / tag, index=index)
        return raised(lambda: m.unit.load_unit("synthetic", d))

    want, got = both(run)
    assert got == want and match in got


def test_unit_rejects_unknown_dirs_stray_files_and_bad_json(tmp_path):
    def run(m, tag):
        d = make_unit(tmp_path / tag)
        out = []
        (d / "weird-dir").mkdir()
        out.append(raised(lambda: m.unit.load_unit("synthetic", d)))
        (d / "weird-dir").rmdir()
        (d / "README").write_text("x")
        out.append(raised(lambda: m.unit.load_unit("synthetic", d)))
        (d / "README").unlink()
        (d / "index-templates" / "broken.json").write_text("{nope")
        out.append(raised(lambda: m.unit.load_unit("synthetic", d)))
        return [msg.replace(str(d), "<D>") for msg in out]

    want, got = both(run)
    assert got == want
    assert ["unknown artifact dir" in got[0], "stray file" in got[1],
            "bad artifact" in got[2]] == [True] * 3


def test_unit_name_manifest_agreement(tmp_path):
    def run(m, tag):
        d = make_unit(tmp_path / tag, name="alpha")
        return raised(lambda: m.unit.load_unit("beta", d))

    want, got = both(run)
    assert got == want and "must agree" in got


@pytest.mark.parametrize("extra,match", [
    ("  - index: synthetic\n    service_names: [x]\n", "duplicate index"),
    ("  - index: other\n    service_names: [synthetic-svc]\n",
     "duplicate service"),
    ("  - index: other\n    service_names: []\n", "at least one service"),
    ("  - index: other\n    service_names: [y]\n    retention: forever\n",
     "unknown retention")])
def test_unit_lane_validation(tmp_path, extra, match):
    def run(m, tag):
        d = make_unit(tmp_path / tag, extra=extra)
        return raised(lambda: m.unit.load_unit("synthetic", d))

    want, got = both(run)
    assert got == want and match in got


def test_materialize_overlays(tmp_path):
    def run(m, tag):
        unit = m.unit.load_unit("synthetic",
                                make_unit(tmp_path / tag / "units"))
        t = tmp_path / tag / "tree"
        m.corpus.write_bootstrap_tree(t)
        written = m.unit.materialize(unit, t)
        return [str(p.relative_to(t)) for p in written], tree(t)

    want, got = both(run)
    assert got == want
    assert got[0] == ["index-templates/synthetic.json"]
    assert "index-templates/clawker-cli.json" in got[1]


def test_materialize_refuses_base_corpus_clobber(tmp_path):
    def run(m, tag):
        d = make_unit(tmp_path / tag / "units")
        (d / "ingest-pipelines").mkdir()
        (d / "ingest-pipelines" / "envelope-normalize.json").write_text(
            json.dumps({"processors": []}))
        unit = m.unit.load_unit("synthetic", d)
        t = tmp_path / tag / "tree"
        m.corpus.write_bootstrap_tree(t)
        return raised(lambda: m.unit.materialize(unit, t))

    want, got = both(run)
    assert got == want and "collides" in got


def test_lane_entries_must_be_mappings(tmp_path):
    def run(m, tag):
        d = tmp_path / tag / "bad"
        (d / "index-templates").mkdir(parents=True)
        (d / "monitoring.yaml").write_text("name: bad\nlogs:\n  - bad\n")
        return raised(lambda: m.unit.load_unit("bad", d))

    want, got = both(run)
    assert got == want and "must be a mapping" in got


def test_discover_units_later_roots_win(tmp_path):
    def run(m, tag):
        a, b = tmp_path / tag / "a", tmp_path / tag / "b"
        make_unit(a, name="dup", index="one")
        make_unit(b, name="dup", index="two")
        make_unit(a, name="solo", index="solo")
        units = m.unit.discover_units([a, b, tmp_path / tag / "missing"])
        return {n: [lane.index for lane in u.manifest.logs]
                for n, u in units.items()}

    want, got = both(run)
    assert got == want == {"dup": ["two"], "solo": ["solo"]}


# ------------------------------------------------------------------ ledger

def test_ledger_roundtrip_and_collision(tmp_path):
    def run(m, tag):
        base = tmp_path / tag
        d1 = make_unit(base / "src1", name="shared")
        d2 = make_unit(base / "src2", name="shared",
                       extra="  - index: other\n    service_names: "
                             "[other-svc]\n")
        u1 = m.unit.load_unit("shared", d1)
        u2 = m.unit.load_unit("shared", d2)
        led = m.ledger.Ledger(base / "monitor")
        led.seed(u1, source=str(d1))
        led.save()
        saved = (base / "monitor" / m.ledger.LEDGER_FILE).read_text()
        led2 = m.ledger.Ledger(base / "monitor")
        loaded = {n: vars(u) for n, u in led2.units.items()}
        led2.seed(u1, source=str(d1))
        try:
            led2.seed(u2, source=str(d2))
            clash = ""
        except (ref_ledger.SeedCollision, port_ledger.SeedCollision) as e:
            clash = str(e)
        led2.seed(u1, source="floor")
        led2.save()
        return [_based(x, str(base)) for x in (
            saved, loaded, clash,
            (base / "monitor" / m.ledger.LEDGER_FILE).read_text())]

    want, got = both(run)
    assert got == want
    assert "cluster-wide namespace" in got[2]
    assert got[1]["shared"]["seeded_at"] == NOW
    assert yaml.safe_load(got[3])["units"]["shared"]["source"] == "floor"


def test_ledgers_read_each_other(tmp_path):
    """A ledger either package wrote loads in the other."""
    d = make_unit(tmp_path / "src", name="shared")
    for writer, reader in (("ref", "port"), ("port", "ref")):
        w, r = PKGS[writer], PKGS[reader]
        led = w.ledger.Ledger(tmp_path / writer)
        led.seed(w.unit.load_unit("shared", d), source="floor")
        led.save()
        back = r.ledger.Ledger(tmp_path / writer)
        assert {n: vars(u) for n, u in back.units.items()} == \
            {n: vars(u) for n, u in led.units.items()}


# ---------------------------------------------------------------- rendering

class FakeCompose:
    def __init__(self, rc=0, stdout=""):
        self.calls = []
        self.rc = rc
        self.stdout = stdout

    def __call__(self, *args):
        self.calls.append(args)
        return subprocess.CompletedProcess(args, self.rc, self.stdout, "boom")


def test_compose_service_set(tmp_path):
    def scenario(s):
        mon = s.cfg.settings.monitoring
        return (s.m.stack.render_compose(mon),
                s.m.stack.render_prometheus_config(mon),
                s.m.stack.render_bootstrap_script(),
                s.m.stack.render_otel_config(mon),
                s.m.stack.render_otel_config(
                    mon, {"b-lane": ["b-svc", "a-svc"], "a-lane": ["c"]}))

    want, got = twin(tmp_path, scenario)
    assert got == want
    compose = yaml.safe_load(got[0])
    assert set(compose["services"]) == {
        "otel-collector", "opensearch", "opensearch-bootstrap",
        "opensearch-dashboards", "prometheus"}
    assert compose["name"] == port_stack.COMPOSE_PROJECT
    for surface in ("_component_template", "_index_template",
                    "_ingest/pipeline", "_plugins/_ism/policies",
                    "saved_objects/_import", "osd-xsrf"):
        assert surface in got[2]
    table = yaml.safe_load(got[4])["connectors"]["routing"]["table"]
    assert [row["pipelines"] for row in table] == [["logs/a-lane"],
                                                   ["logs/b-lane"]]


def test_render_writes_stack_dir(tmp_path):
    def scenario(s):
        loose = s.cfg.data_dir / "monitoring-units"
        make_unit(loose, name="extra", index="extra-lane")
        d = s.m.stack.MonitorStack(s.cfg).render()
        return str(d), tree(d)

    want, got = twin(tmp_path, scenario)
    assert got == want
    files = got[1]
    for f in ("compose.yaml", "otel-config.yaml", "prometheus.yaml",
              "bootstrap.sh", "units-ledger.yaml"):
        assert f in files, f
    t = "opensearch-bootstrap/"
    for index in port_stack.LOG_INDICES[1:]:
        assert f"{t}index-templates/{index}.json" in files
    assert f"{t}saved-objects/claude-code.ndjson" in files
    assert f"{t}index-templates/extra-lane.json" in files
    otel = yaml.safe_load(files["otel-config.yaml"])
    assert {"logs/claude-code", "logs/extra-lane"} <= set(
        otel["service"]["pipelines"])
    ism = json.loads(files[f"{t}ism-policies/clawker-units-default.json"])
    assert ism["policy"]["ism_template"][0]["index_patterns"] == [
        "claude-code*"]
    ledger = yaml.safe_load(files["units-ledger.yaml"])["units"]
    assert ledger["claude-code"]["source"] == "floor"
    assert ledger["extra"]["source"].startswith("<BASE>")


@pytest.mark.parametrize("clash", ["index", "service"])
def test_render_refuses_units_claiming_one_lane(tmp_path, clash):
    def scenario(s):
        loose = s.cfg.data_dir / "monitoring-units"
        make_unit(loose, name="one", index="shared-lane")
        other = make_unit(loose, name="two", index="other-lane")
        if clash == "index":
            (other / "monitoring.yaml").write_text(
                "name: two\nlogs:\n  - index: shared-lane\n"
                "    service_names: [two-svc]\n")
        else:
            (other / "monitoring.yaml").write_text(
                "name: two\nlogs:\n  - index: other-lane\n"
                "    service_names: [shared-lane-svc]\n")
        return raised(lambda: s.m.stack.MonitorStack(s.cfg).render())

    want, got = twin(tmp_path, scenario)
    assert got == want and "both claim" in got


def test_down_resets_units_ledger(tmp_path):
    def scenario(s):
        runner = FakeCompose()
        stack = s.m.stack.MonitorStack(s.cfg, runner=runner)
        stack.render()
        before = (stack.dir / s.m.ledger.LEDGER_FILE).exists()
        stack.down()
        return before, (stack.dir / s.m.ledger.LEDGER_FILE).exists(), \
            runner.calls

    want, got = twin(tmp_path, scenario)
    assert got == want == (True, False, [("down", "--volumes")])


# ---------------------------------------------------------------- lifecycle

@pytest.mark.parametrize("stdout", [
    '{"Service": "opensearch", "State": "running"}\n',
    '[{"Service": "opensearch", "State": "running"}, {"Name": "p"}]\n'
    'not json\n{"Service": "prometheus", "State": "exited"}\n'],
    ids=["ndjson", "array-and-garbage"])
def test_up_down_status_over_runner(tmp_path, stdout):
    def scenario(s):
        runner = FakeCompose(stdout=stdout)
        stack = s.m.stack.MonitorStack(s.cfg, runner=runner)
        stack.up()
        rendered = (stack.dir / "compose.yaml").exists()
        rows = stack.status()
        stack.down()
        return runner.calls, rendered, rows

    want, got = twin(tmp_path, scenario)
    assert got == want
    calls, rendered, rows = got
    assert calls[0] == ("up", "-d", "--remove-orphans") and rendered
    assert calls[-1] == ("down", "--volumes")
    assert rows[0] == {"Service": "opensearch", "State": "running"}


def test_up_failure_raises_and_failed_status_is_empty(tmp_path):
    def scenario(s):
        stack = s.m.stack.MonitorStack(s.cfg, runner=FakeCompose(rc=1))
        with pytest.raises(s.m.stack.MonitorError) as e:
            stack.up()
        with pytest.raises(s.m.stack.MonitorError) as e2:
            stack.down()
        return str(e.value), str(e2.value), stack.status()

    want, got = twin(tmp_path, scenario)
    assert got == want == ("monitor up failed: boom",
                           "monitor down failed: boom", [])


def test_unit_roots_are_the_floor_then_the_loose_dir(tmp_path):
    def scenario(s):
        floor, loose = s.m.stack.MonitorStack(s.cfg).unit_roots()
        return (str(floor.relative_to(s.m.resolver.FLOOR_DIR)), str(loose),
                sorted(p.name for p in floor.iterdir()))

    want, got = twin(tmp_path, scenario)
    assert got == want == ("monitoring", "<BASE>/data/monitoring-units",
                           ["claude-code"])


# ---------------------------------------------------------------- netlogger

def _event(m, cg=7, ip="203.0.113.9", verdict="DENY", reason="NO_ROUTE",
           zone=""):
    M = m.model
    return M.EgressEvent(
        ts_ns=123, cgroup_id=cg, dst_ip=ip, dst_port=443,
        zone_hash=m.hashes.zone_hash(zone) if zone else 0,
        verdict=M.Action[verdict], proto=M.PROTO_TCP, reason=M.Reason[reason])


def test_netlogger_drains_and_enriches(tmp_path, pinned_clocks):
    def run(m, tag):
        maps = m.maps.FakeMaps()
        maps.emit_event(_event(m, zone="example.com", verdict="REDIRECT",
                               reason="ROUTE"))
        maps.emit_event(_event(m))
        maps.emit_event(_event(m, cg=8, ip="1.2.3.4", reason="NO_DNS_ENTRY"))
        out = tmp_path / tag / "egress.jsonl"
        zh = m.hashes.zone_hash("example.com")
        nl = m.netlogger.NetLogger(
            maps, out_path=out,
            resolve_cgroup=lambda cg: "clawker.mon.dev" if cg == 7 else "",
            resolve_zone=lambda h: "example.com" if h == zh else "")
        counts = [nl.drain_once()]
        pinned_clocks[0] += 1
        maps.emit_event(_event(m, verdict="ALLOW", reason="MONITOR"))
        counts += [nl.drain_once(), nl.drain_once()]
        pinned_clocks[0] = NOW
        return counts, nl.emitted, out.read_bytes()

    want, got = both(run)
    assert got == want
    counts, emitted, body = got
    assert counts == [3, 1, 0] and emitted == 4
    recs = [json.loads(line) for line in body.splitlines()]
    assert recs[0]["verdict"] == "REDIRECT" and recs[0]["zone"] == "example.com"
    assert recs[0]["container"] == "clawker.mon.dev"
    assert recs[1]["reason"] == "NO_ROUTE" and recs[2]["container"] == ""
    assert recs[0]["zone_hash"] == str(port_hashes.zone_hash("example.com"))
    assert recs[3]["@timestamp"] == time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime(NOW + 1))


def test_netlogger_drains_at_most_512_a_call(tmp_path):
    def run(m, tag):
        maps = m.maps.FakeMaps()
        for i in range(700):
            maps.emit_event(_event(m, cg=i))
        nl = m.netlogger.NetLogger(maps, out_path=tmp_path / tag / "e.jsonl")
        return [nl.drain_once() for _ in range(3)], \
            (tmp_path / tag / "e.jsonl").read_bytes()

    want, got = both(run)
    assert got == want and got[0] == [512, 188, 0]


def test_netlogger_background_loop(tmp_path):
    def run(m, tag):
        maps = m.maps.FakeMaps()
        nl = m.netlogger.NetLogger(maps, out_path=tmp_path / tag / "e.jsonl",
                                   poll_s=0.05)
        nl.start()
        try:
            maps.emit_event(_event(m))
            deadline = time.time() + 5
            while nl.emitted < 1 and time.time() < deadline:
                time.sleep(0.02)
            seen = nl.emitted
        finally:
            # the final sweep on stop picks up late events
            maps.emit_event(_event(m, cg=9))
            nl.stop()
        return seen, nl.emitted, nl._thread.is_alive(), \
            (tmp_path / tag / "e.jsonl").read_bytes()

    want, got = both(run)
    assert got == want and got[:3] == (1, 2, False)


def test_netlogger_survives_a_failing_drain(tmp_path):
    """A drain that raises is logged and the loop keeps going."""
    def run(m, tag):
        maps = m.maps.FakeMaps()
        real, calls = maps.drain_events, []

        def flaky(max_events=256):
            calls.append(max_events)
            if len(calls) == 1:
                raise OSError("ring gone")
            return real(max_events)

        maps.drain_events = flaky
        maps.emit_event(_event(m))
        nl = m.netlogger.NetLogger(maps, out_path=tmp_path / tag / "e.jsonl",
                                   poll_s=0.02)
        nl.start()
        deadline = time.time() + 5
        while nl.emitted < 1 and time.time() < deadline:
            time.sleep(0.02)
        nl.stop()
        return nl.emitted, calls[0]

    want, got = both(run)
    assert got == want == (1, 512)


def test_handler_resolvers(tmp_path):
    """``test_monitor.py::test_handler_resolvers`` over each package's
    ``build_handler``: an enrolled container's cgroup names it, the
    base rules' zones name their apexes.  The gate listens on a port no
    TCP socket held (``test_torch_firewall_handler.py``'s rigs)."""
    from importlib import import_module

    from test_torch_firewall_handler import tcp_free_port

    def run(m, tag):
        root = m.netlogger.__name__.split(".")[0]
        api = import_module(f"{root}.engine.api")
        enroll = import_module(f"{root}.firewall.enroll")
        runtime = import_module(f"{root}.firewall.runtime")
        with side(tag, tmp_path) as s:
            driver = m.drivers.FakeDriver()
            driver.api.add_image("envoyproxy/envoy:v1.30.2")
            handler = runtime.build_handler(
                s.cfg, driver.engine(), maps=m.maps.FakeMaps(),
                resolver=enroll.FakeCgroupResolver(),
                attacher=enroll.FakeAttacher(), dns_host="127.0.0.1",
                dns_port=tcp_free_port())
            try:
                driver.api.add_image("a:1")
                eng = driver.engine()
                cid = eng.create_container("clawker.mon.dev",
                                           api.ContainerSpec(image="a:1"))
                eng.start_container(cid)
                cgid = handler.enable({"container_id": cid})["cgroup_id"]
                rc, rz = m.netlogger.handler_resolvers(handler)
                zh = m.hashes.zone_hash
                return [rc(cgid) == cid, cgid == int.from_bytes(
                            cid.encode()[:6], "big"), rc(999999),
                        rz(zh("api.anthropic.com")), rz(0), rz(12345)]
            finally:
                handler.close()
                if handler.stack.gate is not None:
                    handler.stack.gate.stop()

    want, got = both(run)
    assert got == want == [True, True, "", "api.anthropic.com", "", ""]


class _StubHandler:
    """What ``handler_resolvers`` reads of a ``FirewallHandler``:
    ``enrollments`` (records with ``cgroup_id`` and ``container_id``)
    and ``effective_rules()``."""

    def __init__(self, m):
        self.m = m
        self.enrollments = {
            "c1": SimpleNamespace(cgroup_id=11, container_id="cid-1"),
            "c2": SimpleNamespace(cgroup_id=12, container_id="cid-2")}
        self.reads = 0

    def effective_rules(self):
        self.reads += 1
        R = self.m.schema.EgressRule
        return [R(dst="api.anthropic.com"), R(dst="*.example.com"),
                R(dst="ntp.example.net", proto="udp", port=123)]


def test_handler_resolvers_over_a_stub_handler():
    def run(m, _):
        h = _StubHandler(m)
        rc, rz = m.netlogger.handler_resolvers(h, cache_ttl_s=60.0)
        zh = m.hashes.zone_hash
        got = [rc(11), rc(12), rc(999999), rz(zh("api.anthropic.com")),
               rz(zh("example.com")), rz(zh("ntp.example.net")), rz(0),
               rz(12345)]
        h.enrollments["c3"] = SimpleNamespace(cgroup_id=13,
                                              container_id="cid-3")
        got += [rc(13), h.reads]           # cached: not re-read
        rc2, _ = m.netlogger.handler_resolvers(h, cache_ttl_s=0.0)
        return got + [rc2(13), h.reads]

    want, got = both(run)
    assert got == want == ["cid-1", "cid-2", "", "api.anthropic.com",
                           "example.com", "ntp.example.net", "", "", "", 1,
                           "cid-3", 2]


# --------------------------------------------------------------------- CLI

def invoke(s, *args):
    res = CliRunner().invoke(s.m.cli, list(args), obj=s.m.Factory(
        cwd=s.proj, driver=s.m.drivers.FakeDriver()))
    return res.exit_code, res.stdout, res.stderr


def _egress_log(s, records):
    logp = s.cfg.logs_dir / "ebpf-egress.jsonl"
    logp.parent.mkdir(parents=True, exist_ok=True)
    logp.write_text("".join(json.dumps(r) + "\n" for r in records)
                    + "{torn\n")


def _egress_records():
    out = []
    for i in range(6):
        out.append({"@timestamp": f"2026-07-29T00:00:0{i}Z",
                    "verdict": "DENY" if i % 2 else "REDIRECT",
                    "container": "clawker.mon.dev" if i < 4 else "",
                    "cgroup_id": 70 + i, "dst_ip": f"1.2.3.{i}",
                    "dst_port": 443, "zone": "" if i % 2 else "example.com",
                    "reason": "NO_DNS_ENTRY" if i % 2 else "ROUTE"})
    return out


def test_cli_monitor_init_and_egress(tmp_path):
    def scenario(s):
        out = [invoke(s, "monitor", "init"),
               (s.cfg.data_dir / "monitor" / "compose.yaml").exists(),
               invoke(s, "monitor", "egress")]
        _egress_log(s, _egress_records())
        out += [invoke(s, "monitor", "egress"),
                invoke(s, "monitor", "egress", "--deny-only"),
                invoke(s, "monitor", "egress", "--tail", "2")]
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    init, rendered, missing, all_, denies, tail = got
    assert init[0] == 0 and "clawker-ebpf-egress" in init[1] and rendered
    assert missing[0] == 1 and "no egress log yet" in missing[2]
    assert len(all_[1].splitlines()) == 6
    assert [line.split("\t")[2] for line in denies[1].splitlines()] == [
        "clawker.mon.dev", "clawker.mon.dev", "75"]
    assert tail[1].splitlines()[0].startswith("2026-07-29T00:00:04Z\tREDIRECT")


def test_cli_monitor_units(tmp_path):
    def scenario(s):
        out = [invoke(s, "monitor", "units")]
        invoke(s, "monitor", "init")
        out.append(invoke(s, "monitor", "units"))
        make_unit(s.cfg.data_dir / "monitoring-units", name="extra",
                  index="extra-lane")
        out.append(invoke(s, "monitor", "units"))
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    before, seeded, extra = got
    assert before[1].startswith("claude-code\tunseeded\tclaude-code\t")
    assert seeded[1].startswith("claude-code\tseeded\tclaude-code\t")
    assert "extra\tunseeded\textra-lane\ttest unit" in extra[1]


@pytest.mark.parametrize("stdout", [
    "", '{"Service": "opensearch", "State": "running"}\n'],
    ids=["not-running", "running"])
def test_cli_monitor_up_status_down_over_the_runner(tmp_path, monkeypatch,
                                                   stdout):
    """The verbs over the stack's runner seam (no ``docker compose``)."""
    def scenario(s):
        runner = FakeCompose(stdout=stdout)
        monkeypatch.setattr(s.m.stack.MonitorStack, "_run_compose",
                            lambda self, *args: runner(*args))
        out = [invoke(s, "monitor", "up"), invoke(s, "monitor", "status"),
               invoke(s, "monitor", "status", "--format", "json"),
               invoke(s, "monitor", "down")]
        return out, runner.calls

    want, got = twin(tmp_path, scenario)
    assert got == want
    (up, status, as_json, down), calls = got
    assert up == (0, "monitor stack up: dashboards http://localhost:5601 "
                  "prometheus http://localhost:9090\n", "")
    assert down[:2] == (0, "monitor stack down\n")
    assert status[0] == (0 if stdout else 1)
    assert json.loads(as_json[1]) == ([json.loads(stdout)] if stdout else [])
    assert calls[0] == ("up", "-d", "--remove-orphans")


def test_monitor_help_lists_every_verb():
    want, got = both(lambda m, _: sorted(m.cli.commands["monitor"].commands))
    assert got == want == ["anomalies", "down", "egress", "init", "status",
                           "units", "up"]


# ------------------------------------------------ the slice, end to end


E2E_CONTAINERS = 12
E2E_STORM = 7
E2E_STEPS = 60
# ROADMAP §3 item 7: fitted scores agree to ~1e-3 relative (this
# stream's: 8.5e-6 on the raw scores, 9.3e-6 on the z of its hot windows)
Z_RTOL = 1e-3


def _traffic(tmp_path, pinned_clocks):
    """chip_smoke's ``egress_traffic`` through each package's lane, each
    drain one (pinned) second after the last: -> {tag: (run, bytes)}."""
    out = {}
    with chip_smoke.LoopbackUpstream() as up:
        for tag, m in PKGS.items():
            pinned_clocks[0] = NOW

            def next_drain():
                pinned_clocks[0] += 1

            path = tmp_path / tag / "ebpf-egress.jsonl"
            run = chip_smoke.egress_traffic(
                m, path, up.addr, next_drain=next_drain,
                containers=E2E_CONTAINERS, storm_slot=E2E_STORM)
            out[tag] = (run, path)
    return out


def test_egress_traffic_through_both_lanes_writes_one_file(tmp_path,
                                                           pinned_clocks):
    runs = _traffic(tmp_path, pinned_clocks)
    (want, ref_path), (got, port_path) = runs["ref"], runs["port"]
    assert got == want
    assert port_path.read_bytes() == ref_path.read_bytes()
    assert got["emitted"] == got["emitting"] == sum(got["drained"])
    assert got["events_dropped"] == 0 and len(got["drained"]) == 3
    assert got["gate"]["queries"] == got["gate"]["allowed"] == \
        3 * E2E_CONTAINERS
    recs = [json.loads(line) for line in port_path.read_text().splitlines()]
    assert len({r["@timestamp"] for r in recs}) == 3
    storm = chip_smoke.egress_container(E2E_STORM)
    assert sum(1 for r in recs if r["container"] == storm
               and r["dst_port"] >= 4444) == chip_smoke.EGRESS_STORM


def test_slice_end_to_end_flags_the_storm_like_the_reference(
        tmp_path, pinned_clocks, injected):
    runs = _traffic(tmp_path, pinned_clocks)
    want = ref_art.score_file(runs["ref"][1], window_s=1,
                              train_steps=E2E_STEPS)
    got = art.score_file(runs["port"][1], window_s=1, train_steps=E2E_STEPS,
                         device="cpu")
    assert got.device == "cpu" and len(got.keys) == len(want.keys)
    storm = chip_smoke.egress_container(E2E_STORM)

    def ranked(rep):
        return [a.agent for a in sorted(rep.agents, key=lambda a: -a.latest)]

    def flagged(rep):
        return [a for a in ranked(rep) if next(
            x for x in rep.agents if x.agent == a).latest
            >= chip_smoke.EGRESS_THRESHOLD]

    assert flagged(got) == flagged(want)
    assert flagged(got)[0] == ranked(got)[0] == storm
    np.testing.assert_allclose(got.raw, want.raw, rtol=Z_RTOL)
    hot = [k for k, z in enumerate(want.z) if z >= 1.0]
    np.testing.assert_allclose(got.z[hot], want.z[hot], rtol=Z_RTOL)
    by = {a.agent: a.latest for a in got.agents}
    ref_by = {a.agent: a.latest for a in want.agents}
    np.testing.assert_allclose(by[storm], ref_by[storm], rtol=Z_RTOL)
