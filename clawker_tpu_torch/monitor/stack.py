"""Monitor stack: deterministic compose rendering + lifecycle.

The port's copy of ``clawker_tpu/monitor/stack.py``, whole.

Renders the observability compose file (OTel Collector gateway,
OpenSearch single node, OpenSearch Dashboards, Prometheus, one-shot
bootstrap seeding index templates + saved objects) into the data dir and
drives ``docker compose`` over it.  Rendering is pure (settings -> bytes)
so tests pin the output; the compose invocation rides a runner seam.

Parity reference: internal/monitor/templates/compose.yaml.tmpl:11-198
(service set), otel-config.yaml.tmpl, prometheus.yaml.tmpl; `monitor up`
shells to docker compose (internal/cmd/monitor/up/up.go:81).  The six
log indices (SURVEY.md 2.11): claude-code, clawker-cli, clawkercp,
clawker-envoy, clawker-dnsgate, clawker-ebpf-egress.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

from .. import consts, logsetup
from ..config import Config
from ..errors import ClawkerError

log = logsetup.get("monitor.stack")

LOG_INDICES = (
    "clawker-otlp",       # everything arriving over OTLP (service.name
    #                       attribute discriminates: claude-code harness
    #                       telemetry, ebpf-egress, cp subsystems)
    "claude-code",        # harness telemetry (file-shipped lane)
    "clawker-cli",        # host CLI logs
    "clawkercp",          # control-plane logs
    "clawker-envoy",      # proxy access logs (container stdout)
    "clawker-dnsgate",    # DNS query decisions
    "clawker-ebpf-egress",  # per-decision kernel egress events (jsonl lane)
)

COMPOSE_PROJECT = "clawker-monitor"


class MonitorError(ClawkerError):
    pass


def render_otel_config(s, lanes: dict[str, list[str]] | None = None) -> str:
    """OTLP (grpc+http) -> OpenSearch log indices + Prometheus metrics.

    ``lanes`` maps index -> service.name values routed into it (base
    lanes + monitoring-unit lanes); everything unrouted lands in
    clawker-otlp.  Lane/service names pass the unit grammar (lowercase/
    digits/hyphens), so interpolating them into OTTL conditions cannot
    inject (unit.py index-name rule)."""
    lanes = lanes or {}
    exporters: dict = {
        "opensearch/default": {
            "http": {"endpoint": "http://opensearch:9200"},
            "logs_index": "clawker-otlp",
        },
        # harness OTLP traces land in the SS4O traces dataset (reference:
        # MONITORING-REFERENCE.md:5 -- Claude Code traces -> SS4O
        # traces/clawker), queryable from the Dashboards Observability UI
        "opensearch/traces": {
            "http": {"endpoint": "http://opensearch:9200"},
            "dataset": "clawker",
        },
        "prometheus": {"endpoint": "0.0.0.0:8889"},
        "debug": {"verbosity": "basic"},
    }
    pipelines: dict = {
        "metrics": {"receivers": ["otlp"],
                    "processors": ["transform/metrics", "batch"],
                    "exporters": ["prometheus"]},
        "traces": {"receivers": ["otlp"], "processors": ["batch"],
                   "exporters": ["opensearch/traces"]},
    }
    routing_table = []
    for index in sorted(lanes):
        exporters[f"opensearch/{index}"] = {
            "http": {"endpoint": "http://opensearch:9200"},
            "logs_index": index,
        }
        pipelines[f"logs/{index}"] = {
            "receivers": ["routing"], "processors": ["batch"],
            "exporters": [f"opensearch/{index}"]}
        cond = " or ".join(
            f'resource.attributes["service.name"] == "{svc}"'
            for svc in sorted(lanes[index]))
        # the condition rides INSIDE the OTTL statement -- a separate
        # `condition` key is rejected by the pinned collector's strict
        # config decoding (and a bare route() would match everything)
        routing_table.append(
            {"statement": f"route() where {cond}",
             "pipelines": [f"logs/{index}"]})
    pipelines["logs/default"] = {"receivers": ["routing"],
                                 "processors": ["batch"],
                                 "exporters": ["opensearch/default"]}
    pipelines["logs/in"] = {"receivers": ["otlp"], "processors": [],
                            "exporters": ["routing"]}
    cfg = {
        "receivers": {
            "otlp": {
                "protocols": {
                    "grpc": {"endpoint": f"0.0.0.0:{s.otlp_grpc_port}"},
                    "http": {"endpoint": "0.0.0.0:4318"},
                }
            }
        },
        "connectors": {
            "routing": {
                "default_pipelines": ["logs/default"],
                "table": routing_table,
            }
        },
        "processors": {
            "batch": {"timeout": "2s"},
            # label rename worked around an OpenSearch SQL-plugin bug in
            # the reference (MONITORING-REFERENCE.md:13-31); kept so
            # dashboards port over unchanged
            "transform/metrics": {
                "metric_statements": [{
                    "context": "datapoint",
                    "statements": [
                        'set(attributes["kind"], attributes["type"]) where attributes["type"] != nil',
                        'delete_key(attributes, "type")',
                    ],
                }]
            },
        },
        "exporters": exporters,
        "service": {"pipelines": pipelines},
    }
    import yaml

    return yaml.safe_dump(cfg, sort_keys=True)


def render_prometheus_config(s) -> str:
    import yaml

    return yaml.safe_dump({
        "global": {"scrape_interval": "15s"},
        "scrape_configs": [
            {"job_name": "otel-collector",
             "static_configs": [{"targets": ["otel-collector:8889"]}]},
            {"job_name": "prometheus",
             "static_configs": [{"targets": ["localhost:9090"]}]},
        ],
    }, sort_keys=True)


def render_bootstrap_script() -> str:
    """One-shot seeding: plain directory loops over the mounted
    opensearch-bootstrap tree (base corpus + unit overlays apply the
    same way -- that is the point of the shared layout).

    Reference: internal/monitor/templates/opensearch-bootstrap/
    bootstrap.sh.tmpl semantics."""
    return r"""#!/bin/sh
set -e
B=/bootstrap
OS=http://opensearch:9200
DASH=http://opensearch-dashboards:5601
H='Content-Type: application/json'

until curl -fsS "$OS" >/dev/null; do sleep 2; done

for f in "$B"/component-templates/*.json; do
  [ -e "$f" ] || continue
  n=$(basename "$f" .json)
  curl -fsS -X PUT -H "$H" "$OS/_component_template/$n" --data-binary @"$f" >/dev/null
  echo "component-template $n"
done

for f in "$B"/index-templates/*.json; do
  [ -e "$f" ] || continue
  n=$(basename "$f" .json)
  curl -fsS -X PUT -H "$H" "$OS/_index_template/$n" --data-binary @"$f" >/dev/null
  echo "index-template $n"
done

for f in "$B"/ingest-pipelines/*.json; do
  [ -e "$f" ] || continue
  n=$(basename "$f" .json)
  curl -fsS -X PUT -H "$H" "$OS/_ingest/pipeline/$n" --data-binary @"$f" >/dev/null
  echo "ingest-pipeline $n"
done

# ISM is a plugin: degrade (bare OSS images run without retention)
for f in "$B"/ism-policies/*.json; do
  [ -e "$f" ] || continue
  n=$(basename "$f" .json)
  curl -fsS -X PUT -H "$H" "$OS/_plugins/_ism/policies/$n" --data-binary @"$f" >/dev/null \
    && echo "ism-policy $n" || echo "ism-policy $n skipped (plugin unavailable)"
done

# saved objects import needs Dashboards, which boots after OpenSearch
until curl -fsS "$DASH/api/status" >/dev/null; do sleep 2; done
for f in "$B"/saved-objects/*.ndjson; do
  [ -e "$f" ] || continue
  curl -fsS -X POST "$DASH/api/saved_objects/_import?overwrite=true" \
    -H 'osd-xsrf: true' --form file=@"$f" >/dev/null
  echo "saved-objects $(basename "$f")"
done

echo 'clawker monitor bootstrap complete'
"""


def render_compose(s) -> str:
    import yaml

    services = {
        "otel-collector": {
            "image": "otel/opentelemetry-collector-contrib:0.103.0",
            "command": ["--config=/etc/otel/config.yaml"],
            "volumes": ["./otel-config.yaml:/etc/otel/config.yaml:ro"],
            "ports": [f"{s.otlp_grpc_port}:{s.otlp_grpc_port}", "4318:4318"],
            "depends_on": ["opensearch"],
            "restart": "unless-stopped",
        },
        "opensearch": {
            "image": "opensearchproject/opensearch:2.15.0",
            "environment": [
                "discovery.type=single-node",
                "DISABLE_SECURITY_PLUGIN=true",
                "OPENSEARCH_JAVA_OPTS=-Xms512m -Xmx512m",
            ],
            "ports": [f"{s.opensearch_port}:9200"],
            "volumes": ["opensearch-data:/usr/share/opensearch/data"],
            "restart": "unless-stopped",
        },
        "opensearch-bootstrap": {
            "image": "curlimages/curl:8.8.0",
            "entrypoint": ["/bin/sh", "/bootstrap.sh"],
            "volumes": ["./bootstrap.sh:/bootstrap.sh:ro",
                        "./opensearch-bootstrap:/bootstrap:ro"],
            "depends_on": ["opensearch", "opensearch-dashboards"],
            "restart": "no",
        },
        "opensearch-dashboards": {
            "image": "opensearchproject/opensearch-dashboards:2.15.0",
            "environment": [
                "OPENSEARCH_HOSTS=[\"http://opensearch:9200\"]",
                "DISABLE_SECURITY_DASHBOARDS_PLUGIN=true",
            ],
            "ports": [f"{s.dashboards_port}:5601"],
            "depends_on": ["opensearch"],
            "restart": "unless-stopped",
        },
        "prometheus": {
            "image": "prom/prometheus:v2.53.0",
            "volumes": ["./prometheus.yaml:/etc/prometheus/prometheus.yml:ro"],
            "ports": [f"{s.prometheus_port}:9090"],
            "restart": "unless-stopped",
        },
    }
    return yaml.safe_dump({
        "name": COMPOSE_PROJECT,
        "services": services,
        "volumes": {"opensearch-data": {}},
    }, sort_keys=True)


class MonitorStack:
    def __init__(self, cfg: Config, *, runner=None):
        self.cfg = cfg
        self.dir = cfg.data_dir / "monitor"
        self.runner = runner or self._run_compose

    # ------------------------------------------------------------ render

    def unit_roots(self) -> list:
        """Unit discovery roots: embedded floor, then the host's loose
        extension dir (later wins on name)."""
        from ..bundle.resolver import FLOOR_DIR

        return [FLOOR_DIR / "monitoring",
                self.cfg.data_dir / "monitoring-units"]

    def render(self) -> Path:
        from . import corpus
        from .ledger import Ledger
        from .unit import UnitError, discover_units, materialize

        s = self.cfg.settings.monitoring
        self.dir.mkdir(parents=True, exist_ok=True)

        # bootstrap tree: base corpus + monitoring-unit overlays, then
        # record every seeded unit in the ledger (collision = refusal)
        tree = self.dir / "opensearch-bootstrap"
        if tree.exists():
            import shutil

            shutil.rmtree(tree)
        corpus.write_bootstrap_tree(tree)
        floor, loose = self.unit_roots()
        units = discover_units([floor, loose])
        ledger = Ledger(self.dir)
        # units removed from the host are pruned: unit roots are
        # host-global, so an undiscovered name has no owner left and a
        # stale record would block its name forever
        for gone in set(ledger.units) - set(units):
            del ledger.units[gone]
        lanes: dict[str, list[str]] = {}
        lane_owner: dict[str, str] = {}      # index -> unit
        svc_owner: dict[str, str] = {}       # service.name -> unit
        retention_lanes: dict[str, list[str]] = {}  # token -> indices
        for name, unit in sorted(units.items()):
            source = "floor" if unit.root.is_relative_to(floor) else str(unit.root)
            ledger.seed(unit, source=source)
            materialize(unit, tree)
            for lane in unit.manifest.logs:
                if lane.index in lane_owner:
                    raise UnitError(
                        f"monitoring units {lane_owner[lane.index]!r} and "
                        f"{name!r} both claim index {lane.index!r}")
                lane_owner[lane.index] = name
                for svc in lane.service_names:
                    if svc in svc_owner:
                        raise UnitError(
                            f"monitoring units {svc_owner[svc]!r} and "
                            f"{name!r} both claim service {svc!r} -- logs "
                            "would be double-routed")
                    svc_owner[svc] = name
                lanes[lane.index] = list(lane.service_names)
                retention_lanes.setdefault(lane.retention, []).append(lane.index)
        ledger.save()
        # per-retention ISM policies for unit lanes (the declared tokens
        # must actually rotate the indices, not just pass validation)
        for token, indices in sorted(retention_lanes.items()):
            pol = corpus.ism_policy(
                sorted(f"{i}*" for i in indices),
                age=corpus.RETENTIONS[token])
            (tree / "ism-policies" / f"clawker-units-{token}.json").write_text(
                json.dumps(pol, indent=1, sort_keys=True))

        (self.dir / "compose.yaml").write_text(render_compose(s))
        (self.dir / "otel-config.yaml").write_text(render_otel_config(s, lanes))
        (self.dir / "prometheus.yaml").write_text(render_prometheus_config(s))
        (self.dir / "bootstrap.sh").write_text(render_bootstrap_script())
        return self.dir

    # --------------------------------------------------------- lifecycle

    def _run_compose(self, *args: str) -> subprocess.CompletedProcess:
        cmd = ["docker", "compose", "-p", COMPOSE_PROJECT,
               "-f", str(self.dir / "compose.yaml"), *args]
        try:
            return subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise MonitorError(f"docker compose {' '.join(args)}: {e}") from None

    def up(self) -> None:
        self.render()
        res = self.runner("up", "-d", "--remove-orphans")
        if res.returncode != 0:
            raise MonitorError(f"monitor up failed: {res.stderr.strip()[:500]}")
        log.info("monitor stack up (dashboards :%d, prometheus :%d)",
                 self.cfg.settings.monitoring.dashboards_port,
                 self.cfg.settings.monitoring.prometheus_port)

    def down(self) -> None:
        res = self.runner("down", "--volumes")
        if res.returncode != 0:
            raise MonitorError(f"monitor down failed: {res.stderr.strip()[:500]}")
        # --volumes deletes every seeded object with the data volume, so
        # the ledger must reset too -- it is the documented way out of a
        # SeedCollision (ledger.py), and a stale record would otherwise
        # block the colliding name forever
        from .ledger import LEDGER_FILE

        (self.dir / LEDGER_FILE).unlink(missing_ok=True)

    def status(self) -> list[dict]:
        res = self.runner("ps", "--format", "json")
        if res.returncode != 0:
            return []
        out = []
        for line in res.stdout.splitlines():
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            # compose <2.21 emits one JSON array; newer emits NDJSON rows
            if isinstance(row, list):
                out.extend(row)
            else:
                out.append(row)
        return out
