"""The opensearch-bootstrap content corpus: templates, pipelines, ISM,
saved objects.

The port's copy of ``clawker_tpu/monitor/corpus.py``, whole.

Everything the one-shot ``opensearch-bootstrap`` compose service seeds
into the cluster, generated as pure functions (settings -> JSON trees)
the way the rest of the monitor module renders configs -- pinnable by
golden tests, no template files to drift.

Parity reference: internal/monitor/templates/opensearch-bootstrap/
(component-templates/clawker-common.json, index-templates/*.json,
ingest-pipelines/{envelope,netlogger,envoy}-normalize.json,
ism-policies/clawker-retention.json.tmpl, saved-objects/clawker.ndjson)
-- shapes re-derived for this build's lanes, not copied.
"""

from __future__ import annotations

import json
from pathlib import Path

# Retention tokens a lane may declare (reference: unit.go retention
# validation); mapped to ISM min_index_age.
RETENTIONS = {"default": "7d", "short": "2d", "long": "30d"}


def component_template_common() -> dict:
    """Shared OTLP log-envelope mappings every lane composes."""
    return {
        "template": {
            "settings": {"number_of_shards": 1, "number_of_replicas": 0},
            "mappings": {
                "properties": {
                    "@timestamp": {"type": "date"},
                    "observedTimestamp": {"type": "date"},
                    "severityText": {"type": "keyword"},
                    "severityNumber": {"type": "integer"},
                    "traceId": {"type": "keyword"},
                    "spanId": {"type": "keyword"},
                    "body": {
                        "type": "text",
                        "fields": {"keyword": {"type": "keyword",
                                               "ignore_above": 2048}},
                    },
                    "resource": {
                        "properties": {
                            "service.name": {"type": "keyword"},
                            "service.version": {"type": "keyword"},
                        }
                    },
                }
            },
        }
    }


def _lane_template(index: str, default_pipeline: str | None,
                   attrs: dict) -> dict:
    settings: dict = {}
    if default_pipeline:
        settings["index"] = {"default_pipeline": default_pipeline,
                             "final_pipeline": "envelope-normalize"}
    else:
        settings["index"] = {"final_pipeline": "envelope-normalize"}
    return {
        "index_patterns": [index, f"{index}-*"],
        "priority": 100,
        "composed_of": ["clawker-common"],
        "template": {
            "settings": settings,
            "mappings": {"properties": {"attributes": {"properties": attrs}}},
        },
    }


def _fleet_template(index: str, props: dict) -> dict:
    """Bulk-ingested fleet-telemetry index: top-level document fields
    (no OTLP envelope -- the shipper stamps ``@timestamp`` itself),
    composed on clawker-common for the shared time/trace mappings and
    keeping the envelope-normalize backstop every clawker index
    carries (a no-op for docs that already arrive stamped)."""
    return {
        "index_patterns": [index, f"{index}-*"],
        "priority": 100,
        "composed_of": ["clawker-common"],
        "template": {
            "settings": {"index": {"final_pipeline": "envelope-normalize"}},
            "mappings": {"properties": props},
        },
    }


def index_templates() -> dict[str, dict]:
    """Per-lane index templates for the base log indices."""
    kw = {"type": "keyword"}
    return {
        "clawker-otlp": _lane_template("clawker-otlp", None, {
            "event": {"properties": {"name": kw}},
            "source": kw,
        }),
        "clawker-cli": _lane_template("clawker-cli", None, {
            "subsystem": kw, "event": {"properties": {"name": kw}},
            "project": kw, "agent": kw,
        }),
        "clawkercp": _lane_template("clawkercp", "cp-normalize", {
            "subsystem": kw, "event": {"properties": {"name": kw}},
            "container_id": kw, "agent": kw, "project": kw,
        }),
        "clawker-envoy": _lane_template("clawker-envoy", "envoy-normalize", {
            "authority": kw, "path": kw, "method": kw, "sni": kw,
            "action": kw, "response_code": {"type": "integer"},
            "bytes_sent": {"type": "long"}, "bytes_received": {"type": "long"},
            "duration_ms": {"type": "float"}, "upstream": kw,
        }),
        "clawker-dnsgate": _lane_template("clawker-dnsgate", None, {
            "qname": kw, "qtype": kw, "rcode": kw, "zone": kw,
            "verdict": kw, "container_id": kw,
        }),
        "clawker-ebpf-egress": _lane_template(
            "clawker-ebpf-egress", "netlogger-normalize", {
                "event": {"properties": {"name": kw}},
                "source": kw, "action": kw, "reason": kw,
                "container_id": kw, "agent": kw, "project": kw,
                "cgroup_id": kw, "bpf_ts_ns": kw,
                "dst_ip": {"type": "ip"}, "dst_port": kw,
                "l4_proto": kw, "l4_proto_code": {"type": "integer"},
                "zone_hash": kw, "dst_host": kw,
            }),
        # fleet-telemetry ingestion (monitor/shipper.py,
        # docs/fleet-console.md#ingestion): these docs arrive over the
        # bulk API with top-level fields, not OTLP attributes, so the
        # templates map the document root directly
        "clawker-fleet-metrics": _fleet_template("clawker-fleet-metrics", {
            "type": kw, "source": kw, "metric": kw, "kind": kw,
            "labels": {"type": "object", "dynamic": True},
            "value": {"type": "double"}, "sum": {"type": "double"},
        }),
        "clawker-fleet-events": _fleet_template("clawker-fleet-events", {
            "type": kw, "source": kw, "event": kw, "run": kw,
            "agent": kw, "worker": kw, "seq": {"type": "long"},
            "policy": kw, "tenant": kw, "action": kw,
            "old_state": kw, "new_state": kw, "reason": kw,
            "kind": kw, "z": {"type": "float"},
            "detail": {"type": "text"},
        }),
        "clawker-fleet-spans": _fleet_template("clawker-fleet-spans", {
            "type": kw, "source": kw, "run": kw, "trace_id": kw,
            "span_id": kw, "parent_id": kw, "name": kw, "agent": kw,
            "worker": kw, "status": kw,
            "t_start": {"type": "double"}, "t_end": {"type": "double"},
            "wall_ms": {"type": "float"},
            "attrs": {"type": "object", "dynamic": True},
        }),
    }


def _with_failure_markers(description: str, processors: list[dict]) -> dict:
    """Every pipeline marks (never drops) documents it could not process
    -- a normalization bug must not silently lose telemetry."""
    return {
        "description": description,
        "processors": processors,
        "on_failure": [
            {"set": {"field": "_normalize_failed", "value": True}},
            {"set": {"field": "_normalize_failed_pipeline",
                     "value": "{{ _ingest.on_failure_pipeline }}"}},
            {"set": {"field": "_normalize_failed_message",
                     "value": "{{ _ingest.on_failure_message }}"}},
        ],
    }


def ingest_pipelines() -> dict[str, dict]:
    return {
        "envelope-normalize": _with_failure_markers(
            "final pipeline for every clawker lane: backstop @timestamp "
            "from observedTimestamp so time-based views never lose docs",
            [{"set": {"field": "@timestamp",
                      "copy_from": "observedTimestamp",
                      "if": "ctx['@timestamp'] == null && ctx.observedTimestamp != null"}}],
        ),
        "netlogger-normalize": _with_failure_markers(
            "stringify bpf_ts_ns: an opaque BPF monotonic timestamp used "
            "for dedup/ordering, never numeric math -- keyword storage "
            "stops the UI rendering it with thousands separators",
            [{"convert": {"field": "attributes.bpf_ts_ns", "type": "string",
                          "ignore_missing": True}},
             {"convert": {"field": "attributes.cgroup_id", "type": "string",
                          "ignore_missing": True}}],
        ),
        "envoy-normalize": _with_failure_markers(
            "proxy access-log normalization: numeric response_code and "
            "duration for range filters",
            [{"convert": {"field": "attributes.response_code",
                          "type": "integer", "ignore_missing": True}},
             {"convert": {"field": "attributes.duration_ms", "type": "float",
                          "ignore_missing": True}}],
        ),
        "cp-normalize": _with_failure_markers(
            "control-plane log normalization: stringify container ids",
            [{"convert": {"field": "attributes.container_id",
                          "type": "string", "ignore_missing": True}}],
        ),
    }


def ism_policy(index_patterns: list[str], *, age: str = "7d") -> dict:
    """Retention: hot -> delete after ``age``.  A throwaway monitoring
    stack keeps short retention by design."""
    return {
        "policy": {
            "description": "Default retention for clawker observability "
                           "indices (throwaway stack, short by design).",
            "default_state": "hot",
            "states": [
                {"name": "hot", "actions": [], "transitions": [
                    {"state_name": "delete",
                     "conditions": {"min_index_age": age}}]},
                {"name": "delete", "actions": [{"delete": {}}],
                 "transitions": []},
            ],
            "ism_template": [
                {"index_patterns": index_patterns, "priority": 100}],
        }
    }


# ----------------------------------------------------------- saved objects

def _index_pattern(pid: str, title: str) -> dict:
    return {"id": pid, "type": "index-pattern",
            "attributes": {"title": title, "timeFieldName": "@timestamp"}}


def _metric_vis(vid: str, title: str, index_pattern: str, agg: dict) -> dict:
    vis_state = {"title": title, "type": "metric",
                 "aggs": [{"id": "1", "enabled": True, "schema": "metric",
                           **agg}],
                 "params": {"addTooltip": True, "metric": {
                     "metricColorMode": "None",
                     "style": {"fontSize": 36}}}}
    return {
        "id": vid, "type": "visualization",
        "attributes": {
            "title": title,
            "visState": json.dumps(vis_state),
            "uiStateJSON": "{}",
            "kibanaSavedObjectMeta": {"searchSourceJSON": json.dumps(
                {"query": {"query": "", "language": "kuery"}, "filter": [],
                 "indexRefName": "kibanaSavedObjectMeta.searchSourceJSON.index"})},
        },
        "references": [{"name": "kibanaSavedObjectMeta.searchSourceJSON.index",
                        "type": "index-pattern", "id": index_pattern}],
    }


def _histogram_vis(vid: str, title: str, index_pattern: str,
                   split_field: str) -> dict:
    vis_state = {
        "title": title, "type": "histogram",
        "aggs": [
            {"id": "1", "enabled": True, "schema": "metric",
             "type": "count", "params": {}},
            {"id": "2", "enabled": True, "schema": "segment",
             "type": "date_histogram",
             "params": {"field": "@timestamp", "interval": "auto"}},
            {"id": "3", "enabled": True, "schema": "group", "type": "terms",
             "params": {"field": split_field, "size": 8}},
        ],
        "params": {"addTooltip": True, "addLegend": True, "type": "histogram"},
    }
    out = _metric_vis(vid, title, index_pattern, {"type": "count", "params": {}})
    out["attributes"]["visState"] = json.dumps(vis_state)
    return out


def _dashboard(did: str, title: str, panel_ids: list[str]) -> dict:
    panels = []
    refs = []
    for i, pid in enumerate(panel_ids):
        name = f"panel_{i}"
        panels.append({
            "panelIndex": str(i), "panelRefName": name, "version": "2.15.0",
            "gridData": {"x": (i % 3) * 16, "y": (i // 3) * 12,
                         "w": 16, "h": 12, "i": str(i)},
            "embeddableConfig": {},
        })
        refs.append({"name": name, "type": "visualization", "id": pid})
    return {
        "id": did, "type": "dashboard",
        "attributes": {
            "title": title,
            "panelsJSON": json.dumps(panels),
            "optionsJSON": json.dumps({"useMargins": True}),
            "timeRestore": False,
            "kibanaSavedObjectMeta": {"searchSourceJSON": json.dumps(
                {"query": {"query": "", "language": "kuery"}, "filter": []})},
        },
        "references": refs,
    }


def saved_objects() -> list[dict]:
    """Base workspace: index patterns for every lane + the seeded egress
    dashboard (deny/allow over time, top denied zones, top talkers)."""
    objs = [
        _index_pattern("clawker-ebpf-egress", "clawker-ebpf-egress"),
        _index_pattern("clawker-envoy", "clawker-envoy"),
        _index_pattern("clawker-dnsgate", "clawker-dnsgate"),
        _index_pattern("clawkercp", "clawkercp"),
        _index_pattern("clawker-cli", "clawker-cli"),
        _metric_vis("clawker-egress-denies", "Egress denies",
                    "clawker-ebpf-egress",
                    {"type": "count", "params": {}}),
        _histogram_vis("clawker-egress-by-action", "Egress verdicts over time",
                       "clawker-ebpf-egress", "attributes.action"),
        _histogram_vis("clawker-egress-by-zone", "Denied zones over time",
                       "clawker-ebpf-egress", "attributes.dst_host"),
        _histogram_vis("clawker-envoy-by-code", "Proxy responses over time",
                       "clawker-envoy", "attributes.response_code"),
        _histogram_vis("clawker-dns-by-verdict", "DNS verdicts over time",
                       "clawker-dnsgate", "attributes.verdict"),
    ]
    objs.append(_dashboard(
        "clawker-egress", "Clawker Egress",
        ["clawker-egress-denies", "clawker-egress-by-action",
         "clawker-egress-by-zone", "clawker-envoy-by-code",
         "clawker-dns-by-verdict"]))
    return objs


def to_ndjson(objs: list[dict]) -> str:
    return "\n".join(json.dumps(o, sort_keys=True) for o in objs) + "\n"


# ------------------------------------------------------------ tree writer

def write_bootstrap_tree(root: Path) -> list[Path]:
    """Materialize the base corpus as the opensearch-bootstrap overlay
    tree (the same layout units overlay into; the bootstrap script's
    directory loops apply both unmodified)."""
    written: list[Path] = []

    def put(rel: str, body: str) -> None:
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(body)
        written.append(p)

    put("component-templates/clawker-common.json",
        json.dumps(component_template_common(), indent=1, sort_keys=True))
    for name, tmpl in index_templates().items():
        put(f"index-templates/{name}.json",
            json.dumps(tmpl, indent=1, sort_keys=True))
    for name, pipe in ingest_pipelines().items():
        put(f"ingest-pipelines/{name}.json",
            json.dumps(pipe, indent=1, sort_keys=True))
    patterns = sorted({p for t in index_templates().values()
                       for p in t["index_patterns"]})
    put("ism-policies/clawker-retention.json",
        json.dumps(ism_policy(patterns), indent=1, sort_keys=True))
    put("saved-objects/clawker.ndjson", to_ndjson(saved_objects()))
    return written
