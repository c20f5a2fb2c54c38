"""The port's image builds against the reference's, on the CPU.

Twins of tests/test_bundler.py's cases that need no ``BundleManager``
(floor assets, the Dockerfiles' determinism and cache tail, the
context tar, the egress composer, the two stages, ``build -q`` then
``run``, the harness escape, the stack's ``RUN`` prefix and ``CMD``
JSON, ``--no-cache``), of tests/test_buildkit.py's 12 (the codec, the
trace renderer, the probe, the legacy lane, the remembered fallback,
``cancel``) and of tests/test_agentd_payload.py's 3 on the port's
zipapp; then each package's ``Engine`` building and cancelling over its
own HTTP client and the port's ``FakeEngineDaemon``, and ``build``
forked over such a daemon on each lane, the reference's CLI and the
port's over one daemon each.

Both packages get the same inputs.  Dockerfiles and every context
member are compared byte for byte, but the agentd zipapp: it holds each
package's own modules, so its member names are compared after mapping
``clawker_tpu/`` to ``clawker_tpu_torch/`` and each member with the
package's own file.  Outputs are normalised only for ids (the final
image id, the buildid), paths and stamps.  The supervisor that the
payload carries is pinned per test (``CLAWKER_TPU_SUPERVISOR_BIN``): a
stand-in file, or the binary built from ``native/`` into a temporary
directory (tests/test_torch_agentd.py's fixture), so no test reads or
writes ``native/build/``.
"""

from __future__ import annotations

import base64
import io
import json
import os
import re
import socket
import subprocess
import sys
import tarfile
import time
import zipfile
from pathlib import Path
from types import SimpleNamespace

import pytest
from click.testing import CliRunner

import clawker_tpu.bundle as ref_bundle
import clawker_tpu.bundle.model as ref_model
import clawker_tpu.bundler as ref_bundler
import clawker_tpu.bundler.payload as ref_payload
import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.config as ref_config
import clawker_tpu.config.schema as ref_schema
import clawker_tpu.consts as ref_consts
import clawker_tpu.engine.bkproto as ref_bkproto
import clawker_tpu.engine.buildkit as ref_buildkit
import clawker_tpu.engine.api as ref_engine_api
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.engine.httpapi as ref_httpapi
import clawker_tpu.errors as ref_errors
import clawker_tpu.testenv as ref_testenv
import clawker_tpu.ui.buildview as ref_buildview
import clawker_tpu.ui.iostreams as ref_iostreams
import clawker_tpu.ui.progress as ref_progress
import clawker_tpu_torch.bundle as port_bundle
import clawker_tpu_torch.bundle.model as port_model
import clawker_tpu_torch.bundler as port_bundler
import clawker_tpu_torch.bundler.payload as port_payload
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.config.schema as port_schema
import clawker_tpu_torch.consts as port_consts
import clawker_tpu_torch.engine.bkproto as port_bkproto
import clawker_tpu_torch.engine.buildkit as port_buildkit
import clawker_tpu_torch.engine.api as port_engine_api
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.engine.httpapi as port_httpapi
import clawker_tpu_torch.errors as port_errors
import clawker_tpu_torch.testenv as port_testenv
import clawker_tpu_torch.ui.buildview as port_buildview
import clawker_tpu_torch.ui.iostreams as port_iostreams
import clawker_tpu_torch.ui.progress as port_progress
from clawker_tpu_torch.agentd import SupervisorClient
from clawker_tpu_torch.controlplane import identity
from clawker_tpu_torch.controlplane.session_client import dial_with_retry
from clawker_tpu_torch.firewall import pki
from test_torch_agentd import supervisor_bin  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

PKGS = {
    "ref": SimpleNamespace(
        name="clawker_tpu", bundle=ref_bundle, model=ref_model,
        bundler=ref_bundler, payload=ref_payload, cli=ref_root.cli,
        Factory=ref_factory.Factory, config=ref_config, schema=ref_schema,
        consts=ref_consts, bkproto=ref_bkproto, buildkit=ref_buildkit,
        drivers=ref_drivers, fake=ref_fake, errors=ref_errors,
        testenv=ref_testenv, buildview=ref_buildview,
        iostreams=ref_iostreams, progress=ref_progress,
        engine_api=ref_engine_api, httpapi=ref_httpapi),
    "port": SimpleNamespace(
        name="clawker_tpu_torch", bundle=port_bundle, model=port_model,
        bundler=port_bundler, payload=port_payload, cli=port_cli.cli,
        Factory=port_cli.Factory, config=port_config, schema=port_schema,
        consts=port_consts, bkproto=port_bkproto, buildkit=port_buildkit,
        drivers=port_drivers, fake=port_fake, errors=port_errors,
        testenv=port_testenv, buildview=port_buildview,
        iostreams=port_iostreams, progress=port_progress,
        engine_api=port_engine_api, httpapi=port_httpapi),
}
PROJECT_YAML = "project: demo\nbuild:\n  stack: go\n"
CA_PEM = b"-----BEGIN CERTIFICATE-----\nstand-in\n-----END CERTIFICATE-----\n"
_ID = re.compile(r"\b[0-9a-f]{12,64}\b")
_STAMP = re.compile(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d+")


def both(fn):
    """``fn(m)`` for the reference's modules, then the port's: ->
    (reference's result, port's)."""
    return fn(PKGS["ref"]), fn(PKGS["port"])


def twin_cfg(tmp_path: Path, fn, yaml: str = PROJECT_YAML, **kw):
    """``fn(m, cfg, proj)`` in each package's own ``TestEnv`` with a
    project at ``<tmp>/<pkg>/proj``: -> (reference's result, port's)."""
    out = []
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        with m.testenv.TestEnv(base=tmp_path / pkg) as tenv:
            tenv.write_settings("host_proxy:\n  enable: false\n")
            proj = tenv.base / "proj"
            tenv.make_project(proj, yaml)
            out.append(fn(m, m.config.load_config(proj), proj, **kw))
    return tuple(out)


@pytest.fixture(autouse=True)
def stand_in_supervisor(tmp_path, monkeypatch):
    """Both packages' payload finds the same supervisor bytes."""
    path = tmp_path / "stand-in-supervisord"
    path.write_bytes(b"\x7fELF stand-in supervisor\n")
    monkeypatch.setenv("CLAWKER_TPU_SUPERVISOR_BIN", str(path))
    return path


def pyz_view(data: bytes, pkg: str) -> dict:
    """A zipapp's members keyed with the package mapped to ``<PKG>``:
    each module checked against the package's own file, ``__main__.py``
    with the package name mapped too."""
    zf = zipfile.ZipFile(io.BytesIO(data))
    out = {}
    for info in zf.infolist():
        body = zf.read(info)
        key = info.filename.replace(pkg + "/", "<PKG>/", 1)
        if info.filename.startswith(pkg + "/"):
            assert body == (ROOT / info.filename).read_bytes(), info.filename
            body = b"<own file>"
        else:
            body = body.replace(pkg.encode() + b".", b"<PKG>.")
        out[key] = (info.date_time, info.external_attr, body)
    return out


def ctx_view(tar: bytes, pkg: str) -> list:
    """A context tar's members in order: name, mode, mtime and bytes
    (the zipapp through :func:`pyz_view`, its size left out)."""
    out = []
    with tarfile.open(fileobj=io.BytesIO(tar)) as tf:
        for ti in tf.getmembers():
            data = tf.extractfile(ti).read()
            if ti.name == "clawker-agentd.pyz":
                out.append((ti.name, ti.mode, ti.mtime, pyz_view(data, pkg)))
            else:
                out.append((ti.name, ti.mode, ti.mtime, ti.size, data))
    return out


def capture_contexts(api) -> list:
    """Record every build's (tags, context tar) off the fake daemon."""
    seen: list = []
    api.build_hook = lambda tar, tags: seen.append((list(tags), tar))
    return seen


# ---------------------------------------------------------------- resolver

def test_floor_assets_resolve(tmp_path):
    def run(m, cfg, proj):
        r = m.bundle.Resolver(cfg)
        claude = r.harness("claude")
        try:
            r.harness("nope")
            missing = None
        except m.errors.NotFoundError as e:
            missing = str(e)
        return (claude.tier, claude.cmd, sorted(s.name for s in r.list("stack")),
                missing)

    want, got = twin_cfg(tmp_path, run)
    assert got == want
    assert got[:2] == ("floor", ["claude"])
    assert set(got[2]) >= {"python", "go", "node", "rust", "cpp", "java",
                           "ruby", "dotnet"}
    assert got[3] is not None


# --------------------------------------------------------------- dockerfile

def test_generate_base_deterministic(tmp_path):
    def run(m, cfg, proj):
        stack = m.bundle.Resolver(cfg).stack("go")
        df1 = m.bundler.generate_base("demo", stack,
                                      m.schema.BuildConfig(packages=["jq"]))
        df2 = m.bundler.generate_base("demo", stack,
                                      m.schema.BuildConfig(packages=["jq"]))
        assert df1 == df2
        return df1

    want, got = twin_cfg(tmp_path, run)
    assert got == want
    assert "FROM golang:" in got
    assert "jq" in got and "useradd" in got and port_consts.WORKSPACE_DIR in got


@pytest.mark.parametrize("with_ca", [True, False])
def test_generate_harness_cache_tail(tmp_path, with_ca):
    def run(m, cfg, proj):
        harness = m.bundle.Resolver(cfg).harness("claude")
        return m.bundler.generate_harness(
            "demo", harness, m.schema.BuildConfig(), with_ca_cert=with_ca,
            with_agentd=True)

    want, got = twin_cfg(tmp_path, run)
    assert got == want
    # supervisor/agentd COPYs come after every install RUN and after the
    # CA COPY (cache-tail invariant)
    agentd_at = got.index("COPY clawker-supervisord")
    assert got.index("npm install") < agentd_at
    assert ("COPY clawker-ca.crt" in got) == with_ca
    if with_ca:
        assert got.index("COPY clawker-ca.crt") < agentd_at
    assert got.index("COPY clawker-agentd.pyz") > agentd_at
    assert got.rstrip().endswith('CMD ["claude"]')
    assert f'ENTRYPOINT ["{port_consts.SUPERVISOR_PATH}"' in got
    assert got.index("--default-cmd") < got.index('CMD ["claude"]')


def test_build_context_deterministic_tar():
    files = {"Dockerfile": b"FROM x\n", "clawkerd": b"\x7fELF",
             "clawker-supervisord": b"\x7fELF sup"}

    def run(m):
        t1, t2 = m.bundler.build_context(files), m.bundler.build_context(files)
        assert t1 == t2
        return t1

    want, got = both(run)
    assert got == want
    with tarfile.open(fileobj=io.BytesIO(got)) as tf:
        names = tf.getnames()
        modes = {ti.name: ti.mode for ti in tf.getmembers()}
    assert names == sorted(names)
    assert modes["clawker-supervisord"] == 0o755 and modes["Dockerfile"] == 0o644


# ------------------------------------------------------------------ egress

def test_compose_egress_rules_dedupes(tmp_path):
    def run(m, cfg, proj):
        harness = m.bundle.Resolver(cfg).harness("claude")
        pconf = cfg.project
        pconf.security.egress.append(
            m.schema.EgressRule(dst="api.anthropic.com", proto="https"))
        pconf.security.egress.append(
            m.schema.EgressRule(dst="internal.corp", proto="tcp", port=22))
        return [r.key() for r in m.bundler.compose_egress_rules(pconf, harness)]

    want, got = twin_cfg(tmp_path, run)
    assert got == want
    assert len(got) == len(set(got))
    assert "api.anthropic.com:https:443" in got
    assert "internal.corp:tcp:22" in got


# ------------------------------------------------------------- build + CLI

@pytest.mark.parametrize("with_ca", [False, True])
def test_project_builder_two_stages(tmp_path, with_ca):
    def run(m, cfg, proj):
        drv = m.drivers.FakeDriver()
        seen = capture_contexts(drv.api)
        lines: list[str] = []
        pb = m.bundler.ProjectBuilder(drv.engine(), cfg,
                                      ca_cert_pem=CA_PEM if with_ca else None,
                                      progress=lines.append)
        res = pb.build()
        builds = drv.api.calls_named("image_build")
        return ((res.base_ref, res.harness_ref, res.default_ref,
                 res.with_agentd, res.with_ca),
                "clawker-demo:default" in drv.api.images,
                [(b[1]["tags"], b[1]["labels"]) for b in builds],
                [(tags, ctx_view(tar, m.name)) for tags, tar in seen],
                lines)

    want, got = twin_cfg(tmp_path, run)
    assert got == want
    refs, tagged, builds, contexts, lines = got
    assert refs == ("clawker-demo:base", "clawker-demo:claude",
                    "clawker-demo:default", True, with_ca)
    assert tagged
    assert [b[0] for b in builds] == [["clawker-demo:base"],
                                      ["clawker-demo:claude"]]
    assert builds[0][1][port_consts.LABEL_IMAGE_KIND] == "base"
    assert builds[1][1][port_consts.LABEL_HARNESS] == "claude"
    assert [n for n, *_ in contexts[0][1]] == ["Dockerfile"]
    names = [n for n, *_ in contexts[1][1]]
    assert {"Dockerfile", "clawker-agentd.pyz", "clawker-supervisord"} <= set(names)
    assert ("clawker-ca.crt" in names) == with_ca
    assert lines[-1] == "tagged clawker-demo:default"


def test_project_builder_contexts_hold_the_in_process_dockerfiles(tmp_path):
    """Each stage's context carries the Dockerfile that ``generate_base``
    / ``generate_harness`` write for the project, byte for byte."""
    def run(m, cfg, proj):
        drv = m.drivers.FakeDriver()
        seen = capture_contexts(drv.api)
        m.bundler.ProjectBuilder(drv.engine(), cfg, ca_cert_pem=CA_PEM).build()
        r = m.bundle.Resolver(cfg)
        base = m.bundler.generate_base("demo", r.stack("go"), cfg.project.build)
        harness = m.bundler.generate_harness(
            "demo", r.harness("claude"), cfg.project.build,
            base_ref="clawker-demo:base", with_ca_cert=True, with_agentd=True)
        docker = []
        for _tags, tar in seen:
            with tarfile.open(fileobj=io.BytesIO(tar)) as tf:
                docker.append(tf.extractfile("Dockerfile").read().decode())
        return docker == [base, harness], docker

    want, got = twin_cfg(tmp_path, run)
    assert got == want
    assert got[0] is True


def test_build_cli_then_run(tmp_path):
    def run(m, cfg, proj):
        drv = m.drivers.FakeDriver()
        factory = m.Factory(cwd=proj, driver=drv)
        runner = CliRunner()
        res = runner.invoke(m.cli, ["build", "-q"], obj=factory,
                            catch_exceptions=False)
        built = (res.exit_code, res.output)
        drv.api.set_behavior("clawker-demo:default",
                             m.fake.exit_behavior(b"hi\n"))
        res = runner.invoke(m.cli, ["run"], obj=factory, catch_exceptions=False)
        return built, res.exit_code, res.output

    want, got = twin_cfg(tmp_path, run, yaml="project: demo\n")
    assert got == want
    assert got[0] == (0, "clawker-demo:default\n")
    assert got[1] == 0, got[2]


def test_harness_file_escape_rejected(tmp_path):
    def run(m, cfg, proj):
        hdir = proj / ".clawker" / "bundles" / "esc" / "harnesses" / "h"
        hdir.mkdir(parents=True)
        hdir.joinpath("harness.yaml").write_text(
            "name: h\ncmd: [h]\nfiles: ['../../../../../secret.txt']\n")
        proj.parent.joinpath("secret.txt").write_text("s3cret")
        cfg.project.build.harness = "h"
        drv = m.drivers.FakeDriver()
        with pytest.raises(m.errors.ClawkerError) as ei:
            m.bundler.ProjectBuilder(drv.engine(), cfg).build()
        return str(ei.value), [c[0] for c in drv.api.calls]

    want, got = twin_cfg(tmp_path, run)
    assert got == want
    assert "escapes" in got[0]
    assert "image_tag" not in got[1]


def test_stack_install_gets_run_prefix_and_cmd_json():
    def run(m):
        stack = m.model.Stack(name="s", base_image="debian",
                              install=["pip install uv"])
        base = m.bundler.generate_base("demo", stack, m.schema.BuildConfig())
        h = m.model.Harness(name="h", cmd=["sh", "-c", 'echo "hi"'])
        harness = m.bundler.generate_harness("demo", h, m.schema.BuildConfig(),
                                             with_agentd=False)
        return base, harness

    want, got = both(run)
    assert got == want
    assert "RUN pip install uv" in got[0]
    assert 'CMD ["sh", "-c", "echo \\"hi\\""]' in got[1]


def test_no_cache_plumbed_to_daemon(tmp_path):
    def run(m, cfg, proj):
        drv = m.drivers.FakeDriver()
        m.bundler.ProjectBuilder(drv.engine(), cfg).build(no_cache=True)
        return [b[1]["no_cache"] for b in drv.api.calls_named("image_build")]

    want, got = twin_cfg(tmp_path, run)
    assert got == want == [True, True]


# ------------------------------------------------------------- wire codec

def _status(m):
    B = m.bkproto
    return B.StatusResponse(
        vertexes=[
            B.Vertex(digest="sha256:aa", name="[1/3] FROM python:3.12",
                     inputs=["sha256:bb"], started=10.5, completed=12.25),
            B.Vertex(digest="sha256:cc", name="[2/3] RUN pip install",
                     cached=True),
            B.Vertex(digest="sha256:dd", name="[3/3] COPY . .",
                     started=12.5, error="boom"),
        ],
        statuses=[B.VertexStatus(id="extracting", vertex="sha256:aa",
                                 current=512, total=2048)],
        logs=[B.VertexLog(vertex="sha256:dd", stream=2, msg=b"err line\n")],
    )


def _decoded(resp) -> tuple:
    return ([(v.digest, v.name, v.inputs, v.started, v.completed, v.cached,
              v.error) for v in resp.vertexes],
            [(s.id, s.vertex, s.current, s.total) for s in resp.statuses],
            [(lg.vertex, lg.stream, lg.msg) for lg in resp.logs])


def test_codec_roundtrip():
    raw_ref, raw_port = both(lambda m: m.bkproto.encode_status(_status(m)))
    assert raw_port == raw_ref
    # each package decodes its own bytes and the other's the same way
    want = _decoded(ref_bkproto.decode_status(raw_ref))
    assert _decoded(port_bkproto.decode_status(raw_port)) == want
    assert _decoded(port_bkproto.decode_status(raw_ref)) == want
    assert _decoded(ref_bkproto.decode_status(raw_port)) == want
    vertexes, statuses, logs = want
    assert [v[0] for v in vertexes] == ["sha256:aa", "sha256:cc", "sha256:dd"]
    assert vertexes[0][2] == ["sha256:bb"]
    assert vertexes[0][3] == pytest.approx(10.5)
    assert vertexes[0][4] == pytest.approx(12.25)
    assert vertexes[1][5] is True and vertexes[2][6] == "boom"
    assert statuses[0][2:] == (512, 2048)
    assert logs[0][1:] == (2, b"err line\n")


def test_codec_rejects_truncated():
    def run(m):
        raw = m.bkproto.encode_status(m.bkproto.StatusResponse(
            vertexes=[m.bkproto.Vertex(digest="sha256:aa")]))
        with pytest.raises(m.bkproto.WireError) as ei:
            m.bkproto.parse_fields(raw[:-2])
        return str(ei.value)

    want, got = both(run)
    assert got == want


def test_codec_skips_unknown_fields_gracefully():
    def run(m):
        emit = m.bkproto.emit_field
        vertex = emit(1, "sha256:aa") + emit(3, "step") + emit(15, "future-field")
        got = m.bkproto.decode_status(emit(1, vertex))
        return got.vertexes[0].digest, got.vertexes[0].name

    want, got = both(run)
    assert got == want == ("sha256:aa", "step")


# --------------------------------------------------------- trace renderer

def test_renderer_numbers_and_lifecycle():
    def run(m):
        B = m.bkproto
        r = m.buildkit.TraceRenderer()
        first = [e["stream"] for e in r.render(B.StatusResponse(vertexes=[
            B.Vertex(digest="d1", name="[internal] load", started=1.0)]))]
        second = [e["stream"] for e in r.render(B.StatusResponse(
            vertexes=[B.Vertex(digest="d1", name="[internal] load",
                               started=1.0, completed=1.5),
                      B.Vertex(digest="d2", name="[1/2] FROM scratch",
                               cached=True)],
            logs=[B.VertexLog(vertex="d1", msg=b"line a\nline b\n")]))]
        streams, _, _, _ = m.iostreams.IOStreams.test()
        tree = m.progress.ProgressTree(streams)
        view = m.buildview.BuildProgressView(tree)
        view.stage("s")
        for line in ["#7 [2/2] COPY . .", "#7 CACHED"]:
            view.line(line)
        node = next(n for n in tree._nodes.values() if "COPY" in n.label)
        third = [e["stream"] for e in r.render(B.StatusResponse(vertexes=[
            B.Vertex(digest="d3", name="[2/2] RUN false", started=2.0,
                     error="exit 1")]))]
        return first, second, node.state, third

    want, got = both(run)
    assert got == want
    first, second, state, third = got
    assert first == ["#1 [internal] load\n"]
    assert second == ["#1 DONE 0.5s\n", "#2 [1/2] FROM scratch\n",
                      "#2 CACHED\n", "#1 line a\n", "#1 line b\n"]
    assert state == "done"           # cache hits must not spin
    assert third == ["#3 [2/2] RUN false\n", "#3 ERROR exit 1\n"]


def test_decode_stream_passthrough_and_trace():
    def run(m):
        resp = m.bkproto.StatusResponse(vertexes=[
            m.bkproto.Vertex(digest="d1", name="x", started=1.0)])
        raw = [
            {"stream": "classic line\n"},
            {"id": "moby.buildkit.trace",
             "aux": base64.b64encode(m.bkproto.encode_status(resp)).decode()},
            {"id": "moby.buildkit.trace", "aux": "!!!not-base64"},  # skipped
            {"aux": {"ID": "sha256:final"}},
        ]
        return list(m.buildkit.decode_stream(iter(raw)))

    want, got = both(run)
    assert got == want == [{"stream": "classic line\n"}, {"stream": "#1 x\n"},
                           {"aux": {"ID": "sha256:final"}}]


# ------------------------------------------------------ probe + fallback

def _events(events) -> list:
    """Build events with the final image id replaced."""
    return json.loads(_ID.sub("<ID>", json.dumps(events)))


def test_probe_prefers_buildkit_and_decodes_transcript():
    def run(m):
        drv = m.drivers.FakeDriver()
        drv.api.builder_version = "2"
        events = list(drv.engine().build_image(b"tar", tags=["t:1"]))
        return (_events(events), [c[0] for c in drv.api.calls],
                drv.api.images.get("t:1") is not None)

    want, got = both(run)
    assert got == want
    events, calls, tagged = got
    streams = "".join(e.get("stream", "") for e in events)
    assert "#1 [internal] load build definition" in streams
    assert "#2 hello from buildkit" in streams
    assert "#2 DONE" in streams
    assert events[-1] == {"aux": {"ID": "sha256:<ID>"}}
    assert "image_build_buildkit" in calls and tagged


def test_legacy_daemon_uses_legacy_lane():
    def run(m):
        drv = m.drivers.FakeDriver()       # builder_version defaults to "1"
        events = list(drv.engine().build_image(b"tar", tags=["t:1"]))
        return _events(events), [c[0] for c in drv.api.calls]

    want, got = both(run)
    assert got == want
    assert any("Step 1/1" in e.get("stream", "") for e in got[0])
    assert "image_build_buildkit" not in got[1]


def test_buildkit_refusal_falls_back_to_legacy_and_is_remembered():
    def run(m):
        drv = m.drivers.FakeDriver()
        drv.api.builder_version = "2"
        drv.api.buildkit_refuse = True
        eng = drv.engine()
        first = _events(list(eng.build_image(b"tar", tags=["t:1"])))
        tagged = drv.api.images.get("t:1") is not None
        list(eng.build_image(b"tar", tags=["t:2"]))
        return first, tagged, [c[0] for c in drv.api.calls
                               if c[0].startswith("image_build")]

    want, got = both(run)
    assert got == want
    first, tagged, lanes = got
    assert any("Step 1/1" in e.get("stream", "") for e in first) and tagged
    # the refusal sticks: the context is uploaded eagerly, so the doomed
    # lane is not retried on the next build
    assert lanes == ["image_build_buildkit", "image_build", "image_build"]


def test_type_confused_trace_skipped_not_fatal():
    def run(m):
        emit = m.bkproto.emit_field
        # Vertex field 5 (Timestamp message) as a varint instead of bytes
        bad_vertex = emit(1, "sha256:aa") + bytes([5 << 3]) + b"\x2a"
        raw = [{"id": "moby.buildkit.trace",
                "aux": base64.b64encode(emit(1, bad_vertex)).decode()},
               {"stream": "still alive\n"}]
        return list(m.buildkit.decode_stream(iter(raw)))

    want, got = both(run)
    assert got == want == [{"stream": "still alive\n"}]


def test_truncated_fixed_fields_error():
    def run(m):
        out = []
        for raw in (bytes([1 << 3 | 1]) + b"\x01\x02",   # fixed64, 2 bytes
                    bytes([1 << 3 | 5]) + b"\x01"):      # fixed32, 1 byte
            with pytest.raises(m.bkproto.WireError) as ei:
                m.bkproto.parse_fields(raw)
            out.append(str(ei.value))
        return out

    want, got = both(run)
    assert got == want


def test_cancel_uses_last_buildid():
    class Api:
        def __init__(self):
            self.cancelled = []
            self.bid = ""

        def info(self):
            return {"BuilderVersion": "2"}

        def image_build_buildkit(self, tar, *, buildid="", **kw):
            self.bid = buildid
            return iter(())

        def build_cancel(self, buildid):
            self.cancelled.append(buildid)

    def run(m):
        api = Api()
        b = m.buildkit.Builder(api)
        list(b.build(b"tar", tags=["t:1"]))
        held = b.last_buildid == api.bid != ""
        b.cancel()
        return held, api.cancelled == [api.bid], len(api.bid)

    want, got = both(run)
    assert got == want == (True, True, 32)


@pytest.mark.parametrize("version", ["2", "1"])
def test_build_and_cancel_over_the_wire(tmp_path, version):
    """Each package's ``Engine`` over its own HTTP client and the port's
    ``FakeEngineDaemon``: the same requests, lanes and decoded events;
    ``cancel`` sends the in-flight build's id on the BuildKit lane and
    nothing on the legacy one."""
    def run(m):
        api = port_fake.FakeDockerAPI()
        api.builder_version = version
        sock = tmp_path / f"{m.name}.sock"
        with port_testenv.FakeEngineDaemon(sock, api) as d:
            client = m.httpapi.HTTPDockerAPI(m.httpapi.unix_socket_factory(sock))
            eng = m.engine_api.Engine(client)
            events = list(eng.build_image(b"tar", tags=["t:1", "t:2"],
                                          labels={"k": "v"}, no_cache=True))
            eng._builder.cancel()
            client.close()
            bid = d.builds[0].get("buildid", "")
            requests = [(meth, path) for meth, path, _q, _h in d.log]
            return (requests, [{k: v for k, v in b.items() if k != "buildid"}
                               for b in d.builds],
                    d.cancelled == ([bid] if version == "2" else []),
                    _events(events), sorted(api.images))

    want, got = both(run)
    assert got == want
    requests, builds, cancelled, events, images = got
    assert builds[0]["tags"] == ["t:1", "t:2"] and builds[0]["no_cache"]
    assert builds[0]["labels"]["k"] == "v" and cancelled
    assert images == ["t:1", "t:2"]
    assert (("POST", "/build/cancel") in requests) == (version == "2")
    assert {"aux": {"ID": "sha256:<ID>"}} in events


def test_vertex_lines_feed_buildview_tree():
    def run(m):
        drv = m.drivers.FakeDriver()
        drv.api.builder_version = "2"
        streams, _, _, _ = m.iostreams.IOStreams.test()
        tree = m.progress.ProgressTree(streams)
        view = m.buildview.BuildProgressView(tree)
        view.stage("base image")
        for ev in drv.engine().build_image(b"tar", tags=["t:1"]):
            if ev.get("stream"):
                view.line(ev["stream"])
        view.done()
        return sorted((n.label, n.state) for n in tree._nodes.values())

    want, got = both(run)
    assert got == want
    assert ("[internal] load build definition", "done") in got
    assert any("FROM scratch" in label for label, _ in got)


# ---------------------------------------------------------- the payload

def _isolated_import(pyz: Path) -> dict:
    """Import the session daemon and the bridge with only ``pyz`` on
    ``sys.path`` in ``python3 -I``: -> what loaded."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(pyz)!r})\n"
        "import clawker_tpu_torch.agentd.daemon, clawker_tpu_torch.socketbridge.container\n"
        "import clawker_tpu_torch\n"
        "print(json.dumps({'file': clawker_tpu_torch.__file__,\n"
        "                  'torch': 'torch' in sys.modules,\n"
        "                  'jax': 'jax' in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-I", "-c", code], cwd=pyz.parent,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def test_pyz_is_deterministic_and_stdlib_only(tmp_path):
    a, b = port_payload.build_agentd_pyz(), port_payload.build_agentd_pyz()
    assert a == b
    names = zipfile.ZipFile(io.BytesIO(a)).namelist()
    assert "__main__.py" in names
    assert "clawker_tpu_torch/agentd/daemon.py" in names
    allowed_prefixes = ("__main__.py", "clawker_tpu_torch/agentd/",
                        "clawker_tpu_torch/socketbridge/")
    allowed = {"clawker_tpu_torch/__init__.py", "clawker_tpu_torch/consts.py",
               "clawker_tpu_torch/errors.py"}
    for n in names:
        assert n.startswith(allowed_prefixes) or n in allowed, n
    # the reference's closure, member for member, each the port's own file
    ref = ref_payload.build_agentd_pyz()
    assert pyz_view(a, "clawker_tpu_torch") == pyz_view(ref, "clawker_tpu")
    pyz = tmp_path / "clawker-agentd.pyz"
    pyz.write_bytes(a)
    assert _isolated_import(pyz) == {
        "file": f"{pyz}/clawker_tpu_torch/__init__.py", "torch": False,
        "jax": False}


def test_payload_includes_supervisor_when_built(supervisor_bin, monkeypatch):
    monkeypatch.setenv("CLAWKER_TPU_SUPERVISOR_BIN", str(supervisor_bin))
    want, got = both(lambda m: m.payload.agentd_payload())
    assert got is not None and sorted(got) == sorted(want)
    assert got["clawker-supervisord"] == want["clawker-supervisord"]
    assert got["clawker-supervisord"][:4] == b"\x7fELF"
    assert got["clawker-agentd.pyz"][:2] == b"PK"
    assert (pyz_view(got["clawker-agentd.pyz"], "clawker_tpu_torch")
            == pyz_view(want["clawker-agentd.pyz"], "clawker_tpu"))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_full_payload_composition(tmp_path, supervisor_bin):
    """supervisor --child python3 <port's pyz> --default-cmd <image cmd>:
    AgentReady with no argv runs the image CMD under the supervisor,
    the session driven by the port's client over mTLS."""
    ca = pki.generate_ca()
    cp = pki.generate_cp_cert(ca)
    certs = tmp_path / "certs"
    certs.mkdir()
    (certs / "cp.crt").write_bytes(cp.cert_pem)
    (certs / "cp.key").write_bytes(cp.key_pem)
    (certs / "ca.crt").write_bytes(ca.cert_pem)
    bdir = tmp_path / "bootstrap"
    bdir.mkdir()
    for name, data in identity.mint_bootstrap_material(ca, "p", "dev").files().items():
        (bdir / name).write_bytes(data)

    pyz = tmp_path / "clawker-agentd.pyz"
    pyz.write_bytes(port_payload.build_agentd_pyz())
    sock = tmp_path / "sup.sock"
    port = free_port()
    marker = tmp_path / "image-cmd-ran"
    proc = subprocess.Popen(
        [str(supervisor_bin), "--socket", str(sock), "--child",
         "python3", str(pyz), "--bootstrap-dir", str(bdir),
         "--host", "127.0.0.1", "--port", str(port),
         "--ready-file", str(tmp_path / "ready"),
         "--init-marker", str(tmp_path / "init"),
         "--supervisor-socket", str(sock), "--default-cmd",
         "/bin/sh", "-c", f"touch {marker}; exit 21"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        s = dial_with_retry("127.0.0.1", port, cert_file=certs / "cp.crt",
                            key_file=certs / "cp.key",
                            ca_file=certs / "ca.crt", deadline_s=15)
        with s:
            h = s.hello()
            assert not h.initialized and not h.cmd_running
            r = s.run_shell([{"argv": ["/bin/echo", "plan-step"]}])
            assert r.stdout.strip() == b"plan-step" and r.code == 0
            s.agent_initialized()
            assert s.agent_ready([], cwd=str(tmp_path)) > 0
        deadline = time.time() + 10
        while not marker.exists() and time.time() < deadline:
            time.sleep(0.05)
        assert marker.exists()
        with SupervisorClient(sock) as c:
            assert c.wait(timeout=10) == 21
    finally:
        if proc.poll() is None:
            proc.terminate()
        try:
            proc.wait(5)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(5)


# -------------------------------------- build forked over a Docker socket

def _error_build(api):
    """A legacy build whose stream ends in an ``errorDetail``."""
    def image_build(context_tar, *, tags, **kw):
        api._record("image_build", tags=tags)
        return iter([{"stream": "Step 1/1 : RUN false\n"},
                     {"errorDetail": {"message": "exit code 1"},
                      "error": "exit code 1"}])
    api.image_build = image_build


LANES = {
    "buildkit": dict(version="2"),
    "legacy": dict(version="1"),
    "refused": dict(version="2", refuse=True),
    "error": dict(version="1", error=True),
}


def _forked_build(m, base: Path, lane: dict) -> tuple:
    api = port_fake.FakeDockerAPI()
    api.builder_version = lane["version"]
    api.buildkit_refuse = lane.get("refuse", False)
    if lane.get("error"):
        _error_build(api)
    sock = base / "d.sock"
    proj = base / "proj"
    proj.mkdir(parents=True)
    (proj / ".clawker.yaml").write_text("project: demo\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CLAWKER_TPU_", "XDG_"))}
    (base / "supervisord").write_bytes(b"\x7fELF stand-in supervisor\n")
    env.update(DOCKER_HOST=f"unix://{sock}", PYTHONPATH=str(ROOT),
               CLAWKER_TPU_SUPERVISOR_BIN=str(base / "supervisord"))
    for name in ("CONFIG", "DATA", "STATE", "CACHE"):
        (base / name).mkdir()
        env[f"CLAWKER_TPU_{name}_DIR"] = str(base / name)
    (base / "CONFIG" / "settings.yaml").write_text("host_proxy:\n  enable: false\n")
    runs = []
    with port_testenv.FakeEngineDaemon(sock, api) as d:
        for argv in (["build", "--plain"], ["image", "ls"]):
            p = subprocess.run([sys.executable, "-m", m.name, *argv], cwd=proj,
                               env=env, capture_output=True, text=True,
                               timeout=120)
            runs.append((p.returncode, p.stdout, _STAMP.sub(
                "<TS>", p.stderr.replace(str(base), "<BASE>"))))
        lanes = [(b["version"], b["tags"], b["labels"], b["no_cache"],
                  bool(b.get("buildid"))) for b in d.builds]
        routes = [(meth, path) for meth, path, _q, _h in d.log
                  if path.startswith(("/build", "/images"))]
    return runs, lanes, routes


@pytest.mark.parametrize("lane", sorted(LANES))
def test_build_forked_over_a_docker_socket(tmp_path, lane):
    """``build --plain`` then ``image ls`` forked on each package's CLI
    over its own ``FakeEngineDaemon``: the same output, lanes and
    requests."""
    want = _forked_build(PKGS["ref"], tmp_path / "ref", LANES[lane])
    got = _forked_build(PKGS["port"], tmp_path / "port", LANES[lane])
    assert got == want
    (build_rc, build_out, build_err), (ls_rc, ls_out, _), = got[0]
    lanes, routes = got[1], got[2]
    tags = [t for _v, t, *_ in lanes]
    if lane == "error":
        assert build_rc == 1
        assert "build of clawker-demo:base failed: exit code 1" in build_err
        assert ("POST", "/images/clawker-demo%3Aclaude/tag") not in routes
        assert ls_out == ""
        return
    assert build_rc == 0 and ls_rc == 0, build_err
    assert build_out.endswith("tagged clawker-demo:default\nclawker-demo:default\n")
    assert ls_out == ("clawker-demo:base\nclawker-demo:claude\n"
                      "clawker-demo:default\n")
    assert routes[-2:] == [("POST", "/images/clawker-demo%3Aclaude/tag"),
                           ("GET", "/images/json")]
    if lane == "buildkit":
        assert [v for v, *_ in lanes] == ["2", "2"]
        assert all(bid for *_, bid in lanes)
        assert "#1 [internal] load build definition" in build_out
        assert "#2 hello from buildkit" in build_out
    elif lane == "legacy":
        assert [v for v, *_ in lanes] == ["1", "1"]
        assert "Step 1/1 : FROM scratch" in build_out
    else:
        # one refused v2 request; the fallback is remembered for stage 2
        assert [v for v, *_ in lanes] == ["2", "1", "1"]
        tags = tags[1:]
    assert tags == [["clawker-demo:base"], ["clawker-demo:claude"]]
