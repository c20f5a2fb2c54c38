"""The port's CLI leftovers against the reference's.

Twins of tests/test_state.py (the state store and the TTL-cached update
check, whose fetcher is always a stub here), tests/test_fieldbrowser.py
(the key decoder, the browser's state machine, ``browse`` over a key
stream, the dashboard's status bar), tests/test_plugin_storeui.py (the
plugin lanes with the traversal guard and the symlink refusals, the
store editor) and test_cli_extras.py's ``gen_docs`` (the page names,
the reference's less the pages of the verbs that still wait); then
``project edit`` and ``settings edit`` through the CLI, the ``plugin``
verbs, and the start-up notices on a fake TTY with a stubbed fetcher:
shown once on a terminal, never off one or with
``CLAWKER_TPU_NO_NOTICES`` set, and never breaking a command.  No case
reaches the network: every update check takes a stub.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest
from click.testing import CliRunner

import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.config.config as ref_cfgmod
import clawker_tpu.docs as ref_docs
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.plugin as ref_plugin
import clawker_tpu.state as ref_state
import clawker_tpu.storeui as ref_storeui
import clawker_tpu.testenv as ref_testenv
import clawker_tpu.ui.dashboard as ref_dashboard
import clawker_tpu.ui.fieldbrowser as ref_fb
import clawker_tpu.ui.iostreams as ref_iostreams
import clawker_tpu_torch as port_pkg
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.cli.root as port_root
import clawker_tpu_torch.config.config as port_cfgmod
import clawker_tpu_torch.docs as port_docs
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.plugin as port_plugin
import clawker_tpu_torch.state as port_state
import clawker_tpu_torch.storeui as port_storeui
import clawker_tpu_torch.testenv as port_testenv
import clawker_tpu_torch.ui.dashboard as port_dashboard
import clawker_tpu_torch.ui.fieldbrowser as port_fb
import clawker_tpu_torch.ui.iostreams as port_iostreams

REPO = Path(__file__).resolve().parent.parent
EXAMPLE_PLUGIN = REPO / "examples" / "clawker-plugin"
PROXY_OFF = "host_proxy:\n  enable: false\n"

PKGS = {
    "ref": SimpleNamespace(
        pkg="ref", state=ref_state, fb=ref_fb, iostreams=ref_iostreams,
        cfgmod=ref_cfgmod, plugin=ref_plugin, storeui=ref_storeui,
        docs=ref_docs, dashboard=ref_dashboard, testenv=ref_testenv,
        drivers=ref_drivers, cli=ref_root.cli, root=ref_root,
        Factory=ref_factory.Factory),
    "port": SimpleNamespace(
        pkg="port", state=port_state, fb=port_fb, iostreams=port_iostreams,
        cfgmod=port_cfgmod, plugin=port_plugin, storeui=port_storeui,
        docs=port_docs, dashboard=port_dashboard, testenv=port_testenv,
        drivers=port_drivers, cli=port_cli.cli, root=port_root,
        Factory=port_cli.Factory),
}
BOTH = pytest.mark.parametrize("pkg", ["ref", "port"])


def both(fn):
    """``fn(m, tag)`` for the reference, then the port: -> (reference's
    result, port's)."""
    return fn(PKGS["ref"], "ref"), fn(PKGS["port"], "port")


# ---------------------------------------------------- tests/test_state.py


def _store(m, tmp_path, tag):
    return m.state.StateStore(tmp_path / tag / "state.json")


def test_state_store_roundtrip(tmp_path):
    def run(m, tag):
        store = _store(m, tmp_path, tag)
        out = [store.get("k")]
        store.set("k", {"a": 1})
        out.append(store.get("k"))
        store.set("j", [1, 2])
        out += [store.get("k"), store.get("j")]
        store.delete("k")
        out.append(store.get("k"))
        return out

    want, got = both(run)
    assert got == want == [None, {"a": 1}, {"a": 1}, [1, 2], None]


def test_state_store_corrupt_file_resets(tmp_path):
    def run(m, tag):
        store = _store(m, tmp_path, tag)
        store.path.parent.mkdir(parents=True, exist_ok=True)
        store.path.write_text("{not json")
        out = [store.get("k")]
        store.set("k", 1)
        return out + [store.get("k")]

    want, got = both(run)
    assert got == want == [None, 1]


def test_newer_semver():
    cases = [("v9.0.0", "0.1.0"), ("0.0.1", "0.1.0"), ("", "0.1.0"),
             ("garbage", "0.1.0"), ("0.2.1", "0.2.0"), ("v0.2.0", "0.2.0")]
    want, got = both(lambda m, tag: [m.state._newer(a, b) for a, b in cases])
    assert got == want == [True, False, False, False, True, False]


def test_update_check_ttl_and_teaser(tmp_path):
    def run(m, tag):
        store = _store(m, tmp_path, tag)
        calls = []

        def fetch():
            calls.append(1)
            return "v99.0.0"

        teaser = m.state.check_for_update(state=store, fetch=fetch, now=1000.0)
        teaser2 = m.state.check_for_update(state=store, fetch=fetch,
                                           now=1000.0 + 60)
        m.state.check_for_update(state=store, fetch=fetch,
                                 now=1000.0 + m.state.UPDATE_TTL_S + 1)
        return teaser, teaser2, len(calls), store.get("update_check")

    want, got = both(run)
    assert got == want
    assert "v99.0.0" in got[0] and port_pkg.__version__ in got[0]
    assert got[1] == got[0] and got[2] == 2


def test_update_check_offline_is_quiet(tmp_path):
    def run(m, tag):
        store = _store(m, tmp_path, tag)
        calls = []

        def fetch():
            calls.append(1)
            return ""

        return (m.state.check_for_update(state=store, fetch=fetch, now=1.0),
                m.state.check_for_update(state=store, fetch=fetch, now=2.0),
                len(calls))

    want, got = both(run)
    assert got == want == ("", "", 1)


def test_concurrent_set_loses_no_updates(tmp_path):
    def run(m, tag):
        store = m.state.StateStore(tmp_path / tag / "cli-state.json")

        def writer(prefix):
            for i in range(30):
                store.set(f"{prefix}-{i}", i)

        threads = [threading.Thread(target=writer, args=(p,)) for p in "abcd"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return sorted(json.loads(store.path.read_text()).items())

    want, got = both(run)
    assert got == want and len(got) == 120


def test_state_store_defaults_to_the_state_dir(tmp_path):
    def run(m, tag):
        with m.testenv.TestEnv(base=tmp_path / tag) as tenv:
            store = m.state.StateStore()
            return store.path.relative_to(tenv.base).as_posix()

    want, got = both(run)
    assert got == want == "state/cli-state.json"


# ----------------------------------------------- tests/test_fieldbrowser.py


def _browser(m, tmp_path, tag, **kw):
    streams, _, out, _ = m.iostreams.IOStreams.test()
    store = m.cfgmod.settings_store(tmp_path / tag / "config")
    return m.fb.FieldBrowser(store, streams, **kw), out, store


@pytest.mark.parametrize("text", ["j\x1b[A\x1b[B\r\x7f\x1bq",
                                  "\x1b[5~\x1b[6~\x1b[H\x1b[F"])
def test_read_key_decodes_tokens(text):
    def run(m, tag):
        s = io.StringIO(text)
        return [m.fb.read_key(s) for _ in range(8)]

    want, got = both(run)
    assert got == want
    assert got[:2] in (["j", port_fb.K_UP], ["pgup", "pgdn"])


def test_browser_lists_all_leaf_fields_with_provenance(tmp_path):
    def run(m, tag):
        b, _, _ = _browser(m, tmp_path, tag)
        return [(s.path, s.provenance) for s in b.specs], b.render()

    want, got = both(run)
    assert got == want
    paths = [p for p, _ in got[0]]
    assert "firewall.enable" in paths and "credentials.stage" in paths
    frame = "\n".join(got[1])
    assert "settings browser" in frame and "[default]" in frame


def test_browser_navigation_and_bounds(tmp_path):
    def run(m, tag):
        b, _, _ = _browser(m, tmp_path, tag)
        out = [b.cursor]
        for key in (m.fb.K_UP, "j", m.fb.K_DOWN, "end", m.fb.K_DOWN, "home",
                    "pgdn", "k"):
            b.handle(key)
            out.append(b.cursor)
        return out, len(b.specs)

    want, got = both(run)
    assert got == want
    cursors, n = got
    assert cursors[:4] == [0, 0, 1, 2] and cursors[4:6] == [n - 1, n - 1]


def test_browser_filter_narrows_and_escape_clears(tmp_path):
    def run(m, tag):
        b, _, _ = _browser(m, tmp_path, tag)
        for key in "/firewall":
            b.handle(key)
        out = [b.filtering]
        b.handle(m.fb.K_ENTER)
        out += [b.filtering, [s.path for s in b.visible()]]
        b.handle("/")
        b.handle(m.fb.K_ESC)
        return out + [len(b.visible()) == len(b.specs)]

    want, got = both(run)
    assert got == want
    assert got[0] and not got[1] and got[3]
    assert got[2] and all("firewall" in p for p in got[2])


def test_browser_edit_writes_value_and_updates_provenance(tmp_path):
    def run(m, tag):
        b, _, store = _browser(m, tmp_path, tag)
        for key in "/credentials.stage":
            b.handle(key)
        b.handle(m.fb.K_ENTER)
        b.handle(m.fb.K_ENTER)
        out = [b.editing, b.edit_buf]
        for _ in range(5):
            b.handle("backspace")
        for key in "true":
            b.handle(key)
        b.handle(m.fb.K_ENTER)
        spec = b.current()
        return out + [b.changed, spec.value, bool(spec.provenance),
                      m.cfgmod.settings_store(
                          tmp_path / tag / "config").get("credentials.stage")]

    want, got = both(run)
    assert got == want == [True, "false", 1, True, True, True]


def test_browser_edit_escape_cancels_and_bad_value_reports(tmp_path):
    def run(m, tag):
        b, _, _ = _browser(m, tmp_path, tag)
        b.handle(m.fb.K_ENTER)
        out = [b.editing]
        b.handle(m.fb.K_ESC)
        out += [b.editing, b.changed]
        b2, _, _ = _browser(m, tmp_path, tag + "2")
        for key in "/firewall.enable":
            b2.handle(key)
        b2.handle(m.fb.K_ENTER)
        b2.handle(m.fb.K_ENTER)
        for _ in range(6):
            b2.handle("backspace")
        for key in "nope":
            b2.handle(key)
        b2.handle(m.fb.K_ENTER)
        return out + [b2.changed, b2.message]

    want, got = both(run)
    assert got == want
    assert got[:4] == [True, False, 0, 0] and got[4]


def test_browser_layer_cycle_and_quit_keys(tmp_path):
    def run(m, tag):
        b, _, _ = _browser(m, tmp_path, tag, layers=["settings"])
        out = [b.write_layer]
        b.handle("L")
        out.append(b.write_layer)
        b.handle("L")
        return out + [b.write_layer, b.handle("q"), b.handle("")]

    want, got = both(run)
    assert got == want == [None, "settings", None, False, False]


def test_browse_end_to_end_over_key_stream(tmp_path):
    def run(m, tag):
        streams, _, out, _ = m.iostreams.IOStreams.test()
        keys = io.StringIO("/credentials.stage\r" "\r" + "\x7f" * 5
                           + "true\r" "q")
        store = m.cfgmod.settings_store(tmp_path / tag / "config")
        changed = m.fb.browse(store, streams, key_stream=keys)
        return changed, store.get("credentials.stage"), out.getvalue()

    want, got = both(run)
    assert got == want
    assert got[:2] == (1, True) and "settings browser" in got[2]


def test_dashboard_statusbar_summarizes():
    class Sched:
        loop_id = "abc123"

        def status(self):
            return [
                {"agent": "a1", "worker": "w0", "status": "running",
                 "iteration": 2, "exit_codes": [0], "anomaly_z": 4.2},
                {"agent": "a2", "worker": "w1", "status": "done",
                 "iteration": 1, "exit_codes": [0], "anomaly_z": 0.3},
            ]

    def run(m, tag):
        streams, _, _, _ = m.iostreams.IOStreams.test()
        dash = m.dashboard.LoopDashboard(streams, Sched())
        dash.record_event("a1", "anomaly", "egress z-score 4.2")
        # the elapsed seconds run on each dashboard's own clock
        return [re.sub(r"(?<= )\d+s(?= |$)", "<T>s", line)
                for line in dash._frame_lines()]

    want, got = both(run)
    assert got == want
    bar = got[-1]
    assert "ANOM-Z" in "\n".join(got) and "loop abc123" in bar
    assert "running:1" in bar and "done:1" in bar and "anom-max:4.2" in bar


# -------------------------------------------- tests/test_plugin_storeui.py


@pytest.fixture
def claude_dirs(tmp_path, monkeypatch):
    """Each package's own ``CLAUDE_CONFIG_DIR``, switched per side."""
    def use(tag):
        (tmp_path / tag).mkdir(exist_ok=True)
        monkeypatch.setenv("CLAUDE_CONFIG_DIR", str(tmp_path / tag / "claude"))
        return tmp_path / tag
    return use


def test_example_plugin_discovers_skills():
    want, got = both(lambda m, tag: [
        (s.name, s.description, s.path == EXAMPLE_PLUGIN / "skills"
         / s.name) for s in m.plugin.discover_skills(EXAMPLE_PLUGIN)])
    assert got == want
    assert [s[0] for s in got] == ["hello-skill"] and "hello" in got[0][1]


def test_install_and_remove_roundtrip(claude_dirs):
    def run(m, tag):
        claude_dirs(tag)
        installed = m.plugin.install(EXAMPLE_PLUGIN, harness="claude")
        dest = m.plugin.skills_dir("claude") / "hello-skill"
        present = (dest / "SKILL.md").is_file()
        removed = m.plugin.remove(EXAMPLE_PLUGIN, harness="claude")
        return installed, present, removed, dest.exists()

    want, got = both(run)
    assert got == want == (["hello-skill"], True, ["hello-skill"], False)


def test_traversal_guard(claude_dirs):
    def run(m, tag):
        base = claude_dirs(tag)
        evil = base / "evil-src"
        (evil / "skills" / "ok").mkdir(parents=True)
        (evil / "skills" / "ok" / "SKILL.md").write_text("# ok")
        skills = m.plugin.discover_skills(evil)
        skills[0].name = "../../escape"
        with pytest.raises(m.plugin.PluginError) as e:
            m.plugin._guard(m.plugin.skills_dir("claude"), skills[0].name)
        return str(e.value).replace(str(base), "<BASE>")

    want, got = both(run)
    assert got == want and "escapes" in got


def test_install_refuses_source_inside_skills_dir(claude_dirs):
    def run(m, tag):
        base = claude_dirs(tag)
        m.plugin.install(EXAMPLE_PLUGIN, harness="claude")
        sd = m.plugin.skills_dir("claude")
        with pytest.raises(m.plugin.PluginError) as e:
            m.plugin.install(sd, harness="claude")
        return (str(e.value).replace(str(base), "<BASE>"),
                (sd / "hello-skill" / "SKILL.md").is_file())

    want, got = both(run)
    assert got == want
    assert "already inside" in got[0] and got[1]


def test_storeui_default_roundtrips():
    values = ((str, "ubuntu:24.04"), (int, 8080), (float, 1.5), (bool, True),
              (list, []), (list, ["a", "b"]), (dict, {}), (dict, {"K": "1"}))

    def run(m, tag):
        out = []
        for t, v in values:
            spec = m.storeui.FieldSpec("x", t, v, "")
            out.append((m.storeui._raw(spec),
                        m.storeui.coerce(spec, m.storeui._raw(spec))))
        return out

    want, got = both(run)
    assert got == want
    assert [v for _, v in got] == [v for _, v in values]


def test_unknown_harness_and_empty_source(tmp_path):
    def run(m, tag):
        out = []
        with pytest.raises(m.plugin.PluginError) as e:
            m.plugin.skills_dir("unknown-harness")
        out.append(str(e.value))
        empty = tmp_path / tag
        empty.mkdir()
        with pytest.raises(m.plugin.PluginError) as e:
            m.plugin.install(empty)
        out.append(str(e.value).replace(str(empty), "<SRC>"))
        return out + [m.plugin.show("claude"), m.plugin.show("codex")]

    want, got = both(run)
    assert got == want
    assert "no skills lane" in got[0] and "no skills found" in got[1]
    assert "claude plugin install" in got[2]


def _settings_store(m, tmp_path, tag):
    cfgdir = tmp_path / tag / "config"
    cfgdir.mkdir(parents=True, exist_ok=True)
    return m.cfgmod.settings_store(cfgdir)


def test_field_specs_flatten_with_provenance(tmp_path):
    def run(m, tag):
        store = _settings_store(m, tmp_path, tag)
        store.set("firewall.enable", True)
        return [(s.path, s.type.__name__, s.value, s.provenance)
                for s in m.storeui.field_specs(store)]

    want, got = both(run)
    assert json.loads(json.dumps(got, default=str).replace(
        str(tmp_path / "port"), "<B>")) == json.loads(json.dumps(
            want, default=str).replace(str(tmp_path / "ref"), "<B>"))
    specs = {p: (t, v, prov) for p, t, v, prov in got}
    assert specs["firewall.enable"][1] is True and specs["firewall.enable"][2]
    assert specs["monitoring.opensearch_port"][0] == "int"


def test_coerce_types():
    cases = [(bool, False, "yes"), (int, 0, "8080"), (list, [], "a, b"),
             (dict, {}, "K=1,L=2"), (bool, False, "maybe"),
             (int, 0, "NaNish"), (float, 0.0, "2.5")]

    def run(m, tag):
        out = []
        for t, v, raw in cases:
            try:
                out.append(m.storeui.coerce(m.storeui.FieldSpec("x", t, v, ""),
                                            raw))
            except m.storeui.EditError as e:
                out.append(f"EditError: {e}")
        return out

    want, got = both(run)
    assert got == want
    assert got[:4] == [True, 8080, ["a", "b"], {"K": "1", "L": "2"}]
    assert all(str(x).startswith("EditError") for x in got[4:6])


def _tty_streams(m, stdin_data: str):
    streams, fin, fout, ferr = m.iostreams.IOStreams.test(
        stdin_data=stdin_data)
    for stream in (streams.stdin, streams.stdout, streams.stderr):
        stream.isatty = lambda: True  # force the TTY probes
    return streams, fout


def test_run_editor_drives_store(tmp_path):
    def run(m, tag):
        store = _settings_store(m, tmp_path, tag)
        specs = m.storeui.field_specs(store)
        idx = next(i for i, s in enumerate(specs)
                   if s.path == "firewall.enable") + 1
        streams, _ = _tty_streams(m, f"{idx}\ntrue\n\n")
        return m.storeui.run_editor(store, streams), store.get(
            "firewall.enable")

    want, got = both(run)
    assert got == want == (1, True)


def test_run_editor_refuses_without_tty(tmp_path):
    def run(m, tag):
        store = _settings_store(m, tmp_path, tag)
        streams, *_ = m.iostreams.IOStreams.test()
        with pytest.raises(m.storeui.EditError) as e:
            m.storeui.run_editor(store, streams)
        return str(e.value)

    want, got = both(run)
    assert got == want and "TTY" in got


def test_install_skips_symlinks_in_third_party_trees(claude_dirs):
    def run(m, tag):
        base = claude_dirs(tag)
        secret = base / "id_rsa"
        secret.write_text("PRIVATE KEY MATERIAL")
        sk = base / "evil-plugin" / "skills" / "innocent"
        sk.mkdir(parents=True)
        (sk / "SKILL.md").write_text("# innocent")
        (sk / "stolen").symlink_to(secret)
        (sk / "linkdir").symlink_to(base)
        installed = m.plugin.install(base / "evil-plugin", harness="claude")
        dest = m.plugin.skills_dir("claude") / "innocent"
        return (installed, sorted(p.name for p in dest.iterdir()))

    want, got = both(run)
    assert got == want == (["innocent"], ["SKILL.md"])


def test_install_skips_skill_dir_that_is_a_symlink(claude_dirs):
    def run(m, tag):
        base = claude_dirs(tag)
        foreign = base / "foreign-tree"
        foreign.mkdir()
        (foreign / "SKILL.md").write_text("# foreign")
        (foreign / "cred.pem").write_text("SECRET")
        src = base / "plug"
        (src / "skills" / "genuine").mkdir(parents=True)
        (src / "skills" / "genuine" / "SKILL.md").write_text("# genuine")
        (src / "skills" / "linked").symlink_to(foreign)
        installed = m.plugin.install(src, harness="claude")
        return installed, (m.plugin.skills_dir("claude") / "linked").exists()

    want, got = both(run)
    assert got == want == (["genuine"], False)


# ------------------------------------------------------- the CLI verbs


@contextlib.contextmanager
def side(pkg: str, tmp_path: Path):
    m = PKGS[pkg]
    with m.testenv.TestEnv(base=tmp_path / pkg) as tenv:
        tenv.write_settings(PROXY_OFF)
        proj = tenv.base / "proj"
        proj.mkdir()
        (proj / ".clawker.yaml").write_text("project: leftovers\n")
        yield SimpleNamespace(m=m, tenv=tenv, proj=proj, pkg=pkg)


def twin(tmp_path: Path, scenario):
    out = []
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path) as s:
            text = json.dumps(scenario(s), default=str)
            out.append(json.loads(text.replace(str(s.tenv.base), "<BASE>")))
    return tuple(out)


def invoke(s, *args, factory=None, input=None):
    factory = factory or s.m.Factory(cwd=s.proj,
                                     driver=s.m.drivers.FakeDriver())
    res = CliRunner().invoke(s.m.cli, list(args), obj=factory, input=input)
    return res.exit_code, res.stdout, res.stderr


@pytest.mark.parametrize("group,path", [("settings", "firewall.enable"),
                                        ("project", "build.stack")])
def test_edit_verbs_drive_the_select_editor_on_a_tty(tmp_path, group, path):
    """``settings edit --select`` / ``project edit --select`` on a
    terminal: pick the field, type the value, done."""
    value = {"firewall.enable": "true", "build.stack": "go"}[path]

    def scenario(s):
        f = s.m.Factory(cwd=s.proj, driver=s.m.drivers.FakeDriver())
        store = (f.config.settings_store_ref if group == "settings"
                 else f.config.project_store_ref)
        idx = next(i for i, sp in enumerate(s.m.storeui.field_specs(store))
                   if sp.path == path) + 1
        streams, out = _tty_streams(s.m, f"{idx}\n{value}\n\n")
        f.__dict__["streams"] = streams
        res = invoke(s, group, "edit", "--select", factory=f)
        fresh = s.m.Factory(cwd=s.proj, driver=s.m.drivers.FakeDriver())
        after = (fresh.config.settings_store_ref if group == "settings"
                 else fresh.config.project_store_ref).get(path)
        return res, after

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == [0, "1 field(s) changed\n", ""]
    assert str(got[1]).lower() == value


@pytest.mark.parametrize("group", ["settings", "project"])
def test_edit_verbs_refuse_without_a_tty(tmp_path, group):
    def scenario(s):
        return invoke(s, group, "edit")

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == 1 and "interactive editor needs a TTY" in got[2]


def test_project_edit_without_a_project_refuses(tmp_path):
    def scenario(s):
        (s.proj / ".clawker.yaml").unlink()
        return invoke(s, "project", "edit")

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == 1 and "no project config found" in got[2]


def test_plugin_verbs(tmp_path, monkeypatch):
    def scenario(s):
        monkeypatch.setenv("CLAUDE_CONFIG_DIR", str(s.tenv.base / "claude"))
        out = [invoke(s, "plugin", "list")]
        out.append(invoke(s, "plugin", "install", "--source",
                          str(EXAMPLE_PLUGIN)))
        out.append(invoke(s, "skill", "list"))
        out.append(invoke(s, "plugin", "show", "--harness", "codex"))
        out.append(invoke(s, "plugin", "remove", "--source",
                          str(EXAMPLE_PLUGIN), "--yes"))
        out.append(invoke(s, "plugin", "list"))
        out.append(invoke(s, "plugin", "install", "--source",
                          str(EXAMPLE_PLUGIN), "--harness", "nope"))
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0][1].startswith("no skills directory at")
    assert got[1] == [0, "installed hello-skill\n", ""]
    assert got[2][1].startswith("hello-skill\t")
    assert got[4] == [0, "removed hello-skill\n", ""]
    assert got[6][0] == 1 and "no skills lane" in got[6][2]


def _command_paths(group, prefix=()) -> set[tuple]:
    import click

    out = {prefix}
    if isinstance(group, click.Group):
        for name, sub in group.commands.items():
            if not sub.hidden:
                out |= _command_paths(sub, prefix + (name,))
    return out


def _page(path: tuple) -> str:
    return "clawker" + ("_" + "_".join(path) if path else "") + ".md"


# the reference's commands the port has no counterpart of: none
ABSENT = set()


def test_gen_docs_page_names(tmp_path):
    def scenario(s):
        out_dir = s.tenv.base / "docs" / "cli-reference"
        res = invoke(s, "gen-docs", "--out", str(out_dir))
        pages = sorted(p.name for p in out_dir.iterdir())
        schemas = sorted(p.name for p in (out_dir.parent / "schemas").iterdir())
        return res, pages, schemas, (out_dir / "clawker_loop.md").read_text()

    want, got = twin(tmp_path, scenario)
    res, pages, schemas, loop_page = got
    assert res[0] == 0 and res[1].startswith(f"wrote {len(pages)} pages")
    assert schemas == want[2] == ["clawker.schema.json",
                                  "settings.schema.json"]
    assert _command_paths(ref_root.cli) - _command_paths(port_cli.cli) == ABSENT
    assert set(pages) == set(want[1]) - {_page(p) for p in ABSENT}
    assert "clawker.md" in pages and "README.md" in pages
    assert "clawker_loop.md" in pages and "clawker_worktree_add.md" in pages
    assert "clawker_gen-docs.md" not in pages
    assert {"clawker_bundle_prune.md", "clawker_fed_status.md",
            "clawker_fleet_health.md", "clawker_plugin_install.md"} <= set(pages)
    assert "--parallel" in loop_page and "# clawker loop" in loop_page
    assert "--pods" in loop_page
    assert {"clawker_loop_trace.md", "clawker_controlplane.md",
            "clawker_controlplane_up.md", "clawker_controlplane_agents.md",
            "clawker_controlplane_status.md",
            "clawker_controlplane_down.md"} <= set(pages)


def test_gen_docs_pages_match_the_reference_for_shared_verbs(tmp_path):
    """The schema generator and the page renderer give the same bytes on
    both packages for a command tree they share."""
    import click

    @click.group()
    def root():
        """A root."""

    @root.command("hello")
    @click.option("--name", help="Who.")
    @click.argument("target")
    def hello(name, target):
        """Say hello."""

    def run(m, tag):
        out = tmp_path / tag
        pages = m.docs.generate_cli_reference(root, out / "ref")
        schemas = m.docs.generate_json_schemas(out / "schemas")
        return ({p.name: p.read_text() for p in pages},
                {p.name: p.read_text() for p in schemas})

    want, got = both(run)
    assert got == want
    assert "clawker_hello.md" in got[0]


# ------------------------------------------------------ start-up notices


class _TtyErr(io.StringIO):
    def isatty(self):
        return True


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_notices_show_once_on_a_tty_with_a_stubbed_fetch(tmp_path,
                                                          monkeypatch, pkg):
    m = PKGS[pkg]
    with m.testenv.TestEnv(base=tmp_path / pkg):
        monkeypatch.delenv("CLAWKER_TPU_NO_NOTICES", raising=False)
        real = m.state.check_for_update
        fetched = []

        def stub():
            fetched.append(1)
            return "v99.0.0"

        monkeypatch.setattr(m.state, "check_for_update",
                            lambda: real(fetch=stub))
        err = _TtyErr()
        monkeypatch.setattr("sys.stderr", err)
        lines = []
        for _ in range(2):
            t = m.root._start_notices()
            t.join(5)
            lines.append(list(t.lines))
        assert fetched == [1]            # the TTL cache absorbs the second
        assert "v99.0.0 is available" in lines[0][0]
        assert lines[1] == lines[0][:1]  # the teaser shows once
        # off a terminal, or opted out: no thread at all
        monkeypatch.setattr("sys.stderr", io.StringIO())
        assert m.root._start_notices() is None
        monkeypatch.setattr("sys.stderr", err)
        monkeypatch.setenv("CLAWKER_TPU_NO_NOTICES", "1")
        assert m.root._start_notices() is None


def test_main_prints_notices_after_the_command_and_survives_a_failing_probe(
        tmp_path, monkeypatch):
    """``main`` joins the probe for at most a beat and prints its lines
    on stderr after the command; a probe that raises prints nothing and
    the command's exit code stands."""
    def run(m, tag):
        out = []
        with m.testenv.TestEnv(base=tmp_path / tag):
            monkeypatch.delenv("CLAWKER_TPU_NO_NOTICES", raising=False)
            real = m.state.check_for_update
            monkeypatch.setattr(m.state, "check_for_update",
                                lambda: real(fetch=lambda: "v99.0.0"))
            for probe in ("ok", "raises"):
                if probe == "raises":
                    def boom():
                        raise RuntimeError("offline")
                    monkeypatch.setattr(m.state, "check_for_update", boom)
                err, stdout = _TtyErr(), io.StringIO()
                monkeypatch.setattr("sys.stderr", err)
                monkeypatch.setattr("sys.stdout", stdout)
                code = m.root.main(["version"])
                out.append((code, stdout.getvalue(),
                            [line for line in err.getvalue().splitlines()
                             if "available" in line]))
        return out

    want, got = both(run)
    assert got == want
    assert got[0][0] == 0 and got[0][1] == f"clawker-tpu {port_pkg.__version__}\n"
    assert len(got[0][2]) == 1 and "v99.0.0" in got[0][2][0]
    assert got[1][0] == 0 and got[1][2] == []
