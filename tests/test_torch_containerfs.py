"""The port's harness staging (``containerfs``, ``bundle``) against the
reference's.

Every twin runs the same host state through both packages: the staged
mirror (each file's bytes by path), the staging tar (byte for byte, with
``time.time`` pinned: the tar stamps its members' mtime), the errors
raised, and on the create path what ``put_archive`` delivered at the
container home.  tests/test_containerfs.py's 16 cases, then
tests/test_bundler.py's floor resolution, installed-tier shadowing and
the loose-tier escaping harness.
"""

from __future__ import annotations

import io
import json
import shutil
import tarfile
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import yaml

import clawker_tpu.bundle.resolver as ref_resolver
import clawker_tpu.config as ref_config
import clawker_tpu.containerfs as ref_cfs
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.errors as ref_errors
import clawker_tpu.runtime.orchestrate as ref_orch
import clawker_tpu_torch.bundle as port_bundle
import clawker_tpu_torch.bundle.resolver as port_resolver
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.containerfs as port_cfs
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.errors as port_errors
import clawker_tpu_torch.runtime.orchestrate as port_orch
from clawker_tpu import consts
from clawker_tpu.testenv import TestEnv

PKGS = {
    "ref": SimpleNamespace(cfs=ref_cfs, resolver=ref_resolver,
                           config=ref_config, drivers=ref_drivers,
                           errors=ref_errors, orch=ref_orch),
    "port": SimpleNamespace(cfs=port_cfs, resolver=port_resolver,
                            config=port_config, drivers=port_drivers,
                            errors=port_errors, orch=port_orch),
}
HOME = "/home/agent"
WORK = "/workspace"
NOW = 1_790_000_000


@pytest.fixture(autouse=True)
def _fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: float(NOW))


def _mirror(sdir: Path) -> dict:
    """Each staged path -> its bytes (None for a directory)."""
    return {str(p.relative_to(sdir)): (None if p.is_dir() else p.read_bytes())
            for p in sorted(sdir.rglob("*"))}


def _staged(m, raw: dict, root: str = "/nonexistent-project", **kw):
    """-> (mirror, staging tar) or the raised error's class name and
    message."""
    staging = m.cfs.Staging.from_raw(raw)
    try:
        sdir, cleanup = m.cfs.prepare_config(
            staging, container_home=HOME, container_work=WORK,
            host_project_root=root, **kw)
    except Exception as e:  # noqa: BLE001 -- compared across packages
        return type(e).__name__, str(e)
    try:
        return _mirror(sdir), m.cfs.staging_tar(sdir)
    finally:
        cleanup()


def _twin(raw: dict, **kw):
    ref = _staged(PKGS["ref"], raw, **kw)
    port = _staged(PKGS["port"], raw, **kw)
    assert port == ref
    return port


def _copy(src, dest, **kw) -> dict:
    return {"copy": [dict(src=str(src), dest=dest, **kw)]}


# ---------------------------------------------------- tests/test_containerfs


def test_expand_host_path(monkeypatch, tmp_path):
    monkeypatch.setenv("XDIR", str(tmp_path))
    monkeypatch.delenv("NOPE", raising=False)
    for raw in ("$XDIR/a", "${XDIR}/a", "${NOPE:-/fallback}/a", "~", "~/x"):
        assert port_cfs.expand_host_path(raw) == ref_cfs.expand_host_path(raw)
    assert port_cfs.expand_host_path("${NOPE:-/fallback}/a") == "/fallback/a"


def test_resolve_host_mount_source(tmp_path):
    d = tmp_path / "dir"
    d.mkdir()
    f = tmp_path / "file"
    f.write_text("x")
    for src in (str(d), str(tmp_path / "missing")):
        assert port_cfs.resolve_host_mount_source(src) == \
            ref_cfs.resolve_host_mount_source(src)
    with pytest.raises(port_cfs.StagingError) as got:
        port_cfs.resolve_host_mount_source(str(f))
    with pytest.raises(ref_cfs.StagingError) as want:
        ref_cfs.resolve_host_mount_source(str(f))
    assert str(got.value) == str(want.value)


def test_missing_source_soft_skips(tmp_path):
    raw = {"copy": [
        {"src": str(tmp_path / "nope" / "settings.json"),
         "dest": ".claude/settings.json"},
        {"src": str(tmp_path / "gone"), "dest": ".claude/agents"}]}
    assert _twin(raw) == ({}, b"")


def test_json_key_allowlist(tmp_path):
    src = tmp_path / "settings.json"
    src.write_text(json.dumps({"enabledPlugins": {"a": True},
                               "apiKey": "SECRET",
                               "hostPath": "/Users/someone"}))
    mirror, tar = _twin(_copy(src, ".claude/settings.json",
                              json_keys=["enabledPlugins"]))
    assert json.loads(mirror[".claude/settings.json"]) == \
        {"enabledPlugins": {"a": True}}
    assert b"SECRET" not in tar


def test_dir_copy_with_skip_and_rewrites(tmp_path, monkeypatch):
    plugins = tmp_path / "plugins"
    plugins.mkdir()
    monkeypatch.setenv("HOME", str(tmp_path))
    (plugins / "installed-plugins.json").write_text(json.dumps({
        "plugins": [{"installPath": f"{tmp_path}/.claude/plugins/x",
                     "projectPath": "/Users/someone/repo"}]}))
    (plugins / "install-counts-cache.json").write_text("{}")
    (plugins / "keep.txt").write_text("k")
    mirror, _ = _twin(_copy(plugins, ".claude/plugins",
                            skip=["install-counts-cache.json"],
                            json_rewrites=[
                                {"file": "installed-plugins.json",
                                 "key": "installPath",
                                 "rewrite": "prefix-swap"},
                                {"file": "installed-plugins.json",
                                 "key": "projectPath",
                                 "rewrite": "replace-with-workdir"}]))
    assert ".claude/plugins/install-counts-cache.json" not in mirror
    data = json.loads(mirror[".claude/plugins/installed-plugins.json"])
    assert data["plugins"][0] == {"installPath": f"{HOME}/.claude/plugins/x",
                                  "projectPath": WORK}


def test_workspace_guard(tmp_path):
    ws = tmp_path / "repo"
    ws.mkdir()
    (ws / "inside.txt").write_text("x")
    got = _twin(_copy(ws / "inside.txt", ".claude/x"), root=str(ws))
    assert got[0] == "StagingError" and "workspace" in got[1]


def test_glob_lands_each_match_under_dest(tmp_path):
    for n in ("a.md", "b.md"):
        (tmp_path / n).write_text(n)
    mirror, _ = _twin(_copy(tmp_path / "*.md", ".claude/docs"))
    assert [k for k in mirror if k.startswith(".claude/docs/")] == \
        [".claude/docs/a.md", ".claude/docs/b.md"]


@pytest.mark.parametrize("dest", ["../escape", "",
                                  ".claude/../../../../etc/evil", "..foo"])
def test_dest_must_be_home_relative(tmp_path, dest):
    f = tmp_path / "f"
    f.write_text("x")
    got = _twin(_copy(f, dest))
    if dest == "..foo":     # '..'-prefixed NAMES are legitimate
        assert got[0] == {"..foo": b"x"}
    else:
        assert got[0] == "StagingError"


def test_symlinks_never_dereferenced(tmp_path):
    secret = tmp_path / ".credentials.json"
    secret.write_text('{"token": "SECRET"}')
    plugins = tmp_path / "plugins"
    plugins.mkdir()
    (plugins / "creds").symlink_to(secret)
    (plugins / "ok.txt").write_text("fine")
    mirror, tar = _twin(_copy(plugins, ".claude/plugins"))
    assert ".claude/plugins/ok.txt" in mirror
    assert ".claude/plugins/creds" not in mirror and b"SECRET" not in tar


def test_empty_mirror_tar_is_empty(tmp_path):
    empty = tmp_path / "mirror"
    empty.mkdir()
    assert port_cfs.staging_tar(empty) == ref_cfs.staging_tar(empty) == b""


def test_staging_tar_extracts_at_home(tmp_path):
    staging = tmp_path / "mirror"
    (staging / ".claude").mkdir(parents=True)
    (staging / ".claude" / "CLAUDE.md").write_text("hi")
    tar = port_cfs.staging_tar(staging, uid=1001, gid=1002)
    assert tar == ref_cfs.staging_tar(staging, uid=1001, gid=1002)
    member = tarfile.open(fileobj=io.BytesIO(tar)).getmember(
        ".claude/CLAUDE.md")
    assert (member.uid, member.gid, member.mtime) == (1001, 1002, NOW)


@pytest.mark.parametrize("script", ["echo hi", ""])
def test_prepare_hook_tar_wraps_script(script):
    got = port_cfs.prepare_hook_tar("/bin/sh", script, "post-init")
    assert got == ref_cfs.prepare_hook_tar("/bin/sh", script, "post-init")
    body = tarfile.open(fileobj=io.BytesIO(got)).extractfile(
        ".clawker/post-init.sh").read().decode()
    assert body.startswith("#!/bin/sh\nset -e\n")


def _create(pkg: str, tmp_path: Path, monkeypatch, *, home: Path | None,
            settings: str = "") -> bytes | None:
    """One agent created through each package's ``AgentRuntime`` on its
    fake driver, HOME pinned; -> the archive delivered at the container
    home (None: nothing was)."""
    m = PKGS[pkg]
    monkeypatch.setenv("HOME", str(home or tmp_path / "no-home"))
    monkeypatch.delenv("CLAUDE_CONFIG_DIR", raising=False)
    m.orch.clear_harness_seed_cache()
    with TestEnv(base=tmp_path / pkg) as tenv:
        tenv.write_settings("host_proxy:\n  enable: false\n" + settings)
        proj = tenv.base / "proj"
        proj.mkdir()
        (proj / consts.PROJECT_FLAT_FORM).write_text("project: cfsproj\n")
        cfg = m.config.load_config(proj)
        drv = m.drivers.FakeDriver()
        drv.api.add_image("clawker-cfsproj:default")
        rt = m.orch.AgentRuntime(drv.engine(), cfg)
        cid = rt.create(m.orch.CreateOptions(agent="dev",
                                             workspace_mode="snapshot"))
        c = drv.api.containers[cid]
        assert c.state == "created"
        return c.archives.get(consts.CONTAINER_HOME)


def _host_home(tmp_path: Path) -> Path:
    home = tmp_path / "home"
    claude = home / ".claude"
    claude.mkdir(parents=True)
    (claude / "settings.json").write_text(json.dumps(
        {"enabledPlugins": {"p": True}, "apiKey": "SECRET"}))
    (claude / "CLAUDE.md").write_text("my global memory")
    (claude / ".credentials.json").write_text('{"access": "tok"}')
    return home


def _members(tar: bytes) -> dict:
    tf = tarfile.open(fileobj=io.BytesIO(tar))
    return {m.name: (tf.extractfile(m).read() if m.isfile() else None)
            for m in tf.getmembers()}


def test_create_seeds_config_volume_from_harness_staging(tmp_path,
                                                         monkeypatch):
    home = _host_home(tmp_path)
    want = _create("ref", tmp_path, monkeypatch, home=home)
    got = _create("port", tmp_path, monkeypatch, home=home)
    assert got == want
    files = _members(got)
    assert files[".claude/CLAUDE.md"] == b"my global memory"
    assert json.loads(files[".claude/settings.json"]) == \
        {"enabledPlugins": {"p": True}}
    assert ".claude/.credentials.json" not in files


def test_create_with_no_host_state_still_works(tmp_path, monkeypatch):
    assert _create("ref", tmp_path, monkeypatch, home=None) is None
    assert _create("port", tmp_path, monkeypatch, home=None) is None


def test_credentials_staged_only_on_opt_in(tmp_path, monkeypatch):
    home = _host_home(tmp_path)
    settings = "credentials:\n  stage: true\n"
    want = _create("ref", tmp_path, monkeypatch, home=home, settings=settings)
    got = _create("port", tmp_path, monkeypatch, home=home, settings=settings)
    assert got == want
    assert _members(got)[".claude/.credentials.json"] == b'{"access": "tok"}'
    raw = {"copy": [{"src": str(home / ".claude/CLAUDE.md"),
                     "dest": ".claude/CLAUDE.md"}],
           "credentials": [{"src": str(home / ".claude/.credentials.json"),
                            "dest": ".claude/.credentials.json"}]}
    without = _twin(raw, root=str(tmp_path / "proj"))[0]
    with_creds = _twin(raw, root=str(tmp_path / "proj"),
                       include_credentials=True)[0]
    assert ".claude/.credentials.json" not in without
    assert with_creds[".claude/.credentials.json"] == b'{"access": "tok"}'


def test_claude_manifest_declares_credentials_as_opt_in():
    got = (port_resolver.FLOOR_DIR / "harnesses/claude/harness.yaml")
    want = (ref_resolver.FLOOR_DIR / "harnesses/claude/harness.yaml")
    assert got.read_bytes() == want.read_bytes()
    st = port_cfs.Staging.from_raw(yaml.safe_load(got.read_text())["staging"])
    assert any(".credentials.json" in c.src for c in st.credentials)
    assert not any(".credentials.json" in c.src for c in st.copy)


def test_harness_seed_tar_is_cached_and_both_seeds_prefetch(tmp_path,
                                                           monkeypatch):
    """The second create of a (harness, root, credentials) key is a
    cache hit; ``prefetch_seeds`` warms it."""
    from clawker_tpu_torch.util import phases

    home = _host_home(tmp_path)
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("CLAUDE_CONFIG_DIR", raising=False)
    port_orch.clear_harness_seed_cache()
    with TestEnv(base=tmp_path / "env") as tenv:
        proj = tenv.base / "proj"
        proj.mkdir()
        (proj / consts.PROJECT_FLAT_FORM).write_text("project: cfsproj\n")
        cfg = port_config.load_config(proj)
        drv = port_drivers.FakeDriver()
        rt = port_orch.AgentRuntime(drv.engine(), cfg)
        phases.enable()
        try:
            rt.prefetch_seeds("claude", proj)
            tar = rt.harness_seed_tar("claude", proj)
            counts = phases.counts()
        finally:
            phases.disable()
    assert counts.get("harness_seed.tar_cache_miss") == 1
    assert counts.get("harness_seed.tar_cache_hit") == 1
    assert ".claude/CLAUDE.md" in _members(tar)


# ------------------------------------------------------- tests/test_bundler


def _cfg(m, tmp_path: Path, tag: str):
    tenv = TestEnv(base=tmp_path / tag)
    tenv.__enter__()
    tenv.make_project(tenv.base / "proj", "project: demo\nbuild:\n  stack: go\n")
    return tenv, m.config.load_config(tenv.base / "proj")


def _resolved(m, cfg, kind: str, name: str):
    try:
        c = m.resolver.Resolver(cfg).resolve(kind, name)
    except m.errors.NotFoundError as e:
        return "NotFoundError", str(e)
    return (c.name, c.tier, getattr(c, "cmd", None), c.validate())


def test_floor_assets_resolve(tmp_path):
    out = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        tenv, cfg = _cfg(m, tmp_path, pkg)
        try:
            r = m.resolver.Resolver(cfg)
            out[pkg] = (_resolved(m, cfg, "harness", "claude"),
                        _resolved(m, cfg, "harness", "nope"),
                        sorted(s.name for s in r.list("stack")),
                        [(c.name, c.tier) for c in r.list("monitoring")])
        finally:
            tenv.__exit__(None, None, None)
    assert out["port"] == out["ref"]
    assert out["port"][0][:3] == ("claude", "floor", ["claude"])
    assert set(out["port"][2]) >= {"python", "go", "node", "rust", "cpp",
                                   "java", "ruby", "dotnet"}
    assert port_bundle.Resolver is port_resolver.Resolver


def test_installed_bundle_shadows_floor(tmp_path):
    """An installed bundle (the layout ``bundle install`` leaves under
    the data dir) shadows the floor, and the floor returns once it
    goes."""
    out = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        tenv, cfg = _cfg(m, tmp_path, pkg)
        try:
            hdir = cfg.bundles_dir / "local" / "mybundle" / "harnesses" / "claude"
            hdir.mkdir(parents=True)
            (hdir / "harness.yaml").write_text("name: claude\ncmd: [my-claude]\n")
            shadowed = _resolved(m, cfg, "harness", "claude")
            shutil.rmtree(cfg.bundles_dir / "local" / "mybundle")
            out[pkg] = (shadowed, _resolved(m, cfg, "harness", "claude"))
        finally:
            tenv.__exit__(None, None, None)
    assert out["port"] == out["ref"]
    assert out["port"][0][:3] == ("claude", "installed", ["my-claude"])
    assert out["port"][1][:3] == ("claude", "floor", ["claude"])


def test_loose_harness_with_escaping_file(tmp_path):
    """A loose-tier harness whose ``files`` climbs out of its bundle
    resolves the same in both packages and fails validation the same
    way (the reference's image build then refuses it as escaping)."""
    out = {}
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        tenv, cfg = _cfg(m, tmp_path, pkg)
        try:
            hdir = (cfg.project_root / ".clawker" / "bundles" / "esc"
                    / "harnesses" / "h")
            hdir.mkdir(parents=True)
            (hdir / "harness.yaml").write_text(
                "name: h\ncmd: [h]\nfiles: ['../../../secret.txt']\n")
            (tmp_path / "secret.txt").write_text("s3cret")
            h = m.resolver.Resolver(cfg).harness("h")
            out[pkg] = (h.tier, h.files, h.validate(),
                        str(h.source_dir.relative_to(cfg.project_root)))
        finally:
            tenv.__exit__(None, None, None)
    assert out["port"] == out["ref"]
    assert out["port"][0] == "loose"
    assert out["port"][2] == ["harness h: missing file ../../../secret.txt"]
