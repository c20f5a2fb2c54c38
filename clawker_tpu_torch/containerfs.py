"""Host harness-config staging for container injection.

Interprets a harness bundle's ``staging`` manifest -- explicit
host->container copy directives (glob-capable src, optional JSON key
allowlist, per-file skips, JSON path rewrites) -- into a temp staging
mirror that callers pack into the per-agent config volume.  Only host
state OUTSIDE the workspace is staged; the workspace arrives via mount.
Credentials are never copied from the host: the user authenticates in
the container and the token family persists in the config volume.

Degradation contract: a missing host source (no ~/.claude, no keyring,
fresh machine) is a debug-logged soft skip, never an error -- an agent
must start on a host with zero harness state.

Leaf module: imports stdlib + logsetup only.

Parity reference: internal/containerfs/containerfs.go
(ResolveHostMountSource :41, PrepareConfig :64, stageCopy :94,
guardWorkspaceSrc :185, filterJSONKeys :321, rewriteJSONPaths :450) --
semantics re-derived.

The port's copy of ``clawker_tpu/containerfs.py``, whole.
"""

from __future__ import annotations

import glob as _glob
import io
import json
import os
import re
import shutil
import tarfile
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

from . import logsetup

log = logsetup.get("containerfs")

_VAR_DEFAULT = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)(?::-([^}]*))?\}")


class StagingError(ValueError):
    pass


@dataclass
class JsonRewrite:
    """One JSON path rewrite applied to a named file in a copied tree.

    ``rewrite`` tokens: ``prefix-swap`` (host home prefix -> container
    home prefix) and ``replace-with-workdir`` (entire value -> the
    container workdir)."""

    file: str = ""
    key: str = ""
    rewrite: str = "prefix-swap"


@dataclass
class CopySpec:
    src: str = ""
    dest: str = ""
    json_keys: list[str] = field(default_factory=list)
    skip: list[str] = field(default_factory=list)
    json_rewrites: list[JsonRewrite] = field(default_factory=list)


@dataclass
class Staging:
    copy: list[CopySpec] = field(default_factory=list)
    # declared credential material (keyring-backed files).  NEVER staged
    # by default: only when settings ``credentials.stage`` opts in
    # (reference internal/containerfs stages its keyring path
    # unconditionally -- the opt-in is this framework's divergence;
    # see README "Credential staging")
    credentials: list[CopySpec] = field(default_factory=list)

    @classmethod
    def from_raw(cls, raw: dict | None) -> "Staging":
        out = cls()
        for section, target in (("copy", out.copy),
                                ("credentials", out.credentials)):
            for c in (raw or {}).get(section) or []:
                if not isinstance(c, dict):
                    raise StagingError(
                        f"staging.{section} entry must be a mapping: {c!r}")
                target.append(CopySpec(
                    src=str(c.get("src") or ""),
                    dest=str(c.get("dest") or ""),
                    json_keys=[str(k) for k in c.get("json_keys") or []],
                    skip=[str(s) for s in c.get("skip") or []],
                    json_rewrites=[JsonRewrite(
                        file=str(r.get("file") or ""),
                        key=str(r.get("key") or ""),
                        rewrite=str(r.get("rewrite") or "prefix-swap"))
                        for r in c.get("json_rewrites") or []],
                ))
        return out


# ------------------------------------------------------------- expansion

def expand_host_path(src: str) -> str:
    """``~``, ``$VAR``, and shell-style ``${VAR:-fallback}``."""
    def sub(m: re.Match) -> str:
        val = os.environ.get(m.group(1))
        if val:
            return val
        return m.group(2) if m.group(2) is not None else ""

    expanded = _VAR_DEFAULT.sub(sub, src)
    expanded = os.path.expandvars(expanded)
    return os.path.expanduser(expanded)


def resolve_host_mount_source(src: str) -> tuple[str, bool]:
    """Expand a manifest mount src and stat it.  (path, False) when the
    directory is absent -- callers soft-skip the bind; a path that exists
    but is not a directory errors."""
    path = expand_host_path(src)
    if not os.path.exists(path):
        return "", False
    if not os.path.isdir(path):
        raise StagingError(f"{path} exists but is not a directory")
    return path, True


# --------------------------------------------------------------- staging

def prepare_config(staging: Staging, *, container_home: str,
                   container_work: str, host_project_root: str,
                   include_credentials: bool = False) -> tuple[Path, "callable"]:
    """Run every copy directive into a temp staging mirror.  Returns
    (staging_dir, cleanup); the staged layout mirrors the container home:
    each directive lands at ``<dir>/<dest>``.

    ``include_credentials`` additionally stages the manifest's declared
    credential material -- the settings-gated opt-in (credentials.stage)
    that makes ``loop --parallel N`` start N authenticated agents
    without N manual logins."""
    tmp = Path(tempfile.mkdtemp(prefix="clawker-config-"))

    def cleanup() -> None:
        shutil.rmtree(tmp, ignore_errors=True)

    specs = list(staging.copy)
    if include_credentials:
        specs += staging.credentials
    try:
        for c in specs:
            _stage_copy(c, tmp, container_home=container_home,
                        container_work=container_work,
                        host_project_root=host_project_root)
    except Exception:
        cleanup()
        raise
    return tmp, cleanup


def _stage_copy(c: CopySpec, root: Path, *, container_home: str,
                container_work: str, host_project_root: str) -> None:
    pattern = expand_host_path(c.src)
    globbed = _glob.has_magic(pattern)
    matches = sorted(_glob.glob(pattern, recursive=True)) if globbed else (
        [pattern] if os.path.exists(pattern) else [])
    if not matches:
        log.debug("staging source %s not found on host, skipping", pattern)
        return

    dest_rel = c.dest.strip("/")
    if not dest_rel or ".." in Path(dest_rel).parts:
        # interior '..' segments would escape the staging mirror and
        # write arbitrary host paths -- a third-party loose-tier harness
        # bundle must not get that power
        raise StagingError(f"staging dest {c.dest!r} must be home-relative")
    dest_is_dir = globbed or len(matches) > 1 or c.dest.endswith("/")

    for match in matches:
        _guard_workspace_src(match, host_project_root)
        dst = root / dest_rel
        if dest_is_dir:
            dst = dst / os.path.basename(match)
        if os.path.isdir(match):
            _copy_tree(match, dst, skip=c.skip)
            _apply_rewrites(dst, c.json_rewrites,
                            container_home=container_home,
                            container_work=container_work)
        else:
            dst.parent.mkdir(parents=True, exist_ok=True)
            if c.json_keys:
                body = _filter_json_keys(match, c.json_keys)
                if body is None:
                    continue  # unparseable json: skip, never stage secrets
                dst.write_bytes(body)
            else:
                shutil.copyfile(match, dst)


def _guard_workspace_src(src: str, host_project_root: str) -> None:
    """The workspace is mounted, never staged -- staging it would fork
    the live tree into a stale volume copy."""
    if not host_project_root:
        return
    try:
        real_src = os.path.realpath(src)
        real_root = os.path.realpath(host_project_root)
        if real_src == real_root or real_src.startswith(real_root + os.sep):
            raise StagingError(
                f"staging src {src} is inside the project workspace "
                f"({host_project_root}); the workspace arrives via mount")
    except OSError:
        pass


def _filter_json_keys(path: str, keys: list[str]) -> bytes | None:
    """Allowlist: only the listed top-level keys survive (e.g. the claude
    bundle stages only enabledPlugins from settings.json -- the rest can
    hold secrets and host-specific state)."""
    try:
        data = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        log.warning("staging: unreadable json %s (%s); skipped", path, e)
        return None
    if not isinstance(data, dict):
        return None
    kept = {k: v for k, v in data.items() if k in keys}
    return json.dumps(kept, indent=2, sort_keys=True).encode()


def _copy_tree(src: str, dst: Path, *, skip: list[str]) -> None:
    dst.mkdir(parents=True, exist_ok=True)
    for entry in sorted(os.listdir(src)):
        if entry in skip:
            continue
        s = os.path.join(src, entry)
        d = dst / entry
        if os.path.islink(s):
            # never dereference: a staged tree (e.g. a third-party plugin
            # repo) could link to credentials or anything on the host --
            # following it would violate the never-stage-secrets contract
            log.warning("staging: symlink %s skipped (links are never "
                        "dereferenced into the container)", s)
            continue
        if os.path.isdir(s):
            _copy_tree(s, d, skip=skip)
        else:
            shutil.copyfile(s, d)


def _apply_rewrites(tree: Path, rules: list[JsonRewrite], *,
                    container_home: str, container_work: str) -> None:
    by_file: dict[str, list[JsonRewrite]] = {}
    for r in rules:
        by_file.setdefault(r.file, []).append(r)
    if not by_file:
        return
    host_home = os.path.expanduser("~")
    for path in tree.rglob("*.json"):
        rules_here = by_file.get(path.name)
        if not rules_here:
            continue
        try:
            data = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        changed = _rewrite_json(data, rules_here, host_home=host_home,
                                container_home=container_home,
                                container_work=container_work)
        if changed:
            path.write_text(json.dumps(data, indent=2, sort_keys=True))


def _rewrite_json(v, rules: list[JsonRewrite], *, host_home: str,
                  container_home: str, container_work: str) -> bool:
    """Recursive key-targeted value rewrite (reference rewriteJSONPaths)."""
    changed = False
    if isinstance(v, dict):
        for key, val in v.items():
            for r in rules:
                if key != r.key or not isinstance(val, str):
                    continue
                if r.rewrite == "replace-with-workdir":
                    v[key] = container_work
                    changed = True
                elif r.rewrite == "prefix-swap" and val.startswith(host_home):
                    v[key] = container_home + val[len(host_home):]
                    changed = True
            if isinstance(val, (dict, list)):
                changed |= _rewrite_json(val, rules, host_home=host_home,
                                         container_home=container_home,
                                         container_work=container_work)
    elif isinstance(v, list):
        for item in v:
            changed |= _rewrite_json(item, rules, host_home=host_home,
                                     container_home=container_home,
                                     container_work=container_work)
    return changed


# --------------------------------------------------------------- packing

def staging_tar(staging_dir: Path, *, uid: int = 1000, gid: int = 1000) -> bytes:
    """Pack the staging mirror as a tar extracting at the container home.
    An empty mirror returns b"" so callers can skip the daemon round-trip
    entirely (the fresh-host no-op contract)."""
    if not any(staging_dir.rglob("*")):
        return b""
    buf = io.BytesIO()
    now = int(time.time())
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for path in sorted(staging_dir.rglob("*")):
            rel = str(path.relative_to(staging_dir))
            info = tarfile.TarInfo(rel)
            info.uid, info.gid = uid, gid
            info.mtime = now
            if path.is_dir():
                info.type = tarfile.DIRTYPE
                info.mode = 0o755
                tf.addfile(info)
            else:
                body = path.read_bytes()
                info.size = len(body)
                info.mode = 0o644
                tf.addfile(info, io.BytesIO(body))
    return buf.getvalue()


def prepare_hook_tar(shell: str, script: str, name: str, *,
                     uid: int = 1000, gid: int = 1000) -> bytes:
    """Tar with ``.clawker/<name>.sh`` (shebang + ``set -e`` + script,
    0755) extracting at the container home.  Empty script -> bare no-op
    wrapper, so callers can always-deliver and overwrite stale content."""
    body = f"#!{shell}\nset -e\n{script.strip()}\n".encode()
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        d = tarfile.TarInfo(".clawker")
        d.type = tarfile.DIRTYPE
        d.mode = 0o755
        d.uid, d.gid = uid, gid
        tf.addfile(d)
        info = tarfile.TarInfo(f".clawker/{name}.sh")
        info.size = len(body)
        info.mode = 0o755
        info.uid, info.gid = uid, gid
        tf.addfile(info, io.BytesIO(body))
    return buf.getvalue()
