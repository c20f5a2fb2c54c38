"""The port's everyday verbs against the reference's, on the CPU.

Twins of every test of tests/test_cli.py and of tests/test_cli_extras.py
but ``gen_docs`` (twinned in tests/test_torch_cli_leftovers.py): each flow runs through ``clawker_tpu.cli.root.cli``
with the reference's ``Factory(cwd, driver=FakeDriver())`` and through
``clawker_tpu_torch.cli.cli`` with the port's, each package under its
own ``TestEnv`` (so the settings, aliases and registry files of one
never meet the other's), and the outputs, exit codes and files are
compared after normalising container ids, paths and timestamps.  Then:
dotenv parsing over a table of inputs, alias dispatch, the root's exit
codes (``Abort`` 130, ``FlagError`` a usage error), the worktree verbs
with ``prune``, the verb that is refused by name beside the control
plane's verbs that no longer are, and the ``logs``
route of the port's ``FakeEngineDaemon``.  The host proxy is off but in
the one twin that checks its mapping.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import yaml
from click.testing import CliRunner

import clawker_tpu.cli.cmd_init as ref_cmd_init
import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.consts as ref_consts
import clawker_tpu.controlplane.manager as ref_manager
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.errors as ref_errors
import clawker_tpu.firewall.pki as ref_pki
import clawker_tpu.hostproxy.manager as ref_proxy
import clawker_tpu.testenv as ref_testenv
import clawker_tpu.ui.iostreams as ref_iostreams
import clawker_tpu.util.dotenv as ref_dotenv
import clawker_tpu.util.xdg as ref_xdg
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.cli.cmd_init as port_cmd_init
import clawker_tpu_torch.consts as port_consts
import clawker_tpu_torch.controlplane.manager as port_manager
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.errors as port_errors
import clawker_tpu_torch.firewall.pki as port_pki
import clawker_tpu_torch.hostproxy.manager as port_proxy
import clawker_tpu_torch.testenv as port_testenv
import clawker_tpu_torch.ui.iostreams as port_iostreams
import clawker_tpu_torch.util.dotenv as port_dotenv
import clawker_tpu_torch.util.xdg as port_xdg

PKGS = {
    "ref": SimpleNamespace(
        pkg="ref", cli=ref_root.cli, main=ref_root.main,
        Factory=ref_factory.Factory, drivers=ref_drivers, fake=ref_fake,
        consts=ref_consts, errors=ref_errors, pki=ref_pki, proxy=ref_proxy,
        testenv=ref_testenv, iostreams=ref_iostreams, dotenv=ref_dotenv,
        xdg=ref_xdg, cmd_init=ref_cmd_init, manager=ref_manager),
    "port": SimpleNamespace(
        pkg="port", cli=port_cli.cli, main=port_cli.main,
        Factory=port_cli.Factory, drivers=port_drivers, fake=port_fake,
        consts=port_consts, errors=port_errors, pki=port_pki,
        proxy=port_proxy, testenv=port_testenv, iostreams=port_iostreams,
        dotenv=port_dotenv, xdg=port_xdg, cmd_init=port_cmd_init,
        manager=port_manager),
}
PROJECT = "demo"
IMAGE = f"clawker-{PROJECT}:default"
PROXY_OFF = "host_proxy:\n  enable: false\n"


def init_repo(root: Path) -> None:
    subprocess.run(["git", "init", "-q", str(root)], check=True)
    subprocess.run(
        ["git", "-C", str(root), "-c", "user.email=t@t", "-c", "user.name=t",
         "commit", "--allow-empty", "-q", "-m", "init"], check=True)


@contextlib.contextmanager
def side(pkg: str, tmp_path: Path, *, git: bool = False,
         settings: str = PROXY_OFF, project: str | None = PROJECT):
    """One package's environment: its own ``TestEnv`` under
    ``tmp_path/pkg``, a project dir (a git repository with one commit
    when ``git``), a ``FakeDriver`` holding the project image, and one
    ``Factory`` over it -> namespace with ``m``, ``tenv``, ``proj``,
    ``drv``, ``api``, ``factory``."""
    m = PKGS[pkg]
    with m.testenv.TestEnv(base=tmp_path / pkg) as tenv:
        tenv.write_settings(settings)
        proj = tenv.base / "proj"
        proj.mkdir()
        if git:
            init_repo(proj)
        if project is not None:
            tenv.make_project(proj, f"project: {project}\n")
        drv = m.drivers.FakeDriver()
        drv.api.add_image(IMAGE)
        yield SimpleNamespace(m=m, tenv=tenv, proj=proj, drv=drv, api=drv.api,
                              factory=m.Factory(cwd=proj, driver=drv))


def twin(tmp_path: Path, scenario, **kw):
    """``scenario(side)`` on the reference, then on the port: ->
    (reference's result, port's)."""
    out = []
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path, **kw) as s:
            out.append(scenario(s))
    return tuple(out)


def invoke(s, *args, fresh: bool = False, input=None, catch: bool = True):
    """The package's root group over ``args``: -> (exit code, normalised
    output).  ``fresh`` builds a new Factory over the side's driver, as
    tests/test_cli_extras.py does for each call."""
    obj = s.m.Factory(cwd=s.proj, driver=s.drv) if fresh else s.factory
    res = CliRunner().invoke(s.m.cli, list(args), obj=obj, input=input,
                             catch_exceptions=catch)
    if res.exception is not None and not isinstance(res.exception, SystemExit):
        raise res.exception
    return res.exit_code, norm(s, res.output)


_HEX_ID = re.compile(r"\b[0-9a-f]{12,64}\b")
_STAMP = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?(Z|[+-]\d\d:\d\d)?")


def norm(s, text: str) -> str:
    text = text.replace(str(s.tenv.base), "<BASE>")
    text = _HEX_ID.sub("<ID>", text)
    return _STAMP.sub("<TS>", text)


def norm_doc(s, doc):
    return json.loads(norm(s, json.dumps(doc, sort_keys=True)))


# --------------------------------------------------- tests/test_cli.py


def test_run_attaches_and_propagates_exit(tmp_path):
    def scenario(s):
        s.api.set_behavior(IMAGE, s.m.fake.exit_behavior(b"agent says hi\n",
                                                         code=0))
        return invoke(s, "run", "--agent", "dev")

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == 0 and "agent says hi" in got[1]


def test_run_nonzero_exit_code(tmp_path):
    def scenario(s):
        s.api.set_behavior(IMAGE, s.m.fake.exit_behavior(code=3))
        return invoke(s, "run")

    want, got = twin(tmp_path, scenario)
    assert got == want and got[0] == 3


def test_run_detach_then_ps_stop_rm(tmp_path):
    def scenario(s):
        return [invoke(s, *argv) for argv in (
            ["run", "--detach"], ["ps"], ["stop", "dev"], ["rm", "dev"],
            ["ps"])]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert all(code == 0 for code, _ in got)
    assert "clawker.demo.dev" in got[0][1]
    assert "clawker.demo.dev" in got[1][1] and "running" in got[1][1]
    assert "no agent containers" in got[4][1]


def test_run_missing_project_image(tmp_path):
    def scenario(s):
        del s.api.images[IMAGE]
        return invoke(s, "run")

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == 1 and "clawker build" in got[1]


def test_container_create_and_inspect(tmp_path):
    def scenario(s):
        created = invoke(s, "container", "create", "--agent", "aux")
        code, out = invoke(s, "container", "inspect", "aux")
        return created, code, json.loads(out)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0][0] == 0 and got[1] == 0
    assert got[2]["Name"].lstrip("/") == "clawker.demo.aux"


def test_run_env_flag(tmp_path):
    def scenario(s):
        invoke(s, "run", "--detach", "-e", "FOO=bar")
        return norm_doc(s, list(s.api.containers.values())[0].config["Env"])

    want, got = twin(tmp_path, scenario)
    assert got == want and "FOO=bar" in got


def test_init_scaffold(tmp_path):
    def scenario(s):
        first = invoke(s, "init", "--name", "myproj")
        text = (s.proj / s.m.consts.PROJECT_FLAT_FORM).read_text()
        return first, text, invoke(s, "init")

    want, got = twin(tmp_path, scenario, project=None)
    assert got == want
    assert got[0][0] == 0 and "project: myproj" in got[1]
    assert got[2][0] != 0 and "already exists" in got[2][1]


def test_init_wizard_drives_choices(tmp_path):
    """The wizard over a scripted TTY session (name, stack, harness,
    mode): the same answers and the same prompts in both packages."""
    def scenario(s):
        streams, _, _, err = s.m.iostreams.IOStreams.test(
            stdin_data="wiz proj\n\n\n2\n")
        for stream in (streams.stdin, streams.stdout, streams.stderr):
            stream.isatty = lambda: True
        s.factory.__dict__["streams"] = streams
        return s.m.cmd_init._wizard(s.factory, "", "python"), err.getvalue()

    want, got = twin(tmp_path, scenario, project=None)
    assert got == want
    assert got[0] == ("wiz-proj", "python", "claude", "snapshot")


def test_volume_ls_after_run(tmp_path):
    def scenario(s):
        invoke(s, "run", "--detach")
        return invoke(s, "volume", "ls")

    want, got = twin(tmp_path, scenario)
    assert got == want and "clawker.demo.dev.config" in got[1]


def test_worktree_add_list_remove(tmp_path):
    def scenario(s):
        return [invoke(s, "worktree", *argv) for argv in (
            ["add", "feat1"], ["list"], ["remove", "feat1"], ["list"])]

    want, got = twin(tmp_path, scenario, git=True)
    assert got == want
    assert [code for code, _ in got] == [0, 0, 0, 0]
    assert "clawker/feat1" in got[0][1] and "feat1" in got[1][1]
    assert "feat1" not in got[3][1]


def test_worktree_remove_dirty_requires_force(tmp_path):
    def scenario(s):
        code, out = invoke(s, "worktree", "add", "feat2")
        path = Path(out.split("\t")[1].strip().replace("<BASE>",
                                                       str(s.tenv.base)))
        (path / "junk.txt").write_text("dirty")
        return [(code, out), invoke(s, "worktree", "remove", "feat2"),
                invoke(s, "worktree", "remove", "feat2", "--force"),
                path.exists()]

    want, got = twin(tmp_path, scenario, git=True)
    assert got == want
    assert got[1][0] == 1 and "local changes" in got[1][1]
    assert got[2][0] == 0 and got[3] is False


def test_run_in_worktree_mounts(tmp_path):
    def scenario(s):
        invoke(s, "worktree", "add", "feat3")
        res = invoke(s, "run", "--detach", "--worktree", "feat3")
        c = list(s.api.containers.values())[0]
        return res, norm_doc(s, c.config["HostConfig"]["Binds"])

    want, got = twin(tmp_path, scenario, git=True)
    assert got == want
    res, binds = got
    assert res[0] == 0
    assert any("worktrees/demo/feat3:/workspace" in b for b in binds)
    assert any(b.endswith(":ro") and "/.git" in b for b in binds)


def test_project_register_and_list(tmp_path):
    def scenario(s):
        return (invoke(s, "project", "register"),
                invoke(s, "project", "list"),
                invoke(s, "project", "list", "--format", "json"))

    want, got = twin(tmp_path, scenario, git=True)
    assert got == want
    assert got[0][0] == 0 and "demo" in got[1][1]


def test_stop_long_agent_name_resolves_to_project(tmp_path):
    agent = "experiment-long-context-window-ablation-a"

    def scenario(s):
        return [invoke(s, *argv) for argv in (
            ["run", "--detach", "--agent", agent], ["stop", agent],
            ["ps", "--running"], ["ps"])]

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0][0] == 0 and got[1][0] == 0
    assert "no agent containers" in got[2][1] and agent in got[3][1]


def test_create_wires_socket_and_hostproxy_mapping(tmp_path):
    """The host proxy on (its own free port a package, stopped after):
    the host-gateway mapping and no docker socket mount."""
    def scenario(s):
        try:
            res = invoke(s, "run", "--detach")
        finally:
            s.m.proxy.stop(s.factory.config)
        hc = list(s.api.containers.values())[0].config["HostConfig"]
        return res, hc.get("ExtraHosts"), norm_doc(s, hc["Binds"])

    want, got = twin(tmp_path, scenario,
                     settings=f"host_proxy:\n  port: {_free_port()}\n")
    assert got == want
    assert got[0][0] == 0
    assert got[1] == ["host.docker.internal:host-gateway"]
    assert not any("docker.sock" in b for b in got[2])


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# -------------------------------------------- tests/test_cli_extras.py


def test_network_verbs(tmp_path):
    def scenario(s):
        name = s.m.consts.NETWORK_NAME
        out = [invoke(s, "network", "ensure", fresh=True),
               invoke(s, "network", "ls", fresh=True)]
        code, text = invoke(s, "network", "inspect", name, fresh=True)
        out.append((code, json.loads(text)["Name"]))
        out.append(invoke(s, "network", "rm", name, fresh=True))
        out.append(invoke(s, "network", "ls", fresh=True))
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert port_consts.NETWORK_NAME in got[0][1]
    assert port_consts.NETWORK_NAME in got[1][1]
    assert got[2] == (0, port_consts.NETWORK_NAME) and got[3][0] == 0
    assert port_consts.NETWORK_NAME not in got[4][1]


def test_settings_get_set_list(tmp_path):
    def scenario(s):
        out = [invoke(s, "settings", "get", "firewall.enable", fresh=True),
               invoke(s, "settings", "set", "firewall.enable", "true",
                      fresh=True),
               invoke(s, "settings", "get", "firewall.enable", fresh=True),
               invoke(s, "settings", "list", fresh=True),
               invoke(s, "settings", "get", "no.such.key", fresh=True),
               invoke(s, "settings", "get", "monitoring", fresh=True),
               invoke(s, "settings", "set", "firewall.enable", "no",
                      fresh=True),
               invoke(s, "settings", "set", "host_proxy.port", "abc",
                      fresh=True)]
        settings = (s.tenv.config / "settings.yaml").read_bytes()
        return out, settings

    want, got = twin(tmp_path, scenario)
    assert got == want
    out, settings = got
    assert out[0] == (0, "false\n") and out[1][0] == 0
    assert out[2] == (0, "true\n") and "firewall" in out[3][1]
    assert out[4][0] != 0
    assert out[5][0] == 0 and "opensearch_port" in out[5][1]
    assert out[6][0] != 0 and "boolean" in out[6][1]
    assert out[7][0] != 0
    assert b"firewall:\n  enable: true" in settings


def test_auth_status_and_rotate(tmp_path):
    def scenario(s):
        out = [invoke(s, "auth", "status", fresh=True)]
        pki_dir = s.factory.config.pki_dir
        ca1 = s.m.pki.ensure_ca(pki_dir)
        code, text = invoke(s, "auth", "status", fresh=True)
        out.append((code, text.splitlines()[0]))
        out.append(invoke(s, "auth", "rotate", input="y\n", fresh=True))
        ca2 = s.m.pki.ensure_ca(pki_dir)
        return out, ca1.cert_pem != ca2.cert_pem

    want, got = twin(tmp_path, scenario)
    assert got == want
    out, rotated = got
    assert "not initialized" in out[0][1] and "CA:" in out[1][1]
    assert out[2][0] == 0 and rotated


def test_version_cmd(tmp_path):
    want, got = twin(tmp_path, lambda s: (invoke(s, "version", fresh=True),
                                          invoke(s, "--version", fresh=True)))
    assert got == want
    assert port_consts.PRODUCT in got[0][1] and "0.2.0" in got[0][1]
    assert got[1] == (0, "clawker, version 0.2.0\n")


def test_alias_set_expand_dispatch(tmp_path):
    def scenario(s):
        out = [invoke(s, "alias", "set", "st", "settings list", fresh=True),
               invoke(s, "alias", "ls", fresh=True),
               invoke(s, "st", fresh=True)]
        aliases = (s.tenv.config / "aliases.yaml").read_bytes()
        out += [invoke(s, "alias", "rm", "st", fresh=True),
                invoke(s, "st", fresh=True)]
        return out, aliases

    want, got = twin(tmp_path, scenario)
    assert got == want
    out, aliases = got
    assert out[0][0] == 0 and "st\tsettings list" in out[1][1]
    assert out[2][0] == 0 and out[3][0] == 0 and out[4][0] != 0
    assert aliases == b"st: settings list\n"


def test_alias_with_flags_and_args(tmp_path):
    def scenario(s):
        invoke(s, "alias", "set", "fg", "settings get", fresh=True)
        invoke(s, "alias", "set", "sl", "settings list", fresh=True)
        invoke(s, "alias", "set", "ps2", "ps --running --format json",
               fresh=True)
        invoke(s, "run", "--detach", "--agent", "a1")
        return (invoke(s, "fg", "firewall.enable", fresh=True),
                invoke(s, "sl", fresh=True)[0],
                invoke(s, "ps2"),
                (s.tenv.config / "aliases.yaml").read_bytes())

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0] == (0, "false\n") and got[1] == 0
    rows = json.loads(got[2][1])
    assert [r["name"] for r in rows] == ["clawker.demo.a1"]


def test_corrupt_aliases_file_never_crashes_dispatch(tmp_path):
    def scenario(s):
        path = s.m.xdg.config_dir() / "aliases.yaml"
        path.write_text("- just\n- a list\n")
        out = [invoke(s, "definitely-not-a-command", fresh=True)]
        path.write_text("st: [settings, list]\n")
        out.append(invoke(s, "st", fresh=True))
        path.write_text("st: [unclosed\n")
        out.append(invoke(s, "st", fresh=True))
        return out

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert all(code == 2 for code, _ in got)
    assert "No such command" in got[0][1]


def test_harness_and_stack_ls(tmp_path):
    want, got = twin(tmp_path, lambda s: (invoke(s, "harness", "ls"),
                                          invoke(s, "stack", "ls")))
    assert got == want
    assert "claude" in got[0][1] and "codex" in got[0][1]
    assert all(st in got[1][1] for st in ("python", "go", "node", "rust"))


# ----------------------------------------------------- prompter and init


PROMPTS = [
    ("string", "answer\n", ("Project name",), {"default": "d"}),
    ("string", "\n", ("Project name",), {"default": "d"}),
    ("confirm", "\n", ("Remove x?",), {"default": True}),
    ("confirm", "maybe\nyes\n", ("Remove x?",), {}),
    ("confirm", "N\n", ("Remove x?",), {"default": True}),
    ("select", "9\nzero\n2\n", ("Pick", ["a", "b", "c"]), {"default": 1}),
    ("select", "\n", ("Pick", ["a", "b"]), {"default": 1}),
    ("select", "1\n", ("Pick", []), {}),
    ("string", "", ("Name",), {}),
]


@pytest.mark.parametrize("tty", [True, False])
@pytest.mark.parametrize("case", range(len(PROMPTS)))
def test_prompter_matches_reference(case, tty):
    """``string``/``confirm``/``select`` over scripted streams: the same
    answers, prompts and ``PromptError`` texts (off a terminal every
    prompt refuses; EOF mid-prompt refuses)."""
    method, stdin, args, kw = PROMPTS[case]

    def ask(m):
        streams, _, _, err = m.iostreams.IOStreams.test(stdin_data=stdin)
        if tty:
            for stream in (streams.stdin, streams.stdout, streams.stderr):
                stream.isatty = lambda: True
        prompter = m.Factory(cwd=Path("."), driver=object()).prompter
        prompter.streams = streams
        try:
            got = getattr(prompter, method)(*args, **kw)
        except m.errors.ClawkerError as e:
            got = (type(e).__name__, str(e))
        return got, err.getvalue()

    assert ask(PKGS["port"]) == ask(PKGS["ref"])


@pytest.mark.parametrize("raw", ["My Project", "  --x__", "ÄÖ!!", "", "a.b/c",
                                 "already-ok_1"])
def test_init_slug_matches_reference(raw):
    assert port_cmd_init._slug(raw) == ref_cmd_init._slug(raw)


# -------------------------------------------------------------- dotenv


DOTENV_CASES = [
    ("plain", "A=1\nB=two\n"),
    ("export", "export A=1\nexport  B = spaced \n"),
    ("comments", "# head\n\nA=1 # trailing\nB=#not-a-comment\n"),
    ("double quotes", 'A="hello world"\nB="tab\\there"\n'),
    ("escapes", 'A="line\\nbreak"\nB="q\\"uote"\nC="back\\\\slash"\n'),
    ("single quotes", "A='$HOME \\n literal'\n"),
    ("expand bare", "A=base\nB=$A/x\n"),
    ("expand braced", "A=base\nB=${A}x\n"),
    ("expand from env", "B=${DOTENV_TWIN_ENV}-y\n"),
    ("unknown var", "B=$NOT_SET_ANYWHERE-z\n"),
    ("escaped dollar", 'A="pa\\$\\$wd"\nB="$A"\n'),
    ("dotted key", "a.b_c=1\n"),
    ("empty value", "A=\nB=''\nC=\"\"\n"),
    ("hash value", "A=#\nB=x#y\n"),
    ("crlf", "A=1\r\nB=2\r\n"),
    ("later wins", "A=1\nA=2\n"),
    ("expanded escapes kept", 'A="\\\\n"\nB="$A"\n'),
    ("not key value", "A=1\njust words\n"),
    ("bad key", "1A=x\n"),
    ("unterminated double", 'A="open\n'),
    ("unterminated single", "A='open\n"),
]


@pytest.mark.parametrize("text", [c[1] for c in DOTENV_CASES],
                         ids=[c[0] for c in DOTENV_CASES])
def test_dotenv_parse_matches_reference(text):
    lookup = {"DOTENV_TWIN_ENV": "from-env"}.get

    def parse(m):
        try:
            return "ok", m.dotenv.parse(text, lookup=lookup, source="t.env")
        except m.errors.ClawkerError as e:
            return type(e).__name__, str(e)

    want, got = parse(PKGS["ref"]), parse(PKGS["port"])
    assert got == want


def test_env_file_flags_reach_the_container(tmp_path):
    """``--env-file`` files in order, ``--env`` wins; a bad file is a
    one-line error."""
    def scenario(s):
        (s.proj / "a.env").write_text("A=1\nB=from-a\nexport C=\"x y\"\n")
        (s.proj / "b.env").write_text("B=from-b\nD=${A}-d\n")
        (s.proj / "bad.env").write_text("A=\"open\n")
        res = invoke(s, "run", "--detach", "--env-file", str(s.proj / "a.env"),
                     "--env-file", str(s.proj / "b.env"), "-e", "D=flag")
        env = list(s.api.containers.values())[0].config["Env"]
        bad = invoke(s, "run", "--detach", "--agent", "x", "--env-file",
                     str(s.proj / "bad.env"))
        return res, sorted(e for e in env if e[:2] in ("A=", "B=", "C=", "D=")), bad

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[1] == ["A=1", "B=from-b", "C=x y", "D=flag"]
    assert got[2][0] == 1 and "unterminated double quote" in got[2][1]


# ------------------------------------------------------ the root's codes


def _raiser(exc):
    def callback(*args, **kw):
        raise exc
    return callback


@pytest.mark.parametrize("case", ["flag", "exit", "silent", "domain"])
def test_root_renders_domain_errors(tmp_path, monkeypatch, case):
    """``main`` over a verb that raises: ``FlagError`` a usage error
    (exit 2; the port's ``main`` returned 1), ``ExitError`` its code, ``SilentError`` 1 with nothing
    printed, any other ``ClawkerError`` one line and 1."""
    def scenario(s):
        errors = s.m.errors
        exc = {"flag": errors.FlagError("--bad needs a value"),
               "exit": errors.ExitError(7),
               "silent": errors.SilentError("shown already"),
               "domain": errors.NotFoundError("no such agent")}[case]
        monkeypatch.setattr(s.m.cli.commands["version"], "callback",
                            _raiser(exc))
        monkeypatch.chdir(s.proj)
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            code = s.m.main(["version"])
        return code, err.getvalue(), out.getvalue()

    want, got = twin(tmp_path, scenario)
    assert got == want
    code, err, out = got
    assert code == {"flag": 2, "exit": 7, "silent": 1, "domain": 1}[case]
    assert out == ""
    # a UsageError raised outside a context prints no usage line
    assert err == {"flag": "Error: --bad needs a value\n", "exit": "",
                   "silent": "", "domain": "Error: no such agent\n"}[case]


def test_abort_at_a_prompt_exits_130(tmp_path, monkeypatch):
    """Declining ``auth rotate``'s confirmation aborts: ``aborted`` and
    exit 130 in both packages (the port's ``main`` returned 1)."""
    def scenario(s):
        monkeypatch.chdir(s.proj)
        monkeypatch.setattr(sys, "stdin", io.StringIO("n\n"))
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            code = s.m.main(["auth", "rotate"])
        return code, err.getvalue(), out.getvalue(), s.factory.config.pki_dir.exists()

    want, got = twin(tmp_path, scenario)
    assert got == want
    code, err, out, _ = got
    assert code == 130 and err == "aborted\n"
    assert out.startswith("Rotate the CA?")


def test_main_usage_error_exits_2(tmp_path, monkeypatch):
    def scenario(s):
        monkeypatch.chdir(s.proj)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            code = s.m.main(["stop"])
        return code, "Missing argument 'NAMES...'" in err.getvalue()

    want, got = twin(tmp_path, scenario)
    assert got == want == (2, True)


# -------------------------------------------------------------- worktrees


def test_worktree_prune_and_registry_file(tmp_path):
    """add two, delete one's directory behind git's back, prune: the
    same output and the same ``registry.yaml`` in both packages."""
    def scenario(s):
        out = [invoke(s, "worktree", "add", "w1"),
               invoke(s, "worktree", "add", "w2", "--branch", "topic/w2"),
               invoke(s, "worktree", "add", "w1")]
        shutil.rmtree(s.factory.config.worktrees_dir / PROJECT / "w1")
        out += [invoke(s, "worktree", "prune"), invoke(s, "worktree", "list"),
                invoke(s, "worktree", "prune")]
        registry = yaml.safe_load(
            norm(s, s.factory.config.registry_path.read_text()))
        branches = subprocess.run(
            ["git", "-C", str(s.proj), "branch", "--list", "--format",
             "%(refname:short)"], capture_output=True, text=True).stdout
        return out, registry, sorted(branches.split())

    want, got = twin(tmp_path, scenario, git=True)
    assert got == want
    out, registry, branches = got
    assert out[0][0] == 0 and "topic/w2" in out[1][1]
    assert out[2][0] == 1 and "already exists" in out[2][1]
    assert out[3] == (0, "pruned w1\n") and "w1" not in out[4][1]
    assert out[5] == (0, "")
    assert [w["name"] for w in registry["projects"][PROJECT]["worktrees"]] \
        == ["w2"]
    assert "clawker/w1" in branches and "topic/w2" in branches


def test_project_remove_and_non_tty_confirm(tmp_path):
    """Off a terminal the destructive verbs proceed (a prompt they
    cannot answer never hangs a script)."""
    def scenario(s):
        return [invoke(s, *argv) for argv in (
            ["project", "register"], ["project", "remove", PROJECT],
            ["project", "list"], ["project", "remove", PROJECT])]

    want, got = twin(tmp_path, scenario, git=True)
    assert got == want
    assert [c for c, _ in got] == [0, 0, 0, 1]
    assert "not registered" in got[3][1]


def test_destructive_prompt_on_a_tty_declines(tmp_path):
    """On a terminal ``rm`` asks; ``n`` leaves the container and exits
    1, ``--force`` skips the prompt."""
    def scenario(s):
        invoke(s, "run", "--detach")
        streams, _, _, err = s.m.iostreams.IOStreams.test(stdin_data="n\n")
        for stream in (streams.stdin, streams.stdout, streams.stderr):
            stream.isatty = lambda: True
        s.factory.__dict__["streams"] = streams
        declined = invoke(s, "rm", "dev")
        alive = len(s.api.containers)
        forced = invoke(s, "rm", "-f", "dev")
        return declined, alive, err.getvalue(), forced, len(s.api.containers)

    want, got = twin(tmp_path, scenario)
    assert got == want
    assert got[0][0] == 1 and got[1] == 1 and "Remove dev?" in got[2]
    assert got[3][0] == 0 and got[4] == 0


# -------------------------------------------- the verbs that wait


def _cp_settings() -> str:
    """The control plane on, on ports free now (not its fixed 7443,
    7444 and 7080)."""
    ports = []
    for _ in range(3):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    return ("control_plane:\n  enable: true\n"
            f"  admin_port: {ports[0]}\n  agent_port: {ports[1]}\n"
            f"  health_port: {ports[2]}\n")


@pytest.mark.parametrize("argv,name", [
    (["analyze"], "clawker analyze"),
    (["controlplane", "status"], "clawker controlplane"),
    (["firewall", "status"], "clawker firewall"),
])
def test_verbs_that_wait_are_refused_by_name(tmp_path, monkeypatch, argv,
                                             name):
    """``analyze`` waits for its modules and is refused by name.  The
    control plane is ported: ``controlplane status`` with none running
    exits 1 as the reference's does, and ``firewall status`` with
    ``control_plane.enable`` starts each package's daemon (forked, over
    the fake driver) and answers over its AdminService; the daemon is
    stopped after."""
    if argv == ["analyze"]:
        with side("port", tmp_path, settings=PROXY_OFF) as s:
            code, out = invoke(s, *argv)
        assert code == 1
        assert name in out and "not yet ported" in out
        return
    monkeypatch.setenv("CLAWKER_TPU_DRIVER", "fake")
    settings = PROXY_OFF + ("firewall:\n  enable: true\n"
                            "  default_deny: false\n" + _cp_settings()
                            if argv[0] == "firewall" else "")

    def scenario(s):
        try:
            return invoke(s, *argv), s.m.manager.running(s.factory.config)
        finally:
            s.m.manager.stop(s.factory.config)

    want, got = twin(tmp_path, scenario, settings=settings)
    assert got == want
    (code, out), running = got
    if argv[0] == "controlplane":
        assert (code, out, running) == (1, "control plane: not running\n",
                                        False)
    else:
        doc = json.loads(out)
        assert code == 0 and running and not doc["initialized"]


def test_help_lists_the_everyday_verbs_beside_the_earlier_ones():
    proc = subprocess.run([sys.executable, "-m", "clawker_tpu_torch",
                           "--help"], cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    listed = {line.split()[0] for line in
              proc.stdout.split("Commands:")[1].splitlines() if line.strip()}
    assert listed >= {
        "run", "container", "ps", "start", "stop", "rm", "attach", "kill",
        "logs", "exec", "init", "project", "worktree", "settings", "auth",
        "version", "alias", "network", "volume", "harness", "stack",
        "monitor", "fleet", "loop", "loopd", "workerd", "trace", "journal",
        "chaos", "build", "image", "bundle", "fed", "plugin"}


def test_exec_passes_every_word_after_the_name(tmp_path):
    """``exec NAME CMD...``: options before NAME are clawker's, every
    word after it the command's -- a ``--`` after NAME too (a finding
    kept from the reference, ROADMAP §3), while ``--`` before NAME ends
    clawker's options as click reads it."""
    def scenario(s):
        invoke(s, "run", "--detach")
        s.api.exec_handler = lambda c, cmd: (len(cmd), b"")
        codes = [invoke(s, *argv)[0] for argv in (
            ["exec", "dev", "sh", "-c", "true"],
            ["exec", "dev", "--", "sh", "-c", "true"],
            ["exec", "--", "dev", "ls", "-la"],
            ["exec", "-e", "K=v", "dev", "env"])]
        sent = [(a[1]["Cmd"], a[1].get("Env")) for a, _ in
                s.api.calls_named("exec_create")]
        return codes, sent

    want, got = twin(tmp_path, scenario)
    assert got == want
    codes, sent = got
    assert codes == [3, 4, 2, 1]
    assert [cmd for cmd, _ in sent] == [["sh", "-c", "true"],
                                        ["--", "sh", "-c", "true"],
                                        ["ls", "-la"], ["env"]]
    assert sent[3][1] == ["K=v"]


def test_foreground_run_with_stdin_left_open_exits_with_the_container(
        tmp_path):
    """A foreground ``run`` whose container exits while the user's stdin
    is still open: the reference's stdin writer, blocked inside
    ``sys.stdin.buffer``, makes the interpreter abort at exit (134, the
    container's code lost); the port's reads the descriptor and exits
    with the container's code (the repair in ``runtime/attach.py``)."""
    root = Path(__file__).resolve().parents[1]
    got = {}
    for pkg, module in (("ref", "clawker_tpu"), ("port", "clawker_tpu_torch")):
        base = tmp_path / pkg
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("CLAWKER_")}
        for name in ("CONFIG", "DATA", "STATE", "CACHE"):
            (base / name).mkdir(parents=True)
            env[f"CLAWKER_TPU_{name}_DIR"] = str(base / name)
        (base / "CONFIG" / "settings.yaml").write_text(PROXY_OFF)
        (base / ".clawker.yaml").write_text(f"project: {PROJECT}\n")
        env.update(CLAWKER_TPU_DRIVER="fake", CLAWKER_TPU_FAKE_IMAGES=IMAGE,
                   PYTHONPATH=str(root), JAX_PLATFORMS="cpu")
        proc = subprocess.Popen(
            [sys.executable, "-m", module, "run", "--no-tty"], cwd=base,
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            code = proc.wait(timeout=120)      # stdin still open
        finally:
            proc.stdin.close()
        got[pkg] = (code, proc.stdout.read(), proc.stderr.read())
        proc.stdout.close()
        proc.stderr.close()
    assert got["ref"][0] == -signal.SIGABRT    # a shell reads 134
    assert "_enter_buffered_busy" in got["ref"][2]
    assert got["port"][:2] == (0, "fake agent ran\n")
    assert got["ref"][1] == got["port"][1]


# ---------------------------------- the verbs over a real Docker socket


def test_logs_exec_and_wait_over_the_fake_engine_daemon(tmp_path):
    """The port's ``local`` driver over ``FakeEngineDaemon``: ``logs``
    reads the stdcopy-framed route, ``exec`` propagates its exit code,
    ``wait`` echoes the container's."""
    import tempfile

    sock_dir = Path(tempfile.mkdtemp(prefix="v", dir="/tmp"))
    api = port_fake.FakeDockerAPI()
    api.add_image(IMAGE)

    def hold(io_):
        io_.write_stdout(b"agent up\n")
        io_.kill_event.wait(30)
        return 0

    api.set_behavior(IMAGE, hold)
    api.exec_handler = lambda c, cmd: (int(cmd[-1]), b"ran " +
                                       " ".join(cmd).encode() + b"\n")
    daemon = port_testenv.FakeEngineDaemon(sock_dir / "e.sock", api).start()
    try:
        with side("port", tmp_path) as s:
            drv = port_drivers.LocalDriver(
                docker_host=f"unix://{daemon.sock_path}")
            s.factory = port_cli.Factory(cwd=s.proj, driver=drv)
            out = [invoke(s, "run", "-d"), invoke(s, "logs", "dev"),
                   invoke(s, "exec", "dev", "sh", "-c", "5"),
                   invoke(s, "stop", "dev"), invoke(s, "container", "wait",
                                                    "dev"),
                   invoke(s, "logs", "--tail", "1", "dev")]
            drv.close()
    finally:
        daemon.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
    assert out[0] == (0, "clawker.demo.dev\n")
    assert out[1] == (0, "agent up\n")
    assert out[2] == (5, "ran sh -c 5\n")
    assert out[3][0] == 0 and out[4] == (0, "0\n")
    assert out[5] == (0, "agent up\n")
    assert daemon.routes["container_logs"] == 2 and not daemon.unrouted
