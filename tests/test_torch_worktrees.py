"""The port's worktree swarm against the reference's.

Twins of tests/test_worktrees.py (all nine: ``GitManager``'s worktree
lifecycle and merges, the ``MergeQueue``, the ``--worktrees`` scheduler
run and its resume), tests/test_loop.py's worktree run, and
tests/test_workerd.py's bind-versus-snapshot dispatch.  Each twin runs
the reference test's scenario through ``clawker_tpu`` and then through
``clawker_tpu_torch`` with the same inputs: the git cases on two
repositories made alike, the scheduler cases each package on its own
``FakeDriver`` under its own ``TestEnv`` in a git repository with one
commit, one run id on both sides so agent and branch names agree, the
host proxy off (tests/test_torch_loop.py says why).  They must give the
same statuses, merge outcomes (``clean``/``ff``/``merged``,
``MergeConflict``), branch lists, journal record kinds and counts and
``gitguard_summary()``, and each side must hold the reference test's
own assertions.

Besides: a killed swarm resumed with no new worktree or branch and the
guard re-armed on the journaled keys; ``loop --worktrees`` and
``--gitguard`` without ``--worktrees`` through both CLIs; a loopd-hosted
worktree run with its status row; a snapshot-mode swarm over workerd,
its seeds collapsed to one digest; the sentinel riding a swarm, its
scores within ``SCORE_RTOL``; and a swarm whose rider asks for the card
without one exits 1 before any worktree is made.

The gitguard socket sits in a short temporary directory (settings
``gitguard.socket``): the default, under the data dir, can pass the
107-byte ``sun_path`` limit below pytest's temporary paths.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import clawker_tpu.cli.factory as ref_factory
import clawker_tpu.cli.root as ref_root
import clawker_tpu.config as ref_config
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.engine.fake as ref_fake
import clawker_tpu.errors as ref_errors
import clawker_tpu.firewall.rules as ref_rules
import clawker_tpu.gitx.git as ref_git
import clawker_tpu.loop as ref_loop
import clawker_tpu.loop.journal as ref_journal
import clawker_tpu.loop.mergeq as ref_mergeq
import clawker_tpu.loopd.client as ref_loopd_client
import clawker_tpu.loopd.server as ref_loopd_server
import clawker_tpu.util.ids as ref_ids
import clawker_tpu.workerd.executor as ref_executor
import clawker_tpu.workerd.server as ref_wserver
import clawker_tpu_torch.cli as port_cli
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.engine.fake as port_fake
import clawker_tpu_torch.errors as port_errors
import clawker_tpu_torch.firewall.rules as port_rules
import clawker_tpu_torch.gitx.git as port_git
import clawker_tpu_torch.loop as port_loop
import clawker_tpu_torch.loop.journal as port_journal
import clawker_tpu_torch.loop.mergeq as port_mergeq
import clawker_tpu_torch.loopd.client as port_loopd_client
import clawker_tpu_torch.loopd.server as port_loopd_server
import clawker_tpu_torch.util.ids as port_ids
import clawker_tpu_torch.workerd.executor as port_executor
import clawker_tpu_torch.workerd.server as port_wserver
import clawker_tpu_torch.workspace.strategy as port_strategy
from clawker_tpu.testenv import TestEnv
from test_torch_loop_anomaly import _assert_rows_agree, run_with_rider
from test_torch_fleet_sentinel import SCORE_RTOL
from test_torch_loopd import _time_limit  # noqa: F401
from test_torch_sentinel import injected  # noqa: F401

torch.set_num_threads(1)

PROJECT = "wtproj"
IMAGE = f"clawker-{PROJECT}:default"
RUN_ID = "wttwinrun001"
HOSTS = ("git.example.com",)
RULE_KEYS = {"git.example.com:https:443", "git.example.com:ssh:22",
             "git.example.com:git:9418"}
SETTINGS = """host_proxy:
  enable: false
loop:
  storage_pressure:
    soft_free_pct: 0.001
    hard_free_pct: 0.0005
"""

PKGS = {
    "ref": SimpleNamespace(
        config=ref_config, drivers=ref_drivers, fake=ref_fake,
        errors=ref_errors, rules=ref_rules, git=ref_git, loop=ref_loop,
        journal=ref_journal, mergeq=ref_mergeq, ids=ref_ids,
        loopd_client=ref_loopd_client, loopd_server=ref_loopd_server,
        executor=ref_executor, wserver=ref_wserver),
    "port": SimpleNamespace(
        config=port_config, drivers=port_drivers, fake=port_fake,
        errors=port_errors, rules=port_rules, git=port_git, loop=port_loop,
        journal=port_journal, mergeq=port_mergeq, ids=port_ids,
        loopd_client=port_loopd_client, loopd_server=port_loopd_server,
        executor=port_executor, wserver=port_wserver),
}


def git(repo, *args):
    return subprocess.run(
        ["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
        cwd=repo, check=True, capture_output=True, text=True).stdout


def init_repo(root: Path) -> None:
    """``root`` as a git repository on ``main`` with one commit."""
    root.mkdir(parents=True, exist_ok=True)
    git(root, "init", "-q", "-b", "main")
    git(root, "add", ".")
    git(root, "commit", "-q", "--allow-empty", "-m", "root")


def make_repo(m, root: Path):
    root.mkdir(parents=True, exist_ok=True)
    (root / "file.txt").write_text("base\n")
    init_repo(root)
    return m.git.GitManager(root)


def commit_on(gm, branch, fname, content, msg="wip"):
    """Commit to ``branch`` through a throwaway worktree."""
    wt = gm.root.parent / f"tmp-{branch.replace('/', '-')}"
    gm.setup_worktree(wt, branch)
    (wt / fname).write_text(content)
    git(wt, "add", ".")
    git(wt, "commit", "-q", "-m", msg)
    gm.remove_worktree(wt, force=True)


def branches(repo: Path, pattern: str = "*") -> list[str]:
    return sorted(b.strip(" *+") for b in git(
        repo, "branch", "--list", pattern).splitlines())


@pytest.fixture
def short_sock():
    """A gitguard socket path well inside ``sun_path``."""
    d = tempfile.mkdtemp(prefix="gg")
    try:
        yield Path(d) / "g.sock"
    finally:
        shutil.rmtree(d, ignore_errors=True)


def guard_settings(sock: Path, hosts=HOSTS) -> str:
    return (f"gitguard:\n  socket: {sock}\n"
            f"  hosts: [{', '.join(hosts)}]\n")


@contextlib.contextmanager
def side(pkg: str, tmp_path: Path, settings: str = ""):
    """One package's environment in a git repository with one commit:
    -> namespace with ``m``, ``cfg``, ``proj``, ``tenv``, ``pkg``."""
    with TestEnv(base=tmp_path / pkg) as tenv:
        tenv.write_settings(SETTINGS + settings)
        proj = tenv.base / "proj"
        proj.mkdir()
        (proj / ".clawker.yaml").write_text(f"project: {PROJECT}\n")
        init_repo(proj)
        m = PKGS[pkg]
        yield SimpleNamespace(m=m, cfg=m.config.load_config(proj),
                              proj=proj, tenv=tenv, pkg=pkg)


def twin(tmp_path: Path, scenario, settings: str = ""):
    out = []
    for pkg in ("ref", "port"):
        with side(pkg, tmp_path, settings) as s:
            out.append(scenario(s))
    return tuple(out)


def driver_with(m, n_workers: int, behavior=None):
    drv = m.drivers.FakeDriver(n_workers=n_workers)
    for api in drv.apis:
        api.add_image(IMAGE)
        api.set_behavior(IMAGE,
                         behavior or m.fake.exit_behavior(b"", 0, delay=0.02))
    return drv


def hold_behavior(hold: threading.Event):
    def run(io) -> int:
        if not hold.is_set():
            hold.wait(20.0)
        return 0

    return run


def wait_for(pred, timeout=10.0, interval=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def scheduler(s, drv, *, events=None, executors=None, **spec):
    return s.m.loop.LoopScheduler(
        s.cfg, drv, s.m.loop.LoopSpec(image=IMAGE, **spec),
        on_event=(None if events is None
                  else lambda a, e, d="": events.append((a, e, d))),
        run_id=RUN_ID, executors=executors)


def journal_of(s, run_id: str = RUN_ID) -> list[dict]:
    return s.m.journal.RunJournal.read(
        s.m.journal.journal_path(s.cfg.logs_dir, run_id))


def agent_kinds(records) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    for r in records:
        if r.get("agent"):
            out.setdefault(r["agent"], []).append(r["kind"])
    return out


def run_kinds(records) -> list[str]:
    return sorted(r["kind"] for r in records if not r.get("agent"))


def store_keys(s) -> set[str]:
    return {r.key() for r in s.m.rules.RulesStore(
        s.cfg.egress_rules_path).load()}


def swarm_outcome(s, sched, loops, events) -> dict:
    """What a finished swarm left, in names both packages share."""
    records = journal_of(s, sched.loop_id)
    wts = [r for r in records if r.get("kind") == s.m.journal.REC_SEED_WORKTREE]
    return {
        "status": sched.status(),
        "agent_kinds": agent_kinds(records),
        "run_kinds": run_kinds(records),
        "worktrees": sorted((r["agent"], r["branch"], r["base"],
                             str(Path(r["path"]).relative_to(s.cfg.data_dir)))
                            for r in wts),
        "linked": sorted((l.agent, (l.worktree / ".git").is_file())
                         for l in loops),
        "branches": branches(s.proj, f"loop/{sched.loop_id}/*"),
        "merged": sorted((a, d) for a, e, d in events if e == "merged"),
        "merge_events": sorted({e for _a, e, _d in events
                                if e.startswith("merge")}),
    }


# ----------------------------------------------------------- lifecycle


def test_worktree_lifecycle(tmp_path):
    def scenario(m, root):
        gm = make_repo(m, root / "repo")
        dest = root / "wt" / "agent-0"
        info = gm.setup_worktree(dest, "loop/run/agent-0")
        first = (info.path == dest, dest.exists(),
                 gm.branch_exists("loop/run/agent-0"),
                 (dest / "file.txt").read_text())
        again = gm.setup_worktree(dest, "loop/run/agent-0")
        n = len([w for w in gm.list_worktrees()
                 if w.branch == "loop/run/agent-0"])
        gm.remove_worktree(dest, force=True)
        gone = not any(w.path == dest for w in gm.list_worktrees())
        return first, again.head == info.head, n, gone

    want = scenario(PKGS["ref"], tmp_path / "ref")
    got = scenario(PKGS["port"], tmp_path / "port")
    assert got == want == ((True, True, True, "base\n"), True, 1, True)


def test_worktree_reattach_after_dir_vanished(tmp_path):
    def scenario(m, root):
        gm = make_repo(m, root / "repo")
        dest = root / "wt" / "agent-0"
        gm.setup_worktree(dest, "loop/run/agent-0")
        shutil.rmtree(dest)
        info = gm.setup_worktree(dest, "loop/run/agent-0")
        return dest.exists(), info.branch, len(gm.list_worktrees())

    want = scenario(PKGS["ref"], tmp_path / "ref")
    got = scenario(PKGS["port"], tmp_path / "port")
    assert got == want == (True, "loop/run/agent-0", 2)


def test_worktree_branch_exists_without_worktree(tmp_path):
    def scenario(m, root):
        gm = make_repo(m, root / "repo")
        git(gm.root, "branch", "loop/run/agent-0")
        dest = root / "wt" / "agent-0"
        info = gm.setup_worktree(dest, "loop/run/agent-0")
        return dest.exists(), info.branch

    want = scenario(PKGS["ref"], tmp_path / "ref")
    got = scenario(PKGS["port"], tmp_path / "port")
    assert got == want == (True, "loop/run/agent-0")


def test_worktree_cross_claim_rejected(tmp_path):
    def scenario(m, root):
        gm = make_repo(m, root / "repo")
        gm.setup_worktree(root / "wt" / "a", "loop/run/a")
        out = []
        for dest, branch in ((root / "wt" / "elsewhere", "loop/run/a"),
                             (root / "wt" / "a", "loop/run/b")):
            with pytest.raises(m.git.GitError) as ei:
                gm.setup_worktree(dest, branch)
            out.append(str(ei.value).replace(str(root), "<root>"))
        return out

    want = scenario(PKGS["ref"], tmp_path / "ref")
    got = scenario(PKGS["port"], tmp_path / "port")
    assert got == want and len(got) == 2


# ---------------------------------------------------------- merge_into


def test_merge_into_clean_ff_merged_conflict(tmp_path):
    def scenario(m, root):
        gm = make_repo(m, root / "repo")
        gm.ensure_branch("target")
        gm.ensure_branch("noop")
        out = [gm.merge_into("target", "noop")]
        commit_on(gm, "ahead", "a.txt", "a\n")
        out.append(gm.merge_into("target", "ahead"))
        commit_on(gm, "left", "left.txt", "l\n")
        commit_on(gm, "right", "right.txt", "r\n")
        out.append(gm.merge_into("target", "left"))
        out.append(gm.merge_into("target", "right"))
        commit_on(gm, "c1", "hot.txt", "one\n")
        commit_on(gm, "c2", "hot.txt", "two\n")
        out.append(gm.merge_into("target", "c1"))
        with pytest.raises(m.git.MergeConflict) as ei:
            gm.merge_into("target", "c2")
        out.append((ei.value.target, ei.value.src,
                    str(ei.value).split(":")[0]))
        out.append(gm.current_branch())
        out.append({w.branch for w in gm.list_worktrees()})
        out.append(sorted(git(gm.root, "ls-tree", "--name-only",
                              "target").split()))
        return out

    want = scenario(PKGS["ref"], tmp_path / "ref")
    got = scenario(PKGS["port"], tmp_path / "port")
    assert got == want
    assert got[0] == "clean" and got[1] == "ff"
    assert got[2] in ("ff", "merged") and got[3] == "merged"
    assert got[4] == "merged"
    assert got[5] == ("target", "c2", "merge of c2 into target conflicts")
    assert got[6] == "main" and got[7] == {"main"}


def test_merge_into_needs_no_configured_identity(tmp_path, monkeypatch):
    """A host with no git identity still lands a true merge: the queue's
    own commits take ``_identity_args``' synthetic identity."""
    def scenario(m, root):
        gm = make_repo(m, root / "repo")
        gm.ensure_branch("target")
        commit_on(gm, "left", "left.txt", "l\n")
        commit_on(gm, "right", "right.txt", "r\n")
        with monkeypatch.context() as mp:
            home = root / "home"
            home.mkdir()
            mp.setenv("HOME", str(home))
            mp.setenv("GIT_CONFIG_NOSYSTEM", "1")
            mp.setenv("GIT_CONFIG_GLOBAL", str(home / "none"))
            for k in ("GIT_AUTHOR_NAME", "GIT_AUTHOR_EMAIL",
                      "GIT_COMMITTER_NAME", "GIT_COMMITTER_EMAIL",
                      "EMAIL"):
                mp.delenv(k, raising=False)
            args = gm._identity_args()
            out = [gm.merge_into("target", "left"),
                   gm.merge_into("target", "right")]
        author = git(gm.root, "log", "-1", "--format=%an <%ae>", "target")
        return args, out, author.strip()

    want = scenario(PKGS["ref"], tmp_path / "ref")
    got = scenario(PKGS["port"], tmp_path / "port")
    assert got == want
    assert got[0] == ["-c", "user.name=clawker", "-c",
                      "user.email=clawker@localhost"]
    assert got[1][1] == "merged"
    assert got[2] == "clawker <clawker@localhost>"


# ---------------------------------------------------------- MergeQueue


def _report(r) -> tuple:
    return (list(r.landed), list(r.resubmitted), list(r.failed),
            list(r.deferred))


def test_merge_queue_conflict_backoff_and_exhaustion(tmp_path):
    def scenario(m, root):
        gm = make_repo(m, root / "repo")
        gm.ensure_branch("target")
        commit_on(gm, "winner", "hot.txt", "one\n")
        commit_on(gm, "loser", "hot.txt", "two\n")
        clock = [0.0]
        delays = []

        def retry_delay():
            delays.append(0.7)
            return 0.7

        q = m.mergeq.MergeQueue(retry_s=0.5, max_attempts=2,
                                clock=lambda: clock[0])
        q.submit("w", "winner")
        q.submit("l", "loser")
        out = [_report(q.drain(gm, "target", retry_delay=retry_delay))]
        clock[0] = 0.5
        out.append(_report(q.drain(gm, "target", retry_delay=retry_delay)))
        clock[0] = 1.0
        out.append(_report(q.drain(gm, "target", retry_delay=retry_delay)))
        return out, delays, q.pending()

    want = scenario(PKGS["ref"], tmp_path / "ref")
    got = scenario(PKGS["port"], tmp_path / "port")
    assert got == want
    reports, delays, pending = got
    assert [a for a, _ in reports[0][0]] == ["w"]
    assert reports[0][1] == ["l"] and delays == [0.7]
    assert reports[1][3] == ["l"] and not reports[1][0]
    assert reports[2][2] == ["l"] and not pending


def test_merge_queue_resubmit_replaces_stale_entry():
    def scenario(m):
        q = m.mergeq.MergeQueue()
        q.submit("a", "branch-v1")
        q.submit("a", "branch-v2")
        return q.pending(), q._entries[0].branch, q.retry_s, q.max_attempts

    want, got = scenario(PKGS["ref"]), scenario(PKGS["port"])
    assert got == want == (["a"], "branch-v2", 0.5, 3)


def test_merge_queue_without_a_retry_hint_backs_off_retry_s(tmp_path):
    def scenario(m, root):
        gm = make_repo(m, root / "repo")
        gm.ensure_branch("target")
        commit_on(gm, "c1", "hot.txt", "one\n")
        commit_on(gm, "c2", "hot.txt", "two\n")
        clock = [10.0]
        q = m.mergeq.MergeQueue(retry_s=0.25, max_attempts=3,
                                clock=lambda: clock[0])
        q.submit("a", "c1")
        q.submit("b", "c2", delay_s=1.0)
        out = [_report(q.drain(gm, "target"))]
        clock[0] = 11.0
        out.append(_report(q.drain(gm, "target")))
        out.append(q._entries[0].not_before)
        clock[0] = 11.25
        out.append(_report(q.drain(gm, "target")))
        return out

    want = scenario(PKGS["ref"], tmp_path / "ref")
    got = scenario(PKGS["port"], tmp_path / "port")
    assert got == want
    assert got[0] == ([("a", "ff")], [], [], ["b"])
    assert got[1] == ([], ["b"], [], []) and got[2] == 11.25


# -------------------------------------------------------- swarm run


def test_swarm_run_branch_per_agent_merge_queue_lands(tmp_path, short_sock):
    """--worktrees fan-out: one branch + linked worktree per agent,
    REC_SEED_WORKTREE journaled write-ahead, every agent landed on the
    run-scoped integration branch; the same in both packages."""
    def scenario(s):
        drv = driver_with(s.m, 2)
        events: list = []
        sched = scheduler(s, drv, events=events, parallel=3, iterations=1,
                          worktrees=True)
        sched.start()
        loops = sched.run(poll_s=0.05)
        try:
            assert all(l.status == "done" for l in loops)
            gm = s.m.git.GitManager(s.proj)
            assert gm.branch_exists(f"loop/{sched.loop_id}/merged")
            for l in loops:
                assert l.worktree is not None and l.worktree.exists()
            return swarm_outcome(s, sched, loops, events)
        finally:
            sched.cleanup(remove_containers=True)
            drv.close()

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want
    assert len(got["worktrees"]) == 3
    assert len({w[0] for w in got["worktrees"]}) == 3
    assert len({w[1] for w in got["worktrees"]}) == 3
    assert len({w[3] for w in got["worktrees"]}) == 3
    assert all(linked for _a, linked in got["linked"])
    assert {a for a, _d in got["merged"]} == {r["agent"]
                                             for r in got["status"]}
    assert all(d == f"loop/{RUN_ID}/merged:clean" for _a, d in got["merged"])
    assert got["branches"] == sorted(
        [f"loop/{RUN_ID}/merged"] + [f"loop/{RUN_ID}/{r['agent']}"
                                     for r in got["status"]])
    for kinds in got["agent_kinds"].values():
        assert kinds.index("seed_worktree") < kinds.index("created")
    assert got["run_kinds"].count("gitguard_rules") == 1


def test_swarm_lands_diverged_branches_and_reports_conflicts(tmp_path,
                                                             short_sock):
    """Agents whose branches diverged land ``merged``; two that edit one
    hunk conflict, and the loser is resubmitted until ``merge_attempts``
    runs out.  The worktrees are bind mounts on the fake engine, so the
    commits are made on the host between the run's two halves."""
    settings = guard_settings(short_sock) + (
        "loop:\n  worktrees:\n    merge_retry_s: 0.0\n"
        "    merge_attempts: 2\n")

    def scenario(s):
        drv = driver_with(s.m, 1)
        events: list = []
        sched = scheduler(s, drv, events=events, parallel=3, iterations=1,
                          worktrees=True)
        sched.start()
        loops = sched.run(poll_s=0.05)
        for l, (fname, body) in zip(loops, (("a.txt", "a\n"),
                                            ("hot.txt", "one\n"),
                                            ("hot.txt", "two\n"))):
            (l.worktree / fname).write_text(body)
            git(l.worktree, "add", ".")
            git(l.worktree, "commit", "-q", "-m", l.agent)
            sched.mergeq.submit(l.agent, sched._branches[l.agent])
        sched._drain_merges(deadline_s=5.0)
        sched.cleanup(remove_containers=True)
        drv.close()
        target = f"loop/{sched.loop_id}/merged"
        return {
            "events": sorted((a, e, d) for a, e, d in events
                             if e.startswith("merge")),
            "tree": sorted(git(s.proj, "ls-tree", "--name-only",
                               target).split()),
            "hot": git(s.proj, "show", f"{target}:hot.txt"),
        }

    want, got = twin(tmp_path, scenario, settings)
    assert got == want
    kinds = [e for _a, e, _d in got["events"]]
    assert kinds.count("merge_conflict") == 1
    assert kinds.count("merge_failed") == 1
    assert "a.txt" in got["tree"] and got["hot"] == "one\n"


def test_swarm_resume_reattaches_zero_duplicate_worktrees(tmp_path,
                                                          short_sock):
    def scenario(s):
        drv = driver_with(s.m, 1)
        sched = scheduler(s, drv, parallel=2, iterations=1, worktrees=True)
        sched.start()
        loops = sched.run(poll_s=0.05)
        assert all(l.status == "done" for l in loops)
        sched.cleanup(remove_containers=True)
        image = s.m.journal.replay(journal_of(s))
        sched2 = s.m.loop.LoopScheduler.resume(s.cfg, drv, image)
        try:
            out = {"journaled": sorted(sched2._worktrees_journaled),
                   "branches": dict(sched2._branches), "paths": []}
            for agent, wt in sorted(image.worktrees.items()):
                with sched2._git_lock:
                    path, _git_dir = sched2._maybe_worktree(agent)
                out["paths"].append(str(path) == wt["path"])
            out["records"] = sum(
                1 for r in journal_of(s)
                if r.get("kind") == s.m.journal.REC_SEED_WORKTREE)
            out["agent_branches"] = [b for b in branches(
                s.proj, f"loop/{RUN_ID}/*") if not b.endswith("/merged")]
            out["rules"] = list(sched2._gitguard_rule_keys)
            return out
        finally:
            sched2.cleanup(remove_containers=False)
            drv.close()

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want
    assert len(got["journaled"]) == 2
    assert got["paths"] == [True, True] and got["records"] == 2
    assert len(got["agent_branches"]) == 2
    # the journal keeps the first generation's keys: the resumed run
    # re-arms teardown for them (and, the store emptied, re-installs)
    assert sorted(got["rules"]) == sorted(RULE_KEYS)


def test_worktree_per_agent(tmp_path, short_sock):
    """tests/test_loop.py's worktree run: distinct worktrees, one branch
    each."""
    def scenario(s):
        drv = driver_with(s.m, 2)
        sched = scheduler(s, drv, parallel=2, iterations=1, worktrees=True)
        sched.start()
        loops = sched.run(poll_s=0.05)
        out = ([l.status for l in loops],
               len({str(l.worktree) for l in loops}),
               [bool(branches(s.proj, f"loop/{sched.loop_id}/{l.agent}"))
                for l in loops],
               [l.worktree.exists() for l in loops])
        sched.cleanup(remove_containers=True)
        drv.close()
        return out

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want == (["done", "done"], 2, [True, True], [True, True])


def test_worktrees_need_a_git_repository(tmp_path, short_sock):
    """Outside a repository the swarm's creates fail by name: every loop
    strands, no worktree is made."""
    def scenario(s):
        shutil.rmtree(s.proj / ".git")
        drv = driver_with(s.m, 1)
        events: list = []
        sched = scheduler(s, drv, events=events, parallel=1, iterations=1,
                          worktrees=True)
        sched.start()
        loops = sched.run(poll_s=0.05)
        sched.cleanup(remove_containers=True)
        drv.close()
        msgs = sorted({d for _a, e, d in events
                       if "requires a git repository" in d})
        return ([l.status for l in loops], msgs,
                (s.cfg.data_dir / "worktrees").exists())

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want
    assert got[1] and got[2] is False


def test_merge_queue_off_lands_nothing(tmp_path, short_sock):
    settings = guard_settings(short_sock) + (
        "loop:\n  worktrees:\n    merge_queue: false\n")

    def scenario(s):
        drv = driver_with(s.m, 1)
        events: list = []
        sched = scheduler(s, drv, events=events, parallel=2, iterations=1,
                          worktrees=True)
        sched.start()
        sched.run(poll_s=0.05)
        out = (sched.mergeq is None,
               [e for _a, e, _d in events if e.startswith("merge")],
               branches(s.proj, f"loop/{sched.loop_id}/*"))
        sched.cleanup(remove_containers=True)
        drv.close()
        return out

    want, got = twin(tmp_path, scenario, settings)
    assert got == want
    assert got[0] is True and got[1] == [] and len(got[2]) == 2


# --------------------------------------------------- warm pool, workerd


def test_worktree_runs_stay_direct(tmp_path, short_sock):
    """tests/test_workerd.py's degrade matrix: bind-mode --worktrees runs
    never route through workerd; snapshot-mode ones do."""
    def scenario(s):
        drv = driver_with(s.m, 1)
        servers, execset = wd_pod(s, drv)
        try:
            bind = scheduler(s, drv, executors=execset, parallel=1,
                             iterations=1, worktrees=True)
            snap = scheduler(s, drv, executors=execset, parallel=1,
                             iterations=1, worktrees=True,
                             workspace_mode="snapshot")
            return (bind._workerd_for(drv.workers()[0]) is None,
                    snap._workerd_for(drv.workers()[0]) is not None,
                    bind._effective_mode(), snap._effective_mode())
        finally:
            wd_teardown(servers, execset, drv)

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want == (True, True, "bind", "snapshot")


def wd_pod(s, drv):
    """One WorkerdServer a worker on its local engine view, and an
    executor set over them."""
    servers, socks = [], {}
    for i, w in enumerate(drv.workers()):
        socks[w.id] = s.tenv.base / f"wd-{i}.sock"
        servers.append(s.m.wserver.WorkerdServer(
            s.cfg, drv.local_engine(i), worker_id=w.id,
            sock_path=socks[w.id]).start())
    return servers, s.m.executor.ExecutorSet({
        wid: s.m.executor.WorkerdExecutor(wid, sock, intent_deadline_s=10.0)
        for wid, sock in socks.items()})


def wd_teardown(servers, execset, drv):
    execset.close_all()
    for srv in servers:
        srv.stop()
    drv.close()


def test_snapshot_swarm_over_workerd_ships_one_seed_an_agent(tmp_path,
                                                            short_sock):
    """A snapshot-mode swarm dispatches every launch through workerd.
    Each agent's seed is its worktree, and the linked worktree's
    ``.git`` file (its ``gitdir:`` line names the agent) rides the tar,
    so worktrees that have not diverged still give one digest an agent
    in both packages; without that file their trees are one."""
    def scenario(s):
        drv = driver_with(s.m, 2)
        servers, execset = wd_pod(s, drv)
        events: list = []
        try:
            sched = scheduler(s, drv, events=events, executors=execset,
                              parallel=4, iterations=1, worktrees=True,
                              workspace_mode="snapshot")
            sched.start()
            loops = sched.run(poll_s=0.05)
            out = swarm_outcome(s, sched, loops, events)
            records = journal_of(s, sched.loop_id)
            out["seed_tars"] = sum(1 for r in records
                                   if r["kind"] == "seed_tar")
            out["seed_ships"] = sorted(r["worker"] for r in records
                                       if r["kind"] == "seed_ship")
            out["trees"] = len({_tar_without_git_file(l.worktree)
                                for l in loops})
            sched.cleanup(remove_containers=True)
            return out
        finally:
            wd_teardown(servers, execset, drv)

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want
    assert got["seed_tars"] == 4 and got["trees"] == 1
    assert got["seed_ships"] == ["fake-0"] * 2 + ["fake-1"] * 2
    assert len(got["merged"]) == 4


def _tar_without_git_file(root: Path) -> bytes:
    import io
    import tarfile

    src = io.BytesIO(port_strategy._tar_tree(root))
    out = io.BytesIO()
    with tarfile.open(fileobj=src) as tin, \
            tarfile.open(fileobj=out, mode="w",
                         format=tarfile.GNU_FORMAT) as tout:
        for ti in tin.getmembers():
            if ti.name != ".git":
                tout.addfile(ti, tin.extractfile(ti) if ti.isfile() else None)
    return out.getvalue()


# ------------------------------------------------------- kill and resume


def test_killed_swarm_resumes_with_no_new_worktree_or_branch(tmp_path,
                                                             short_sock):
    """A swarm killed mid-run, resumed and reconciled: no new
    REC_SEED_WORKTREE and no new branch, the guard re-armed on exactly
    the journaled rule keys, every agent landed, the keys gone after
    cleanup."""
    def scenario(s):
        hold = threading.Event()
        drv = driver_with(s.m, 2, behavior=hold_behavior(hold))
        sched1 = scheduler(s, drv, parallel=2, iterations=2, worktrees=True)
        sched1.start()
        t = threading.Thread(target=sched1.run, kwargs={"poll_s": 0.05},
                             daemon=True)
        t.start()
        assert wait_for(lambda: all(l.status == "running"
                                    for l in sched1.loops))
        sched1.kill()
        t.join(10.0)
        before = journal_of(s)
        branches1 = branches(s.proj, f"loop/{RUN_ID}/*")
        keys1 = store_keys(s)
        image = s.m.journal.replay(before)
        events: list = []
        sched2 = s.m.loop.LoopScheduler.resume(
            s.cfg, drv, image,
            on_event=lambda a, e, d="": events.append((a, e, d)))
        out = {
            "rearmed": (sorted(sched2._gitguard_rule_keys),
                        sorted(image.gitguard_rules),
                        sched2.gitguard is not None
                        and sched2.gitguard.running),
            "summary": sched2.reconcile(),
        }
        hold.set()
        loops = sched2.run(poll_s=0.05)
        after = journal_of(s)
        out["new_worktrees"] = sum(
            1 for r in after[len(before):]
            if r["kind"] == s.m.journal.REC_SEED_WORKTREE)
        out["new_rules"] = sum(
            1 for r in after[len(before):]
            if r["kind"] == s.m.journal.REC_GITGUARD_RULES)
        out["branches"] = (branches1, branches(s.proj, f"loop/{RUN_ID}/*"))
        out["keys"] = (sorted(keys1 & RULE_KEYS), )
        out["statuses"] = [(l.agent, l.status, l.iteration) for l in loops]
        out["merged"] = sorted({a for a, e, _d in events if e == "merged"})
        sched2.cleanup(remove_containers=True)
        out["keys"] += (sorted(store_keys(s) & RULE_KEYS),
                        sched2.gitguard is None)
        drv.close()
        return out

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want
    assert got["rearmed"] == (sorted(RULE_KEYS), sorted(RULE_KEYS), True)
    assert got["new_worktrees"] == 0 and got["new_rules"] == 0
    assert got["branches"][1] == sorted(got["branches"][0]
                                        + [f"loop/{RUN_ID}/merged"])
    assert got["keys"] == (sorted(RULE_KEYS), [], True)
    assert all(st == "done" and it == 2 for _a, st, it in got["statuses"])
    assert got["merged"] == sorted(a for a, _s, _i in got["statuses"])


# ------------------------------------------------------------------ CLI

CLI = {"ref": (ref_root.cli, ref_factory.Factory, ["--no-daemon",
                                                   "--no-workerd"]),
       "port": (port_cli.cli, port_cli.Factory, ["--no-daemon"])}


def _cli(s, drv, args, monkeypatch, device="cpu"):
    root, factory, extra = CLI[s.pkg]
    if s.pkg == "port":
        monkeypatch.setenv(port_cli.DEVICE_ENV, device)
    with _fixed_ids(s):
        res = CliRunner().invoke(root, [*args, *extra],
                                 obj=factory(cwd=s.proj, driver=drv),
                                 catch_exceptions=False)
    return res


@contextlib.contextmanager
def _fixed_ids(s):
    real = s.m.ids.short_id
    s.m.ids.short_id = (lambda n=12, *a, **k:
                        RUN_ID if n == 12 else real(n, *a, **k))
    try:
        yield
    finally:
        s.m.ids.short_id = real


def _json_rows(res) -> list[tuple]:
    import json

    doc = json.loads(res.stdout)
    return [(a["agent"], a["status"], a["iteration"]) for a in doc["agents"]]


def test_cli_loop_worktrees_matches_reference(tmp_path, monkeypatch,
                                              short_sock):
    def scenario(s):
        drv = driver_with(s.m, 2)
        res = _cli(s, drv, ["loop", "--worktrees", "-p", "2", "-n", "1",
                            "--json"], monkeypatch)
        drv.close()
        assert res.exit_code == 0, res.output
        return (_json_rows(res), branches(s.proj, "loop/*"),
                sorted(store_keys(s) & RULE_KEYS))

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want
    assert all(st == "done" for _a, st, _i in got[0])
    assert f"loop/{RUN_ID}/merged" in got[1] and len(got[1]) == 3
    assert got[2] == []


def test_cli_gitguard_without_worktrees_does_nothing(tmp_path, monkeypatch,
                                                     short_sock):
    """``--gitguard`` alone arms nothing, in either package: no rule, no
    socket, no journal record (``_gitguard_armed``)."""
    def scenario(s):
        drv = driver_with(s.m, 1)
        res = _cli(s, drv, ["loop", "--gitguard", "-p", "1", "-n", "1",
                            "--json"], monkeypatch)
        drv.close()
        assert res.exit_code == 0, res.output
        return (_json_rows(res), store_keys(s), short_sock.exists(),
                [r["kind"] for r in journal_of(s)
                 if r["kind"].startswith("gitguard")])

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want
    assert got[1] == set() and got[2] is False and got[3] == []


def test_gitguard_spec_without_worktrees_is_disarmed(tmp_path, short_sock):
    def scenario(s):
        drv = driver_with(s.m, 1)
        sched = scheduler(s, drv, parallel=1, iterations=1, gitguard=True)
        sched.start()
        out = (sched.gitguard, sched.gitguard_summary(), sched.mergeq)
        sched.run(poll_s=0.05)
        sched.cleanup(remove_containers=True)
        drv.close()
        return out

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want == (None, {"enabled": False, "running": False,
                                  "socket": "", "hosts": list(HOSTS),
                                  "rules": [], "decisions": {}}, None)


def test_cli_swarm_without_a_gpu_exits_1_before_any_worktree(
        tmp_path, monkeypatch, short_sock):
    """No fallback hides the card: the rider asks for ``cuda``, there is
    none, and the run stops before the scheduler makes a worktree."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with side("port", tmp_path, guard_settings(short_sock)) as s:
        drv = driver_with(s.m, 1)
        res = _cli(s, drv, ["loop", "--worktrees", "--sentinel", "-p", "2",
                            "-n", "1", "--json"], monkeypatch,
                   device="cuda")
        assert res.exit_code == 1, res.output
        assert "cpu" in res.output
        assert not (s.cfg.data_dir / "worktrees").exists()
        assert branches(s.proj, "loop/*") == []
        assert not drv.api.calls_named("container_create")
        assert store_keys(s) == set()


# ---------------------------------------------------------------- loopd


def test_loopd_hosts_a_worktree_run(tmp_path, short_sock):
    """A submitted worktree spec runs under the daemon: its status row's
    ``gitguard`` is the run's ``gitguard_summary()`` while it runs, and
    the swarm lands every agent."""
    def scenario(s):
        hold = threading.Event()
        drv = driver_with(s.m, 2, behavior=hold_behavior(hold))
        srv = s.m.loopd_server.LoopdServer(s.cfg, drv).start()
        try:
            with _fixed_ids(s):
                c = s.m.loopd_client.LoopdClient(srv.sock_path)
                c.hello()
                ack = c.submit_run({"parallel": 2, "iterations": 1,
                                    "worktrees": True}, stream=False)
            c.close()
            run = srv.runs[ack["run"]]
            assert wait_for(lambda: run.sched is not None and all(
                l.status == "running" for l in run.sched.loops))
            with s.m.loopd_client.LoopdClient(srv.sock_path) as c2:
                row = {r["run"]: r for r in c2.status()["runs"]}[ack["run"]]
            hold.set()
            assert run.done.wait(20.0)
            with s.m.loopd_client.LoopdClient(srv.sock_path) as c3:
                done = {r["run"]: r for r in c3.status()["runs"]}[ack["run"]]
            return (ack["run"], row["gitguard"], done["gitguard"],
                    [a["status"] for a in done["agents"]],
                    branches(s.proj, f"loop/{ack['run']}/*"),
                    sorted(store_keys(s) & RULE_KEYS))
        finally:
            hold.set()
            srv.stop()
            drv.close()

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want
    run, running, done, statuses, brs, keys = got
    assert run == RUN_ID
    assert running["enabled"] and running["running"]
    assert set(running["rules"]) == RULE_KEYS
    assert running["socket"] == str(short_sock)
    assert done["running"] is False and done["rules"] == []
    assert statuses == ["done", "done"] and len(brs) == 3 and keys == []


# ------------------------------------------------------------- sentinel


def test_sentinel_scores_a_swarm_as_the_reference(tmp_path, injected,
                                                  short_sock):
    """The sentinel riding a worktree swarm: the same windows with raw
    scores within SCORE_RTOL, the same rows within the loop twins'
    tolerance, the same flags, the storm agent hottest."""
    kw = dict(rider="sentinel", hot_slot=5, spec={"worktrees": True},
              prepare=init_repo,
              settings=guard_settings(short_sock))
    want = run_with_rider("ref", tmp_path / "a", **kw)
    got = run_with_rider("port", tmp_path / "b", **kw)
    hot = got["agents"][5]
    assert got["errors"] == want["errors"] == []
    assert got["scored"] == want["scored"] and got["scored"][0] > 0
    assert got["raw"][0] == want["raw"][0]
    np.testing.assert_allclose(got["raw"][1], want["raw"][1],
                               rtol=SCORE_RTOL)
    _assert_rows_agree(got, want)
    assert got["flagged"] == want["flagged"] and hot in got["flagged"]
    assert got["flags"] == want["flags"]
    assert got["snapshot"] == want["snapshot"]
    assert got["tick_spans"] == want["tick_spans"] == 1


# ------------------------------------------------------------- hygiene


def test_port_git_modules_load_no_torch():
    """The git manager, the merge queue, the rule store and gitguard run
    without torch, as the reference's run without JAX."""
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['torch'] = None\n"
        "import clawker_tpu_torch.gitx, clawker_tpu_torch.gitguard\n"
        "import clawker_tpu_torch.firewall.rules\n"
        "import clawker_tpu_torch.loop.mergeq\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('torch', 'jax', 'clawker_tpu')\n"
        "    and sys.modules[m] is not None)))\n")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env=dict(os.environ, PYTHONPATH=str(root)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
