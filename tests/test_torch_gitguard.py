"""The port's gitguard and rule store against the reference's.

Twins of tests/test_gitguard.py:80-520 (the pkt-line codec over the
reference's adversarial corpus, ``RefPolicy``, the smart-HTTP filter,
the proxy end to end over the fake upstream and under a real ``git``
client) and :616-676 (the scheduler arming the guard, journaling its
rule keys write-ahead and tearing both down; the ``--no-gitguard``
opt-out).  Each twin feeds both packages the same inputs and compares
what comes out exactly: the bytes of every encoded or filtered body,
decisions' documents and verdicts, rule keys and their dicts, HTTP
statuses and acknowledged updates, and ``gitguard_summary()``.

And tests/test_gitguard.py:521-600, the chaos rider: the push-probe
script (``gitguard_probe_script``), the ``ref-isolation-at-proxy``
invariant of each package's checker over the same poisoned evidence,
and a ``gitguard_down`` scenario through each package's
``ChaosRunner`` (helpers from tests/test_torch_chaos.py).

Besides, the egress rule store (``firewall/rules.py``): validation,
the dedupe-by-key add with its collision merge, removal, the effective
set, and the comment-preserving rewrite of a hand-edited rules file
(``storage/yamledit.py``), each file byte for byte.
"""

from __future__ import annotations

import http.client
import subprocess
from types import SimpleNamespace

import pytest

import clawker_tpu.chaos.runner as ref_chaos_runner
import clawker_tpu.config.schema as ref_schema
import clawker_tpu.firewall.rules as ref_rules
import clawker_tpu.gitguard as ref_gg
import clawker_tpu.gitguard.pktline as ref_pkt
import clawker_tpu.gitguard.protocol as ref_proto
import clawker_tpu.gitguard.refpolicy as ref_pol
import clawker_tpu.gitguard.server as ref_server
import clawker_tpu.storage.yamledit as ref_yamledit
import clawker_tpu_torch.chaos.runner as port_chaos_runner
import clawker_tpu_torch.config.schema as port_schema
import clawker_tpu_torch.firewall.rules as port_rules
import clawker_tpu_torch.gitguard as port_gg
import clawker_tpu_torch.gitguard.pktline as port_pkt
import clawker_tpu_torch.gitguard.protocol as port_proto
import clawker_tpu_torch.gitguard.refpolicy as port_pol
import clawker_tpu_torch.gitguard.server as port_server
import clawker_tpu_torch.storage.yamledit as port_yamledit
from test_torch_chaos import SEED, _clean_run, run_plan_twin
from test_torch_chaos import twin as chaos_twin
from test_torch_worktrees import (
    HOSTS,
    RULE_KEYS,
    driver_with,
    guard_settings,
    journal_of,
    scheduler,
    short_sock,  # noqa: F401
    store_keys,
    twin,
)

SHA_A = "a" * 40
SHA_B = "b" * 40
ZERO = "0" * 40

PKGS = {
    "ref": SimpleNamespace(gg=ref_gg, pkt=ref_pkt, proto=ref_proto,
                           pol=ref_pol, server=ref_server, rules=ref_rules,
                           schema=ref_schema, yamledit=ref_yamledit),
    "port": SimpleNamespace(gg=port_gg, pkt=port_pkt, proto=port_proto,
                            pol=port_pol, server=port_server,
                            rules=port_rules, schema=port_schema,
                            yamledit=port_yamledit),
}


def both(fn):
    """``fn(m)`` on the reference's modules, then the port's."""
    return fn(PKGS["ref"]), fn(PKGS["port"])


def outcome(fn):
    """``fn()``'s value, or its exception's class name and message."""
    try:
        return ("ok", fn())
    except Exception as e:      # noqa: BLE001 -- compared across packages
        return ("raise", type(e).__name__, str(e),
                getattr(e, "consumed", None))


# ------------------------------------------------------------- pkt-line


def test_pktline_roundtrip_golden():
    def scenario(m):
        p = m.pkt
        body = (p.encode_pkt("hello\n") + p.FLUSH_PKT + b"0001" +
                p.encode_pkt(b"raw-bytes") + b"0002")
        return (body, [(x.kind, x.payload) for x in p.iter_pkts(body)],
                p.encode_pkt("a\n"))

    want, got = both(scenario)
    assert got == want
    assert got[1] == [("data", b"hello\n"), ("flush", b""), ("delim", b""),
                      ("data", b"raw-bytes"), ("response-end", b"")]
    assert got[2] == b"0006a\n"


CORPUS = [
    b"zzzzoops", b"0003", b"fff5" + b"x" * 100, b"0006ok\n0040only-ten",
    b"0005x00", b"", b"0000", b"00040000", b"0001000200000004",
    b"0009hello0000", b"fff0" + b"y" * 65516, b"fff1" + b"y" * 65517,
    b"000a\x00\xff\x01abc\n0000", b"0008abc",
]


@pytest.mark.parametrize("tolerate", [False, True])
@pytest.mark.parametrize("body", CORPUS, ids=range(len(CORPUS)))
def test_pktline_adversarial_corpus(body, tolerate):
    def scenario(m):
        return outcome(lambda: [(x.kind, x.payload) for x in m.pkt.iter_pkts(
            body, tolerate_truncated=tolerate)])

    want, got = both(scenario)
    assert got == want


def test_pktline_corpus_checks_of_the_reference():
    p = port_pkt
    with pytest.raises(p.PktError, match="reserved"):
        list(p.iter_pkts(b"0003"))
    with pytest.raises(p.PktError, match="oversized"):
        list(p.iter_pkts(b"fff5" + b"x" * 100))
    torn = p.encode_pkt("ok\n") + b"0040only-ten"
    with pytest.raises(p.TruncatedPkt) as ei:
        list(p.iter_pkts(torn))
    assert ei.value.consumed == len(p.encode_pkt("ok\n"))
    assert [x.payload for x in p.iter_pkts(torn, tolerate_truncated=True)] \
        == [b"ok\n"]


def test_encode_pkt_rejects_oversized_payload():
    def scenario(m):
        p = m.pkt
        return (len(p.encode_pkt(b"x" * p.MAX_PKT_PAYLOAD)),
                outcome(lambda: p.encode_pkt(b"x" * (p.MAX_PKT_PAYLOAD + 1))))

    want, got = both(scenario)
    assert got == want
    assert got[0] == port_pkt.MAX_PKT_PAYLOAD + 4 and got[1][0] == "raise"


@pytest.mark.parametrize("band,size", [(1, 120_000), (2, 10), (3, 4),
                                       (1, 0)])
def test_sideband_roundtrip_and_split(band, size):
    def scenario(m):
        p = m.pkt
        payload = (b"status " * (size // 7 + 1))[:size]
        framed = p.encode_sideband(band, payload) + p.encode_sideband(
            3, b"oops")
        return (framed, p.decode_sideband(framed),
                max(len(x.payload) for x in p.iter_pkts(framed)))

    want, got = both(scenario)
    assert got == want
    assert got[2] <= port_pkt.MAX_PKT_PAYLOAD
    assert got[1][2].endswith(b"oops")


# ------------------------------------------------------------ refpolicy


@pytest.mark.parametrize("value", ["r1/a0", "r1/a0/mergeq", "r1/a0/other",
                                   "", "one-part", "a/b/c/d", "//",
                                   " r1/a0 ", "r1//a0"])
def test_identity_from_header_shapes(value):
    def scenario(m):
        ident = m.pol.AgentIdentity.from_header(value)
        if ident is None:
            return None
        return (ident.run, ident.agent, ident.role, ident.merge_queue,
                ident.header_value())

    want, got = both(scenario)
    assert got == want


def test_identity_from_labels():
    def scenario(m):
        out = []
        for labels in ({m.pol.LABEL_AGENT: "a0"},
                       {m.pol.LABEL_AGENT: "a0", m.pol.LABEL_ROLE: "mergeq"},
                       {m.pol.LABEL_AGENT: "a0", m.pol.LABEL_ROLE: "agent"},
                       {}, None):
            ident = m.pol.AgentIdentity.from_labels(labels, "r1")
            out.append(None if ident is None else ident.header_value())
        return out

    want, got = both(scenario)
    assert got == want == ["r1/a0", "r1/a0/mergeq", "r1/a0", None, None]


IDENTITIES = [None, ("r1", "a0", ""), ("r1", "a1", ""), ("r1", "q", "mergeq"),
              ("other-run", "a0", "")]
REFS = ["HEAD", "refs/heads/main", "refs/heads/loop/r1/a0",
        "refs/heads/loop/r1/a0/wip", "refs/heads/loop/r1/a0-suffix",
        "refs/heads/loop/r1/a1", "refs/heads/loop/r1/merged",
        "refs/heads/other", "", "refs/heads/loop/r1/a0/\x00evil",
        "refs/heads/loop/r1/a0/b\x07ell", "refs/heads/loop/r1/a0/../../x",
        "no-refs-prefix", "refs/heads/loop/r1/a0/",
        "refs/heads/loop/r1/a0/x.lock", "refs/heads/loop/r1/a0//y"]


def _ident(m, spec):
    return None if spec is None else m.pol.AgentIdentity(*spec)


@pytest.mark.parametrize("policy", [
    dict(run="r1"), dict(run="r1", branch_prefix="swarm"),
    dict(run="r1", base_refs=("refs/heads/dev",),
         merge_ref="refs/heads/integration")],
    ids=["default", "prefix", "base-and-merge-ref"])
def test_policy_matrix(policy):
    """may_read and may_update over every identity and ref: the same
    verdicts and the same decision documents."""
    def scenario(m):
        pol = m.pol.RefPolicy(**policy)
        return (pol.integration_ref(),
                [[pol.may_read(_ident(m, i), r) for r in REFS]
                 for i in IDENTITIES],
                [[pol.may_update(_ident(m, i), r).to_doc() for r in REFS]
                 for i in IDENTITIES])

    want, got = both(scenario)
    assert got == want


def test_may_update_matrix_of_the_reference():
    pol = port_pol.RefPolicy(run="r1")
    a0 = port_pol.AgentIdentity("r1", "a0")
    mq = port_pol.AgentIdentity("r1", "q", role="mergeq")
    own = "refs/heads/loop/r1/a0"
    assert pol.integration_ref() == "refs/heads/loop/r1/merged"
    assert pol.may_update(a0, own).allowed
    d = pol.may_update(a0, "refs/heads/loop/r1/a1")
    assert not d.allowed and "namespace" in d.reason
    d = pol.may_update(a0, pol.integration_ref())
    assert not d.allowed and "merge-queue" in d.reason
    assert pol.may_update(mq, pol.integration_ref()).allowed
    assert "unauthenticated" in pol.may_update(None, own).reason
    assert "match" in pol.may_update(
        port_pol.AgentIdentity("other-run", "a0"), own).reason


@pytest.mark.parametrize("hosts", [["github.com"],
                                   ["git.example.com", "gitlab.com"], []])
def test_git_egress_rules_shape(hosts):
    def scenario(m):
        rules = m.gg.git_egress_rules(list(hosts))
        return [(r.key(), r.action, m.schema.to_dict(r)) for r in rules]

    want, got = both(scenario)
    assert got == want
    keys = {k: action for k, action, _d in got}
    for h in hosts:
        assert keys[f"{h}:https:443"] == "allow"
        assert keys[f"{h}:ssh:22"] == keys[f"{h}:git:9418"] == "deny"


# ------------------------------------------------------------- protocol


def _advertise(m, refs: dict[str, str], service="git-receive-pack") -> bytes:
    return m.server.FakeGitUpstream(refs=dict(refs)).advertise(service)


ADVERTISED = [
    {"refs/heads/main": SHA_A, "refs/heads/loop/r1/a0": SHA_B,
     "refs/heads/loop/r1/a1": SHA_B},
    {"refs/heads/loop/r1/a0": SHA_B},
    {"refs/heads/loop/r1/a1": SHA_B, "refs/heads/main": SHA_A},
    {},
]


@pytest.mark.parametrize("service", ["git-receive-pack", "git-upload-pack"])
@pytest.mark.parametrize("caller", [None, ("r1", "a1", ""),
                                    ("r1", "q", "mergeq")])
@pytest.mark.parametrize("refs", range(len(ADVERTISED)))
def test_filter_advertisement(refs, caller, service):
    def scenario(m):
        return m.proto.filter_advertisement(
            _advertise(m, ADVERTISED[refs], service), service,
            m.pol.RefPolicy(run="r1"), _ident(m, caller))

    want, got = both(scenario)
    assert got == want


def test_filter_advertisement_checks_of_the_reference():
    body, hidden = port_proto.filter_advertisement(
        _advertise(PKGS["port"], ADVERTISED[0]), "git-receive-pack",
        port_pol.RefPolicy(run="r1"), port_pol.AgentIdentity("r1", "a1"))
    assert hidden == 1 and body.count(b"\x00") == 1
    assert b"loop/r1/a0" not in body and b"loop/r1/a1" in body
    body, hidden = port_proto.filter_advertisement(
        _advertise(PKGS["port"], ADVERTISED[1]), "git-receive-pack",
        port_pol.RefPolicy(run="r1"), None)
    assert hidden == 1 and b"capabilities^{}" in body


def test_filter_ls_refs_drops_hidden():
    def scenario(m):
        p = m.pkt
        body = (p.encode_pkt(f"{SHA_A} refs/heads/main\n") +
                p.encode_pkt(f"{SHA_B} refs/heads/loop/r1/a0\n") +
                p.encode_pkt(f"{SHA_B} refs/heads/loop/r1/a1 peeled:x\n") +
                p.FLUSH_PKT)
        return [m.proto.filter_ls_refs(body, m.pol.RefPolicy(run="r1"),
                                       _ident(m, i)) for i in IDENTITIES]

    want, got = both(scenario)
    assert got == want
    out, hidden = got[2]
    assert hidden == 1 and b"a0" not in out and b"main" in out


def _push_body(m, ref: str, caps: str = "report-status",
               new: str = SHA_B) -> bytes:
    return m.pkt.encode_pkt(f"{ZERO} {new} {ref}".encode() + b"\x00" +
                            caps.encode() + b"\n") + m.pkt.FLUSH_PKT


def _push_doc(push) -> tuple:
    return ([(c.old_sha, c.new_sha, c.ref, c.is_delete)
             for c in push.commands], push.wants_sideband,
            push.wants_report_status, push.pack)


def _receive_bodies(m):
    p = m.pkt
    return [
        (p.encode_pkt(f"{ZERO} {SHA_B} refs/heads/x".encode() +
                      b"\x00report-status side-band-64k\n") +
         p.encode_pkt(f"{SHA_A} {ZERO} refs/heads/gone\n") + p.FLUSH_PKT +
         b"PACKxxxx"),
        _push_body(m, "refs/heads/loop/r1/a0") +
        p.encode_pkt(f"{ZERO} {SHA_B} refs/heads/loop/r1/merged\n") +
        p.FLUSH_PKT,
        _push_body(m, "refs/heads/loop/r1/a0", caps=""),
        b"0003garbage",
        p.encode_pkt(b"not a command\n") + p.FLUSH_PKT,
        p.FLUSH_PKT,
        b"",
    ]


@pytest.mark.parametrize("case", range(7))
def test_parse_receive_commands(case):
    def scenario(m):
        return outcome(lambda: _push_doc(
            m.proto.parse_receive_commands(_receive_bodies(m)[case])))

    want, got = both(scenario)
    assert got == want


def test_parse_receive_checks_of_the_reference():
    push = port_proto.parse_receive_commands(_receive_bodies(PKGS["port"])[0])
    assert [c.ref for c in push.commands] == ["refs/heads/x",
                                              "refs/heads/gone"]
    assert push.commands[1].is_delete and push.pack == b"PACKxxxx"
    with pytest.raises(port_pkt.PktError, match="smuggled"):
        port_proto.parse_receive_commands(_receive_bodies(PKGS["port"])[1])


@pytest.mark.parametrize("caps", ["report-status",
                                  "report-status side-band-64k", ""])
def test_refusal_response_is_atomic(caps):
    """One denied ref refuses the innocent riders in the same push, in
    the same bytes from both packages."""
    def scenario(m):
        p = m.pkt
        pol = m.pol.RefPolicy(run="r1")
        a0 = m.pol.AgentIdentity("r1", "a0")
        body = (p.encode_pkt(f"{ZERO} {SHA_B} refs/heads/loop/r1/a0".encode()
                             + b"\x00" + caps.encode() + b"\n") +
                p.encode_pkt(f"{ZERO} {SHA_B} refs/heads/loop/r1/a1\n") +
                p.FLUSH_PKT)
        push = m.proto.parse_receive_commands(body)
        return m.proto.refusal_response(
            push, [pol.may_update(a0, c.ref) for c in push.commands])

    want, got = both(scenario)
    assert got == want
    if "side-band" in caps:
        text = port_pkt.decode_sideband(got)[0].decode()
    else:
        text = b"".join(x.payload for x in port_pkt.iter_pkts(got)).decode()
    if caps:
        assert "unpack ok" in text and "ok refs/" not in text
        assert "ng refs/heads/loop/r1/a1" in text
        assert "ng refs/heads/loop/r1/a0" in text


# ------------------------------------------- proxy e2e (fake upstream)


def _guarded(m, fn):
    upstream = m.server.FakeGitUpstream(refs={"refs/heads/main": SHA_A})
    decisions = []
    srv = m.server.GitguardServer(upstream, m.pol.RefPolicy(run="r1"),
                                  tcp_addr=("127.0.0.1", 0),
                                  on_decision=decisions.append).start()
    try:
        out = fn(srv, upstream)
    finally:
        srv.close()
    return (out, [(i, r) for _t, i, r in upstream.acknowledged],
            [d.to_doc() for d in decisions])


def _post(port: int, body: bytes, headers: dict) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5.0)
    conn.request("POST", "/repo/git-receive-pack", body=body,
                 headers={"Content-Type":
                          "application/x-git-receive-pack-request",
                          **headers})
    resp = conn.getresponse()
    out = resp.read()
    conn.close()
    return resp.status, out


def _get(port: int, path: str, headers: dict) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5.0)
    conn.request("GET", path, headers=headers)
    resp = conn.getresponse()
    out = resp.read()
    conn.close()
    return resp.status, out


@pytest.mark.parametrize("ref,ident", [
    ("refs/heads/loop/r1/a0", "r1/a0"),
    ("refs/heads/loop/r1/a1", "r1/a0"),
    ("refs/heads/loop/r1/merged", "r1/a0"),
    ("refs/heads/loop/r1/merged", "r1/q/mergeq"),
    ("refs/heads/loop/r1/a0", ""),
    ("refs/heads/loop/r1/a0", "r2/a0"),
], ids=["own", "sibling", "integration", "mergeq", "anonymous",
        "other-run"])
def test_proxy_push(ref, ident):
    def scenario(m):
        headers = {m.pol.IDENTITY_HEADER: ident} if ident else {}
        return _guarded(m, lambda srv, _u: _post(
            srv.port, _push_body(m, ref), headers))

    want, got = both(scenario)
    assert got == want
    (status, out), acked, decisions = got
    assert status == 200
    if ident in ("r1/a0", "r1/q/mergeq") and ref.endswith(
            ident.split("/")[1] if ident == "r1/a0" else "merged"):
        assert f"ok {ref}".encode() in out and acked == [(ident, ref)]
        assert [d["verdict"] for d in decisions] == ["allow"]
    else:
        assert f"ng {ref}".encode() in out and acked == []
        assert [d["verdict"] for d in decisions] == ["deny"]


def test_proxy_duplicate_identity_header_fail_closed():
    def scenario(m):
        def fn(srv, _u):
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=5.0)
            conn.putrequest("POST", "/repo/git-receive-pack")
            body = _push_body(m, "refs/heads/loop/r1/a0")
            conn.putheader("Content-Type",
                           "application/x-git-receive-pack-request")
            conn.putheader("Content-Length", str(len(body)))
            conn.putheader(m.pol.IDENTITY_HEADER, "r1/a0")
            conn.putheader(m.pol.IDENTITY_HEADER, "r1/a1")
            conn.endheaders()
            conn.send(body)
            resp = conn.getresponse()
            out = resp.read()
            conn.close()
            return resp.status, out
        return _guarded(m, fn)

    want, got = both(scenario)
    assert got == want
    assert b"ng refs/heads/loop/r1/a0" in got[0][1] and got[1] == []


def test_proxy_malformed_body_reports_unpack_error():
    def scenario(m):
        return _guarded(m, lambda srv, _u: _post(
            srv.port, b"0003garbage", {m.pol.IDENTITY_HEADER: "r1/a0"}))

    want, got = both(scenario)
    assert got == want
    assert got[0][0] == 200 and b"unpack error" in got[0][1]
    assert got[1] == [] and "malformed" in got[2][0]["reason"]


@pytest.mark.parametrize("path", [
    "/repo/info/refs?service=git-receive-pack",
    "/repo/info/refs?service=git-upload-pack",
    "/repo/info/refs",
    "/repo/info/refs?service=git-frobnicate",
    "/repo/HEAD",
])
@pytest.mark.parametrize("ident", ["r1/a0", ""])
def test_proxy_advertisement_filtered_per_identity(path, ident):
    def scenario(m):
        def fn(srv, upstream):
            upstream.refs["refs/heads/loop/r1/a0"] = SHA_B
            upstream.refs["refs/heads/loop/r1/a1"] = SHA_B
            return _get(srv.port, path,
                        {m.pol.IDENTITY_HEADER: ident} if ident else {})
        return _guarded(m, fn)

    want, got = both(scenario)
    assert got == want
    status, out = got[0]
    if path == "/repo/info/refs":
        assert status == 403    # the dumb protocol: refused outright
    if status == 200 and "receive-pack" in path:
        assert b"loop/r1/a1" not in out
        assert (b"loop/r1/a0" in out) == bool(ident)


def test_proxy_fail_closed_after_close():
    def scenario(m):
        srv = m.server.GitguardServer(
            m.server.FakeGitUpstream(refs={}), m.pol.RefPolicy(run="r1"),
            tcp_addr=("127.0.0.1", 0)).start()
        port = srv.port
        srv.close()
        running = srv.running
        res = outcome(lambda: _post(port, _push_body(
            m, "refs/heads/loop/r1/a0"), {m.pol.IDENTITY_HEADER: "r1/a0"}))
        srv.close()             # idempotent
        return running, res[0], isinstance(res[0], str)

    want, got = both(scenario)
    assert got == want == (False, "raise", True)


def test_proxy_unix_socket_is_private(tmp_path):
    def scenario(m):
        import os
        import stat

        sock = tmp_path / ("r" if m is PKGS["ref"] else "p") / "gg.sock"
        srv = m.server.GitguardServer(
            m.server.FakeGitUpstream(refs={}), m.pol.RefPolicy(run="r1"),
            socket_path=sock).start()
        try:
            return (stat.S_IMODE(os.stat(sock).st_mode),
                    stat.S_IMODE(os.stat(sock.parent).st_mode),
                    srv.running)
        finally:
            srv.close()

    want, got = both(scenario)
    assert got == want == (0o600, 0o700, True)


def test_server_needs_exactly_one_listener():
    def scenario(m):
        mk = lambda **kw: m.server.GitguardServer(    # noqa: E731
            m.server.FakeGitUpstream(), m.pol.RefPolicy(run="r1"), **kw)
        return (outcome(lambda: mk()),
                outcome(lambda: mk(socket_path="x", tcp_addr=("h", 1))))

    want, got = both(scenario)
    assert got == want and got[0][0] == got[1][0] == "raise"


@pytest.mark.parametrize("reason", [
    "", "ref outside agent namespace loop/r1/a0",
    "integration branch is merge-queue only (submit via the queue)",
    "unauthenticated push refused", "identity run 'x' does not match",
    "'..' in ref name", "malformed command list", "refs/ bad"])
def test_reason_class(reason):
    want, got = both(lambda m: m.server.reason_class(reason))
    assert got == want


# ------------------------------------------------- real-git end-to-end


def _git(cwd, *args, header: str = "", check: bool = True):
    cmd = ["git"]
    if header:
        cmd += ["-c", f"http.extraHeader={port_pol.IDENTITY_HEADER}: {header}"]
    cmd += ["-c", "user.email=t@t", "-c", "user.name=t", *args]
    return subprocess.run(cmd, cwd=cwd, check=check,
                          capture_output=True, text=True)


def _real_git(m, root):
    """tests/test_gitguard.py's real-git scenario: -> what each step
    gave, in terms both packages share."""
    upstream_repo = root / "seed"
    upstream_repo.mkdir(parents=True)
    _git(upstream_repo, "init", "-q", "-b", "main")
    (upstream_repo / "f.txt").write_text("base\n")
    _git(upstream_repo, "add", ".")
    _git(upstream_repo, "commit", "-q", "-m", "root")
    _git(upstream_repo, "branch", "loop/r1/a1")
    decisions = []
    srv = m.server.GitguardServer(m.server.LocalRepoUpstream(upstream_repo),
                                  m.pol.RefPolicy(run="r1"),
                                  tcp_addr=("127.0.0.1", 0),
                                  on_decision=decisions.append).start()
    out = {}
    try:
        url = f"http://127.0.0.1:{srv.port}/seed"
        clone = root / "agent0"
        out["clone"] = _git(root, "clone", "-q", url, str(clone)).returncode
        out["cloned_branches"] = _git(clone, "branch", "-r").stdout.split()
        (clone / "work.txt").write_text("agent-0 was here\n")
        _git(clone, "add", ".")
        _git(clone, "commit", "-q", "-m", "work")
        r = _git(clone, "push", "-q", "origin",
                 "HEAD:refs/heads/loop/r1/a0", header="r1/a0", check=False)
        out["own"] = (r.returncode, "loop/r1/a0" in _git(
            upstream_repo, "branch", "--list", "loop/r1/a0").stdout)
        r = _git(clone, "push", "origin", "HEAD:refs/heads/loop/r1/a1",
                 header="r1/a0", check=False)
        out["sibling"] = (r.returncode != 0, "remote rejected" in r.stderr,
                          "namespace" in r.stderr)
        r = _git(clone, "push", "origin", "HEAD:refs/heads/loop/r1/merged",
                 header="r1/a0", check=False)
        out["integration"] = (r.returncode != 0, "merge-queue" in r.stderr)
        r = _git(clone, "push", "-q", "origin",
                 "HEAD:refs/heads/loop/r1/merged", header="r1/q/mergeq",
                 check=False)
        out["mergeq"] = (r.returncode, "loop/r1/merged" in _git(
            upstream_repo, "branch", "--list", "loop/r1/merged").stdout)
        ls = _git(clone, "ls-remote", "origin", header="r1/a0").stdout
        out["ls_remote"] = sorted(line.split("\t")[1]
                                  for line in ls.splitlines())
        out["decisions"] = [(d.verdict, d.ref, d.agent) for d in decisions
                            if d.service == "git-receive-pack"]
        srv.close()
        r = _git(clone, "push", "origin", "HEAD:refs/heads/loop/r1/a0",
                 header="r1/a0", check=False)
        out["after_close"] = r.returncode != 0
    finally:
        srv.close()
    return out


def test_real_git_push_through_guard(tmp_path):
    want = _real_git(PKGS["ref"], tmp_path / "ref")
    got = _real_git(PKGS["port"], tmp_path / "port")
    assert got == want
    assert got["clone"] == 0 and got["own"] == (0, True)
    assert got["sibling"] == (True, True, True)
    assert got["integration"] == (True, True)
    assert got["mergeq"] == (0, True)
    assert "refs/heads/loop/r1/a0" in got["ls_remote"]
    assert "refs/heads/loop/r1/a1" not in got["ls_remote"]
    assert got["after_close"] is True
    assert [v for v, _r, _a in got["decisions"]] == ["allow", "deny", "deny",
                                                     "allow"]


# ---------------------------------------------------------- rule store


def _rule(m, **kw):
    return m.schema.EgressRule(**kw)


RULE_CASES = [
    dict(dst="github.com"), dict(dst="*.example.com", proto="http"),
    dict(dst="", proto="https"), dict(dst="bad..host"),
    dict(dst="-lead.com"), dict(dst="ex ample.com"),
    dict(dst="x.com", proto="htps"), dict(dst="x.com", proto="tcp"),
    dict(dst="x.com", proto="tcp", port=5432),
    dict(dst="x.com", proto="ssh", path_default="deny"),
    dict(dst="x.com", port=70000), dict(dst="x.com", proto="udp"),
]


@pytest.mark.parametrize("case", range(len(RULE_CASES)))
def test_validate_rule(case):
    def scenario(m):
        def build_and_validate():
            r = _rule(m, **RULE_CASES[case])
            m.rules.validate_rule(r)
            return r.key()
        return outcome(build_and_validate)

    want, got = both(scenario)
    assert got == want


HAND_FILE = """# hand-kept egress rules
rules:
  # the package index
  - dst: pypi.org
    proto: https
  - dst: keep.example.com   # do not drop
    proto: https
"""


def test_rules_store_add_merge_remove_effective(tmp_path):
    def scenario(m):
        root = tmp_path / ("ref" if m is PKGS["ref"] else "port")
        root.mkdir()
        path = root / "egress-rules.yaml"
        path.write_text(HAND_FILE)
        store = m.rules.RulesStore(path)
        out = [sorted(r.key() for r in store.load())]
        added = store.add(m.gg.git_egress_rules(["git.example.com"]))
        out.append([r.key() for r in added])
        out.append(path.read_text())
        merged = store.add([_rule(
            m, dst="pypi.org", action="deny",
            path_rules=[m.schema.PathRule(path="/simple", action="allow")])])
        out.append([m.schema.to_dict(r) for r in merged])
        out.append(store.add(m.gg.git_egress_rules(["git.example.com"])))
        out.append(store.remove("git.example.com:ssh:22"))
        out.append(store.remove("absent:https:443"))
        out.append(path.read_text())
        out.append(sorted(r.key() for r in store.effective(
            [_rule(m, dst="api.example.com"), _rule(m, dst="pypi.org")])))
        for key in ("git.example.com:https:443", "git.example.com:git:9418"):
            store.remove(key)
        out.append(path.read_text())
        out.append(outcome(lambda: store.add([_rule(m, dst="x.com",
                                                    proto="htps")])))
        return out

    want, got = both(scenario)
    assert got == want
    assert got[1] == ["git.example.com:https:443", "git.example.com:ssh:22",
                      "git.example.com:git:9418"]
    assert got[2].startswith("# hand-kept egress rules\n")
    assert got[-2].startswith("# hand-kept egress rules\n")
    assert got[4] == [] and got[5] is True and got[6] is False
    assert "git.example.com" not in got[-2]
    assert got[-1][0] == "raise"


def test_rules_store_skips_an_invalid_stored_rule(tmp_path):
    def scenario(m):
        path = tmp_path / ("ref" if m is PKGS["ref"] else "port") / "r.yaml"
        path.parent.mkdir()
        path.write_text("rules:\n  - dst: ok.example.com\n"
                        "  - dst: x.com\n    action: maybe\n"
                        "  - proto: https\n")
        return sorted(r.key() for r in m.rules.RulesStore(path).load())

    want, got = both(scenario)
    assert got == want == ["ok.example.com:https:443"]


@pytest.mark.parametrize("tree", [
    {"rules": []},
    {"rules": [{"dst": "pypi.org", "proto": "https"}]},
    {"rules": [{"dst": "pypi.org", "proto": "https"},
               {"dst": "new.example.com", "proto": "ssh", "port": 22,
                "action": "deny"}]},
    {"rules": [{"dst": "keep.example.com", "proto": "https"}],
     "extra": {"a": 1}},
])
def test_yamledit_apply_edits(tree):
    want, got = both(lambda m: m.yamledit.apply_edits(HAND_FILE, tree))
    assert got == want


# ----------------------------------------------------- scheduler wiring


def test_scheduler_arms_guard_journals_rules_and_tears_down(tmp_path,
                                                             short_sock):
    """--worktrees arms gitguard: the rule keys journaled write-ahead then
    installed, the proxy up, the summary surfaced, and cleanup removing
    exactly the journaled keys (a user's standing rule stays)."""
    def scenario(s):
        s.m.rules.RulesStore(s.cfg.egress_rules_path).add(
            [s.m.rules.EgressRule(dst="pypi.org"),
             s.m.rules.EgressRule(dst="git.example.com", proto="ssh",
                                  port=22, action="deny")])
        drv = driver_with(s.m, 1)
        sched = scheduler(s, drv, parallel=1, iterations=1, worktrees=True)
        sched.start()
        try:
            running = sched.gitguard is not None and sched.gitguard.running
            summary = sched.gitguard_summary()
            installed = store_keys(s)
            sched.run(poll_s=0.05)
        finally:
            sched.cleanup(remove_containers=True)
            drv.close()
        records = journal_of(s, sched.loop_id)
        rules = [r for r in records
                 if r.get("kind") == s.m.journal.REC_GITGUARD_RULES]
        image = s.m.journal.replay(records)
        return {"running": running, "summary": summary,
                "installed": sorted(installed),
                "after": (sched.gitguard, sorted(store_keys(s))),
                "records": [(r["keys"], r["hosts"]) for r in rules],
                "image": sorted(image.gitguard_rules),
                "socket_gone": not short_sock.exists()}

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want
    fresh = sorted(RULE_KEYS - {"git.example.com:ssh:22"})
    assert got["running"] is True
    assert got["summary"] == {"enabled": True, "running": True,
                              "socket": str(short_sock),
                              "hosts": list(HOSTS), "rules": [
                                  "git.example.com:https:443",
                                  "git.example.com:git:9418"],
                              "decisions": {}}
    assert set(fresh) <= set(got["installed"])
    # the user's own ssh pin and pypi rule survive the teardown
    assert got["after"] == (None, ["git.example.com:ssh:22",
                                   "pypi.org:https:443"])
    assert got["records"] == [(["git.example.com:https:443",
                                "git.example.com:git:9418"], list(HOSTS))]
    assert got["image"] == fresh and got["socket_gone"]


def test_no_gitguard_opt_out_disarms(tmp_path, short_sock):
    def scenario(s):
        drv = driver_with(s.m, 1)
        sched = scheduler(s, drv, parallel=1, iterations=1, worktrees=True,
                          gitguard=False)
        sched.start()
        try:
            out = (sched.gitguard, sched.gitguard_summary())
            sched.run(poll_s=0.05)
        finally:
            sched.cleanup(remove_containers=True)
            drv.close()
        return out + (store_keys(s),)

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want == (None, {"enabled": False, "running": False,
                                  "socket": "", "hosts": list(HOSTS),
                                  "rules": [], "decisions": {}}, set())


def test_settings_disable_the_guard(tmp_path, short_sock):
    settings = guard_settings(short_sock) + "  enable: false\n"

    def scenario(s):
        drv = driver_with(s.m, 1)
        sched = scheduler(s, drv, parallel=1, iterations=1, worktrees=True)
        sched.start()
        out = (sched.gitguard, sched.gitguard_summary()["enabled"])
        sched.run(poll_s=0.05)
        sched.cleanup(remove_containers=True)
        drv.close()
        return out

    want, got = twin(tmp_path, scenario, settings)
    assert got == want == (None, False)


def test_guard_decisions_journal_and_ride_the_bus(tmp_path, short_sock):
    """A push through the run's own guard (over its unix socket) journals
    its verdict, rides the bus typed and counts in the summary."""
    def scenario(s):
        import socket as socketlib

        drv = driver_with(s.m, 1)
        events: list = []
        sched = scheduler(s, drv, events=events, parallel=1, iterations=1,
                          worktrees=True)
        sched.start()
        try:
            for ident, ref in (("r/a", f"refs/heads/loop/{sched.loop_id}/x"),
                               (f"{sched.loop_id}/x",
                                f"refs/heads/loop/{sched.loop_id}/x")):
                body = _push_body(PKGS[s.pkg], ref)
                c = socketlib.socket(socketlib.AF_UNIX)
                c.settimeout(5.0)
                c.connect(str(short_sock))
                c.sendall(
                    b"POST /proj/git-receive-pack HTTP/1.1\r\nHost: g\r\n"
                    b"Content-Type: application/x-git-receive-pack-request"
                    b"\r\n" + f"{PKGS[s.pkg].pol.IDENTITY_HEADER}: {ident}"
                    f"\r\nContent-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n".encode() + body)
                while c.recv(65536):
                    pass
                c.close()
            sched.run(poll_s=0.05)
            summary = sched.gitguard_summary()["decisions"]
        finally:
            sched.cleanup(remove_containers=True)
            drv.close()
        records = journal_of(s, sched.loop_id)
        return (summary,
                [(r["verdict"], r["ref"], r["agent"]) for r in records
                 if r["kind"] == s.m.journal.REC_GITGUARD_DECISION],
                [d.split(" ")[0] for _a, e, d in events
                 if e == "gitguard.decision"])

    want, got = twin(tmp_path, scenario, guard_settings(short_sock))
    assert got == want
    assert got[0] == {"deny": 1, "allow": 1}
    assert [v for v, _r, _a in got[1]] == ["deny", "allow"]


# ------------------------------------------------------------ chaos rider


def test_gitguard_probe_script_matches_reference():
    for seed, i in ((99, 4), (SEED, 0), (5, 17)):
        assert (port_chaos_runner.gitguard_probe_script(seed, i)
                == ref_chaos_runner.gitguard_probe_script(seed, i))


def test_poisoned_gitguard_evidence_gives_the_reference_violations(
        tmp_path):
    """tests/test_gitguard.py's ``test_invariant_flags_poisoned_gitguard_
    evidence``: an out-of-namespace landing, a landing after the kill
    and an impossible allow verdict, each through both checkers."""
    cases = [
        {},
        {"acknowledged": [(1.0, "r1/a0", "refs/heads/loop/r1/a1")]},
        {"downed_at": 10.0,
         "acknowledged": [(11.0, "r1/a0", "refs/heads/loop/r1/a0")]},
        {"decisions": [(1.0, {"verdict": "allow", "run": "r1",
                              "agent": "a0",
                              "ref": "refs/heads/loop/r1/a1"})]},
        {"acknowledged": [(1.0, "r1/queue/mergeq",
                           "refs/heads/loop/r1/merged")]},
    ]

    def scenario(s):
        drv, sched = _clean_run(s, n_loops=1, n_workers=1)
        out = []
        for kw in cases:
            audit = {"run": "r1", "branch_prefix": "loop", "downed_at": None,
                     "acknowledged": [], "decisions": [], "probes": []}
            audit.update(kw)
            out.append(s.m.inv.check_invariants(
                drv, s.cfg, sched.loop_id, loops=sched.loops,
                gitguard=audit))
        drv.close()
        return out

    want, got = chaos_twin(tmp_path, scenario)
    assert got == want
    assert got[0] == [] and got[4] == []
    assert all(any(v.startswith("ref-isolation-at-proxy") for v in out)
               for out in got[1:4])


def test_gitguard_down_scenario_holds_invariants_as_reference(tmp_path):
    """tests/test_gitguard.py's ``test_chaos_scenario_with_gitguard_down_
    holds_invariants``: the probes after the kill are refused, nothing
    lands after the down, and the probe script is the reference's."""
    def make(m):
        return m.plan.FaultPlan(
            seed=5, scenario=0, n_workers=2, n_loops=2, iterations=1,
            gitguard=True, events=[
                m.plan.FaultEvent(at_s=0.05, kind="worker_kill", worker=1),
                m.plan.FaultEvent(at_s=0.2, kind="gitguard_down",
                                  worker=-1),
                m.plan.FaultEvent(at_s=0.35, kind="worker_revive",
                                  worker=1)])

    (ref, want), (port, got) = run_plan_twin(tmp_path, make)
    assert got.ok, got.violations
    assert want.ok, want.violations

    def probes(runner):
        return [(p["kind"], p["identity"], p["ref"], p["outcome"])
                for p in runner._gitguard_probes]

    assert probes(port) == probes(ref)
    assert any(p[3] == "refused" for p in probes(port))
    downed = port._gitguard_downed_at
    assert downed is not None
    assert all(ts <= downed
               for ts, _i, _r in port.gitguard_upstream.acknowledged)
