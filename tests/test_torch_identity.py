"""The create path's identity bootstrap: the port's
``controlplane/identity.py`` and ``controlplane/registry.py`` against the
reference's, on the CPU.

Each create of ``run``/``container create`` (the CLI's factory wires
``make_bootstrapper`` as ``AgentRuntime.bootstrap``) tars the agent's
identity into the container at ``/run/clawker/bootstrap`` before it
first starts and binds a row in ``<data>/agents.db``.  The twins run the
same creates through both packages' CLIs, each under its own
``TestEnv`` and ``FakeDriver``, and compare the archive's member names
and modes, the assertion JWT's header and claims (not its signature
bytes, which are random), the registry rows and the leaf cache's hits;
then the module functions alone: the tar's bytes at a pinned clock, the
JWT checks' error texts, and the registry's writes.
"""

from __future__ import annotations

import base64
import io
import json
import tarfile
from pathlib import Path

import pytest

import clawker_tpu.controlplane.identity as ref_identity
import clawker_tpu.controlplane.registry as ref_registry
import clawker_tpu.util.phases as ref_phases
import clawker_tpu_torch.controlplane.identity as port_identity
import clawker_tpu_torch.controlplane.registry as port_registry
import clawker_tpu_torch.util.phases as port_phases
from test_torch_verbs import PKGS, invoke, side, twin

IDENTITY = {"ref": ref_identity, "port": port_identity}
REGISTRY = {"ref": ref_registry, "port": port_registry}
PHASES = {"ref": ref_phases, "port": port_phases}


def _b64(s: str) -> dict:
    return json.loads(base64.urlsafe_b64decode(s + "=" * (-len(s) % 4)))


def _bootstrap_tar(api, cid: str) -> bytes:
    return api.containers[cid].archives["/run/clawker"]


def _members(tar: bytes) -> tuple[list[tuple], dict[str, bytes]]:
    with tarfile.open(fileobj=io.BytesIO(tar)) as tf:
        members = [(m.name, oct(m.mode), m.type.decode() or "0")
                   for m in tf.getmembers()]
        files = {m.name: tf.extractfile(m).read() for m in tf.getmembers()
                 if m.isfile()}
    return members, files


def _created(s) -> dict[str, str]:
    """agent -> container id of every agent container the fake holds."""
    return {c.config["Labels"]["dev.clawker-tpu.agent"]: cid
            for cid, c in s.api.containers.items()}


def _identity_view(s) -> dict:
    """What each create installed and bound, normalised: per agent the
    archive's members, the JWT's header and claims (container id,
    times and jti checked, then replaced), the leaf's facts, and the
    registry row."""
    m = IDENTITY[s.m.pkg]
    ca_pem = (s.factory.config.pki_dir / "ca.crt").read_bytes()
    rows = {r.agent: r for r in REGISTRY[s.m.pkg].Registry(
        s.factory.config.data_dir / "agents.db").list()}
    out = {}
    for agent, cid in sorted(_created(s).items()):
        members, files = _members(_bootstrap_tar(s.api, cid))
        header, claims, sig = files["bootstrap/assertion.jwt"].decode().split(".")
        header, claims = _b64(header), _b64(claims)
        assert claims.pop("container_id") == cid
        assert claims.pop("exp") - claims.pop("iat") == m.ASSERTION_TTL_S
        assert len(claims.pop("jti")) == 16
        assert len(base64.urlsafe_b64decode(sig + "==")) == 64
        assert files["bootstrap/ca.crt"] == ca_pem
        assert len(files["bootstrap/session.key"]) == 64
        row = rows[agent]
        assert row.container_id == cid
        assert row.cert_sha256 == m.cert_fingerprint(
            files["bootstrap/agent.crt"])
        assert row.last_seen > 0
        out[agent] = {
            "members": members, "header": header, "claims": claims,
            "leaf": files["bootstrap/agent.crt"].startswith(
                b"-----BEGIN CERTIFICATE-----"),
            "row": (row.full_name, row.project, row.agent, row.worker,
                    row.state, row.initialized, row.registered_at),
        }
    return out


def test_run_and_create_install_the_bootstrap_and_bind_rows(tmp_path):
    def scenario(s):
        codes = [invoke(s, "run", "--detach", "--agent", "a1")[0],
                 invoke(s, "container", "create", "--agent", "a2")[0]]
        return codes, _identity_view(s), sorted(
            (a, k) for a, k in s.api.calls_named("put_archive")
            if a[1] == "/run/clawker")

    want, got = twin(tmp_path, scenario)
    codes, view, archives = got
    assert (codes, view) == (want[0], want[1])
    assert codes == [0, 0] and set(view) == {"a1", "a2"}
    a1 = view["a1"]
    assert a1["members"] == [
        ("bootstrap", "0o700", "5"), ("bootstrap/agent.crt", "0o644", "0"),
        ("bootstrap/agent.key", "0o600", "0"), ("bootstrap/ca.crt", "0o644", "0"),
        ("bootstrap/assertion.jwt", "0o600", "0"),
        ("bootstrap/session.key", "0o600", "0")]
    assert a1["header"] == {"alg": "ES256", "typ": "JWT"}
    assert a1["claims"] == {"iss": "clawker-tpu", "sub": "demo.a1",
                            "project": "demo", "agent": "a1",
                            "scope": "self.register"}
    assert a1["row"] == ("demo.a1", "demo", "a1", "", "created", False, 0.0)
    assert len(archives) == len(want[2]) == 2


def test_port_assertion_verifies_with_either_package(tmp_path):
    """The port's token, signed by the port's CA key, verifies under the
    reference's ``verify_jwt_es256`` and the port's, and a tampered
    payload fails both with the same text."""
    with side("port", tmp_path) as s:
        invoke(s, "run", "--detach")
        cid = _created(s)["dev"]
        token = _members(_bootstrap_tar(s.api, cid))[1][
            "bootstrap/assertion.jwt"].decode()
        ca = port_identity.pki.ensure_ca(s.factory.config.pki_dir)
    pub = ca.key.public_key()
    claims = {pkg: m.verify_jwt_es256(pub, token)
              for pkg, m in IDENTITY.items()}
    assert claims["ref"] == claims["port"]
    assert claims["port"]["container_id"] == cid
    head, payload, sig = token.split(".")
    forged = ".".join((head, port_identity._b64url(json.dumps(
        dict(claims["port"], agent="other")).encode()), sig))
    errs = {}
    for pkg, m in IDENTITY.items():
        with pytest.raises(m.IdentityError) as exc:
            m.verify_jwt_es256(pub, forged)
        errs[pkg] = str(exc.value)
    assert errs["ref"] == errs["port"]
    assert errs["port"].startswith("invalid assertion JWT")


def test_second_create_hits_the_leaf_cache(tmp_path):
    """A re-create of the same agent reuses its leaf (a cache hit) while
    the assertion and the session key are new."""
    def scenario(s):
        IDENTITY[s.m.pkg].clear_identity_cache()
        phases = PHASES[s.m.pkg]
        phases.enable()
        try:
            invoke(s, "run", "--detach")
            first = _members(_bootstrap_tar(s.api, _created(s)["dev"]))[1]
            invoke(s, "run", "--detach", "--replace")
            second = _members(_bootstrap_tar(s.api, _created(s)["dev"]))[1]
            counts = phases.counts()
        finally:
            phases.disable()
        same = {k: first[k] == second[k] for k in sorted(first)}
        return ({k: counts.get(k, 0) for k in (
            "identity.leaf_cache_hit", "identity.leaf_cache_miss",
            "identity_bootstrap", "identity_install", "identity_mint_leaf")},
            same, len(s.api.containers))

    want, got = twin(tmp_path, scenario)
    assert got == want
    counts, same, containers = got
    assert counts == {"identity.leaf_cache_hit": 1,
                      "identity.leaf_cache_miss": 1, "identity_bootstrap": 2,
                      "identity_install": 2, "identity_mint_leaf": 2}
    assert same == {"bootstrap/agent.crt": True, "bootstrap/agent.key": True,
                    "bootstrap/assertion.jwt": False, "bootstrap/ca.crt": True,
                    "bootstrap/session.key": False}
    assert containers == 1


def test_prewarm_mints_once_per_agent(tmp_path):
    out = {}
    for pkg, m in IDENTITY.items():
        m.clear_identity_cache()
        ca = m.pki.ensure_ca(tmp_path / pkg)
        out[pkg] = (m.prewarm_identities(ca, "p", ["a", "b", "a"]),
                    m.prewarm_identities(ca, "p", ["a", "c"]))
        m.clear_identity_cache()
    assert out["ref"] == out["port"] == (2, 1)


def test_bootstrap_tar_bytes_at_a_pinned_clock(monkeypatch):
    """The same material tars to the same bytes in both packages."""
    tars = {}
    for pkg, m in IDENTITY.items():
        monkeypatch.setattr(m.time, "time", lambda: 1_700_000_000.0)
        mat = m.BootstrapMaterial(agent_cert=b"CERT\n", agent_key=b"KEY\n",
                                  ca_cert=b"CA\n", assertion_jwt="h.p.s",
                                  session_key="00" * 32)
        tars[pkg] = (mat.tar_bytes(), mat.tar_bytes(prefix="bootstrap"))
    assert tars["ref"] == tars["port"]


@pytest.mark.parametrize("case", ["expired", "future", "alg", "short-sig",
                                  "garbage"])
def test_jwt_checks_fail_with_the_reference_texts(tmp_path, case):
    errs = {}
    for pkg, m in IDENTITY.items():
        ca = m.pki.ensure_ca(tmp_path / pkg)
        now = 1_700_000_000
        claims = {"sub": "p.a", "iat": now, "exp": now + 60}
        token = m.sign_jwt_es256(ca.key, claims)
        head, payload, sig = token.split(".")
        token, at = {
            "expired": (token, now + 61),
            "future": (token, now - 301),
            "alg": (".".join((m._b64url(b'{"alg":"HS256"}'), payload, sig)),
                    now),
            "short-sig": (".".join((head, payload, m._b64url(b"x" * 10))),
                          now),
            "garbage": ("not-a-jwt", now),
        }[case]
        with pytest.raises(m.IdentityError) as exc:
            m.verify_jwt_es256(ca.key.public_key(), token, now=at)
        errs[pkg] = str(exc.value)
    assert errs["ref"] == errs["port"]


def _registry_flow(m, path: Path) -> list:
    reg = m.Registry(path)
    try:
        reg.bind("p.a", "p", "a", container_id="c1", cert_sha256="f1")
        reg.bind("p.b", "p", "b", container_id="c2", cert_sha256="f2",
                 worker="w1")
        reg.bind("q.a", "q", "a", container_id="c3", cert_sha256="f3")
        ok = [reg.mark_registered("p.a", "f1"),
              reg.mark_registered("p.b", "wrong")]
        reg.mark_initialized("p.a")
        reg.bind("p.a", "p", "a", container_id="c1", cert_sha256="f1b")
        keep_init = reg.get("p.a").initialized
        reg.bind("p.a", "p", "a", container_id="c9", cert_sha256="f9")
        reg.set_state("p.b", "stopped")
        reg.touch("q.a")
        reg.remove("q.a")

        def row(r):
            return None if r is None else (
                r.full_name, r.project, r.agent, r.container_id,
                r.cert_sha256, r.worker, r.state, r.initialized,
                r.registered_at == 0)

        return [ok, keep_init, [row(r) for r in reg.list()],
                [row(r) for r in reg.list("p")], row(reg.get("q.a")),
                row(reg.by_container("c9")), row(reg.by_container("c1"))]
    finally:
        reg.close()


def test_registry_writes_and_reads_match_the_reference(tmp_path):
    got = {pkg: _registry_flow(m, tmp_path / pkg / "agents.db")
           for pkg, m in REGISTRY.items()}
    assert got["ref"] == got["port"]
    ok, keep_init, rows, _, gone, by_c9, by_c1 = got["port"]
    assert ok == [True, False] and keep_init is True and gone is None
    assert by_c9[3] == "c9" and by_c9[7] is False and by_c1 is None
    assert [r[0] for r in rows] == ["p.a", "p.b"]


def test_one_registry_file_read_by_the_other_package(tmp_path):
    """The port binds, the reference reads the same ``agents.db`` (and
    the other way): one schema."""
    path = tmp_path / "agents.db"
    reg = port_registry.Registry(path)
    reg.bind("p.a", "p", "a", container_id="c1", cert_sha256="f1")
    reg.close()
    ref = ref_registry.Registry(path)
    try:
        rec = ref.get("p.a")
        ref.mark_registered("p.a", "f1")
    finally:
        ref.close()
    assert (rec.container_id, rec.cert_sha256, rec.state) == ("c1", "f1",
                                                            "created")
    reg = port_registry.Registry(path)
    try:
        assert reg.get("p.a").state == "registered"
    finally:
        reg.close()


def test_ps_and_stop_never_open_the_registry(tmp_path):
    """Only the create path opens ``agents.db``: a factory that lists
    and stops never builds its registry."""
    with side("port", tmp_path) as s:
        invoke(s, "run", "--detach")
        db = s.factory.config.data_dir / "agents.db"
        assert db.exists()
        f = PKGS["port"].Factory(cwd=s.proj, driver=s.drv)
        s.factory = f
        invoke(s, "ps")
        invoke(s, "stop", "dev")
        assert "agent_registry" not in f.__dict__
