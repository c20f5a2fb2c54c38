"""The port's control-plane bus and watcher against the reference's.

Twins of tests/test_controlplane_bus.py's 12 cases (the topic's fan-out,
drop-oldest and recovered delivery; the docker-events normaliser; the
container state repo and the feeder's reconcile-on-reconnect) and of
tests/test_controlplane.py's three watcher cases (drain-to-zero, the
streak reset, the blind ceiling), each run through both packages on the
same inputs and compared.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from test_torch_controlplane import _engine, _start_agent, both, wait_for


# -------------------------------------------------------------- watcher


def test_drain_to_zero():
    def run(m):
        engine = _engine(m)
        drained = threading.Event()
        w = m.watcher.AgentWatcher(engine, drain_grace_polls=2,
                                   on_drained=drained.set)
        out = []
        # unarmed: zero agents at boot never drains
        out += [w.poll_once(), w.poll_once(), drained.is_set()]
        cid = _start_agent(m, engine)
        out.append(w.poll_once())
        engine.remove_container(cid, force=True)
        out += [w.poll_once(), drained.is_set(), w.poll_once(),
                drained.is_set(), w.polls, w.last_count]
        return out

    want, got = both(run)
    assert got == want
    assert got == [0, 0, False, 1, 0, False, 0, True, 5, 0]


def test_running_agent_resets_streak():
    def run(m):
        engine = _engine(m)
        _start_agent(m, engine)
        drained = threading.Event()
        w = m.watcher.AgentWatcher(engine, drain_grace_polls=1,
                                   on_drained=drained.set)
        return [w.poll_once(), drained.is_set(), w._armed]

    want, got = both(run)
    assert got == want
    assert got == [1, False, True]


class _ListFails:
    def list_containers(self, **kw):
        raise OSError("daemon wedged")


def test_blind_ceiling():
    def run(m):
        blind = threading.Event()
        w = m.watcher.AgentWatcher(_ListFails(), on_blind=blind.set)
        codes = [w.poll_once() for _ in range(m.watcher.LIST_ERR_CEILING)]
        return [m.watcher.LIST_ERR_CEILING, codes, blind.is_set(),
                w.consecutive_errors]

    want, got = both(run)
    assert got == want
    assert got[1] == [-1] * got[0] and got[2]


# ------------------------------------------------------------------ bus


def test_fanout():
    def run(m):
        t = m.pubsub.Topic("t")
        a, b = t.subscribe("a"), t.subscribe("b")
        for i in range(3):
            t.publish(i)
        return [[e.payload for e in (s.get(1), s.get(1), s.get(1))]
                for s in (a, b)]

    want, got = both(run)
    assert got == want == [[0, 1, 2], [0, 1, 2]]


def test_seq_monotonic():
    def run(m):
        t = m.pubsub.Topic("t")
        s = t.subscribe()
        t.publish("x")
        t.publish("y")
        return [s.get(1).seq, s.get(1).seq, s.name]

    want, got = both(run)
    assert got == want == [1, 2, "t-sub"]


def test_slow_subscriber_drops_oldest_without_blocking_publisher():
    def run(m):
        t = m.pubsub.Topic("t")
        s = t.subscribe(buffer=4)
        for i in range(10):
            t.publish(i)
        got = [s.get(0.1).payload for _ in range(4)]
        return [got, s.dropped, s.get(0.05)]

    want, got = both(run)
    assert got == want == [[6, 7, 8, 9], 6, None]


def test_closed_subscription_detaches():
    def run(m):
        t = m.pubsub.Topic("t")
        s = t.subscribe()
        s.close()
        t.publish(1)
        return [t.subscriber_count(), s.get(0.05), s.closed]

    want, got = both(run)
    assert got == want == [0, None, True]


def test_topic_close_unblocks_consumers():
    def run(m):
        t = m.pubsub.Topic("t")
        s = t.subscribe()
        done = threading.Event()

        def consume():
            for _ in s:
                pass
            done.set()

        threading.Thread(target=consume, daemon=True).start()
        t.close()
        unblocked = done.wait(2)
        t.publish(1)        # publish-after-close is a no-op, not an error
        late = t.subscribe()
        return [unblocked, t.subscriber_count(), late.closed]

    want, got = both(run)
    assert got == want == [True, 0, True]


def test_run_subscriber_recovers_handler_errors():
    def run(m):
        t = m.pubsub.Topic("t")
        s = t.subscribe()
        seen: list = []

        def handler(ev):
            if ev.payload == 1:
                raise RuntimeError("boom")
            seen.append(ev.payload)

        th = m.pubsub.run_subscriber(s, handler)
        for i in range(3):
            t.publish(i)
        wait_for(lambda: len(seen) >= 2, 2)
        t.close()
        th.join(2)
        return [seen, th.name, th.is_alive()]

    want, got = both(run)
    assert got == want == [[0, 2], "sub-t-sub", False]


def _event_doc(ev) -> dict | None:
    if ev is None:
        return None
    d = dataclasses.asdict(ev)
    d["ts"] = "now" if abs(d["ts"] - time.time()) < 60 else d["ts"]
    return d | {"full_name": ev.full_name}


def test_container_die_event():
    def run(m):
        c = m.consts
        return _event_doc(m.dockerevents._normalize({
            "Type": "container", "Action": "die", "time": 1_785_000_000,
            "Actor": {"ID": "abc", "Attributes": {
                "name": "clawker.p.dev", "exitCode": "137",
                c.LABEL_PROJECT: "p", c.LABEL_AGENT: "dev",
                c.LABEL_ROLE: "agent"}}}))

    want, got = both(run)
    assert got == want
    assert (got["action"], got["exit_code"], got["full_name"], got["ts"]) == \
        ("die", 137, "p.dev", 1_785_000_000.0)


def test_non_container_and_noise_filtered():
    def run(m):
        n = m.dockerevents._normalize
        return [n({"Type": "network", "Action": "connect", "Actor": {}}),
                n({"Type": "container", "Action": "exec_create: ls",
                   "Actor": {}}),
                _event_doc(n({"Type": "container", "Action": "die",
                              "Actor": {"ID": "x", "Attributes": {
                                  "exitCode": "nope"}}}))]

    want, got = both(run)
    assert got == want
    assert got[:2] == [None, None] and got[2]["exit_code"] is None


def test_health_status_prefix():
    def run(m):
        return _event_doc(m.dockerevents._normalize(
            {"Type": "container", "Action": "health_status: healthy",
             "Actor": {"ID": "x", "Attributes": {}}}))

    want, got = both(run)
    assert got == want and got["action"] == "health_status"


def _engine_with_created(m, name: str = "clawker.p.dev"):
    api = m.fake.FakeDockerAPI()
    api.add_image("img")
    api.set_behavior("img", m.fake.exit_behavior(b"", 0))
    eng = m.api.Engine(api)
    c = m.consts
    cid = eng.create_container(name, m.api.ContainerSpec(
        image="img", labels={c.LABEL_PROJECT: "p", c.LABEL_AGENT: "dev",
                             c.LABEL_ROLE: "agent"}))
    return eng, cid


def _state_doc(st) -> dict | None:
    return None if st is None else dataclasses.asdict(st)


def test_repo_reconcile_and_apply():
    def run(m):
        c = m.consts
        E = m.dockerevents.DockerEvent
        repo = m.dockerevents.ContainerStateRepo()
        repo.reconcile([{"Id": "c1", "Names": ["/clawker.p.dev"],
                         "State": "running",
                         "Labels": {c.LABEL_PROJECT: "p",
                                    c.LABEL_AGENT: "dev"}}])
        out = [[_state_doc(s) for s in repo.running()]]
        repo.apply(E(action="die", container_id="c1"))
        out.append(repo.running())
        repo.apply(E(action="start", container_id="c2", name="n2"))
        repo.apply(E(action="rename", container_id="c2", name="n3"))
        out.append([_state_doc(s) for s in repo.all()])
        repo.apply(E(action="destroy", container_id="c1"))
        out.append(repo.get("c1"))
        return out

    want, got = both(run)
    assert got == want
    assert [s["name"] for s in got[0]] == ["clawker.p.dev"]
    assert got[1] == [] and got[3] is None
    assert [(s["name"], s["running"]) for s in got[2]] == \
        [("clawker.p.dev", False), ("n3", True)]


def test_feeder_streams_engine_events():
    def run(m):
        eng, cid = _engine_with_created(m)
        topic = m.pubsub.Topic("docker")
        sub = topic.subscribe()
        feeder = m.dockerevents.Feeder(eng, topic)
        feeder.start()
        try:
            reconciled = wait_for(lambda: feeder.repo.get(cid) is not None, 2)
            eng.start_container(cid)
            ev = sub.get(2)
            return [reconciled, ev.payload.action, ev.payload.project,
                    ev.payload.container_id == cid, feeder.reconnects]
        finally:
            feeder.stop()

    want, got = both(run)
    assert got == want == [True, "start", "p", True, 0]


def test_feeder_reconnects_after_stream_loss():
    def run(m):
        eng, cid = _engine_with_created(m)
        topic = m.pubsub.Topic("docker")
        feeder = m.dockerevents.Feeder(eng, topic, backoff_s=0.05)
        feeder.start()
        try:
            time.sleep(0.1)
            eng.api.close_events()      # the daemon drops the stream
            reconnected = wait_for(lambda: feeder.reconnects >= 1, 3)
            sub = topic.subscribe()
            time.sleep(0.15)
            eng.start_container(cid)
            ev = sub.get(2)
            return [reconnected, ev is not None and ev.payload.action]
        finally:
            feeder.stop()

    want, got = both(run)
    assert got == want == [True, "start"]
