"""The port's socket bridge against the reference's.

Twins of tests/test_socketbridge.py: the frame codec (each package reads
the other's frames), a REAL end-to-end relay per package (the
container-side endpoint as a subprocess on stdio pipes, a throwaway unix
"ssh agent" on the host side, clients dialing the container-side
socket), and the CLOSE answer to an OPEN with nothing to forward.  The
reference's ``test_pyz_contains_container_side`` reads the agentd
zipapp, which comes with the agentd zipapp builder (ROADMAP §1
item 12b); its twin builds a zip of the container side's files alone and
runs the port's own exec command (``host.CONTAINER_CMD``) against it.

On the fake engine the bridge runs against the fake's exec handler: the
post-start bootstrap execs the port's container side into the started
container, as the reference's does, and the stream's EOF closes it.
"""

from __future__ import annotations

import io
import logging
import os
import socket
import socketserver
import subprocess
import sys
import threading
import time
import zipfile
from pathlib import Path
from types import SimpleNamespace

import pytest

import clawker_tpu.config as ref_config
import clawker_tpu.controlplane.bootstrap as ref_bootstrap
import clawker_tpu.engine.drivers as ref_drivers
import clawker_tpu.socketbridge.host as ref_host
import clawker_tpu.socketbridge.protocol as ref_protocol
import clawker_tpu_torch.config as port_config
import clawker_tpu_torch.consts as port_consts
import clawker_tpu_torch.controlplane.bootstrap as port_bootstrap
import clawker_tpu_torch.engine.drivers as port_drivers
import clawker_tpu_torch.socketbridge.host as port_host
import clawker_tpu_torch.socketbridge.protocol as port_protocol
from test_torch_loopd import _time_limit  # noqa: F401 -- fixture

REPO = Path(__file__).resolve().parent.parent

PKGS = {
    "ref": SimpleNamespace(name="clawker_tpu", host=ref_host,
                           protocol=ref_protocol, bootstrap=ref_bootstrap,
                           drivers=ref_drivers, config=ref_config),
    "port": SimpleNamespace(name="clawker_tpu_torch", host=port_host,
                            protocol=port_protocol, bootstrap=port_bootstrap,
                            drivers=port_drivers, config=port_config),
}


# ------------------------------------------------------------------ codec


def test_frame_roundtrip():
    for writer, reader in ((ref_protocol, port_protocol),
                           (port_protocol, ref_protocol)):
        frame = writer.pack(7, writer.K_DATA, writer.W_SSH, b"agent bytes")
        assert frame == reader.pack(7, reader.K_DATA, reader.W_SSH,
                                    b"agent bytes")
        assert reader.read_frame(io.BytesIO(frame)) == (
            7, reader.K_DATA, reader.W_SSH, b"agent bytes")


def _eof_cases(m) -> list:
    truncated = m.pack(1, m.K_DATA, m.W_SSH, b"xyz")[:-1]
    return [m.read_frame(io.BytesIO(b"")),
            m.read_frame(io.BytesIO(m.pack(1, m.K_OPEN, m.W_SSH)[:-1]
                                    or b"\x00")),
            m.read_frame(io.BytesIO(truncated))]


def test_frame_eof_and_truncation():
    assert _eof_cases(port_protocol) == _eof_cases(ref_protocol) == [
        None, None, None]


def test_chunked_splits_large_payloads():
    data = b"x" * (port_protocol.MAX_PAYLOAD * 2 + 5)
    frames = list(port_protocol.chunked(3, port_protocol.W_SSH, data))
    assert frames == list(ref_protocol.chunked(3, ref_protocol.W_SSH, data))
    assert len(frames) == 3
    total = b""
    buf = io.BytesIO(b"".join(frames))
    while (f := ref_protocol.read_frame(buf)) is not None:
        total += f[3]
    assert total == data


# ------------------------------------------------------------------- e2e


class FakeAgent(socketserver.ThreadingUnixStreamServer):
    """Unix 'ssh-agent': echoes whatever it is sent."""

    daemon_threads = True      # handlers block in recv; never join them
    block_on_close = False

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            # raw echo: stream-safe under arbitrary recv segmentation
            while True:
                data = self.request.recv(65536)
                if not data:
                    return
                self.request.sendall(data)


class _PipeStream:
    """read/write/close adapter over a subprocess's stdio pipes."""

    def __init__(self, proc):
        self.proc = proc

    def read(self, n):
        return self.proc.stdout.read(n)

    def write(self, data):
        self.proc.stdin.write(data)
        self.proc.stdin.flush()

    def close(self):
        try:
            self.proc.stdin.close()
        except OSError:
            pass


@pytest.fixture
def relays(tmp_path):
    """One live relay per package: its host ``Bridge`` and its
    container side in a subprocess -> {pkg: container-side socket}."""
    agent_sock = tmp_path / "host-agent.sock"
    agent = FakeAgent(str(agent_sock), FakeAgent.Handler)
    threading.Thread(target=agent.serve_forever, daemon=True).start()
    started = []
    out = {}
    try:
        for pkg, m in PKGS.items():
            sock_dir = tmp_path / pkg
            env = dict(os.environ, CLAWKER_SOCK_DIR=str(sock_dir),
                       PYTHONPATH=str(REPO))
            proc = subprocess.Popen(
                [sys.executable, "-u", "-m",
                 f"{m.name}.socketbridge.container"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
            bridge = m.host.Bridge(_PipeStream(proc),
                                   {m.protocol.W_SSH: str(agent_sock)})
            bridge.start()
            started.append((bridge, proc))
            sock = sock_dir / "ssh-agent.sock"
            deadline = time.time() + 10
            while not sock.exists() and time.time() < deadline:
                time.sleep(0.05)
            assert sock.exists(), f"{pkg}: container-side socket never appeared"
            out[pkg] = sock
        yield out
    finally:
        for bridge, proc in started:
            bridge.close()
            proc.terminate()
            proc.wait(5)
        agent.shutdown()
        agent.server_close()


def _roundtrip(container_sock: Path, payload: bytes) -> bytes:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.settimeout(10)
        c.connect(str(container_sock))
        c.sendall(payload)
        got = b""
        while len(got) < len(payload):
            chunk = c.recv(65536)
            if not chunk:
                break
            got += chunk
        return got


def test_e2e_agent_roundtrip(relays):
    payload = b"\x00\x00\x00\x01\x0b"   # SSH2_AGENTC_REQUEST_IDENTITIES-ish
    assert _roundtrip(relays["port"], payload) == \
        _roundtrip(relays["ref"], payload) == payload


def _concurrent(sock: Path) -> dict:
    results = {}

    def worker(i):
        results[i] = _roundtrip(sock, f"req-{i}".encode() * 100)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(15)
    return results


def test_e2e_concurrent_connections(relays):
    want = {i: f"req-{i}".encode() * 100 for i in range(5)}
    assert _concurrent(relays["port"]) == _concurrent(relays["ref"]) == want


def test_e2e_large_payload_chunking(relays):
    payload = bytes(range(256)) * 600   # ~150 KiB: crosses MAX_PAYLOAD
    assert _roundtrip(relays["port"], payload) == \
        _roundtrip(relays["ref"], payload) == payload


def _open_without_socket(m) -> tuple | None:
    """An OPEN for a ``which`` with no host-side socket: -> the frame
    the bridge answers with."""
    r_h, w_c = os.pipe()   # container -> host
    r_c, w_h = os.pipe()   # host -> container
    host_in = os.fdopen(r_h, "rb")
    host_out = os.fdopen(w_h, "wb")
    cont_in = os.fdopen(r_c, "rb")
    cont_out = os.fdopen(w_c, "wb")

    class _S:
        def read(self, n):
            return host_in.read(n)

        def write(self, d):
            host_out.write(d)
            host_out.flush()

        def close(self):
            for f in (host_in, host_out):
                try:
                    f.close()
                except OSError:
                    pass

    bridge = m.host.Bridge(_S(), host_sockets={})  # nothing forwardable
    bridge.start()
    cont_out.write(m.protocol.pack(9, m.protocol.K_OPEN, m.protocol.W_SSH))
    cont_out.flush()
    frame = m.protocol.read_frame(cont_in)
    cont_out.close()   # EOF the pump thread before closing the bridge
    bridge.close()
    try:
        cont_in.close()
    except OSError:
        pass
    return frame


def test_open_without_host_socket_closes_channel():
    assert _open_without_socket(PKGS["port"]) == \
        _open_without_socket(PKGS["ref"]) == (
            9, port_protocol.K_CLOSE, port_protocol.W_SSH, b"")


def test_pyz_contains_container_side(tmp_path):
    """The container side runs from a zip of its own files (the
    zipapp's shape) through the port's exec command, which names the
    port's package: an EOF on stdin ends it cleanly."""
    files = ["clawker_tpu_torch/__init__.py",
             "clawker_tpu_torch/socketbridge/__init__.py",
             "clawker_tpu_torch/socketbridge/protocol.py",
             "clawker_tpu_torch/socketbridge/container.py"]
    pyz = tmp_path / "agentd.pyz"
    with zipfile.ZipFile(pyz, "w") as zf:
        for name in files:
            zf.write(REPO / name, name)
    cmd = [arg.replace(port_host.consts.AGENTD_PYZ_PATH, str(pyz))
           for arg in port_host.CONTAINER_CMD]
    assert cmd != port_host.CONTAINER_CMD
    assert "from clawker_tpu_torch.socketbridge.container import main" \
        in port_host.CONTAINER_CMD[-1]
    assert port_host.CONTAINER_CMD[-1].replace("clawker_tpu_torch",
                                               "clawker_tpu") \
        == ref_host.CONTAINER_CMD[-1]
    env = {"PATH": os.environ.get("PATH", ""),
           "CLAWKER_SOCK_DIR": str(tmp_path / "run")}
    proc = subprocess.run([sys.executable if c == "python3" else c
                           for c in cmd], input=b"", env=env,
                          capture_output=True, timeout=30, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    # the host side stays out of the zip and out of the run
    assert "socketbridge/host.py" not in "".join(files)


# ------------------------------------------------------- on the fake engine


def _post_start(pkg: str, host_sockets: dict) -> tuple[list, list]:
    """``post_start_services`` for one started fake container with the
    given host agent sockets: -> (exec commands the fake saw, warning
    lines the bootstrap logged)."""
    m = PKGS[pkg]
    settings = m.config.Settings()
    cfg = SimpleNamespace(settings=settings)
    drv = m.drivers.FakeDriver(n_workers=1)
    api = drv.api
    api.add_image("img:1")
    engine = drv.engine()
    engine._socketbridge_manager = m.host.SocketBridgeManager(
        engine, host_sockets=host_sockets)
    cid = api.container_create("clawker.p.a", {
        "Image": "img:1",
        "Labels": {port_consts.LABEL_MANAGED: port_consts.MANAGED_VALUE}})["Id"]
    api.container_start(cid)
    seen: list[str] = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda rec: seen.append(rec.getMessage())
    m.bootstrap.log.addHandler(handler)
    try:
        m.bootstrap.post_start_services(cfg, drv, cid)
    finally:
        m.bootstrap.log.removeHandler(handler)
        engine._socketbridge_manager.close()
    cmds = [args[1]["Cmd"] for args, _ in api.calls_named("exec_create")]
    return cmds, [line.replace(cid, "CID") for line in seen]


@pytest.mark.parametrize("forward", [True, False], ids=["agent", "none"])
def test_post_start_bridges_over_the_fake_exec_handler(tmp_path, forward):
    sockets = {port_protocol.W_SSH: str(tmp_path / "agent.sock")} \
        if forward else {}
    want_cmds, want_log = _post_start("ref", sockets)
    got_cmds, got_log = _post_start("port", sockets)
    assert got_log == want_log
    assert got_cmds == [port_host.CONTAINER_CMD] * len(want_cmds)
    assert len(got_cmds) == (1 if forward else 0)
