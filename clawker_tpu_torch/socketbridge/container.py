"""Container-side bridge endpoint (runs under ``docker exec``).

Creates the in-container unix sockets (ssh-agent / gpg-agent), accepts
client connections, and muxes their bytes over stdio to the host side.
Stdlib-only; launched from the agentd zipapp:

    PYTHONPATH=/usr/local/lib/clawker-agentd.pyz \\
        python3 -m clawker_tpu_torch.socketbridge.container

Parity reference: the reference's in-container ``clawker-socket-server``
binary (internal/hostproxy/internals/cmd), reached the same way (exec'd
by the host, stdio as the channel).

The port's copy of ``clawker_tpu/socketbridge/container.py``, whole.
The agentd zipapp it ships in waits for its builder, with the image
builds (ROADMAP §1 item 13).
"""

from __future__ import annotations

import os
import socket
import sys
import threading

from .protocol import (
    K_CLOSE,
    K_DATA,
    K_OPEN,
    W_GPG,
    W_SSH,
    chunked,
    pack,
    read_frame,
)

SOCK_DIR = "/run/clawker"
SOCK_PATHS = {
    W_SSH: f"{SOCK_DIR}/ssh-agent.sock",
    W_GPG: f"{SOCK_DIR}/gpg-agent.sock",
}


class ContainerBridge:
    def __init__(self, stdin, stdout, sock_paths: dict[int, str] | None = None):
        self.stdin = stdin
        self.stdout = stdout
        self.sock_paths = sock_paths or SOCK_PATHS
        self._conns: dict[int, socket.socket] = {}
        self._next_channel = 1
        self._lock = threading.Lock()
        self._closed = threading.Event()

    def _send(self, frame: bytes) -> None:
        with self._lock:
            self.stdout.write(frame)
            self.stdout.flush()

    # ------------------------------------------------------- accept side

    def _serve_listener(self, which: int, path: str) -> None:
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if os.path.exists(path):
                os.unlink(path)
            srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            # analyze: allow(socket-hardening): in-container bridge
            # endpoint -- 0666 is the contract (the agent user is not the
            # exec user) and the container namespace is the boundary
            srv.bind(path)
            os.chmod(path, 0o666)  # the agent user is not the exec user
            srv.listen(8)
        except OSError as e:
            print(f"socketbridge: listener {path}: {e}", file=sys.stderr)
            return
        while not self._closed.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                break
            with self._lock:
                channel = self._next_channel
                self._next_channel += 1
                self._conns[channel] = conn
            self._send(pack(channel, K_OPEN, which))
            threading.Thread(
                target=self._pump_conn, args=(channel, which, conn),
                daemon=True,
            ).start()
        srv.close()

    def _pump_conn(self, channel: int, which: int, conn: socket.socket) -> None:
        try:
            while True:
                data = conn.recv(65536)
                if not data:
                    break
                for frame in chunked(channel, which, data):
                    self._send(frame)
        except OSError:
            pass
        self._drop(channel, which, notify=True)

    def _drop(self, channel: int, which: int, *, notify: bool) -> None:
        with self._lock:
            conn = self._conns.pop(channel, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            if notify:
                self._send(pack(channel, K_CLOSE, which))

    # ------------------------------------------------------ host -> here

    def run(self) -> None:
        for which, path in self.sock_paths.items():
            threading.Thread(
                target=self._serve_listener, args=(which, path), daemon=True
            ).start()
        while True:
            frame = read_frame(self.stdin)
            if frame is None:
                break
            channel, kind, which, payload = frame
            if kind == K_DATA:
                conn = self._conns.get(channel)
                if conn is not None:
                    try:
                        conn.sendall(payload)
                    except OSError:
                        self._drop(channel, which, notify=True)
            elif kind == K_CLOSE:
                self._drop(channel, which, notify=False)
        self._closed.set()
        for ch in list(self._conns):
            self._drop(ch, 0, notify=False)


def main() -> int:
    sock_dir = os.environ.get("CLAWKER_SOCK_DIR", SOCK_DIR)
    paths = {w: p.replace(SOCK_DIR, sock_dir, 1) for w, p in SOCK_PATHS.items()}
    ContainerBridge(sys.stdin.buffer, sys.stdout.buffer, paths).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
