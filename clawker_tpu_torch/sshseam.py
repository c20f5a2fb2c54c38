"""The loopback ``ssh`` program: a pod of SSH workers on one machine.

Test support, installed by :func:`clawker_tpu_torch.testenv.install_ssh_shim`
as an executable named ``ssh`` first on ``PATH``: the fleet transport's
real :class:`~clawker_tpu_torch.fleet.transport.Runner` execs it with the
argv it would hand OpenSSH.  A host map (JSON, re-read while a forward
runs, so a case can mark a host down or up again) gives each worker host
a root directory on this machine and two loopback addresses of its own.
Every invocation is appended to a log file as one JSON line
(``kind``, ``host``, ``argv``).

What it does, by the shape of the argv:

- ``-O exit``: exit 0 (there is no ControlMaster to stop);
- a host marked down: exit 255 with ssh's "Connection refused" text;
- ``-N -L local:remote``: listen on ``local`` at once, as ssh does; each
  connection dials ``<root><remote>`` and relays both ways, and a remote
  socket that is absent closes that one connection only;
- ``-N -R bind:port:lhost:lport``: listen on the worker's own address for
  ``bind`` (the gateway and the worker's loopback each map to one) and
  relay each connection to ``lhost:lport``; a bind that fails exits 255,
  as ``ExitOnForwardFailure`` makes ssh do;
- a remote command, only one of: ``true``; ``tail -n +1 -F PATH
  2>/dev/null`` (run by ``bash`` under ``HOME=<root>/home/<user>`` with
  ``XDG_STATE_HOME`` unset, cwd ``<root>``); the ``/dev/tcp`` readiness
  probe of a reverse forward, dialled at the mapped address; ``mkdir -p
  X && tar -xzf - -C X``, X mapped under the root.  Anything else exits
  127 with "loopback ssh: command not allowed": no ``sudo``, package
  manager, build, service manager or container command ever runs on the
  machine that runs this.

A forward exits 0 on SIGTERM, and 255 when its host is marked down.
The module imports nothing of the package, and the installed program
runs it in an isolated interpreter without ``site`` (``-I -S``), so
each invocation starts in a few tens of milliseconds.
"""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import sys
import threading
import time

# OpenSSH options that take an argument (ssh(1))
_ARG_OPTS = set("BbcDEeFIiJLlmOopQRSWw")

_TAIL = re.compile(r"^tail -n \+1 -F ([\w${}:\-/.+]+) 2>/dev/null$")
_PROBE = re.compile(
    r"^timeout (\d+) bash -c 'exec 3<>/dev/tcp/([\w.:\-]+)/(\d+)' 2>/dev/null$")
_PUSH = re.compile(r"^mkdir -p (\S+) && tar -xzf - -C (\S+)$")

POLL_S = 0.2         # how often a forward re-reads the host map
SUN_PATH_MAX = 107   # bytes in a unix socket path (sun_path less its NUL)


def parse_argv(argv: list[str]) -> tuple[list[tuple[str, str]], str, str]:
    """ssh argv (without argv[0]) -> ([(option, value)], destination,
    remote command); flags without a value get ``""``."""
    opts: list[tuple[str, str]] = []
    i = 0
    while i < len(argv) and argv[i].startswith("-") and len(argv[i]) > 1:
        arg = argv[i]
        j = 1
        while j < len(arg):
            ch = arg[j]
            if ch in _ARG_OPTS:
                val = arg[j + 1:]
                if not val:
                    i += 1
                    val = argv[i] if i < len(argv) else ""
                opts.append((f"-{ch}", val))
                break
            opts.append((f"-{ch}", ""))
            j += 1
        i += 1
    dest = argv[i] if i < len(argv) else ""
    return opts, dest, " ".join(argv[i + 1:])


def _load(map_path: str) -> dict:
    with open(map_path) as fh:
        return json.load(fh)


def _log(conf: dict, **rec) -> None:
    line = json.dumps({"t": time.time(), "pid": os.getpid(), **rec}) + "\n"
    fd = os.open(conf["log"], os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        os.write(fd, line.encode())
    finally:
        os.close(fd)


def _fail(msg: str, rc: int) -> None:
    sys.stderr.write(msg.rstrip("\n") + "\n")
    sys.stderr.flush()
    sys.exit(rc)


def _mapped_addr(entry: dict, bind: str) -> str:
    """The worker's own address for a bind: its loopback for
    127.0.0.1/localhost, its gateway address for anything else."""
    if bind in ("127.0.0.1", "localhost", "::1"):
        return entry["loopback"]
    return entry["gateway"]


def _under_root(root: str, remote: str) -> str:
    """A worker-side absolute path, mapped under the worker's root; a
    path that climbs out of the root is refused."""
    if not remote.startswith("/"):
        _fail(f"loopback ssh: remote path {remote!r} is not absolute", 127)
    mapped = os.path.normpath(root + remote)
    if mapped != root and not mapped.startswith(root.rstrip("/") + "/"):
        _fail(f"loopback ssh: remote path {remote!r} leaves the root", 127)
    return mapped


# ------------------------------------------------------------------ relays


def _pump(src: socket.socket, dst: socket.socket) -> None:
    try:
        while True:
            data = src.recv(65536)
            if not data:
                break
            dst.sendall(data)
    except OSError:
        pass
    try:
        dst.shutdown(socket.SHUT_WR)
    except OSError:
        pass


class _Forward:
    """One listening end; each accepted connection relays to a target
    that ``dial()`` opens (or None: close that connection only)."""

    def __init__(self, listener: socket.socket, dial, host: str,
                 map_path: str, cleanup=None):
        self.listener = listener
        self.dial = dial
        self.host = host
        self.map_path = map_path
        self.cleanup = cleanup
        self.conns: list[socket.socket] = []
        self.lock = threading.Lock()
        self.done = threading.Event()
        self.rc = 0

    def serve(self) -> int:
        signal.signal(signal.SIGTERM, lambda *_: self.stop(0))
        signal.signal(signal.SIGINT, lambda *_: self.stop(0))
        threading.Thread(target=self._watch, daemon=True).start()
        threading.Thread(target=self._accept, daemon=True).start()
        self.done.wait()
        return self.rc

    def stop(self, rc: int) -> None:
        if self.done.is_set():
            return
        self.rc = rc
        for end in (lambda: self.listener.shutdown(socket.SHUT_RDWR),
                    self.listener.close):
            try:
                end()       # shutdown wakes the thread blocked in accept
            except OSError:
                pass
        with self.lock:
            for c in self.conns:
                try:
                    c.close()
                except OSError:
                    pass
        if self.cleanup is not None:
            self.cleanup()
        self.done.set()

    def _down(self) -> bool:
        try:
            return bool(_load(self.map_path)["hosts"][self.host].get("down"))
        except (OSError, ValueError, KeyError):
            return False

    def _watch(self) -> None:
        while not self.done.wait(POLL_S):
            if self._down():
                # a dead VM drops every session riding the mux
                self.stop(255)

    def _accept(self) -> None:
        while not self.done.is_set():
            try:
                conn, _ = self.listener.accept()
            except OSError:
                return
            threading.Thread(target=self._relay, args=(conn,),
                             daemon=True).start()

    def _relay(self, conn: socket.socket) -> None:
        far = None if self._down() else self.dial()
        if far is None:
            conn.close()
            return
        with self.lock:
            self.conns += [conn, far]
        t = threading.Thread(target=_pump, args=(far, conn), daemon=True)
        t.start()
        _pump(conn, far)
        t.join()
        for s in (conn, far):
            s.close()


def _forward_local(conf: dict, host: str, spec: str) -> int:
    entry = conf["hosts"][host]
    local, _, remote = spec.partition(":")
    target = _under_root(entry["root"], remote)
    if len(target.encode()) > SUN_PATH_MAX:
        _log(conf, kind="L-failed", host=host, error=f"path too long: {target}")
        _fail(f"loopback ssh: {target} is longer than a unix socket path "
              f"may be ({SUN_PATH_MAX} bytes)", 255)

    def dial():
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.connect(target)
        except OSError:
            s.close()
            return None
        return s

    lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    # as OpenSSH's unix_listener binds: under StreamLocalBindMask's
    # default umask 0177, so the socket is 0600 from its first moment
    old = os.umask(0o177)
    try:
        # analyze: allow(socket-hardening): ssh -L neither chmods the
        # socket after the bind nor owns its parent directory (the
        # fleet transport's mux dir); the umask above is what it does
        lst.bind(local)
    except OSError as e:
        _log(conf, kind="L-failed", host=host, error=str(e))
        _fail(f"unix_listener: cannot bind to path {local}: {e}", 255)
    finally:
        os.umask(old)
    lst.listen(64)

    def cleanup():
        try:
            os.unlink(local)
        except OSError:
            pass

    return _Forward(lst, dial, host, conf["map"], cleanup).serve()


def _forward_remote(conf: dict, host: str, spec: str) -> int:
    entry = conf["hosts"][host]
    bind, port, lhost, lport = spec.rsplit(":", 3)
    addr = _mapped_addr(entry, bind)

    def dial():
        try:
            return socket.create_connection((lhost, int(lport)), timeout=5.0)
        except OSError:
            return None

    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        lst.bind((addr, int(port)))
    except OSError as e:
        _log(conf, kind="R-failed", host=host, error=str(e))
        _fail(f"Error: remote port forwarding failed for listen port {port}",
              255)
    lst.listen(64)
    return _Forward(lst, dial, host, conf["map"]).serve()


# ---------------------------------------------------------------- commands


def _command(conf: dict, host: str, cmd: str) -> int:
    entry = conf["hosts"][host]
    root = entry["root"]
    if cmd == "true":
        return 0
    m = _PROBE.match(cmd)
    if m:
        addr = _mapped_addr(entry, m.group(2))
        try:
            with socket.create_connection((addr, int(m.group(3))),
                                          timeout=float(m.group(1))):
                return 0
        except OSError:
            return 1
    m = _TAIL.match(cmd)
    if m:
        env = {k: v for k, v in os.environ.items() if k != "XDG_STATE_HOME"}
        env["HOME"] = os.path.join(root, "home", conf["user"])
        os.chdir(root)
        sys.stdout.flush()
        # exec: the caller's terminate() reaches tail itself
        os.execvpe("bash", ["bash", "-c", f"exec {cmd}"], env)
    m = _PUSH.match(cmd)
    if m and m.group(1) == m.group(2):
        import shlex
        import tarfile

        dest = _under_root(root, shlex.split(m.group(1))[0])
        os.makedirs(dest, exist_ok=True)
        with tarfile.open(fileobj=sys.stdin.buffer, mode="r|gz") as tf:
            tf.extractall(dest, filter="data")
        return 0
    _fail(f"loopback ssh: command not allowed: {cmd}", 127)
    return 127


def main(map_path: str, argv: list[str]) -> int:
    conf = _load(map_path)
    conf["map"] = map_path
    opts, dest, cmd = parse_argv(argv)
    host = dest.rpartition("@")[2]
    flags = {k for k, _ in opts}
    kind = ("O" if "-O" in flags else "L" if "-L" in flags
            else "R" if "-R" in flags else "cmd")
    _log(conf, kind=kind, host=host, argv=argv, cmd=cmd)
    if conf.get("delay_s"):
        time.sleep(float(conf["delay_s"]))      # fake WAN round trip
    if kind == "O":
        return 0
    entry = conf["hosts"].get(host)
    if entry is None:
        _fail(f"ssh: Could not resolve hostname {host}: "
              "Name or service not known", 255)
    if entry.get("down"):
        _fail(f"ssh: connect to host {host} port 22: Connection refused", 255)
    if kind == "L":
        return _forward_local(conf, host, dict(opts)["-L"])
    if kind == "R":
        return _forward_remote(conf, host, dict(opts)["-R"])
    return _command(conf, host, cmd)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2:]))
