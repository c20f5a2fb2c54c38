"""Live-kernel enforcement sandbox: real cgroup, real sockets, real verdicts.

The port's copy of ``clawker_tpu/firewall/bpflive.py``, whole.

This is the harness that grades the assembled firewall programs
(fwprogs.py) against the actual kernel instead of the host-compiled twin
(native/ebpf/fw_harness.c): it creates a scratch cgroup-v2 directory,
attaches all nine verified programs with BPF_F_ALLOW_MULTI, enrolls a
policy, then forks probe children INTO the cgroup and observes what
their socket syscalls actually return -- connect() EPERM for denies,
redirected flows landing on real listeners, getpeername()/recvfrom()
reporting reverse-NATted peers, SOCK_RAW refused at socket().

Used by tests/test_bpf_live.py (skip-gated on kernel capability),
scripts/bpfgate.py (the committed verifier + enforcement transcript) and
the parity red-team lane's socket re-grading.

Parity reference: the reference's equivalent confidence comes from e2e
suites against real containers (test/e2e/firewall_test.go:77-1326); this
sandbox delivers the same observable -- kernel-enforced socket behavior
-- without a container runtime, which is exactly the enforcement layer's
job (cgroup programs don't care who created the cgroup).
"""

from __future__ import annotations

import errno
import json
import os
import socket
import threading
import time
import warnings
from pathlib import Path

# the multi-threaded-fork DeprecationWarning doesn't apply to the probe
# children (sockets + os.write + _exit only, no locks, no exec); filter
# ONCE at import rather than mutating global filter state per fork while
# service-double threads are live
warnings.filterwarnings(
    "ignore", message=r".*use of fork\(\) may lead to deadlocks.*",
    category=DeprecationWarning)

from . import bpfkern as K
from .fwprogs import FwKernel, LiveMaps
from .model import ContainerPolicy

_JOIN_FILE = "cgroup.procs"


class LiveSandbox:
    """Scratch cgroup + attached FwKernel + child-process probe runner."""

    def __init__(self, tag: str = "clawker-bpf"):
        root = K.cgroup2_root()
        if root is None:
            raise K.BpfKernError("no writable cgroup-v2 hierarchy")
        self.cg_dir = root / f"{tag}-{os.getpid()}"
        self.cg_dir.mkdir(exist_ok=True)
        self.kern: FwKernel | None = None
        self.maps: LiveMaps | None = None
        try:
            self.kern = FwKernel()
            self.cgroup_id = self.kern.attach_cgroup(str(self.cg_dir))
            self.maps = LiveMaps(self.kern)
        except Exception:
            self.close()
            raise

    def enroll(self, policy: ContainerPolicy) -> None:
        self.maps.enroll(self.cgroup_id, policy)

    def run_in_cgroup(self, fn, *args):
        """Fork, join the scratch cgroup, run fn(*args), return its JSON
        result.  The child joins BEFORE any socket op so every syscall is
        under enforcement."""
        r, w = os.pipe()
        pid = os.fork()  # fork warning filtered at module import
        if pid == 0:
            code = 0
            try:
                os.close(r)
                (self.cg_dir / _JOIN_FILE).write_text(str(os.getpid()))
                out = fn(*args)
            except BaseException as e:  # noqa: BLE001 - report, then _exit
                out = {"error": repr(e)}
                code = 1
            try:
                os.write(w, json.dumps(out).encode())
                os.close(w)
            finally:
                os._exit(code)
        os.close(w)
        chunks = []
        while True:
            b = os.read(r, 65536)
            if not b:
                break
            chunks.append(b)
        os.close(r)
        os.waitpid(pid, 0)
        raw = b"".join(chunks)
        out = json.loads(raw) if raw else {"error": "child died silently"}
        if isinstance(out, dict) and "error" in out and "result" not in out:
            # callers key on "result"; a child-side failure must grade as
            # a FAIL line, not crash the harness mid-transcript
            out["result"] = "child-error"
        return out

    def close(self) -> None:
        if self.maps is not None:
            self.maps.close()
            self.maps = None
        if self.kern is not None:
            self.kern.close()
            self.kern = None
        try:
            self.cg_dir.rmdir()
        except OSError:
            pass

    def __enter__(self) -> "LiveSandbox":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# probe functions (run inside the cgroup child).  Each returns a plain
# dict so run_in_cgroup can pipe it back as JSON.
# ---------------------------------------------------------------------------

_ERRNO_NAMES = {
    errno.EPERM: "eperm",
    errno.ECONNREFUSED: "refused",
    errno.ENETUNREACH: "unreach",
    errno.EHOSTUNREACH: "unreach",
    errno.EACCES: "eacces",
    errno.EINPROGRESS: "inprogress",
}


def _errname(e: OSError) -> str:
    return _ERRNO_NAMES.get(e.errno, f"errno-{e.errno}")


def probe_tcp_connect(ip: str, port: int, timeout: float = 1.0,
                      family: int = socket.AF_INET) -> dict:
    """Blocking connect with timeout; reports how the kernel answered.
    A BPF deny surfaces as instant EPERM -- before any packet exists."""
    s = socket.socket(family, socket.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect((ip, port))
        peer = s.getpeername()
        return {"result": "connected", "peer": [peer[0], peer[1]]}
    except socket.timeout:
        return {"result": "timeout"}
    except OSError as e:
        return {"result": _errname(e)}
    finally:
        s.close()


def probe_udp_exchange(ip: str, port: int, payload: bytes = b"ping",
                       timeout: float = 1.0) -> dict:
    """Unconnected sendto + recvfrom: exercises sendmsg4 (redirect) and
    recvmsg4 (reverse NAT).  Reports the reply's apparent source."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(timeout)
    try:
        s.sendto(payload, (ip, port))
    except OSError as e:
        s.close()
        return {"result": _errname(e)}
    try:
        data, src = s.recvfrom(2048)
        return {"result": "reply", "src": [src[0], src[1]],
                "data": data.decode(errors="replace")}
    except socket.timeout:
        return {"result": "sent-no-reply"}
    except OSError as e:
        return {"result": _errname(e)}
    finally:
        s.close()


def probe_raw_socket() -> dict:
    """SOCK_RAW at socket() time: fw_sock_create's deny surfaces here."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_RAW, socket.IPPROTO_ICMP)
        s.close()
        return {"result": "created"}
    except OSError as e:
        return {"result": _errname(e)}


def probe_tcp_connect6(ip6: str, port: int, timeout: float = 1.0) -> dict:
    return probe_tcp_connect(ip6, port, timeout, family=socket.AF_INET6)


# ---------------------------------------------------------------------------
# loopback service doubles (run in the parent, outside the cgroup)
# ---------------------------------------------------------------------------


class TcpEcho(threading.Thread):
    """One-shot TCP acceptor standing in for an Envoy listener.

    The serve loop polls with a timeout: a blocking accept() would keep
    the kernel-side file (and the bound port) alive past close() until
    the syscall returned -- close(2) does not cancel in-flight blocking
    syscalls -- which leaks the port to the next binder."""

    def __init__(self, ip: str = "127.0.0.1", port: int = 0):
        super().__init__(daemon=True)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((ip, port))
        self.sock.listen(8)
        self.sock.settimeout(0.1)
        self.port = self.sock.getsockname()[1]
        self.accepted = 0
        self._stopping = threading.Event()

    def run(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self.accepted += 1
            conn.close()
        try:
            self.sock.close()
        except OSError:
            pass

    def stop(self) -> None:
        self._stopping.set()
        if self.is_alive():
            self.join(timeout=2.0)
        else:  # never started: close inline
            try:
                self.sock.close()
            except OSError:
                pass


class UdpResponder(threading.Thread):
    """One-shot UDP responder standing in for the DNS gate listener.
    Polls with a timeout for the same port-leak reason as TcpEcho."""

    def __init__(self, ip: str = "127.0.0.1", port: int = 0,
                 reply: bytes = b"gate-reply"):
        super().__init__(daemon=True)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((ip, port))
        self.sock.settimeout(0.1)
        self.port = self.sock.getsockname()[1]
        self.reply = reply
        self.received: list[bytes] = []
        self._stopping = threading.Event()

    def run(self) -> None:
        while not self._stopping.is_set():
            try:
                data, src = self.sock.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                break
            self.received.append(data)
            try:
                self.sock.sendto(self.reply, src)
            except OSError:
                break
        try:
            self.sock.close()
        except OSError:
            pass

    def stop(self) -> None:
        self._stopping.set()
        if self.is_alive():
            self.join(timeout=2.0)
        else:
            try:
                self.sock.close()
            except OSError:
                pass


def wait_for(cond, timeout: float = 2.0, interval: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()
