"""Label-jailed engine: the safety boundary over any Docker-API daemon.

The port's copy of ``clawker_tpu/engine/api.py``, whole.

Parity reference: pkg/whail/engine.go -- ``injectManagedFilter`` (engine.go:135)
scopes every list to managed objects, and every mutate op verifies the target
carries the managed label before touching it.  The jail means this framework
can never destroy containers/images/volumes/networks it does not own, on a
laptop daemon or a TPU-VM worker daemon alike.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field
from typing import Any, Iterator

from .. import consts
from ..errors import JailViolation, NotFoundError


@dataclass
class ContainerSpec:
    """Builder for the daemon's container-create JSON."""

    image: str
    cmd: list[str] = field(default_factory=list)
    entrypoint: list[str] | None = None
    env: dict[str, str] = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)
    tty: bool = False
    open_stdin: bool = False
    working_dir: str = ""
    user: str = ""
    hostname: str = ""
    binds: list[str] = field(default_factory=list)          # "src:dst[:opts]"
    network: str = ""
    static_ip: str = ""
    privileged: bool = False
    pid_host: bool = False
    cap_add: list[str] = field(default_factory=list)
    memory: str = ""
    nano_cpus: int = 0
    restart_policy: str = ""                                 # e.g. "on-failure:3"
    dns: list[str] = field(default_factory=list)             # resolver override
    extra_hosts: list[str] = field(default_factory=list)     # "host:ip"
    mount_docker_socket: bool = False
    stop_signal: str = ""
    init: bool = False

    def to_json(self) -> dict:
        host_config: dict[str, Any] = {}
        if self.binds:
            host_config["Binds"] = list(self.binds)
        if self.mount_docker_socket:
            host_config.setdefault("Binds", []).append(
                "/var/run/docker.sock:/var/run/docker.sock"
            )
        if self.privileged:
            host_config["Privileged"] = True
        if self.pid_host:
            host_config["PidMode"] = "host"
        if self.cap_add:
            host_config["CapAdd"] = list(self.cap_add)
        if self.memory:
            host_config["Memory"] = _parse_bytes(self.memory)
        if self.nano_cpus:
            host_config["NanoCpus"] = self.nano_cpus
        if self.restart_policy:
            name, _, cnt = self.restart_policy.partition(":")
            rp: dict[str, Any] = {"Name": name}
            if cnt:
                rp["MaximumRetryCount"] = int(cnt)
            host_config["RestartPolicy"] = rp
        if self.extra_hosts:
            host_config["ExtraHosts"] = list(self.extra_hosts)
        if self.dns:
            host_config["Dns"] = list(self.dns)
        if self.init:
            host_config["Init"] = True
        cfg: dict[str, Any] = {
            "Image": self.image,
            "Labels": dict(self.labels),
            "Tty": self.tty,
            "OpenStdin": self.open_stdin,
            "AttachStdin": self.open_stdin,
            "AttachStdout": True,
            "AttachStderr": True,
            "StdinOnce": False,
            "HostConfig": host_config,
        }
        if self.cmd:
            cfg["Cmd"] = list(self.cmd)
        if self.entrypoint is not None:
            cfg["Entrypoint"] = list(self.entrypoint)
        if self.env:
            cfg["Env"] = [f"{k}={v}" for k, v in self.env.items()]
        if self.working_dir:
            cfg["WorkingDir"] = self.working_dir
        if self.user:
            cfg["User"] = self.user
        if self.hostname:
            cfg["Hostname"] = self.hostname
        if self.stop_signal:
            cfg["StopSignal"] = self.stop_signal
        if self.network:
            epc: dict[str, Any] = {}
            if self.static_ip:
                epc["IPAMConfig"] = {"IPv4Address": self.static_ip}
            cfg["NetworkingConfig"] = {"EndpointsConfig": {self.network: epc}}
        return cfg


def _demux_stdcopy(chunks: Iterator[bytes]) -> Iterator[bytes]:
    """Strip Docker's 8-byte stdcopy frame headers from a log stream."""
    import struct as _struct

    buf = b""
    for chunk in chunks:
        buf += chunk
        while len(buf) >= 8:
            length = _struct.unpack(">I", buf[4:8])[0]
            if len(buf) < 8 + length:
                break
            payload = buf[8 : 8 + length]
            buf = buf[8 + length :]
            if payload:
                yield payload
    if buf:
        # trailing partial frame: emit what we can see rather than drop it
        yield buf[8:] if len(buf) > 8 else b""


def _parse_bytes(s: str) -> int:
    s = s.strip().lower()
    mult = 1
    for suffix, m in (("k", 1024), ("m", 1024**2), ("g", 1024**3)):
        if s.endswith(suffix) or s.endswith(suffix + "b"):
            s = s.rstrip("b").rstrip(suffix)
            mult = m
            break
    return int(float(s) * mult)


class Engine:
    """Managed-label jail over a DockerAPI (HTTPDockerAPI or FakeDockerAPI)."""

    def __init__(self, api):
        self.api = api
        self._builder = None  # lazy: probes the daemon once (buildkit.py)

    # ------------------------------------------------------------ helpers

    @staticmethod
    def _managed_labels(extra: dict[str, str] | None = None) -> dict[str, str]:
        labels = {consts.LABEL_MANAGED: consts.MANAGED_VALUE}
        if extra:
            labels.update(extra)
        return labels

    @staticmethod
    def _managed_filter(filters: dict | None = None) -> dict:
        f = {k: list(v) for k, v in (filters or {}).items()}
        f.setdefault("label", [])
        tag = f"{consts.LABEL_MANAGED}={consts.MANAGED_VALUE}"
        if tag not in f["label"]:
            f["label"].append(tag)
        return f

    def _assert_managed_container(self, ref: str) -> dict:
        info = self.api.container_inspect(ref)
        labels = (info.get("Config") or {}).get("Labels") or {}
        if labels.get(consts.LABEL_MANAGED) != consts.MANAGED_VALUE:
            raise JailViolation(
                f"container {ref} is not managed by {consts.PRODUCT}; refusing to touch it"
            )
        return info

    # --------------------------------------------------------- containers

    def create_container(self, name: str, spec: ContainerSpec) -> str:
        spec.labels = self._managed_labels(spec.labels)
        res = self.api.container_create(name, spec.to_json())
        return res["Id"]

    def start_container(self, ref: str) -> None:
        self._assert_managed_container(ref)
        self.api.container_start(ref)

    def stop_container(self, ref: str, timeout: int = 10) -> None:
        self._assert_managed_container(ref)
        self.api.container_stop(ref, timeout)

    def kill_container(self, ref: str, signal: str = "KILL") -> None:
        self._assert_managed_container(ref)
        self.api.container_kill(ref, signal)

    def restart_container(self, ref: str, timeout: int = 10) -> None:
        self._assert_managed_container(ref)
        self.api.container_restart(ref, timeout)

    def pause_container(self, ref: str) -> None:
        self._assert_managed_container(ref)
        self.api.container_pause(ref)

    def unpause_container(self, ref: str) -> None:
        self._assert_managed_container(ref)
        self.api.container_unpause(ref)

    def remove_container(self, ref: str, *, force: bool = False, volumes: bool = False) -> None:
        """volumes=True also removes the agent's NAMED volumes by label.
        Docker's ?v=1 only removes anonymous volumes, and every agent
        volume is named -- without the label-scoped sweep `rm --volumes`
        would be a silent no-op for agent data on real daemons."""
        info = self._assert_managed_container(ref)
        labels = (info.get("Config") or {}).get("Labels") or {}
        self.api.container_remove(ref, force=force, volumes=volumes)
        if not volumes:
            return
        project = labels.get(consts.LABEL_PROJECT, "")
        agent = labels.get(consts.LABEL_AGENT, "")
        if not project or not agent:
            return
        # jailed sweep: the managed filter scopes the listing, and
        # remove_volume re-asserts ownership per volume -- `rm --volumes`
        # must never touch a volume this framework does not own
        for vol in self.list_volumes(filters={"label": [
                f"{consts.LABEL_PROJECT}={project}",
                f"{consts.LABEL_AGENT}={agent}"]}):
            try:
                self.remove_volume(vol["Name"], force=force)
            except NotFoundError:
                pass

    def rename_container(self, ref: str, new_name: str) -> None:
        self._assert_managed_container(ref)
        self.api.container_rename(ref, new_name)

    @property
    def supports_relabel(self) -> bool:
        """True when the backing api can mutate container labels in
        place (the fake/nsd engines; real Docker cannot -- labels are
        create-time immutable there)."""
        return hasattr(self.api, "container_relabel")

    def relabel_container(self, ref: str, labels: dict[str, str]) -> bool:
        """Merge ``labels`` into a managed container's label set.
        Returns False (no-op) on engines without relabel support --
        warm-pool adoption then relies on the run journal instead of
        the labels being authoritative (docs/loop-warmpool.md)."""
        self._assert_managed_container(ref)
        if not self.supports_relabel:
            return False
        self.api.container_relabel(ref, labels)
        return True

    def finalize_adoption(self, ref: str, *, labels: dict[str, str],
                          archive_path: str = "", archive: bytes = b"",
                          new_name: str = "") -> bool:
        """Warm-pool adoption fixups under ONE jail check: relabel
        (where the api supports it), optional archive injection (the
        env-fixup file), and rename, in that order.  Batched because
        every managed assert is a full inspect -- a remote daemon pays
        a round-trip per call, and the warm-pool hit budget is 1ms
        (docs/loop-warmpool.md).  Returns whether the relabel landed."""
        self._assert_managed_container(ref)
        relabeled = False
        if labels and self.supports_relabel:
            self.api.container_relabel(ref, labels)
            relabeled = True
        if archive:
            self.api.put_archive(ref, archive_path, archive)
        if new_name:
            self.api.container_rename(ref, new_name)
        return relabeled

    def inspect_container(self, ref: str) -> dict:
        return self._assert_managed_container(ref)

    def container_exists(self, ref: str) -> bool:
        try:
            self._assert_managed_container(ref)
            return True
        except NotFoundError:
            return False

    def list_containers(self, *, all: bool = False, filters: dict | None = None) -> list[dict]:
        return self.api.container_list(all=all, filters=self._managed_filter(filters))

    def wait_container(self, ref: str) -> int:
        self._assert_managed_container(ref)
        return int(self.api.container_wait(ref)["StatusCode"])

    def attach_container(self, ref: str, *, tty: bool, stdin: bool = True):
        self._assert_managed_container(ref)
        return self.api.container_attach(ref, tty=tty, stdin=stdin)

    def resize_container(self, ref: str, height: int, width: int) -> None:
        self.api.container_resize(ref, height, width)

    def logs(self, ref: str, *, follow: bool = False, tail: str = "all") -> Iterator[bytes]:
        """Log payload chunks; non-TTY daemon streams are stdcopy-demuxed."""
        info = self._assert_managed_container(ref)
        tty = bool((info.get("Config") or {}).get("Tty"))
        raw = self.api.container_logs(ref, follow=follow, tail=tail)
        if tty:
            return raw
        return _demux_stdcopy(raw)

    def put_archive(self, ref: str, path: str, tar_bytes: bytes) -> None:
        self._assert_managed_container(ref)
        self.api.put_archive(ref, path, tar_bytes)

    def get_archive(self, ref: str, path: str) -> bytes:
        self._assert_managed_container(ref)
        return self.api.get_archive(ref, path)

    def exec(
        self,
        ref: str,
        cmd: list[str],
        *,
        user: str = "",
        env: dict[str, str] | None = None,
        tty: bool = False,
        detach: bool = False,
        stdin: bool = False,
        workdir: str = "",
    ):
        """Create+start an exec; returns (exec_id, stream-or-None)."""
        self._assert_managed_container(ref)
        cfg: dict[str, Any] = {
            "Cmd": cmd,
            "AttachStdout": True,
            "AttachStderr": True,
            "AttachStdin": stdin,
            "Tty": tty,
        }
        if user:
            cfg["User"] = user
        if workdir:
            cfg["WorkingDir"] = workdir
        if env:
            cfg["Env"] = [f"{k}={v}" for k, v in env.items()]
        eid = self.api.exec_create(ref, cfg)["Id"]
        stream = self.api.exec_start(eid, tty=tty, detach=detach)
        return eid, stream

    def exec_exit_code(self, exec_id: str) -> int:
        """Exit code once the exec has finished.  Stream EOF can precede
        the daemon committing the code (docker CLI polls inspect for the
        same reason), so poll briefly while Running/None."""
        import time as _time

        deadline = _time.monotonic() + 5.0
        while True:
            info = self.api.exec_inspect(exec_id)
            code = info.get("ExitCode")
            if code is not None and not info.get("Running"):
                return int(code)
            if _time.monotonic() >= deadline:
                return int(code or 0)
            _time.sleep(0.05)

    def run_exec(self, ref: str, cmd: list[str], *, user: str = "") -> tuple[int, bytes]:
        """Exec to completion, collecting output."""
        eid, stream = self.exec(ref, cmd, user=user)
        out = b""
        if stream is not None:
            for _, payload in stream.frames():
                out += payload
            stream.close()
        return self.exec_exit_code(eid), out

    # ------------------------------------------------------------- images

    def list_images(self, *, filters: dict | None = None) -> list[dict]:
        return self.api.image_list(filters=self._managed_filter(filters))

    def image_exists(self, ref: str) -> bool:
        try:
            self.api.image_inspect(ref)
            return True
        except NotFoundError:
            return False

    def inspect_image(self, ref: str) -> dict:
        return self.api.image_inspect(ref)

    def build_image(
        self,
        context_tar: bytes,
        *,
        tags: list[str],
        labels: dict[str, str] | None = None,
        dockerfile: str = "Dockerfile",
        buildargs: dict[str, str] | None = None,
        target: str = "",
        pull: bool = False,
        no_cache: bool = False,
        secrets: dict[str, bytes] | None = None,
        ssh_auth_sock: str = "",
    ) -> Iterator[dict]:
        from .buildkit import Builder

        if self._builder is None:
            self._builder = Builder(self.api)
        return self._builder.build(
            context_tar,
            tags=tags,
            labels=self._managed_labels(labels),
            dockerfile=dockerfile,
            buildargs=buildargs,
            target=target,
            pull=pull,
            no_cache=no_cache,
            secrets=secrets,
            ssh_auth_sock=ssh_auth_sock,
        )

    def tag_image(self, ref: str, repo: str, tag: str) -> None:
        self.api.image_tag(ref, repo, tag)

    def remove_image(self, ref: str, *, force: bool = False) -> None:
        img = self.api.image_inspect(ref)
        # real daemons nest labels under Config.Labels; fakes/summaries use Labels
        labels = (img.get("Config") or {}).get("Labels") or img.get("Labels") or {}
        if labels.get(consts.LABEL_MANAGED) != consts.MANAGED_VALUE:
            raise JailViolation(f"image {ref} is not managed; refusing to remove")
        self.api.image_remove(ref, force=force)

    def pull_image(self, ref: str) -> Iterator[dict]:
        return self.api.image_pull(ref)

    # ------------------------------------------------------------ volumes

    def ensure_volume(self, name: str, labels: dict[str, str] | None = None) -> dict:
        return self.api.volume_create(name, labels=self._managed_labels(labels))

    def list_volumes(self, *, filters: dict | None = None) -> list[dict]:
        # dockerd marshals an empty result as {"Volumes": null}
        got = self.api.volume_list(filters=self._managed_filter(filters))
        return (got or {}).get("Volumes") or []

    def remove_volume(self, name: str, *, force: bool = False) -> None:
        try:
            vol = self.api.volume_inspect(name)
        except NotFoundError:
            if force:
                return
            raise
        if (vol.get("Labels") or {}).get(consts.LABEL_MANAGED) != consts.MANAGED_VALUE:
            raise JailViolation(f"volume {name} is not managed; refusing to remove")
        self.api.volume_remove(name, force=force)

    # ----------------------------------------------------------- networks

    def ensure_network(self, name: str, *, subnet: str = "") -> dict:
        """Idempotent create (reference: whail EnsureNetwork, SURVEY.md 2.3)."""
        for n in self.api.network_list(filters=self._managed_filter()):
            if n["Name"] == name:
                return n
        cfg: dict[str, Any] = {"Labels": self._managed_labels(), "Driver": "bridge"}
        if subnet:
            cfg["IPAM"] = {"Config": [{"Subnet": subnet}]}
        self.api.network_create(name, cfg)
        return self.api.network_inspect(name)

    def network_static_ip(self, name: str, host_offset: int) -> str:
        """Deterministic static IP: network base + offset (reference:
        ARCHITECTURE.md:490 -- gateway+.2 Envoy, +.3 CoreDNS, +.202 CP)."""
        n = self.api.network_inspect(name)
        subnet = n["IPAM"]["Config"][0]["Subnet"]
        net = ipaddress.ip_network(subnet)
        return str(net.network_address + host_offset)

    def remove_network(self, name: str) -> None:
        n = self.api.network_inspect(name)
        if (n.get("Labels") or {}).get(consts.LABEL_MANAGED) != consts.MANAGED_VALUE:
            raise JailViolation(f"network {name} is not managed; refusing to remove")
        self.api.network_remove(name)

    def connect_network(self, name: str, ref: str, *, ipv4: str = "") -> None:
        self._assert_managed_container(ref)
        self.api.network_connect(name, ref, ipv4=ipv4)

    # ------------------------------------------------------------- events

    def events(self, *, filters: dict | None = None) -> Iterator[dict]:
        return self.api.events(filters=self._managed_filter(filters))

    def ping(self) -> bool:
        return self.api.ping()

    def info(self) -> dict:
        return self.api.info()

    # ----------------------------------------------------------- lifecycle

    def pool_stats(self) -> dict:
        """Connection-pool telemetry from the underlying client (empty for
        clients without a pool)."""
        stats = getattr(self.api, "pool_stats", None)
        return stats() if stats is not None else {}

    def close(self) -> None:
        """Drain-on-shutdown: tear down event streams and the client's
        idle keep-alive connections.  Safe to call more than once."""
        closer = getattr(self.api, "close", None)
        if closer is not None:
            closer()
