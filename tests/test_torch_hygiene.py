"""The port stands alone: no JAX, nothing of clawker_tpu, no CPU fallback.

tests/conftest.py imports jax into every test process, so the import
checks run in a fresh interpreter with ``sys.modules["jax"] = None``
(any ``import jax`` then raises).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# small shapes: one intra-op thread keeps torch's pool from spinning on
# every core beside the other test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "clawker_tpu_torch"
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _run_isolated(code: str) -> dict:
    prelude = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
    )
    proc = subprocess.run([sys.executable, "-c", prelude + code], cwd=ROOT,
                          env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# the terminal views, the egress feed and the metrics exporters
VIEW_MODULES = ["clawker_tpu_torch.ui", "clawker_tpu_torch.ui.colors",
                "clawker_tpu_torch.ui.iostreams", "clawker_tpu_torch.ui.table",
                "clawker_tpu_torch.ui.damage",
                "clawker_tpu_torch.ui.dashboard",
                "clawker_tpu_torch.ui.fleetconsole",
                "clawker_tpu_torch.fleet.egress_tail",
                "clawker_tpu_torch.telemetry.httpserv",
                "clawker_tpu_torch.telemetry.otlp",
                "clawker_tpu_torch.controlplane.otel",
                "clawker_tpu_torch.firewall.pki"]


# the Docker HTTP client, the local driver and the create path's harness
# staging
ENGINE_MODULES = ["clawker_tpu_torch.engine.errors_map",
                  "clawker_tpu_torch.engine.pool",
                  "clawker_tpu_torch.engine.httpapi",
                  "clawker_tpu_torch.engine.drivers.local",
                  "clawker_tpu_torch.containerfs",
                  "clawker_tpu_torch.bundle",
                  "clawker_tpu_torch.bundle.model",
                  "clawker_tpu_torch.bundle.resolver"]


# the fleet transport, provisioning, discovery, the tpu_vm driver and
# the loopback ssh its tests and chip_smoke run it over
FLEET_MODULES = ["clawker_tpu_torch.fleet",
                 "clawker_tpu_torch.fleet.transport",
                 "clawker_tpu_torch.fleet.inventory",
                 "clawker_tpu_torch.fleet.provision",
                 "clawker_tpu_torch.fleet.channels",
                 "clawker_tpu_torch.engine.drivers.tpu_vm",
                 "clawker_tpu_torch.sshseam"]


# the everyday verbs and what they stand on: plain Python, no torch
VERB_MODULES = ["clawker_tpu_torch.cli", "clawker_tpu_torch.cli.root",
                "clawker_tpu_torch.cli.factory",
                "clawker_tpu_torch.cli.cmd_container",
                "clawker_tpu_torch.cli.cmd_init",
                "clawker_tpu_torch.cli.cmd_project",
                "clawker_tpu_torch.cli.cmd_settings",
                "clawker_tpu_torch.cli.cmd_network",
                "clawker_tpu_torch.cli.cmd_volume",
                "clawker_tpu_torch.cli.cmd_harness",
                "clawker_tpu_torch.cli.cmd_monitor",
                "clawker_tpu_torch.cli.cmd_fleet",
                "clawker_tpu_torch.cli.cmd_loop",
                "clawker_tpu_torch.cli.cmd_loopd",
                "clawker_tpu_torch.cli.cmd_workerd",
                "clawker_tpu_torch.cli.cmd_trace",
                "clawker_tpu_torch.cli.cmd_journal",
                "clawker_tpu_torch.cli.cmd_chaos",
                "clawker_tpu_torch.cli.cmd_bundle",
                "clawker_tpu_torch.cli.cmd_fed",
                "clawker_tpu_torch.cli.cmd_plugin",
                "clawker_tpu_torch.project",
                "clawker_tpu_torch.project.manager",
                "clawker_tpu_torch.util.dotenv",
                "clawker_tpu_torch.ui.prompter",
                "clawker_tpu_torch.controlplane.registry"]


# image builds: the bundler, the BuildKit lanes, the agentd zipapp's
# modules and the session's host half, the build views and verbs
IMAGE_MODULES = ["clawker_tpu_torch.bundler",
                 "clawker_tpu_torch.bundler.build",
                 "clawker_tpu_torch.bundler.context",
                 "clawker_tpu_torch.bundler.dockerfile",
                 "clawker_tpu_torch.bundler.egress",
                 "clawker_tpu_torch.bundler.payload",
                 "clawker_tpu_torch.engine.buildkit",
                 "clawker_tpu_torch.engine.bkproto",
                 "clawker_tpu_torch.engine.bksession",
                 "clawker_tpu_torch.agentd",
                 "clawker_tpu_torch.agentd.daemon",
                 "clawker_tpu_torch.agentd.protocol",
                 "clawker_tpu_torch.agentd.register",
                 "clawker_tpu_torch.agentd.supervisor_client",
                 "clawker_tpu_torch.controlplane.session_client",
                 "clawker_tpu_torch.ui.progress",
                 "clawker_tpu_torch.ui.buildview",
                 "clawker_tpu_torch.cli.cmd_build",
                 "clawker_tpu_torch.cli.cmd_image"]


# federation and the CLI's leftovers: the front-tier router, the bundle
# manager, the state store with the update check and the changelog, the
# field browser and store editor, the docs generator and the plugin lanes
LEFTOVER_MODULES = ["clawker_tpu_torch.federation",
                    "clawker_tpu_torch.federation.registry",
                    "clawker_tpu_torch.federation.lease",
                    "clawker_tpu_torch.federation.router",
                    "clawker_tpu_torch.state",
                    "clawker_tpu_torch.changelog",
                    "clawker_tpu_torch.bundle.manager",
                    "clawker_tpu_torch.storeui",
                    "clawker_tpu_torch.ui.fieldbrowser",
                    "clawker_tpu_torch.docs",
                    "clawker_tpu_torch.plugin"]


# the egress lane and the monitor stack: the firewall's model, maps,
# policy and DNS gate, the netlogger, the bootstrap corpus, monitoring
# units with the units ledger, and the compose stack
EGRESS_MODULES = ["clawker_tpu_torch.firewall.hashes",
                  "clawker_tpu_torch.firewall.model",
                  "clawker_tpu_torch.firewall.maps",
                  "clawker_tpu_torch.firewall.policy",
                  "clawker_tpu_torch.firewall.dnsgate",
                  "clawker_tpu_torch.monitor",
                  "clawker_tpu_torch.monitor.netlogger",
                  "clawker_tpu_torch.monitor.corpus",
                  "clawker_tpu_torch.monitor.unit",
                  "clawker_tpu_torch.monitor.ledger",
                  "clawker_tpu_torch.monitor.stack"]


# the firewall's user-space enforcement: the action queue, Envoy's
# bootstrap, the stack, enrollment, the handler, its runtime and run-path
# hooks, and the firewall verbs; the ones that reach ``pki`` load
# ``cryptography``
FIREWALL_MODULES = ["clawker_tpu_torch.firewall.queue",
                    "clawker_tpu_torch.firewall.envoy",
                    "clawker_tpu_torch.firewall.enroll",
                    "clawker_tpu_torch.firewall.lifecycle",
                    "clawker_tpu_torch.cli.cmd_firewall",
                    "clawker_tpu_torch.firewall.stack",
                    "clawker_tpu_torch.firewall.handler",
                    "clawker_tpu_torch.firewall.runtime"]
FIREWALL_PKI = FIREWALL_MODULES[5:]

# the firewall's kernel half: the eBPF assembler, the bpf(2) map and
# loader layers, the nine programs with the ring-buffer reader, and the
# live sandbox
KERNEL_HALF_MODULES = ["clawker_tpu_torch.firewall.bpfasm",
                       "clawker_tpu_torch.firewall.bpfsys",
                       "clawker_tpu_torch.firewall.bpfkern",
                       "clawker_tpu_torch.firewall.fwprogs",
                       "clawker_tpu_torch.firewall.bpflive"]

# the control plane: the bus, the docker-events feeder, the watcher, the
# executor and dialer, the AdminService and AgentService, the daemon
# with its entry point, the manager and the controlplane verbs; the ones
# that serve or mint mTLS material load ``cryptography``
CONTROL_PLANE_MODULES = ["clawker_tpu_torch.controlplane.pubsub",
                         "clawker_tpu_torch.controlplane.watcher",
                         "clawker_tpu_torch.controlplane.dockerevents",
                         "clawker_tpu_torch.controlplane.executor",
                         "clawker_tpu_torch.controlplane.dialer",
                         "clawker_tpu_torch.controlplane.manager",
                         "clawker_tpu_torch.cli.cmd_controlplane",
                         "clawker_tpu_torch.controlplane.adminapi",
                         "clawker_tpu_torch.controlplane.agentservice",
                         "clawker_tpu_torch.controlplane.daemon",
                         "clawker_tpu_torch.controlplane.__main__"]
CONTROL_PLANE_PKI = CONTROL_PLANE_MODULES[7:]


def _modules() -> list[str]:
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_every_module_and_chip_smoke_import_without_jax_or_reference():
    mods = _modules()
    assert "clawker_tpu_torch.kernels.anomaly" in mods
    # the worktree swarm's modules are the port's own copies
    assert {"clawker_tpu_torch.gitx", "clawker_tpu_torch.gitx.git",
            "clawker_tpu_torch.gitguard", "clawker_tpu_torch.gitguard.server",
            "clawker_tpu_torch.gitguard.pktline",
            "clawker_tpu_torch.gitguard.protocol",
            "clawker_tpu_torch.gitguard.refpolicy",
            "clawker_tpu_torch.firewall", "clawker_tpu_torch.firewall.rules",
            "clawker_tpu_torch.loop.mergeq"} <= set(mods)
    # and so are chaos, capacity, the shipper and the test support
    assert {"clawker_tpu_torch.chaos.plan",
            "clawker_tpu_torch.chaos.invariants",
            "clawker_tpu_torch.chaos.runner", "clawker_tpu_torch.capacity",
            "clawker_tpu_torch.capacity.controller",
            "clawker_tpu_torch.capacity.scaler",
            "clawker_tpu_torch.capacity.signals",
            "clawker_tpu_torch.monitor.shipper",
            "clawker_tpu_torch.testenv"} <= set(mods)
    # and the live views of a run and the metrics exporters
    assert set(VIEW_MODULES) <= set(mods)
    # and the Docker HTTP client, the local driver and harness staging
    assert set(ENGINE_MODULES) <= set(mods)
    # and the fleet transport and the tpu_vm driver
    assert set(FLEET_MODULES) <= set(mods)
    # and the everyday verbs, laid out as the reference's cli/, and the
    # create path's identity
    assert set(VERB_MODULES) <= set(mods)
    assert "clawker_tpu_torch.controlplane.identity" in mods
    # and image builds
    assert set(IMAGE_MODULES) <= set(mods)
    # and federation and the CLI's leftovers
    assert set(LEFTOVER_MODULES) <= set(mods)
    # and the egress lane and the monitor stack
    assert set(EGRESS_MODULES) <= set(mods)
    # and the firewall's user-space enforcement
    assert set(FIREWALL_MODULES) <= set(mods)
    # and the firewall's kernel half
    assert set(KERNEL_HALF_MODULES) <= set(mods)
    # and the control plane
    assert set(CONTROL_PLANE_MODULES[:-1]) <= set(mods)
    doc = _run_isolated(
        "import importlib, json\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from clawker_tpu_torch.kernels import build\n"
        "leaked = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "                and (m == 'jax' or m.startswith('jax.')\n"
        "                     or m == 'clawker_tpu' or m.startswith('clawker_tpu.')))\n"
        "print(json.dumps({'leaked': leaked, 'built': sorted(build._libs),\n"
        "                  'loaded': len([m for m in sys.modules\n"
        "                                 if m.startswith('clawker_tpu_torch')])}))\n")
    assert doc["leaked"] == []
    assert doc["built"] == []          # importing builds nothing
    assert doc["loaded"] >= len(mods)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax_and_no_reference_package(path):
    text = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(r"^\s*(import|from)\s+clawker_tpu(\.|\s|$)", text,
                         re.M)


def test_default_device_raises_instead_of_running_on_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device runs there")
    doc = _run_isolated(
        "import json\n"
        "import numpy as np\n"
        "from clawker_tpu_torch.analytics import runtime as art\n"
        "from clawker_tpu_torch.analytics import features as F\n"
        "from clawker_tpu_torch.kernels import anomaly as K\n"
        "from clawker_tpu_torch.sentinel import FleetSentinel, ScoringEngine\n"
        "from clawker_tpu_torch.sentinel import StreamCollector\n"
        "keys = [F.WindowKey('a', 0), F.WindowKey('b', 0)]\n"
        "X = np.ones((2, 32), np.float32)\n"
        "raised = {}\n"
        "for name, call in {\n"
        "    'score_windows': lambda: art.score_windows(X, keys, train_steps=2),\n"
        "    'score_tick': lambda: ScoringEngine(train_steps=2).score_tick(\n"
        "        keys, np.ones((2, 40), np.float32), {}),\n"
        "    'resolve_device': lambda: art.resolve_device('cuda'),\n"
        "}.items():\n"
        "    try:\n"
        "        call()\n"
        "        raised[name] = None\n"
        "    except RuntimeError as e:\n"
        "        raised[name] = str(e)\n"
        # the sentinel's tick must not raise: the failure reaches on_error
        f"stream = {str(tmp_path / 'egress.jsonl')!r}\n"
        "with open(stream, 'w') as f:\n"
        "    for i in range(20):\n"
        "        f.write(json.dumps({'@timestamp': '2023-11-14T22:13:%02dZ' % i,\n"
        "                            'container': 'a', 'verdict': 'ALLOW'}) + '\\n')\n"
        "col = StreamCollector()\n"
        "col.add_local('w', stream)\n"
        "errors = []\n"
        "s = FleetSentinel(None, train_steps=2, collector=col,\n"
        "                  on_error=errors.append)\n"
        "scored = s.refresh_once()\n"
        "raised['refresh_once'] = errors[0] if scored == 0 and errors else None\n"
        "print(json.dumps({'raised': raised, 'launches': K.LAUNCHES}))\n")
    assert all(msg and "no CUDA GPU" in msg for msg in doc["raised"].values())
    assert set(doc["raised"]) == {"score_windows", "score_tick",
                                  "resolve_device", "refresh_once"}
    assert doc["launches"] == {"anomaly_score": 0, "anomaly_fit_step": 0,
                               "anomaly_fit": 0, "anomaly_fit_shard_fit": 0,
                               "anomaly_fit_shard_partials": 0,
                               "anomaly_fit_shard_reduce": 0}


@pytest.mark.parametrize("module", ["clawker_tpu_torch.graft_entry",
                                    "clawker_tpu_torch.analytics.mesh",
                                    "clawker_tpu_torch.loop.scheduler",
                                    "clawker_tpu_torch.loop.warmpool",
                                    "clawker_tpu_torch.loop.mergeq",
                                    "clawker_tpu_torch.gitx",
                                    "clawker_tpu_torch.gitguard",
                                    "clawker_tpu_torch.firewall.rules",
                                    "clawker_tpu_torch.storage.yamledit",
                                    "clawker_tpu_torch.cli",
                                    "clawker_tpu_torch.chaos",
                                    "clawker_tpu_torch.chaos.runner",
                                    "clawker_tpu_torch.chaos.invariants",
                                    "clawker_tpu_torch.capacity",
                                    "clawker_tpu_torch.monitor.shipper",
                                    "clawker_tpu_torch.testenv",
                                    "clawker_tpu_torch.loopd.__main__",
                                    "clawker_tpu_torch.hostproxy.__main__",
                                    "clawker_tpu_torch.socketbridge.container",
                                    "clawker_tpu_torch.controlplane.identity",
                                    *VIEW_MODULES, *ENGINE_MODULES,
                                    *FLEET_MODULES, *VERB_MODULES[1:],
                                    *IMAGE_MODULES, *LEFTOVER_MODULES,
                                    *EGRESS_MODULES, *FIREWALL_MODULES,
                                    *KERNEL_HALF_MODULES,
                                    *CONTROL_PLANE_MODULES])
def test_mesh_and_graft_entry_import_alone_without_jax(module):
    doc = _run_isolated(
        "import importlib, json\n"
        f"importlib.import_module({module!r})\n"
        "from clawker_tpu_torch.kernels import build\n"
        "leaked = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "                and (m in ('jax', 'clawker_tpu')\n"
        "                     or m.startswith(('jax.', 'clawker_tpu.'))))\n"
        "print(json.dumps({'leaked': leaked, 'built': sorted(build._libs)}))\n")
    assert doc == {"leaked": [], "built": []}


@pytest.mark.parametrize("module", ["clawker_tpu_torch.hostproxy.__main__",
                                    "clawker_tpu_torch.socketbridge.container",
                                    "clawker_tpu_torch.workerd.__main__",
                                    "clawker_tpu_torch.controlplane.__main__"])
def test_daemon_entry_points_load_no_torch(module):
    """The host proxy's, the bridge's, workerd's and the control plane's
    processes run without torch."""
    doc = _run_isolated(
        "import importlib, json\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps({'torch': 'torch' in sys.modules}))\n")
    assert doc == {"torch": False}


@pytest.mark.parametrize("module", VERB_MODULES + LEFTOVER_MODULES
                         + EGRESS_MODULES)
def test_everyday_verbs_load_no_torch(module):
    """The CLI, the project registry, dotenv, the prompter and the agent
    registry are plain Python, and so are the egress lane and the monitor
    stack: only a verb that scores loads torch, and only when it runs."""
    doc = _run_isolated(
        "import importlib, json\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps({'torch': 'torch' in sys.modules,\n"
        "                  'cryptography': 'cryptography' in sys.modules}))\n")
    assert doc == {"torch": False, "cryptography": False}


@pytest.mark.parametrize("module", FIREWALL_MODULES)
def test_firewall_modules_load_no_torch(module):
    """The firewall's user-space half is plain Python; only the modules
    that reach ``pki`` (the stack mints MITM certificates) load
    ``cryptography``."""
    doc = _run_isolated(
        "import importlib, json\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps({'torch': 'torch' in sys.modules,\n"
        "                  'cryptography': 'cryptography' in sys.modules}))\n")
    assert doc == {"torch": False, "cryptography": module in FIREWALL_PKI}


@pytest.mark.parametrize("module", KERNEL_HALF_MODULES)
def test_firewall_kernel_half_loads_no_torch(module):
    """The kernel half speaks bpf(2) through ``ctypes``: it loads no
    torch and no ``cryptography``."""
    doc = _run_isolated(
        "import importlib, json\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps({'torch': 'torch' in sys.modules,\n"
        "                  'cryptography': 'cryptography' in sys.modules}))\n")
    assert doc == {"torch": False, "cryptography": False}


@pytest.mark.parametrize("module", IMAGE_MODULES)
def test_image_builds_load_no_torch_and_no_grpc(module):
    """The bundler, the BuildKit lanes, the agentd zipapp's modules and
    the build verbs are plain Python: the session lane imports ``grpc``
    only when a build forwards secrets or an ssh agent."""
    doc = _run_isolated(
        "import importlib, json\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps({'torch': 'torch' in sys.modules,\n"
        "                  'grpc': 'grpc' in sys.modules}))\n")
    assert doc == {"torch": False, "grpc": False}


def _verb_env(tmp_path: Path) -> dict:
    """Isolated XDG dirs with the host proxy off, the fake driver
    seeded with the project's image, a project dir at ``tmp_path``."""
    env = dict(ENV, CLAWKER_TPU_DRIVER="fake",
               CLAWKER_TPU_FAKE_IMAGES="clawker-verbs:default")
    for name in ("CONFIG", "DATA", "STATE", "CACHE"):
        (tmp_path / name).mkdir(exist_ok=True)
        env[f"CLAWKER_TPU_{name}_DIR"] = str(tmp_path / name)
    (tmp_path / "CONFIG" / "settings.yaml").write_text(
        "host_proxy:\n  enable: false\n")
    (tmp_path / ".clawker.yaml").write_text("project: verbs\n")
    return env


@pytest.mark.parametrize("argv,out", [
    (["ps"], "no agent containers\n"),
    (["version"], "clawker-tpu 0.2.0\n"),
    (["run", "-d", "--agent", "a1"], "clawker.verbs.a1\n"),
    (["build", "-q"], "clawker-verbs:default\n"),
])
def test_everyday_verbs_run_without_torch(tmp_path, argv, out):
    """``ps``, ``version``, ``run -d`` and ``build -q`` in a process
    where any ``import torch`` raises; only the create path loads
    ``cryptography`` (the identity bootstrap)."""
    code = (
        "import contextlib, io, json, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['torch'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from clawker_tpu_torch.cli import main\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        f"    rc = main({argv!r})\n"
        "print(json.dumps({'rc': rc, 'out': buf.getvalue(),\n"
        "                  'cryptography': 'cryptography' in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=_verb_env(tmp_path), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc == {"rc": 0, "out": out, "cryptography": argv[0] == "run"}


@pytest.mark.parametrize("module", ENGINE_MODULES)
def test_engine_client_and_staging_load_no_torch(module):
    """The HTTP client, the local driver and the harness staging are
    plain Python: workerd's process runs them without torch."""
    doc = _run_isolated(
        "import importlib, json\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps({'torch': 'torch' in sys.modules}))\n")
    assert doc == {"torch": False}


@pytest.mark.parametrize("module", [m for m in VIEW_MODULES
                                    if not m.endswith(".pki")])
def test_views_and_exporters_load_no_torch_and_no_cryptography(module):
    """The ui, the egress feed and the exporters are plain Python: they
    load torch only when a frame needs the anomaly threshold, and the
    OTLP lanes load ``cryptography`` only for an https collector."""
    doc = _run_isolated(
        "import importlib, json\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps({'torch': 'torch' in sys.modules,\n"
        "                  'cryptography': 'cryptography' in sys.modules}))\n")
    assert doc == {"torch": False, "cryptography": False}


def _literals(path: Path) -> list[str]:
    """Every string literal in ``path`` but the docstrings."""
    import ast

    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_commands_the_port_runs_name_the_port(path):
    """A ``-m`` target or exec command string that named the reference
    would run JAX code under the port's name."""
    bad = [lit for lit in _literals(ROOT / path)
           if re.search(r"(?<![\w/])clawker_tpu(?!_torch)\.[a-z]", lit)]
    assert bad == []


def test_spawned_modules_and_exec_commands_name_the_port(tmp_path,
                                                         monkeypatch):
    """What the port forks and execs, read from the objects that fork
    and exec: the host proxy's ``DaemonSpec``, loopd's and workerd's
    ``spawn_daemon`` and the socket bridge's container command."""
    import subprocess as sp
    from types import SimpleNamespace

    from clawker_tpu_torch import loopd, workerd
    from clawker_tpu_torch.config import Settings
    from clawker_tpu_torch.hostproxy import manager
    from clawker_tpu_torch.socketbridge import host

    cfg = SimpleNamespace(settings=Settings(), state_dir=tmp_path,
                          logs_dir=tmp_path / "logs")
    assert manager._spec(cfg).module == "clawker_tpu_torch.hostproxy"
    argv = []

    class Stop(Exception):
        pass

    def popen(args, **kw):
        argv.append(args)
        raise Stop

    monkeypatch.setattr(sp, "Popen", popen)
    with pytest.raises(Stop):
        loopd.spawn_daemon(cfg)
    with pytest.raises(Stop):
        workerd.spawn_daemon(cfg)
    assert argv == [[sys.executable, "-m", "clawker_tpu_torch.loopd"],
                    [sys.executable, "-m", "clawker_tpu_torch.workerd"]]
    assert "from clawker_tpu_torch.socketbridge.container import main" \
        in host.CONTAINER_CMD[-1]


def test_graft_entry_and_bench_lane_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device runs there")
    doc = _run_isolated(
        "import json\n"
        "from chip_smoke import synth_egress_records\n"
        "from clawker_tpu_torch import graft_entry\n"
        "from clawker_tpu_torch.analytics import mesh as M\n"
        "from clawker_tpu_torch.analytics import runtime as art\n"
        "from clawker_tpu_torch.kernels import anomaly as K\n"
        "recs = synth_egress_records(agents=2, windows=2, per_window=4)\n"
        "raised = {}\n"
        "for name, call in {\n"
        "    'entry': graft_entry.entry,\n"
        "    'dryrun_multichip': lambda: graft_entry.dryrun_multichip(8),\n"
        "    'bench_lane': lambda: art.bench_lane(recs, train_steps=2, reps=1),\n"
        "    'fleet_mesh': M.fleet_mesh,\n"
        "    'virtual_mesh': lambda: M.virtual_mesh(4),\n"
        "}.items():\n"
        "    try:\n"
        "        call()\n"
        "        raised[name] = None\n"
        "    except RuntimeError as e:\n"
        "        raised[name] = str(e)\n"
        "ran = {'entry': graft_entry.entry(device='cpu')[1][1].shape[0],\n"
        "       'dryrun_multichip': graft_entry.dryrun_multichip(8, device='cpu'),\n"
        "       'bench_lane': art.bench_lane(recs, train_steps=2, reps=1,\n"
        "                                    device='cpu')['device']}\n"
        "print(json.dumps({'raised': raised, 'ran': ran,\n"
        "                  'launches': K.LAUNCHES}))\n")
    assert set(doc["raised"]) == {"entry", "dryrun_multichip", "bench_lane",
                                  "fleet_mesh", "virtual_mesh"}
    assert all(msg and "no CUDA GPU" in msg for msg in doc["raised"].values())
    assert doc["ran"] == {"entry": 256, "dryrun_multichip": None,
                          "bench_lane": "cpu"}
    assert not any(doc["launches"].values())


def test_fleet_anomaly_without_a_gpu_exits_1_and_names_the_cpu_device(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device runs there")
    env = {k: v for k, v in ENV.items() if k != "CLAWKER_TORCH_DEVICE"}
    env["CLAWKER_TPU_STATE_DIR"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "clawker_tpu_torch", "fleet", "anomaly",
         "--no-daemon"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 1
    assert "no CUDA GPU" in proc.stderr
    assert "CLAWKER_TORCH_DEVICE=cpu" in proc.stderr
    assert proc.stdout == ""


def test_fleet_anomaly_through_an_alias_without_a_gpu_exits_1(tmp_path):
    """A user alias that expands to ``fleet anomaly`` reaches the same
    device check as the verb by name: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device runs there")
    env = {k: v for k, v in _verb_env(tmp_path).items()
           if k != "CLAWKER_TORCH_DEVICE"}
    env["PYTHONPATH"] = str(ROOT)
    (tmp_path / "CONFIG" / "aliases.yaml").write_text(
        "hot: fleet anomaly --no-daemon --format json\n")
    proc = subprocess.run([sys.executable, "-m", "clawker_tpu_torch", "hot"],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1
    assert "fleet anomaly: " in proc.stderr and "no CUDA GPU" in proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("rider", ["--sentinel", "--no-sentinel"])
def test_loop_without_a_gpu_exits_1_and_names_the_cpu_device(tmp_path,
                                                             rider):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device runs there")
    env = {k: v for k, v in ENV.items() if k != "CLAWKER_TORCH_DEVICE"}
    for name in ("CONFIG", "DATA", "STATE", "CACHE"):
        (tmp_path / name).mkdir()
        env[f"CLAWKER_TPU_{name}_DIR"] = str(tmp_path / name)
    (tmp_path / "CONFIG" / "settings.yaml").write_text(
        "host_proxy:\n  enable: false\n")
    (tmp_path / ".clawker.yaml").write_text("project: nogpu\n")
    env["CLAWKER_TPU_DRIVER"] = "fake"
    env["CLAWKER_TPU_FAKE_IMAGES"] = "clawker-nogpu:default"
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "clawker_tpu_torch", "loop", "-p", "2", "-n",
         "1", rider, "--json"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA GPU" in proc.stderr
    assert "CLAWKER_TORCH_DEVICE=cpu" in proc.stderr
    assert proc.stdout == ""
    # the run never started: no journal, no flight record
    assert not list((tmp_path / "STATE").rglob("*.journal"))


def test_cpu_tensor_calls_leave_launch_counters_at_zero():
    doc = _run_isolated(
        "import json\n"
        "import torch\n"
        "from clawker_tpu_torch.analytics import anomaly\n"
        "from clawker_tpu_torch.analytics import runtime as art\n"
        "from clawker_tpu_torch.kernels import anomaly as K\n"
        "from clawker_tpu_torch.kernels import build\n"
        "g = torch.Generator().manual_seed(0)\n"
        "p = anomaly.init_params(g, feat=40)\n"
        "x = torch.randn((256, 40), generator=g)\n"
        "anomaly.score(p, x)\n"
        "anomaly.train_step(p, x)\n"
        "anomaly.denoise_step(p, x, g)\n"
        "art._fit(p, x, torch.randn((3, 256, 40), generator=g), 1e-2)\n"
        "K.fit_(p, x, torch.randn((2, 256, 40), generator=g), lr=1e-2,\n"
        "       sigma=0.25, losses_out=torch.empty(2))\n"
        "print(json.dumps({'launches': K.LAUNCHES, 'built': sorted(build._libs)}))\n")
    assert doc == {"launches": {"anomaly_score": 0, "anomaly_fit_step": 0,
                                "anomaly_fit": 0, "anomaly_fit_shard_fit": 0,
                                "anomaly_fit_shard_partials": 0,
                                "anomaly_fit_shard_reduce": 0},
                   "built": []}


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=ENV, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=ENV, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_sources_are_sm90a_cuda_with_plain_c_entry_points():
    from clawker_tpu_torch.kernels import build

    assert "arch=compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in build.NVCC_FLAGS
    for source in build.SOURCES:
        src = (build.CSRC / f"{source}.cu").read_text()
        assert "__global__" in src and "Replaces:" in src
        assert not re.search(r"cublas|torch/", src)
        for name in build.entry_points(source):
            assert f'extern "C" int {name}(' in src
            assert len(build.SIGNATURES[name]) == len(
                re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
                .split(","))


@pytest.mark.parametrize("module", CONTROL_PLANE_MODULES)
def test_control_plane_loads_no_torch(module):
    """The control plane is host code: it loads no torch; only the
    modules that serve or mint mTLS material load ``cryptography``."""
    doc = _run_isolated(
        "import importlib, json\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps({'torch': 'torch' in sys.modules,\n"
        "                  'cryptography': 'cryptography' in sys.modules}))\n")
    assert doc == {"torch": False, "cryptography": module in CONTROL_PLANE_PKI}
