"""Control-plane layer: the port's copy of ``clawker_tpu/controlplane/``,
module for module (the daemon, its AdminService and AgentService, the
docker-events feeder, the dialer and executor, the watcher, the
manager, the start-time hooks, the OTLP lanes, identity and the agent
registry)."""
