"""Socket-level firewall parity: executable Envoy-bootstrap interpreter,
attacker capture server, virtual-internet world, and the 22-scenario
reference scorecard (`python -m clawker_tpu_torch.parity`).

The port's copy of ``clawker_tpu/parity/``, whole."""

from .world import CurlResult, EgressBlocked, World  # noqa: F401
