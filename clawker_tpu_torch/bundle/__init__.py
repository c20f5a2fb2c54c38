"""Bundle system: pluggable harness / stack / monitoring components.

Parity reference: internal/bundle (SURVEY.md 2.6) -- three-tier component
resolution (embedded floor assets, loose directories, installed bundles
under the data dir).  Assets are plain directories holding
``harness.yaml`` / ``stack.yaml`` plus optional files referenced by
Dockerfile generation.

The port's copy of ``clawker_tpu/bundle/__init__.py`` without
``BundleManager``: the manager serves the ``bundle install|list`` verbs
through the state store and the project manager, and waits for them
(ROADMAP §1 item 13).  The create path needs only the resolver.
"""

from .model import Harness, MonitoringUnit, Stack, load_component_dir
from .resolver import Resolver

__all__ = [
    "Harness",
    "Stack",
    "MonitoringUnit",
    "Resolver",
    "load_component_dir",
]
