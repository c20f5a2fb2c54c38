"""Configuration subsystem: project + settings schemas over the layered store.

The port's copy of ``clawker_tpu/config/__init__.py``, whole.

Parity reference: internal/config (SURVEY.md 2.5) -- Config facade over
Store[Project] + Store[Settings], path accessors, EgressRules() composition.
"""

from .schema import (
    AgentConfig,
    BuildConfig,
    EgressRule,
    ProjectConfig,
    SecurityConfig,
    Settings,
    WorkspaceConfig,
    TPUSettings,
    FirewallSettings,
    ControlPlaneSettings,
    MonitoringSettings,
    LoggingSettings,
    HostProxySettings,
    LoopSettings,
    RuntimeSettings,
)
from .config import Config, load_config, project_store, settings_store

__all__ = [
    "AgentConfig",
    "BuildConfig",
    "Config",
    "ControlPlaneSettings",
    "EgressRule",
    "FirewallSettings",
    "HostProxySettings",
    "LoggingSettings",
    "LoopSettings",
    "MonitoringSettings",
    "ProjectConfig",
    "RuntimeSettings",
    "SecurityConfig",
    "Settings",
    "TPUSettings",
    "WorkspaceConfig",
    "load_config",
    "project_store",
    "settings_store",
]
