"""Typed error hierarchy for CLI and domain layers.

The port's copy of ``clawker_tpu/errors.py``, whole.

Parity reference: internal/cmdutil typed errors (FlagError / SilentError /
ExitError) and the centralized error rendering in internal/clawker/cmd.go.
"""

from __future__ import annotations


class ClawkerError(Exception):
    """Base class for all framework errors."""


class FlagError(ClawkerError):
    """User error in flags/arguments; CLI prints usage alongside the message."""


class SilentError(ClawkerError):
    """Error already presented to the user; CLI exits non-zero, prints nothing."""


class ExitError(ClawkerError):
    """Carries an explicit process exit code (e.g. forwarded agent exit)."""

    def __init__(self, code: int, message: str = ""):
        super().__init__(message or f"exit status {code}")
        self.code = code


class NotFoundError(ClawkerError):
    """Requested object (container, image, project, agent...) does not exist."""


class ConflictError(ClawkerError):
    """Object already exists or state transition is not allowed."""


class JailViolation(ClawkerError):
    """An engine operation tried to touch an object without the managed label.

    The label jail is a hard safety boundary (reference: pkg/whail/engine.go
    injectManagedFilter): this framework must never mutate containers,
    images, volumes, or networks it does not own.
    """


class DriverError(ClawkerError):
    """Runtime driver transport failure (daemon unreachable, SSH down...)."""


class ConfigError(ClawkerError):
    """Invalid or unresolvable configuration."""


class AuthError(ClawkerError):
    """Identity/credential failure (mTLS, token, assertion)."""
