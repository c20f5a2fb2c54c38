"""Docker API status-code -> typed error mapping.

The port's copy of ``clawker_tpu/engine/errors_map.py``, whole.
"""

from __future__ import annotations

from ..errors import ClawkerError, ConflictError, DriverError, NotFoundError


class APIError(ClawkerError):
    """Raw daemon error with HTTP status."""

    def __init__(self, status: int, message: str, path: str = ""):
        super().__init__(f"daemon: {message} (status {status}{', ' + path if path else ''})")
        self.status = status
        self.raw_message = message


def raise_for(status: int, message: str, path: str = "") -> None:
    if status < 400:
        return
    if status == 404:
        raise NotFoundError(message or f"not found: {path}")
    if status == 409:
        raise ConflictError(message or f"conflict: {path}")
    if status >= 500:
        raise DriverError(message or f"daemon error on {path}")
    raise APIError(status, message, path)
