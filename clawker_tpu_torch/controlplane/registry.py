"""SQLite agent registry: the CP's durable identity <-> container binding.

The port's copy of ``clawker_tpu/controlplane/registry.py``, whole.

Parity reference: controlplane/agent/registry_sqlite.go (SURVEY.md 2.7) --
the CP is the *sole writer* (WAL coherence on bind mounts is why the
reference centralizes writes); rows bind agent full-name to container id and
cert thumbprint, and persist the initialized marker so reconnects skip the
InitPlan.
"""

from __future__ import annotations

import sqlite3
import threading
import time
from dataclasses import dataclass
from pathlib import Path

_SCHEMA = """
CREATE TABLE IF NOT EXISTS agents (
    full_name     TEXT PRIMARY KEY,
    project       TEXT NOT NULL,
    agent         TEXT NOT NULL,
    container_id  TEXT NOT NULL DEFAULT '',
    cert_sha256   TEXT NOT NULL DEFAULT '',
    worker        TEXT NOT NULL DEFAULT '',
    state         TEXT NOT NULL DEFAULT 'created',
    initialized   INTEGER NOT NULL DEFAULT 0,
    registered_at REAL NOT NULL DEFAULT 0,
    last_seen     REAL NOT NULL DEFAULT 0
);
CREATE INDEX IF NOT EXISTS agents_project ON agents(project);
"""


@dataclass
class AgentRecord:
    full_name: str
    project: str
    agent: str
    container_id: str = ""
    cert_sha256: str = ""
    worker: str = ""
    state: str = "created"
    initialized: bool = False
    registered_at: float = 0.0
    last_seen: float = 0.0


def _row_to_record(row: sqlite3.Row) -> AgentRecord:
    return AgentRecord(
        full_name=row["full_name"],
        project=row["project"],
        agent=row["agent"],
        container_id=row["container_id"],
        cert_sha256=row["cert_sha256"],
        worker=row["worker"],
        state=row["state"],
        initialized=bool(row["initialized"]),
        registered_at=row["registered_at"],
        last_seen=row["last_seen"],
    )


class Registry:
    """Thread-safe single-writer registry over one sqlite file."""

    def __init__(self, path: Path | str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._db = sqlite3.connect(str(self.path), check_same_thread=False)
        self._db.row_factory = sqlite3.Row
        with self._lock:
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.executescript(_SCHEMA)
            self._db.commit()

    def close(self) -> None:
        with self._lock:
            self._db.close()

    # ------------------------------------------------------------- writes

    def bind(
        self,
        full_name: str,
        project: str,
        agent: str,
        *,
        container_id: str,
        cert_sha256: str,
        worker: str = "",
    ) -> None:
        """Create-or-rebind a row at container-create time.  Rebinding (new
        container for a known agent) resets registration but keeps the
        initialized marker only if the container is unchanged."""
        with self._lock:
            prev = self._db.execute(
                "SELECT container_id, initialized FROM agents WHERE full_name=?",
                (full_name,),
            ).fetchone()
            keep_init = bool(prev and prev["container_id"] == container_id and prev["initialized"])
            self._db.execute(
                """INSERT INTO agents
                   (full_name, project, agent, container_id, cert_sha256, worker,
                    state, initialized, registered_at, last_seen)
                   VALUES (?,?,?,?,?,?, 'created', ?, 0, ?)
                   ON CONFLICT(full_name) DO UPDATE SET
                     container_id=excluded.container_id,
                     cert_sha256=excluded.cert_sha256,
                     worker=excluded.worker,
                     state='created',
                     initialized=excluded.initialized,
                     registered_at=0,
                     last_seen=excluded.last_seen""",
                (full_name, project, agent, container_id, cert_sha256, worker,
                 int(keep_init), time.time()),
            )
            self._db.commit()

    def mark_registered(self, full_name: str, cert_sha256: str) -> bool:
        """Record a successful Register call iff the thumbprint matches the
        bound material (identity binding; reference: Register handler)."""
        with self._lock:
            cur = self._db.execute(
                "UPDATE agents SET registered_at=?, last_seen=?, state='registered' "
                "WHERE full_name=? AND cert_sha256=?",
                (time.time(), time.time(), full_name, cert_sha256),
            )
            self._db.commit()
            return cur.rowcount == 1

    def mark_initialized(self, full_name: str) -> None:
        with self._lock:
            self._db.execute(
                "UPDATE agents SET initialized=1, last_seen=? WHERE full_name=?",
                (time.time(), full_name),
            )
            self._db.commit()

    def set_state(self, full_name: str, state: str) -> None:
        with self._lock:
            self._db.execute(
                "UPDATE agents SET state=?, last_seen=? WHERE full_name=?",
                (state, time.time(), full_name),
            )
            self._db.commit()

    def touch(self, full_name: str) -> None:
        with self._lock:
            self._db.execute(
                "UPDATE agents SET last_seen=? WHERE full_name=?", (time.time(), full_name)
            )
            self._db.commit()

    def remove(self, full_name: str) -> None:
        with self._lock:
            self._db.execute("DELETE FROM agents WHERE full_name=?", (full_name,))
            self._db.commit()

    # -------------------------------------------------------------- reads

    def get(self, full_name: str) -> AgentRecord | None:
        with self._lock:
            row = self._db.execute(
                "SELECT * FROM agents WHERE full_name=?", (full_name,)
            ).fetchone()
        return _row_to_record(row) if row else None

    def list(self, project: str | None = None) -> list[AgentRecord]:
        with self._lock:
            if project:
                rows = self._db.execute(
                    "SELECT * FROM agents WHERE project=? ORDER BY full_name", (project,)
                ).fetchall()
            else:
                rows = self._db.execute("SELECT * FROM agents ORDER BY full_name").fetchall()
        return [_row_to_record(r) for r in rows]

    def by_container(self, container_id: str) -> AgentRecord | None:
        with self._lock:
            row = self._db.execute(
                "SELECT * FROM agents WHERE container_id=?", (container_id,)
            ).fetchone()
        return _row_to_record(row) if row else None
