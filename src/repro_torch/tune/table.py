"""Versioned JSON persistence for tuning winners (``TuningTable``) — a
copy of ``repro.tune.table``, so that tables load across the packages.

A table maps bucket keys (``repro_torch.tune.cost.bucket_key``) to
``TunedConfig`` entries.  On-disk schema::

    {"schema": "repro.tune/v1",
     "backend": "interpret",
     "provenance": "how/where the entries were recorded",
     "entries": {"<bucket key>": {"impl": ..., "block_q": ...,
                                  "source": "measured", "score_us": ...}}}

Robustness contract (tested): loading a corrupt, unreadable, or
wrong-schema file never raises — it warns and yields an *empty* table,
so a damaged table file degrades serving to pure model predictions
instead of taking the process down.  ``save()`` writes atomically
(temp file + rename).

Shipped defaults live under ``repro_torch/tune/tables/{backend}.json`` and
are loaded once per process (``default_table``); re-record them with
``python -m repro_torch.tune.tuner --backend <name> --out <path>``.
"""
from __future__ import annotations

import json
import os
import tempfile
import warnings
from typing import Optional

from .cost import TunedConfig

SCHEMA = "repro.tune/v1"
_TABLES_DIR = os.path.join(os.path.dirname(__file__), "tables")


class TuningTable:
    """An in-memory bucket-key -> ``TunedConfig`` map with JSON I/O."""

    def __init__(self, backend: str = "interpret", *,
                 provenance: str = "", entries: Optional[dict] = None):
        self.backend = backend
        self.provenance = provenance
        self._entries: dict[str, TunedConfig] = dict(entries or {})

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def keys(self):
        return self._entries.keys()

    def get(self, key: str) -> Optional[TunedConfig]:
        return self._entries.get(key)

    def put(self, key: str, config: TunedConfig) -> None:
        self._entries[key] = config

    # -- persistence ----------------------------------------------------

    def to_json(self) -> dict:
        return {"schema": SCHEMA, "backend": self.backend,
                "provenance": self.provenance,
                "entries": {k: v.to_json()
                            for k, v in sorted(self._entries.items())}}

    def save(self, path: str) -> None:
        """Atomic write (temp + rename) so a crash mid-save can never
        leave a half-written table behind."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_json(), f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def load(cls, path: str, backend: str = "interpret") -> "TuningTable":
        """Load a table; ANY failure (missing file, corrupt JSON, wrong
        schema version, malformed entries) degrades to an empty table
        with a warning — tuning must never take the caller down."""
        try:
            with open(path) as f:
                raw = json.load(f)
        except FileNotFoundError:
            return cls(backend)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            warnings.warn(f"tuning table {path!r} is unreadable ({e}); "
                          f"falling back to the cost model", stacklevel=2)
            return cls(backend)
        if not isinstance(raw, dict) or raw.get("schema") != SCHEMA:
            warnings.warn(
                f"tuning table {path!r} has schema "
                f"{raw.get('schema') if isinstance(raw, dict) else type(raw).__name__!r}"
                f" (want {SCHEMA!r}); ignoring it", stacklevel=2)
            return cls(backend)
        entries = {}
        for key, val in (raw.get("entries") or {}).items():
            try:
                entries[key] = TunedConfig.from_json(dict(val))
            except (TypeError, ValueError):
                warnings.warn(f"tuning table {path!r}: dropping malformed "
                              f"entry {key!r}", stacklevel=2)
        return cls(raw.get("backend", backend),
                   provenance=raw.get("provenance", ""), entries=entries)


_DEFAULT_TABLES: dict = {}


def default_table(backend: str) -> TuningTable:
    """The process-wide table for a backend: the shipped
    ``tables/{backend}.json`` defaults (empty if none ship), loaded once.
    Measured winners recorded at runtime land in this object."""
    if backend not in _DEFAULT_TABLES:
        _DEFAULT_TABLES[backend] = TuningTable.load(
            os.path.join(_TABLES_DIR, f"{backend}.json"), backend)
    return _DEFAULT_TABLES[backend]


def reset_tables() -> None:
    """Drop the process table cache (tests; re-reads shipped files)."""
    _DEFAULT_TABLES.clear()
