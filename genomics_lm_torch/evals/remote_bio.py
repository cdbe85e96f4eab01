"""Local-first BLAST annotation client with a SQLite cache and a mock engine
(twin of ``genomics_lm_tpu/evals/remote_bio.py``).

Remote NCBI calls are off by default (``REMOTE_ENABLED = False``). The
cache is keyed by the sequence's sha256; the deterministic mock engine
answers offline; the rate-limited remote path runs only when the caller
enables it. ``blast_query`` tries them in that order: cache, then mock,
then remote. Host only: no tensor and no device.
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
import time
from typing import Any, Dict, Optional

REMOTE_ENABLED = False
API_RATE_LIMIT_DELAY = 2.0  # seconds between remote queries
CACHE_DB_PATH = "data/processed/remote_bio_cache.db"

_last_remote_call = 0.0


def get_cache_db(path: str | None = None) -> sqlite3.Connection:
    """Open (and initialize) the local cache database."""
    db_path = path or CACHE_DB_PATH
    parent = os.path.dirname(db_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    conn = sqlite3.connect(db_path)
    conn.execute(
        """
        CREATE TABLE IF NOT EXISTS blast_cache (
            seq_hash TEXT PRIMARY KEY,
            sequence TEXT,
            results TEXT,
            timestamp REAL
        )
        """
    )
    conn.commit()
    return conn


def get_cached_result(seq: str, *, db_path: str | None = None) -> Optional[Dict[str, Any]]:
    seq_hash = hashlib.sha256(seq.encode("utf-8")).hexdigest()
    try:
        conn = get_cache_db(db_path)
        row = conn.execute(
            "SELECT results FROM blast_cache WHERE seq_hash = ?", (seq_hash,)
        ).fetchone()
        conn.close()
        if row:
            return json.loads(row[0])
    except Exception:
        pass
    return None


def save_to_cache(seq: str, results: Dict[str, Any], *, db_path: str | None = None) -> None:
    seq_hash = hashlib.sha256(seq.encode("utf-8")).hexdigest()
    try:
        conn = get_cache_db(db_path)
        conn.execute(
            "INSERT OR REPLACE INTO blast_cache (seq_hash, sequence, results, "
            "timestamp) VALUES (?, ?, ?, ?)",
            (seq_hash, seq, json.dumps(results), time.time()),
        )
        conn.commit()
        conn.close()
    except Exception:
        pass


def mock_blast_query(seq: str) -> Dict[str, Any]:
    """Deterministic offline mock hits (reference :63-110)."""
    mock_hits = [
        {
            "hit_id": "ref|WP_001293848.1",
            "title": "DNA polymerase III subunit beta [Escherichia coli]",
            "species": "Escherichia coli",
            "identity_percent": 98.4,
            "e_value": 1e-84,
            "score": 450.0,
        },
        {
            "hit_id": "gb|AAB12984.1",
            "title": "beta-galactosidase [Escherichia coli K-12]",
            "species": "Escherichia coli K-12",
            "identity_percent": 87.1,
            "e_value": 3e-62,
            "score": 320.0,
        },
        {
            "hit_id": "emb|CAA18239.1",
            "title": "outer membrane porin protein [Salmonella enterica]",
            "species": "Salmonella enterica",
            "identity_percent": 74.5,
            "e_value": 4e-42,
            "score": 210.0,
        },
    ]
    if "M" not in seq:
        mock_hits[0].update(
            title="hypothetical protein [Gram-positive bacteria]",
            species="Bacillus subtilis",
            identity_percent=54.2,
            e_value=1e-12,
            score=95.0,
        )
    return {
        "engine": "mock",
        "query_length": len(seq),
        "hits": mock_hits,
    }


def blast_query(
    seq: str,
    *,
    use_cache: bool = True,
    db_path: str | None = None,
    remote_enabled: bool | None = None,
) -> Dict[str, Any]:
    """Cache → mock (default) → rate-limited remote NCBI (opt-in)."""
    global _last_remote_call
    if use_cache:
        cached = get_cached_result(seq, db_path=db_path)
        if cached is not None:
            cached["from_cache"] = True
            return cached

    enabled = REMOTE_ENABLED if remote_enabled is None else remote_enabled
    if not enabled:
        results = mock_blast_query(seq)
    else:
        wait = API_RATE_LIMIT_DELAY - (time.time() - _last_remote_call)
        if wait > 0:
            time.sleep(wait)
        _last_remote_call = time.time()
        try:
            results = _remote_blast(seq)
        except Exception as exc:
            results = mock_blast_query(seq)
            results["remote_error"] = str(exc)
    if use_cache:
        save_to_cache(seq, results, db_path=db_path)
    return results


def _remote_blast(seq: str) -> Dict[str, Any]:
    """Submit a real NCBI BLAST request (network opt-in only)."""
    import urllib.parse
    import urllib.request

    params = urllib.parse.urlencode(
        {"CMD": "Put", "PROGRAM": "blastp", "DATABASE": "nr", "QUERY": seq}
    ).encode()
    with urllib.request.urlopen(
        "https://blast.ncbi.nlm.nih.gov/Blast.cgi", params, timeout=30
    ) as response:
        body = response.read().decode()
    rid = None
    for line in body.splitlines():
        if "RID =" in line:
            rid = line.split("=", 1)[1].strip()
            break
    return {"engine": "ncbi", "rid": rid, "hits": [], "status": "submitted"}


__all__ = [
    "API_RATE_LIMIT_DELAY",
    "CACHE_DB_PATH",
    "REMOTE_ENABLED",
    "blast_query",
    "get_cache_db",
    "get_cached_result",
    "mock_blast_query",
    "save_to_cache",
]
