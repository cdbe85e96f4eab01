"""The port's small utilities against their JAX twins, on the CPU.

- ``utils/metrics_io.py``: the files both write are byte-equal (sorted keys,
  ``indent=2``, a trailing newline), merges included, and a corrupt or
  missing file reads as ``{}``.
- ``utils/sync.py::hard_sync``: the same checksum as JAX's on the same
  first leaf (dicts by sorted keys).
- ``evals/remote_bio.py``: equal mock dicts, equal cache rows (hash,
  sequence, results) and a second query served from the cache in both;
  ``urllib.request.urlopen`` is patched to raise and is never called.
- ``parallel/launch.py::spawn`` with no device runs on the card, so here,
  where there is none, it raises before starting a rank.
"""

from __future__ import annotations

import json
import sqlite3
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.evals import remote_bio as jax_bio
from genomics_lm_tpu.utils import metrics_io as jax_metrics
from genomics_lm_tpu.utils import sync as jax_sync
from genomics_lm_torch.evals import remote_bio
from genomics_lm_torch.parallel import launch, workers
from genomics_lm_torch.utils import metrics_io, sync

UPDATES = [{"val_loss": 1.25, "epoch": 3, "zeta": [1, 2]},
           {"alpha": {"b": 1, "a": 2.5}, "epoch": 4}]


@pytest.mark.parametrize("start", ["missing", "corrupt", "existing"])
def test_metrics_files_are_byte_equal(tmp_path, start):
    paths = {}
    for name, mod in (("jax", jax_metrics), ("port", metrics_io)):
        path = tmp_path / name / "scores" / "metrics.json"
        if start != "missing":
            path.parent.mkdir(parents=True)
            path.write_text("{not json" if start == "corrupt" else '{"kept": true}\n')
        assert mod.read_metrics(path) == ({"kept": True} if start == "existing" else {})
        merged = [mod.write_metrics(path, u) for u in UPDATES]
        paths[name] = (path, merged)
    assert paths["jax"][1] == paths["port"][1]
    assert paths["jax"][0].read_bytes() == paths["port"][0].read_bytes()
    assert paths["port"][0].read_bytes().endswith(b"}\n")


@pytest.mark.parametrize("kind", ["array", "dict", "list"])
def test_hard_sync_checksum_matches_jax(kind):
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((17, 5)).astype(np.float32) for _ in range(2))
    trees = {"array": (a, a), "dict": ({"w": b, "a": a}, {"w": b, "a": a}),
             "list": ([b, a], [b, a])}
    jtree, ttree = trees[kind]

    def convert(tree, fn):
        if isinstance(tree, dict):
            return {k: fn(v) for k, v in tree.items()}
        return [fn(v) for v in tree] if isinstance(tree, list) else fn(tree)

    want = jax_sync.hard_sync(convert(jtree, jnp.asarray))
    got = sync.hard_sync(convert(ttree, torch.from_numpy))
    assert isinstance(got, float)
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


def test_hard_sync_of_a_module_reads_its_first_parameter():
    lin = torch.nn.Linear(3, 2)
    assert sync.hard_sync(lin) == float(lin.weight.detach().sum())


@pytest.fixture
def no_network(monkeypatch):
    calls = []

    def refuse(*args, **kwargs):
        calls.append(args)
        raise AssertionError("the network was reached")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    yield calls
    assert calls == []


SEQS = ["MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ", "GGSAVLLPQ"]  # with and without M


def test_mock_queries_are_equal(no_network):
    for seq in SEQS:
        assert remote_bio.mock_blast_query(seq) == jax_bio.mock_blast_query(seq)
    assert remote_bio.REMOTE_ENABLED is False


def cache_rows(db) -> list:
    with sqlite3.connect(db) as conn:
        return sorted((h, s, json.loads(r)) for h, s, r, _ in
                      conn.execute("SELECT seq_hash, sequence, results, timestamp "
                                   "FROM blast_cache"))


def test_blast_query_caches_then_serves_from_the_cache(tmp_path, no_network):
    out = {}
    for name, mod in (("jax", jax_bio), ("port", remote_bio)):
        db = str(tmp_path / name / "cache.db")
        first = [mod.blast_query(s, db_path=db) for s in SEQS]
        second = [mod.blast_query(s, db_path=db) for s in SEQS]
        assert all("from_cache" not in r for r in first)
        assert all(r.pop("from_cache") is True for r in second)
        assert second == first
        out[name] = (first, cache_rows(db))
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) == len(SEQS)
    # an uncached call with the cache off stays on the mock engine
    assert remote_bio.blast_query("MAA", use_cache=False) == jax_bio.mock_blast_query("MAA")


def test_spawn_with_no_device_raises_without_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.spawn(workers.wait_for, 1, "unused")
