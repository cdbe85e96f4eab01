"""The port's data layer against the JAX package's (``genomics_lm_torch/data``).

Exact, on the CPU: ``chunk_record``, ``pack_chunks`` (single, dynamic,
multi, binpack), ``packed_arrays`` and ``packing_metadata_rows`` give the
same windows, arrays and rows in both packages on ``bench.py``-style
lognormal records cut short; ``EpochPlan`` gives the same microbatch order
and ``grouped_batches`` the same groups for fixed and dynamic datasets, NPZ
and mmap sidecars, one and two shards, host shards, a ragged last group and
a PAD-padded last microbatch; ``DevicePrefetcher`` on the CPU yields the
plain iterator's batches. The numpy copies keep the JAX functions' code:
each public function's source equals its twin's, up to the import lines.
A dataset prepared by the JAX pipeline binds in the port's manifest and
vocabulary contract as in JAX's.
"""

from __future__ import annotations

import dataclasses
import inspect
import re

import numpy as np
import pytest
import torch

from genomics_lm_tpu.data import datasets as jds
from genomics_lm_tpu.data import manifest as jmanifest
from genomics_lm_tpu.data import packing as jpacking
from genomics_lm_tpu.data import vocabulary as jvocab
from genomics_lm_torch.data import datasets as tds
from genomics_lm_torch.data import manifest as tmanifest
from genomics_lm_torch.data import packing as tpacking
from genomics_lm_torch.data import vocabulary as tvocab

BLOCK = 32


def bench_records(n=40, seed=1337):
    """``bench.py:143-181``'s records, cut short: lognormal codon counts
    around ~33 (clipped 5..200), so some exceed the block and chunk."""
    rng = np.random.default_rng(seed)
    records = []
    for line in range(n):
        n_codons = int(np.clip(rng.lognormal(3.5, 0.6), 5, 200))
        records.append({
            "tokens": [1] + list(rng.integers(4, 68, n_codons)) + [2],
            "source_id": f"synth:{line}", "source_line_idx": line,
            "fragment_line_idx": line, "fragment_index": 0, "split": "train",
            "fragment_codon_start": 0, "fragment_codon_end": n_codons,
        })
    return records


def _windows(pk, records, mode):
    chunks = [c for r in records for c in pk.chunk_record(r, BLOCK)]
    return chunks, pk.pack_chunks(chunks, block_size=BLOCK, mode=mode, sep_id=3)


@pytest.mark.parametrize("mode", ["single", "dynamic", "multi", "binpack"])
def test_packing_matches_jax(mode):
    records = bench_records()
    jchunks, jwin = _windows(jpacking, records, mode)
    tchunks, twin = _windows(tpacking, records, mode)
    assert [dataclasses.asdict(c) for c in tchunks] == [dataclasses.asdict(c) for c in jchunks]
    assert any(c.continues_to_next for c in tchunks)  # some records chunk
    assert [dataclasses.asdict(w) for w in twin] == [dataclasses.asdict(w) for w in jwin]
    arr_mode = "dynamic" if mode == "dynamic" else "fixed"
    ja = jpacking.packed_arrays(jwin, block_size=BLOCK, mode=arr_mode)
    ta = tpacking.packed_arrays(twin, block_size=BLOCK, mode=arr_mode)
    assert ja.keys() == ta.keys()
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and np.array_equal(ta[k], ja[k]), k
    assert (tpacking.packing_metadata_rows("train", twin)
            == jpacking.packing_metadata_rows("train", jwin))


def _body(obj) -> str:
    """Source of a function or class with its docstring dropped."""
    src = inspect.getsource(obj)
    return re.sub(r'(:\n\s+)("""|\'\'\')[\s\S]*?\2\n', r"\1", src, count=1)


COPIED = [
    (jpacking, tpacking, [n for n in jpacking.__all__ if n != "PACKING_METADATA_FIELDS"]),
    (jds, tds, ["dataset_length_audit", "PackedDataset", "EpochPlan", "grouped_batches",
                "bucket_for_lengths", "build_codon_lm_datasets"]),
    (jmanifest, tmanifest, [n for n in jmanifest.__all__ if n[0].islower()]
     + ["DatasetManifestError"]),
    (jvocab, tvocab, [n for n in jvocab.__all__ if n[0].islower() or n.startswith(
        ("Vocabulary", "Dataset"))]),
]


@pytest.mark.parametrize("pair", range(len(COPIED)),
                         ids=["packing", "datasets", "manifest", "vocabulary"])
def test_numpy_copies_keep_the_jax_code(pair):
    jmod, tmod, names = COPIED[pair]
    for name in names:
        want = _body(getattr(jmod, name)).replace("genomics_lm_tpu", "genomics_lm_torch")
        assert _body(getattr(tmod, name)) == want, name
    if jmod is jpacking:
        assert tpacking.PACKING_METADATA_FIELDS == jpacking.PACKING_METADATA_FIELDS


def _write_shards(tmp_path, dynamic, n_files, seed=0):
    """``n_files`` shards of windows with ragged lengths, as NPZ and as
    mmap sidecars."""
    rng = np.random.default_rng(seed)
    paths = []
    for f in range(n_files):
        n = 23 + 6 * f
        stem = tmp_path / f"shard{f}"
        if dynamic:
            lengths = rng.integers(3, 70, n).astype(np.int32)
            X = rng.integers(4, 68, int(lengths.sum())).astype(np.int32)
            np.savez(f"{stem}.npz", X=X, lengths=lengths)
            np.save(f"{stem}_X.npy", X)
            np.save(f"{stem}_lengths.npy", lengths)
        else:
            X = rng.integers(4, 68, (n, 24)).astype(np.int32)
            Y = np.roll(X, -1, axis=1)
            Y[:, rng.integers(10, 24):] = 0
            np.savez(f"{stem}.npz", X=X, Y=Y)
            np.save(f"{stem}_X.npy", X)
            np.save(f"{stem}_Y.npy", Y)
        paths.append(f"{stem}.npz")
    return paths


DATASET_CASES = [(dyn, mmap, files) for dyn in (False, True) for mmap in (False, True)
                 for files in (1, 2)]


@pytest.mark.parametrize("dynamic,mmap,files", DATASET_CASES,
                         ids=[f"{'dyn' if d else 'fixed'}-{'mmap' if m else 'npz'}-{f}f"
                              for d, m, f in DATASET_CASES])
def test_epoch_plan_and_groups_match_jax(tmp_path, dynamic, mmap, files):
    paths = _write_shards(tmp_path, dynamic, files)
    jd = jds.PackedDataset(paths, use_mmap=mmap)
    td = tds.PackedDataset(paths, use_mmap=mmap)
    assert td.storage_mode == jd.storage_mode == ("npy_mmap" if mmap else "npz_memory")
    assert tds.dataset_length_audit(td, 24) == jds.dataset_length_audit(jd, 24)
    for epoch, shuffle, bucket in ((1, True, False), (2, True, True), (0, False, False)):
        kw = dict(batch_size=5, seed=1337, epoch=epoch, shuffle=shuffle, bucket_batching=bucket)
        jp, tp = jds.EpochPlan(jd, **kw), tds.EpochPlan(td, **kw)
        assert len(tp) == len(jp)
        for (tr, tw), (jr, jw) in zip(tp.batches, jp.batches):
            assert tw == jw and np.array_equal(tr, jr)
        # host shards with equal-shape padding
        for (tx, ty), (jx, jy) in zip(
                tp.microbatches(host_id=1, n_hosts=2, pad_equal_shards=True),
                jp.microbatches(host_id=1, n_hosts=2, pad_equal_shards=True)):
            assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
        # a ragged last group (gacc 2 does not divide the 5 or 11
        # microbatches) and a padded last microbatch (B 5 does not divide the
        # 23 or 52 windows)
        for skip in (0, 2):
            tg = list(tds.grouped_batches(tp, 2, skip_microbatches=skip, pad_batch_to=5))
            jg = list(jds.grouped_batches(jp, 2, skip_microbatches=skip, pad_batch_to=5))
            assert len(tg) == len(jg) and len(tg) >= 2
            for (tx, ty, ti), (jx, jy, ji) in zip(tg, jg):
                assert ti == ji and np.array_equal(tx, jx) and np.array_equal(ty, jy)
            if not dynamic:
                assert tg[-1][0].shape[:2] == (1, 5)


def test_grouped_batches_pad_rows_are_pad(tmp_path):
    paths = _write_shards(tmp_path, False, 1)
    ds = tds.PackedDataset(paths)
    plan = tds.EpochPlan(ds, batch_size=5, seed=3, epoch=1)
    groups = list(tds.grouped_batches(plan, 2, pad_batch_to=5))
    last_x, last_y, index = groups[-1]
    assert index == len(plan)
    real = len(ds) % 5
    assert real and not last_x[-1, real:].any() and not last_y[-1, real:].any()


def test_device_prefetcher_on_cpu_yields_the_plain_batches(tmp_path):
    paths = _write_shards(tmp_path, True, 2)
    ds = tds.PackedDataset(paths, use_mmap=True)
    plan = tds.EpochPlan(ds, batch_size=4, seed=9, epoch=1, bucket_batching=True)
    stage = lambda g: (g[0], g[1], g[2], g[0].shape[0])  # noqa: E731
    plain = [stage(g) for g in tds.grouped_batches(plan, 3, pad_batch_to=4)]
    with tds.DevicePrefetcher(tds.grouped_batches(plan, 3, pad_batch_to=4), stage,
                              depth=2, device="cpu") as pf:
        got = list(pf)
    assert len(got) == len(plain)
    for (gx, gy, gi, gn), (px, py, pi, pn) in zip(got, plain):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        assert np.array_equal(gx.numpy(), px) and np.array_equal(gy.numpy(), py)
        assert (gi, gn) == (pi, pn)


def test_device_prefetcher_errors_and_early_close():
    def gen():
        yield np.arange(3)
        raise RuntimeError("loader exploded")

    pf = tds.DevicePrefetcher(gen(), depth=2)
    assert torch.equal(next(pf), torch.arange(3))
    with pytest.raises(RuntimeError, match="loader exploded"):
        list(pf)
    endless = tds.DevicePrefetcher((np.full(2, i) for i in range(10**6)), depth=2)
    assert int(next(endless)[0]) == 0
    endless.close()
    assert not endless._worker.is_alive()
    with pytest.raises(StopIteration):
        next(endless)


def test_prepared_dataset_binds_in_the_port(tmp_path):
    from genomics_lm_tpu.data.pipeline import prepare_dataset

    rng = np.random.default_rng(0)
    records = [{"sequence": "ATG" + "".join(rng.choice(["AAA", "CCC", "GGG", "TTC", "GAT"],
                                                      int(rng.integers(12, 30)))) + "TAA",
                "source_id": f"g{g}:cds{i}", "genome": f"genome_{g}", "genus": f"genus_{g % 3}"}
               for g in range(6) for i in range(4)]
    prepare_dataset(records, tmp_path / "ds", block_size=32, pack_mode="binpack",
                    skip_homology=True)
    shards = [tmp_path / "ds" / f"{s}_bs32.npz" for s in ("train", "val")]
    found = tmanifest.discover_manifest(shards)
    assert found == jmanifest.discover_manifest(shards)
    tm = tmanifest.load_dataset_manifest(found, verify_artifacts=True)
    assert tm == jmanifest.load_dataset_manifest(found, verify_artifacts=True)
    tc = tvocab.resolve_vocabulary_contract(shards, configured_path=None, configured_size=68)
    jc = jvocab.resolve_vocabulary_contract(shards, configured_path=None, configured_size=68)
    assert tc.provenance() == jc.provenance()
    with pytest.raises(tvocab.VocabularyContractError):
        tvocab.resolve_vocabulary_contract(shards, configured_path=None, configured_size=70)
    td = tds.PackedDataset([str(s) for s in shards[:1]], use_mmap=True)
    jd = jds.PackedDataset([str(s) for s in shards[:1]], use_mmap=True)
    assert td.storage_mode == jd.storage_mode
    tx, ty = td.fetch_batch(np.arange(len(td)))
    jx, jy = jd.fetch_batch(np.arange(len(jd)))
    assert np.array_equal(tx, jx) and np.array_equal(ty, jy)


@pytest.mark.parametrize("mode", ["multi", "binpack"])
def test_bench_dataset_matches_bench_py(tmp_path, mode):
    """``bench_pipeline.build_packed_dataset`` writes ``bench.py``'s packed
    dataset bit for bit (the same records, packing and pad fraction)."""
    import bench
    from genomics_lm_torch.training import bench_pipeline

    jnpz, jpad = bench.build_packed_dataset(256, 512, tmp_path / "jax", mode)
    tnpz, tpad = bench_pipeline.build_packed_dataset(256, 512, tmp_path / "port", mode)
    assert tpad == jpad
    with np.load(jnpz) as j, np.load(tnpz) as t:
        assert np.array_equal(t["X"], j["X"]) and np.array_equal(t["Y"], j["Y"])
    for side in ("X", "Y"):
        assert np.array_equal(np.load(tmp_path / "port" / f"bench_train_{side}.npy"),
                              np.load(tmp_path / "jax" / f"bench_train_{side}.npy"))


def test_device_prefetcher_surfaces_a_failed_stage():
    """A worker that fails before its first item (here: staging on a device
    this build cannot reach) raises on the consumer side instead of leaving
    it waiting."""
    if torch.cuda.is_available():
        pytest.skip("the card is reachable: staging there succeeds")
    pf = tds.DevicePrefetcher(iter([np.arange(3)]), depth=1, device="cuda")
    with pytest.raises((RuntimeError, AssertionError, AttributeError)):
        next(pf)
    pf.close()
