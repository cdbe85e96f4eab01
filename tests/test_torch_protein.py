"""The PyTorch port of the protein-critic stack's modules against the JAX
package, on the CPU, from the same numpy inputs.

- ``tokenizers/protein.py``: the same vocabulary, lookup table, encode and
  decode.
- ``models/protein.py`` from JAX's own init (``utils/weights.py::
  protein_params_from_jax``): LM logits, classifier logits under padding,
  multi-task logits and attention weights (mean and attention pooling,
  bidirectional and causal), ``extract_latent`` from ids and from
  ``inputs_embeds`` (with its gradient), ``ebm_energy`` on 2-D and 3-D
  input: within 1e-5 of the largest. Dropout: the keep rate, and the
  training forward at rate 0 equal to the inference one.
- ``protein/losses.py``: every loss within 1e-6, the saliency gradient
  within 1e-6 (nonzero exactly on motif positions); class weights,
  ``pos_weight`` and motif masks exactly equal.
- ``protein/{data,dataset,corrected_dataset}.py``: encoded rows, batches
  and length buckets exactly equal; the manifest's binding and each of its
  refusals in both packages.
- Weights: the tree round trip is exact, leftover and missing leaves
  raise, and ``transfer_load_params`` copies every leaf of the block list.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.models import protein as jpm
from genomics_lm_tpu.protein import losses as JPL
from genomics_lm_torch.models import protein as tpm
from genomics_lm_torch.protein import losses as TPL
from genomics_lm_torch.utils.weights import protein_params_from_jax, protein_params_to_jax

FWD_TOL = 1e-5  # float32 forwards whose sums differ only in order
LOSS_TOL = 1e-6
AAS = "ARNDCQEGHILKMFPSTWYV"
BASE = dict(vocab_size=28, n_layer=2, n_head=2, n_embd=16, block_size=32, dropout=0.0)
TASKS = {"family": 3, "function": 2, "stability": 1, "go_terms": 4}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def close(got, want, tol=FWD_TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def padded_batch(seed=0, B=3, T=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 23, (B, T)).astype(np.int32)
    ids[:, 0] = 1
    mask = np.ones((B, T), np.int32)
    for row, n in enumerate(rng.integers(4, T + 1, B)):
        mask[row, n:] = 0
        ids[row, n:] = 0
    return ids, mask


def tree_of(params):
    return jax.tree.map(np.asarray, params)


# --- tokenizer ----------------------------------------------------------------


def test_tokenizer_matches_jax():
    from genomics_lm_tpu.tokenizers.protein import ProteinTokenizer as J
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer as T

    j, t = J(), T()
    assert t.vocab == j.vocab and len(t) == len(j) == 28
    assert t.token_to_id == j.token_to_id
    np.testing.assert_array_equal(t._lut, j._lut)
    assert (t.pad_token_id, t.bos_token_id, t.eos_token_id) == (0, 1, 2)
    seq = "MKVLAXBZ*" + AAS
    assert t.encode_sequence(seq) == j.encode_sequence(seq)
    ids = [1, 25, 3, 4, 23, 2, 0]
    assert t.decode_sequence(ids) == j.decode_sequence(ids)
    assert t.encode_conditions(["<TOPO:TM>"]) == j.encode_conditions(["<TOPO:TM>"])


# --- forwards -------------------------------------------------------------------


def test_lm_logits_match_jax():
    jcfg, tcfg = jpm.ProteinLMConfig(**BASE), tpm.ProteinLMConfig(**BASE)
    params = jpm.init_protein_lm(jax.random.PRNGKey(0), jcfg)
    model = protein_params_from_jax(tree_of(params), "lm", tcfg, "cpu")
    ids, _ = padded_batch(1)
    with torch.no_grad():
        got = tpm.protein_lm_forward(model, tcfg, torch.as_tensor(ids))
    want = jax.jit(lambda p, i: jpm.protein_lm_forward(p, jcfg, i))(params, ids)
    close(got, want, what="lm logits")


def test_classifier_logits_under_padding_match_jax():
    kw = dict(BASE, num_classes=3)
    jcfg, tcfg = jpm.ProteinClassifierConfig(**kw), tpm.ProteinClassifierConfig(**kw)
    params = jpm.init_classifier(jax.random.PRNGKey(1), jcfg)
    model = protein_params_from_jax(tree_of(params), "classifier", tcfg, "cpu")
    ids, mask = padded_batch(2)
    with torch.no_grad():
        for m in (None, mask):
            got = tpm.classifier_forward(model, tcfg, torch.as_tensor(ids),
                                         None if m is None else torch.as_tensor(m))
            close(got, jpm.classifier_forward(params, jcfg, ids, m), what="classifier")


@pytest.mark.parametrize("pooling,bidirectional", [("mean", True), ("attention", True),
                                                   ("attention", False)],
                         ids=["mean", "attention", "attention_causal"])
def test_multitask_logits_latents_and_energy_match_jax(pooling, bidirectional):
    kw = dict(BASE, pooling=pooling, bidirectional=bidirectional)
    jcfg, tcfg = jpm.ProteinClassifierConfig(**kw), tpm.ProteinClassifierConfig(**kw)
    params = jpm.init_multitask(jax.random.PRNGKey(2), jcfg, TASKS)
    model = protein_params_from_jax(tree_of(params), "multitask", tcfg, "cpu")
    ids, mask = padded_batch(3)
    tids, tmask = torch.as_tensor(ids), torch.as_tensor(mask)
    # JAX's functions compiled whole (one compile, not one per primitive)
    jforward = jax.jit(lambda p, i, m: jpm.multitask_forward(p, jcfg, i, m))
    jlatent = jax.jit(lambda p, i, m, e: jpm.extract_latent(p, jcfg, i, m, inputs_embeds=e))
    with torch.no_grad():
        got = tpm.multitask_forward(model, tcfg, tids, tmask)
        want = jforward(params, ids, mask)
        assert got.keys() == want.keys()
        assert ("attention_weights" in got) == (pooling == "attention")
        for key in want:
            close(got[key], want[key], what=key)
        close(tpm.extract_latent(model, tcfg, tids, tmask), jlatent(params, ids, mask, None),
              what="latent")
        close(tpm.extract_latent(model, tcfg, tids), jpm.extract_latent(params, jcfg, ids),
              what="latent without a mask")
    if pooling == "attention":
        # a padded logit is -inf: a row without a valid token is NaN in both
        empty = mask.copy()
        empty[0] = 0
        with torch.no_grad():
            got = tpm.multitask_forward(model, tcfg, tids, torch.as_tensor(empty))
        want = jforward(params, ids, empty)
        assert np.isnan(got["family"][0].numpy()).all()
        assert np.isnan(np.asarray(want["family"][0])).all()

    # the Langevin entry point: inputs_embeds that require grad
    emb = tree_of(params)["backbone"]["token_embedding"][ids]
    ebm = jpm.init_ebm(jax.random.PRNGKey(4), n_embd=16, hidden_dim=8)
    tebm = protein_params_from_jax(tree_of(ebm), "ebm", None, "cpu")
    z = torch.as_tensor(emb).requires_grad_(True)
    lat = tpm.extract_latent(model, tcfg, tids, tmask, inputs_embeds=z)
    energy = tpm.ebm_energy(tebm, lat)
    (grad,) = torch.autograd.grad(energy.sum(), z)

    def jax_energy(e):
        return jpm.ebm_energy(ebm, jpm.extract_latent(params, jcfg, ids, mask,
                                                       inputs_embeds=e)).sum()

    close(lat, jlatent(params, ids, mask, emb), what="latent from embeds")
    close(energy, jpm.ebm_energy(ebm, jlatent(params, ids, mask, None)), what="energy")
    close(grad, jax.jit(jax.grad(jax_energy))(jnp.asarray(emb)), what="energy gradient")
    z3 = np.random.default_rng(5).normal(size=(3, 7, 16)).astype(np.float32)
    with torch.no_grad():
        close(tpm.ebm_energy(tebm, torch.as_tensor(z3)), jpm.ebm_energy(ebm, z3),
              what="energy of a 3-D input")


def test_dropout_keep_rate_and_rate_zero():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = tpm._dropout(x, 0.1, gen, True)
    kept = float((y != 0).float().mean())
    assert abs(kept - 0.9) < 0.005
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    kw = dict(BASE, pooling="attention")
    cfg = tpm.ProteinClassifierConfig(**kw)
    model = tpm.init_weights(tpm.MultiTaskProteinCritic(cfg, TASKS), seed=0)
    ids, mask = (torch.as_tensor(a) for a in padded_batch(6))
    with torch.no_grad():
        plain = tpm.multitask_forward(model, cfg, ids, mask)
        trained = tpm.multitask_forward(model, cfg, ids, mask, train=True, generator=gen)
        for key in plain:
            assert torch.equal(plain[key], trained[key])
        dcfg = tpm.ProteinClassifierConfig(**dict(kw, dropout=0.5))
        dropped = tpm.multitask_forward(model, dcfg, ids, mask, train=True, generator=gen)
    assert not torch.equal(dropped["family"], plain["family"])


def test_init_draws_the_jax_law():
    cfg = tpm.ProteinClassifierConfig(**dict(BASE, n_embd=64, pooling="attention"))
    model = tpm.init_weights(tpm.MultiTaskProteinCritic(cfg, TASKS), seed=3).requires_grad_(False)
    q = model.backbone.blocks[0].attn.query
    assert float(q.w.abs().max()) <= np.sqrt(6 / 128) and float(q.b.abs().max()) == 0.0
    w1 = model.backbone.blocks[0].ff.w1
    assert float(w1.b.abs().max()) <= 1 / 8 and float(w1.b.abs().max()) > 0
    assert abs(float(model.backbone.token_embedding.std()) - 1.0) < 0.15
    assert float(model.pooler.query.abs().max()) < 0.1


# --- losses ---------------------------------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 3)).astype(np.float32)
    labels = np.asarray([0, 2, -1, 1, 2, -1], np.int32)
    weights = JPL.sqrt_inverse_frequency_weights(labels, 3, clamp_max=4.0)
    np.testing.assert_array_equal(TPL.sqrt_inverse_frequency_weights(labels, 3, clamp_max=4.0),
                                  weights)
    for w in (None, weights):
        got, n = TPL.classification_loss(torch.as_tensor(logits), torch.as_tensor(labels),
                                         None if w is None else torch.as_tensor(w))
        want, jn = JPL.classification_loss(logits, labels, w)
        close(got, want, LOSS_TOL, "classification")
        assert int(n) == int(jn) == 4
    none_valid = np.full(6, -1, np.int32)
    got, _ = TPL.classification_loss(torch.as_tensor(logits), torch.as_tensor(none_valid))
    assert float(got) == 0.0 == float(JPL.classification_loss(logits, none_valid)[0])

    ml_logits = rng.normal(size=(5, 4)).astype(np.float32)
    targets = (rng.random((5, 4)) > 0.6).astype(np.float32)
    pos = JPL.auto_pos_weight(targets)
    np.testing.assert_array_equal(TPL.auto_pos_weight(targets), pos)
    for pw in (None, pos):
        close(TPL.multilabel_bce_loss(torch.as_tensor(ml_logits), torch.as_tensor(targets),
                                      None if pw is None else torch.as_tensor(pw)),
              JPL.multilabel_bce_loss(ml_logits, targets, pw), LOSS_TOL, "bce")

    pred = rng.normal(size=6).astype(np.float32) * 2
    target = np.asarray([0.1, np.nan, 3.0, -2.0, np.nan, 0.4], np.float32)
    got, n = TPL.smooth_l1_nan_masked(torch.as_tensor(pred), torch.as_tensor(target))
    want, jn = JPL.smooth_l1_nan_masked(pred, target)
    close(got, want, LOSS_TOL, "smooth l1")
    assert int(n) == int(jn) == 4
    all_nan = np.full(6, np.nan, np.float32)
    got, _ = TPL.smooth_l1_nan_masked(torch.as_tensor(pred), torch.as_tensor(all_nan))
    assert float(got) == 0.0 == float(JPL.smooth_l1_nan_masked(pred, all_nan)[0])


def test_motif_masks_and_saliency_gradient_match_jax():
    seqs = ["AAGDSGGAA", "HIGHKMSKS", "AAAA", "AAAAAAHIGH", "DXDGDSGGDXD"]
    for width in (9, 12):
        np.testing.assert_array_equal(TPL.motif_position_mask(seqs, width),
                                      JPL.motif_position_mask(seqs, width))
    mask = TPL.motif_position_mask(seqs, 12)
    w = np.random.default_rng(0).uniform(0.01, 1.0, (5, 12)).astype(np.float32)
    w = w / w.sum(axis=1, keepdims=True)
    tw = torch.as_tensor(w).requires_grad_(True)
    loss = TPL.saliency_regularizer(tw, torch.as_tensor(mask))
    (grad,) = torch.autograd.grad(loss, tw)
    close(loss, JPL.saliency_regularizer(w, mask), LOSS_TOL, "saliency")
    want = jax.grad(lambda a: JPL.saliency_regularizer(a, jnp.asarray(mask)))(w)
    close(grad, want, LOSS_TOL, "saliency gradient")
    np.testing.assert_array_equal(grad.numpy() != 0, mask > 0)
    empty = torch.as_tensor(TPL.motif_position_mask(["AAAA"] * 5, 12))
    assert float(TPL.saliency_regularizer(tw.detach(), empty)) == 0.0


# --- data -------------------------------------------------------------------------


def write_records(path, n=23, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            record = {"sequence": "".join(rng.choice(list(AAS), int(rng.integers(3, 40)))),
                      "pfam_id": int(rng.integers(-1, 3)), "ec_id": int(rng.integers(0, 2)),
                      "go_terms": [int(x) for x in rng.integers(0, 2, int(rng.integers(2, 5)))]}
            if i % 4:
                record["stability_score"] = float(rng.normal())
            if i % 3 == 0:
                record["func_label"] = "enzyme"
            f.write(json.dumps(record) + "\n")


def test_datasets_batches_and_buckets_match_jax(tmp_path):
    from genomics_lm_tpu.protein import data as jdata
    from genomics_lm_tpu.protein import dataset as jds
    from genomics_lm_tpu.tokenizers.protein import ProteinTokenizer as JTok
    from genomics_lm_torch.protein import data as tdata
    from genomics_lm_torch.protein import dataset as tds
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer as TTok

    path = tmp_path / "records.jsonl"
    write_records(path)
    fasta = tmp_path / "p.fasta"
    fasta.write_text(">a\nMKV\nLA\n>b\nGGH\n")
    for src in (path, fasta):
        assert tdata.load_records(src) == jdata.load_records(src)
        np.testing.assert_array_equal(tdata.encode_dataset(src, TTok(), 16),
                                      jdata.encode_dataset(src, JTok(), 16))
    t = tds.MultiTaskProteinDataset(path, TTok(), max_length=24, multi_label_tasks=["go_terms"])
    j = jds.MultiTaskProteinDataset(path, JTok(), max_length=24, multi_label_tasks=["go_terms"])
    for epoch in range(3):
        for shuffle in (True, False):
            tb = list(tds.length_bucket_batches(t, 5, shuffle=shuffle, seed=7, epoch=epoch))
            jb = list(jds.length_bucket_batches(j, 5, shuffle=shuffle, seed=7, epoch=epoch))
            assert tb == jb
    for rows in tb:
        lengths = [t.sequence_length(r) for r in rows]
        width = tds.pad_width_for(lengths)
        assert width == jds.pad_width_for(lengths) and width & (width - 1) == 0
        for pad_to in (None, width):
            got, want = t.batch(rows, pad_to=pad_to), j.batch(rows, pad_to=pad_to)
            assert got.keys() == want.keys()
            for key in want:
                if key == "sequence":
                    assert got[key] == want[key]
                else:
                    np.testing.assert_array_equal(got[key], want[key])
                    assert got[key].dtype == want[key].dtype
    assert np.isnan(t.batch(list(range(len(t))))["stability"]).any()


def test_corrected_manifest_binding_and_refusals(tmp_path):
    from genomics_lm_tpu.protein import corrected_dataset as jcd
    from genomics_lm_tpu.tokenizers.protein import ProteinTokenizer as JTok
    from genomics_lm_torch.protein import corrected_dataset as tcd
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer as TTok

    write_records(tmp_path / "train.jsonl", seed=1)
    write_records(tmp_path / "val.jsonl", n=7, seed=2)
    vocab = {"family": ["a", "b", "c"], "function": ["x", "y"]}
    manifest = tcd.write_critic_manifest(
        {"train": tmp_path / "train.jsonl", "val": tmp_path / "val.jsonl"}, vocab,
        tmp_path / "manifest.json")
    assert manifest == jcd.write_critic_manifest(
        {"train": tmp_path / "train.jsonl", "val": tmp_path / "val.jsonl"}, vocab,
        tmp_path / "manifest_jax.json")
    t = tcd.CorrectedMultiTaskProteinDataset(tmp_path / "manifest.json", "train", TTok())
    j = jcd.CorrectedMultiTaskProteinDataset(tmp_path / "manifest.json", "train", JTok())
    assert t.task_dims == j.task_dims == {"family": 3, "function": 2}
    assert t.samples == j.samples

    def refusals(mod):
        out = []
        for name, edit in (
                ("missing split", lambda m: m["splits"].pop("val")),
                ("size", lambda m: m["splits"]["val"].update(bytes=1)),
                ("hash", lambda m: m["splits"]["val"].update(sha256="0" * 64)),
                ("path", lambda m: m["splits"]["val"].update(path="gone.jsonl"))):
            m = json.loads((tmp_path / "manifest.json").read_text())
            edit(m)
            bad = tmp_path / f"bad_{name.replace(' ', '_')}.json"
            bad.write_text(json.dumps(m))
            with pytest.raises(mod.CorrectedCriticDatasetError) as err:
                mod.CorrectedMultiTaskProteinDataset(bad, "val", TTok())
            out.append(str(err.value).replace(str(tmp_path), "<tmp>"))
        (tmp_path / "no_schema.json").write_text(json.dumps({"splits": {}}))
        with pytest.raises(mod.CorrectedCriticDatasetError, match="schema"):
            mod.load_critic_manifest(tmp_path / "no_schema.json")
        return out

    assert refusals(tcd) == refusals(jcd)


# --- weights --------------------------------------------------------------------------


def test_tree_round_trip_refusals_and_transfer_over_the_block_list():
    from genomics_lm_torch.training.checkpoints import transfer_load_params

    kw = dict(BASE, pooling="attention")
    jcfg, tcfg = jpm.ProteinClassifierConfig(**kw), tpm.ProteinClassifierConfig(**kw)
    src = tree_of(jpm.init_multitask(jax.random.PRNGKey(0), jcfg, {"family": 3}))
    tgt = tree_of(jpm.init_multitask(jax.random.PRNGKey(1), jcfg, {"family": 3}))
    back = protein_params_to_jax(protein_params_from_jax(src, "multitask", tcfg, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(src)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back),
                                                    jax.tree.leaves(src)))
    lm_cfg = tpm.ProteinLMConfig(**BASE)
    lm = tree_of(jpm.init_protein_lm(jax.random.PRNGKey(2), jpm.ProteinLMConfig(**BASE)))
    assert isinstance(protein_params_to_jax(
        protein_params_from_jax(lm, "lm", lm_cfg, "cpu"))["blocks"], list)

    extra = dict(src, stray={"w": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="stray"):
        protein_params_from_jax(extra, "multitask", tcfg, "cpu")
    missing = dict(src)
    missing.pop("pooler")
    with pytest.raises(KeyError, match="pooler"):
        protein_params_from_jax(missing, "multitask", tcfg, "cpu")
    wide = tpm.ProteinClassifierConfig(**dict(kw, block_size=64))
    with pytest.raises(ValueError, match="position_embedding"):
        protein_params_from_jax(src, "multitask", wide, "cpu")

    out, report = transfer_load_params(tgt, src)
    assert not report["missing"] and not report["skipped"]
    assert isinstance(out["backbone"]["blocks"], list)
    assert len(report["loaded"]) == len(jax.tree.leaves(src))
    for got, want in zip(jax.tree.leaves(out), jax.tree.leaves(src)):
        np.testing.assert_array_equal(got, want)
    protein_params_from_jax(out, "multitask", tcfg, "cpu")  # the result loads
