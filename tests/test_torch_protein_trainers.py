"""The PyTorch port of the protein-critic trainers, scoring, the Langevin
sampler and the nine protein CLIs against the JAX package, on the CPU.

One tiny corpus (18 training and 5 validation proteins, every bucket padded
to 16, so JAX compiles each step once) and one JAX run of each trainer
(module fixture). The port's trainers start from JAX's own init at dropout
0 and follow its curves within 1e-4 relative: the multi-task critic (class
weights, multi-label BCE with ``pos_weight``, NaN stability targets, the
saliency term, a short last accumulation group), the LM (two epochs of its
per-epoch cosine), the classifier and the EBM (the same corrupted strings
from Python's ``random``). ``train_mlp_heads``' features equal JAX's within
1e-5 (its MLPs draw dropout from another generator, so the report is
compared by its layout). Then:

- JAX's ``load_checkpoint`` + ``multitask_forward`` and ``load_score_fn``
  read the port's ``best_critic.npz`` within 1e-5, and the port's
  ``load_score_fn`` reads JAX's;
- resume continues a run (the port's curves and weights equal a straight
  run's; JAX's trainer restarts at epoch 1, ``ROADMAP.md`` §3), a JAX
  checkpoint's optax state is refused, ``--transfer_from`` loads every leaf;
- validation loss is unweighted;
- Langevin at ``noise_std`` 0: energies within 1e-5 and the same sequence;
- ``batch_score_critic`` and ``score_candidate_tasks``: 1e-5, equal top ids;
- ``load_score_fn`` reads no ``bidirectional``: a causal critic is scored
  bidirectionally in both packages;
- the nine CLIs: the five scoring CLIs against the JAX scripts on the same
  checkpoints (outputs equal, floats within 1e-5; the benchmark by its
  keys), the four training CLIs by their artifacts against the JAX runs of
  the same configuration (the port draws its own init).
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from genomics_lm_tpu.models import protein as jpm
from genomics_lm_tpu.training import checkpoints as jckpt
from genomics_lm_torch.models import protein as tpm
from genomics_lm_torch.tokenizers.protein import ProteinTokenizer
from genomics_lm_torch.training import checkpoints as tckpt
from genomics_lm_torch.utils.weights import protein_params_from_jax

CURVE_RTOL = 1e-4  # tiny float32 training runs whose sums differ only in order
FWD_TOL = 1e-5
AAS = "ARNDCQEGHILKMFPSTWYV"
CRITIC = dict(n_layer=1, n_head=2, n_embd=16, block_size=32, dropout=0.0, batch_size=4,
              grad_accum_steps=2, epochs=1, lr=1e-3, seed=1337, pooling="attention",
              multi_label_tasks=["go_terms"], task_dims={"go_terms": 4},
              task_loss_weights={"family": 1.0, "function": 1.0, "stability": 0.5},
              saliency_regularizer_weight=0.5, run_id="critic")
LM = {"model": {"n_layer": 1, "n_head": 2, "n_embd": 16, "block_size": 16, "dropout": 0.0},
      "training": {"epochs": 2, "batch_size": 4, "grad_accum_steps": 2, "lr": 1e-3},
      "run_id": "plm"}
CLF = dict(n_layer=1, n_head=2, n_embd=16, block_size=32, dropout=0.0, batch_size=4,
           epochs=1, lr=1e-3, run_id="clf")
EBM = dict(epochs=1, hidden_dim=8, pooling="attention", run_id="ebm")
# one length: JAX's eager scoring compiles each primitive per shape
SEQS = ["MKVLA", "GDSGG", "HIGHW", "AAAAA"]
TOKENIZER = ProteinTokenizer()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rel_close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rtol * max(1.0, float(np.abs(want).max())), (what, err)


def curves_of(path):
    with open(path) as f:
        return [[float(v) for v in row.values()] for row in csv.DictReader(f)]


def write_corpus(root: Path) -> dict:
    rng = np.random.default_rng(0)

    def record(i):
        seq = "".join(rng.choice(list(AAS), int(rng.integers(3, 15))))
        if i % 5 == 0:
            seq = (seq[:4] + "GDSGG")[:14]
        r = {"sequence": seq, "pfam_id": int(rng.integers(-1, 3)),
             "ec_id": int(rng.integers(0, 2)),
             "go_terms": [int(x) for x in rng.integers(0, 2, 4)]}
        if rng.random() > 0.25:
            r["stability_score"] = float(rng.normal())
        if i % 3 == 0:
            r["func_label"] = "enzyme"
        return r

    records = [record(i) for i in range(23)]
    for name, rows in (("train", records[:18]), ("val", records[18:])):
        (root / f"{name}.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return {"train_data": str(root / "train.jsonl"), "val_data": str(root / "val.jsonl")}


def jax_init(fn, seed, *args):
    key = jax.random.PRNGKey(seed)
    _, init_key = jax.random.split(key)
    return jax.tree.map(np.asarray, fn(init_key, *args))


def critic_cfg(**kw):
    base = dict(vocab_size=28, n_layer=1, n_head=2, n_embd=16, block_size=32, dropout=0.0,
                pooling="attention")
    base.update(kw)
    return jpm.ProteinClassifierConfig(**base), tpm.ProteinClassifierConfig(**base)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX run of each trainer on the tiny corpus."""
    from genomics_lm_tpu.protein import train_classifier, train_ebm, train_lm
    from genomics_lm_tpu.protein import train_multi_task

    root = tmp_path_factory.mktemp("protein_runs")
    data = write_corpus(root)
    critic = dict(CRITIC, **data)
    jax_critic = train_multi_task.train(dict(critic), run_root=root / "jax")
    ckpt = root / "jax" / "critic" / "checkpoints" / "best_critic.npz"
    lm = dict(LM, data={"train_path": data["train_data"], "val_path": data["val_data"]})
    jax_lm = train_lm.train(lm, run_root=root / "jax_lm")
    clf = dict(CLF, **data)
    jax_clf = train_classifier.train(dict(clf), run_root=root / "jax_clf")
    ebm_cfg = dict(critic, batch_size=4)
    jax_ebm = train_ebm.train(ebm_cfg, ckpt, epochs=EBM["epochs"],
                              hidden_dim=EBM["hidden_dim"], run_id="ebm",
                              run_root=root / "jax_ebm", pooling="attention")
    return dict(root=root, data=data, critic=critic, lm=lm, clf=clf, ebm_cfg=ebm_cfg,
                jax_critic=jax_critic, jax_lm=jax_lm, jax_clf=jax_clf, jax_ebm=jax_ebm, ckpt=ckpt,
                ebm_ckpt=root / "jax_ebm" / "ebm" / "checkpoints" / "best_ebm.npz")


def port_critic(runs, run_root, resume=None, **overrides):
    from genomics_lm_tpu.protein.dataset import MultiTaskProteinDataset
    from genomics_lm_tpu.protein.train_multi_task import infer_task_dims
    from genomics_lm_tpu.tokenizers.protein import ProteinTokenizer
    from genomics_lm_torch.protein.train_multi_task import train

    cfg = dict(runs["critic"], **overrides)
    ds = MultiTaskProteinDataset(cfg["train_data"], ProteinTokenizer(), 32, ["go_terms"])
    jcfg, _ = critic_cfg()
    tree = jax_init(jpm.init_multitask, cfg["seed"], jcfg, infer_task_dims(ds, cfg))
    return train(cfg, run_root=run_root, device="cpu", init_tree=tree, resume=resume)


def test_multi_task_trainer_matches_jax_and_checkpoints_cross(runs, tmp_path):
    from genomics_lm_tpu.protein import critic_scoring as jcs
    from genomics_lm_torch.protein import critic_scoring as tcs

    meta = port_critic(runs, tmp_path)
    want = runs["jax_critic"]
    assert meta.keys() == want.keys() and meta["task_dims"] == want["task_dims"]
    assert meta["best_epoch"] == want["best_epoch"]
    for got, ref in zip(meta["history"], want["history"], strict=True):
        rel_close([got["train_loss"], got["val_loss"]],
                  [ref["train_loss"], ref["val_loss"]], CURVE_RTOL, "critic curve")
    run = tmp_path / "critic"
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == sorted(
        p.name for p in runs["ckpt"].parent.iterdir())
    rel_close(curves_of(run / "scores" / "curves.csv"),
              curves_of(runs["ckpt"].parent.parent / "scores" / "curves.csv"), 1e-3, "curves")

    # JAX reads the port's checkpoint and the port reads JAX's
    jcfg, tcfg = critic_cfg()
    payload = jckpt.load_checkpoint(run / "checkpoints" / "best_critic.npz")
    ids = np.asarray([[1, *TOKENIZER.encode_sequence(s), 2] for s in SEQS], np.int32)
    mask = (ids != 0).astype(np.int32)
    jout = jpm.multitask_forward(payload["model"], jcfg, ids, mask)
    model = protein_params_from_jax(tckpt.load_checkpoint(
        run / "checkpoints" / "best_critic.npz")["model"], "multitask", tcfg, "cpu")
    with torch.no_grad():
        tout = tpm.multitask_forward(model, tcfg, torch.as_tensor(ids), torch.as_tensor(mask))
    for key in jout:
        rel_close(tout[key].numpy(), jout[key], FWD_TOL, key)
    seqs = SEQS
    for ckpt in (run / "checkpoints" / "best_critic.npz", runs["ckpt"]):
        jfn, _ = jcs.load_score_fn(ckpt, target_task="family", target_class_idx=1)
        tfn, _ = tcs.load_score_fn(ckpt, target_task="family", target_class_idx=1,
                                   device="cpu")
        rel_close(tfn(seqs), jfn(seqs), FWD_TOL, f"scores of {ckpt.parent.parent.name}")


def test_multi_task_resume_continues_and_transfer(runs, tmp_path, capsys):
    from genomics_lm_torch.training.lifecycle import RunLifecycleError

    port_critic(runs, tmp_path / "a", epochs=2)
    last = tmp_path / "a" / "critic" / "checkpoints" / "last_critic.npz"
    resumed = port_critic(runs, tmp_path / "a", epochs=3, resume=str(last))
    port_critic(runs, tmp_path / "b", epochs=3)
    curves = [curves_of(tmp_path / r / "critic" / "scores" / "curves.csv") for r in "ab"]
    assert [row[0] for row in curves[0]] == [1.0, 2.0, 3.0] and curves[0] == curves[1]
    assert [h["epoch"] for h in resumed["history"]] == [3]
    a, b = (tckpt.load_checkpoint(tmp_path / r / "critic" / "checkpoints" / "last_critic.npz")
            for r in "ab")
    for got, want in zip(jax.tree.leaves(a["model"]), jax.tree.leaves(b["model"])):
        np.testing.assert_array_equal(got, want)
    assert a["optimizer_step"] == b["optimizer_step"] == 9

    jax_run = runs["root"] / "jax_copy"
    import shutil

    shutil.copytree(runs["ckpt"].parent.parent, jax_run / "critic")
    with pytest.raises(RunLifecycleError, match="optax"):
        port_critic(runs, jax_run, epochs=2,
                    resume=str(jax_run / "critic" / "checkpoints" / "last_critic.npz"))
    from genomics_lm_torch.protein.train_multi_task import train

    capsys.readouterr()
    train(dict(runs["critic"], run_id="transfer"), transfer_from=str(runs["ckpt"]),
          run_root=tmp_path / "t", device="cpu")
    n_leaves = len(jax.tree.leaves(jckpt.load_checkpoint(runs["ckpt"])["model"]))
    assert f"[transfer] loaded={n_leaves} skipped=0 missing=0" in capsys.readouterr().out


def test_validation_loss_is_unweighted(runs, tmp_path):
    from genomics_lm_torch.protein import losses as PL
    from genomics_lm_torch.protein.dataset import (
        MultiTaskProteinDataset,
        length_bucket_batches,
        pad_width_for,
    )
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer

    cfg = dict(runs["critic"], saliency_regularizer_weight=0.0, multi_label_tasks=[],
               task_dims={}, task_loss_weights={})
    meta = port_critic(runs, tmp_path, saliency_regularizer_weight=0.0, multi_label_tasks=[],
                       task_dims={}, task_loss_weights={})
    _, tcfg = critic_cfg()
    model = protein_params_from_jax(tckpt.load_checkpoint(
        tmp_path / "critic" / "checkpoints" / "last_critic.npz")["model"], "multitask", tcfg,
        "cpu")
    ds = MultiTaskProteinDataset(cfg["val_data"], ProteinTokenizer(), max_length=32)
    total, n = 0.0, 0
    with torch.no_grad():
        for rows in length_bucket_batches(ds, 4, shuffle=False):
            b = ds.batch(rows, pad_to=pad_width_for([ds.sequence_length(r) for r in rows]))
            out = tpm.multitask_forward(model, tcfg, torch.as_tensor(b["input_ids"]),
                                        torch.as_tensor(b["attention_mask"]))
            fam, _ = PL.classification_loss(out["family"], torch.as_tensor(b["family"]))
            fun, _ = PL.classification_loss(out["function"], torch.as_tensor(b["function"]))
            st, _ = PL.smooth_l1_nan_masked(out["stability"][:, 0],
                                            torch.as_tensor(b["stability"]))
            total += float(fam + fun + st)
            n += 1
    np.testing.assert_allclose(meta["history"][-1]["val_loss"], total / n, rtol=1e-5)


def test_lm_classifier_and_ebm_trainers_match_jax(runs, tmp_path):
    from genomics_lm_torch.protein import train_classifier, train_ebm, train_lm

    lcfg = jpm.ProteinLMConfig(vocab_size=28, **LM["model"])
    meta = train_lm.train(runs["lm"], run_root=tmp_path / "lm", device="cpu",
                          init_tree=jax_init(jpm.init_protein_lm, 1337, lcfg))
    assert meta["status"] == runs["jax_lm"]["status"] == "completed"
    rel_close([h["val_loss"] for h in meta["history"]],
              [h["val_loss"] for h in runs["jax_lm"]["history"]], CURVE_RTOL, "lm val")

    ccfg = jpm.ProteinClassifierConfig(vocab_size=28, n_layer=1, n_head=2, n_embd=16,
                                       block_size=32, dropout=0.0, num_classes=2)
    meta = train_classifier.train(dict(runs["clf"]), run_root=tmp_path / "clf", device="cpu",
                                  init_tree=jax_init(jpm.init_classifier, 1337, ccfg))
    assert meta == runs["jax_clf"]
    # the trained classifiers' logits (their key biases are not compared: a
    # key bias shifts every score of a query alike, so its gradient is
    # rounding noise, which Adam's first steps scale up to lr)
    got = tckpt.load_checkpoint(tmp_path / "clf" / "clf" / "checkpoints" / "last.npz")
    want = jckpt.load_checkpoint(runs["root"] / "jax_clf" / "clf" / "checkpoints" / "last.npz")
    tcfg = tpm.ProteinClassifierConfig(**{f: getattr(ccfg, f) for f in (
        "vocab_size", "n_layer", "n_head", "n_embd", "block_size", "dropout", "num_classes")})
    ids = np.asarray([[1, 5, 9, 14, 7, 2, 0, 0], [1, 3, 4, 2, 0, 0, 0, 0]], np.int32)
    with torch.no_grad():
        tlogits = tpm.classifier_forward(protein_params_from_jax(
            got["model"], "classifier", tcfg, "cpu"), tcfg, torch.as_tensor(ids))
    rel_close(tlogits.numpy(), jpm.classifier_forward(want["model"], ccfg, ids), CURVE_RTOL,
              "classifier logits")

    meta = train_ebm.train(runs["ebm_cfg"], runs["ckpt"], epochs=EBM["epochs"],
                           hidden_dim=EBM["hidden_dim"], run_id="ebm",
                           run_root=tmp_path / "ebm", pooling="attention", device="cpu",
                           init_tree=jax_init(jpm.init_ebm, 1337, 16, EBM["hidden_dim"]))
    for g, w in zip(meta["history"], runs["jax_ebm"]["history"], strict=True):
        rel_close([g["train_loss"], g["val_loss"]], [w["train_loss"], w["val_loss"]],
                  CURVE_RTOL, "ebm curve")
    assert meta["best_epoch"] == runs["jax_ebm"]["best_epoch"]
    assert train_ebm.corrupt_sequence("MKVLAGGHHKLA", 0.2, rng=__import__("random").Random(3)) \
        == __import__("genomics_lm_tpu.protein.train_ebm", fromlist=["x"]).corrupt_sequence(
            "MKVLAGGHHKLA", 0.2, rng=__import__("random").Random(3))


def test_mlp_heads_features_match_jax(runs, tmp_path):
    from genomics_lm_tpu.protein.dataset import MultiTaskProteinDataset as JDS
    from genomics_lm_tpu.protein.train_mlp_heads import extract_features as jfeat
    from genomics_lm_tpu.tokenizers.protein import ProteinTokenizer as JTok
    from genomics_lm_torch.protein import train_mlp_heads
    from genomics_lm_torch.protein.dataset import MultiTaskProteinDataset as TDS
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer as TTok

    jcfg, tcfg = critic_cfg()
    payload = jckpt.load_checkpoint(runs["ckpt"])
    model = protein_params_from_jax(payload["model"], "multitask", tcfg, "cpu")
    for split in ("train_data", "val_data"):
        got = train_mlp_heads.extract_features(model, tcfg, TDS(runs["data"][split], TTok(), 32))
        want = jfeat(jax.tree.map(jax.numpy.asarray, payload["model"]), jcfg,
                     JDS(runs["data"][split], JTok(), 32))
        rel_close(got, want, FWD_TOL, split)
    report = train_mlp_heads.train(dict(runs["critic"], pooling="attention"), runs["ckpt"],
                                   epochs=2, out_dir=tmp_path, device="cpu")
    assert_heads_report(report)


def assert_heads_report(report):
    """JAX's report layout: per task the MLP's training metrics (``fit_mlp``,
    held to JAX's by the probe suite) and the validation accuracy."""
    from genomics_lm_torch.evals.metrics import compute_metrics

    assert report.keys() == {"family", "function"}
    metric_keys = compute_metrics(np.asarray([0, 1, 1]), np.asarray([0, 1, 0]),
                                  np.asarray([[0.6, 0.4], [0.2, 0.8], [0.7, 0.3]])).keys()
    for row in report.values():
        assert row.keys() == {"train_metrics", "val_accuracy"}
        assert row["train_metrics"].keys() == metric_keys
        assert 0.0 <= row["val_accuracy"] <= 1.0


def test_langevin_and_critic_scoring_match_jax(runs):
    from genomics_lm_tpu.protein import critic_scoring as jcs
    from genomics_lm_tpu.protein.sampler import latent_langevin_sample as jlangevin
    from genomics_lm_tpu.tokenizers.protein import ProteinTokenizer as JTok
    from genomics_lm_torch.protein import critic_scoring as tcs
    from genomics_lm_torch.protein.sampler import latent_langevin_sample as tlangevin
    from genomics_lm_torch.tokenizers.protein import ProteinTokenizer as TTok

    jcfg, tcfg = critic_cfg()
    cpay, epay = jckpt.load_checkpoint(runs["ckpt"]), jckpt.load_checkpoint(runs["ebm_ckpt"])
    jcritic = jax.tree.map(jax.numpy.asarray, cpay["model"])
    jebm = jax.tree.map(jax.numpy.asarray, epay["model"])
    critic = protein_params_from_jax(cpay["model"], "multitask", tcfg, "cpu")
    ebm = protein_params_from_jax(epay["model"], "ebm", None, "cpu")
    seqs = set()
    for kw in (dict(lr=0.5, lambda_reg=0.1), dict(lr=3.0, lambda_reg=0.0, normalize_grad=True)):
        kw.update(steps=5, noise_std=0.0)
        jseq, jenergy = jlangevin(jebm, jcritic, jcfg, JTok(), "MKVLAGDSGG", **kw)
        tseq, tenergy = tlangevin(ebm, critic, tcfg, TTok(), "MKVLAGDSGG", **kw)
        assert tseq == jseq
        rel_close(tenergy, jenergy, FWD_TOL, f"langevin energies {kw}")
        seqs.add(tseq)
    assert len(seqs) == 2  # the normalized steps move the design
    assert all(not p.requires_grad for p in critic.parameters())

    seqs = SEQS
    for task, cls, use_ebm in (("family", 1, False), ("function", 5, False),
                               ("missing", 0, False), ("ebm", None, True)):
        want = jcs.batch_score_critic(jcritic, jcfg, JTok(), seqs, task, cls,
                                      jebm if use_ebm else None)
        got = tcs.batch_score_critic(critic, tcfg, TTok(), seqs, task, cls,
                                     ebm if use_ebm else None)
        rel_close(got, want, FWD_TOL, f"batch_score_critic {task}")
    _, jbundle = jcs.load_score_fn(runs["ckpt"])
    _, tbundle = tcs.load_score_fn(runs["ckpt"], device="cpu")
    for seq in seqs:
        want, got = jcs.score_candidate_tasks(jbundle, seq), tcs.score_candidate_tasks(
            tbundle, seq)
        assert got.keys() == want.keys()
        for key in want:
            if key.endswith(("top1", "top5", "pred")):
                assert got[key] == want[key], key
            else:
                rel_close(got[key], want[key], FWD_TOL, key)


def test_load_score_fn_scores_a_causal_critic_bidirectionally(tmp_path):
    """``load_score_fn`` reads no ``bidirectional`` from the checkpoint, in
    both packages: a critic trained causal is scored bidirectionally."""
    from genomics_lm_tpu.protein import critic_scoring as jcs
    from genomics_lm_torch.protein import critic_scoring as tcs

    jcfg, tcfg = critic_cfg(bidirectional=False)
    tree = jax_init(jpm.init_multitask, 5, jcfg, {"family": 3, "stability": 2})
    ckpt = tmp_path / "causal.npz"
    tckpt.save_checkpoint({"model": tree, "cfg": dict(CRITIC, bidirectional=False),
                           "task_dims": {"family": 3, "stability": 2}}, ckpt)
    jfn, jb = jcs.load_score_fn(ckpt, target_task="family", target_class_idx=2)
    tfn, tb = tcs.load_score_fn(ckpt, target_task="family", target_class_idx=2, device="cpu")
    assert jb["cfg"].bidirectional is True and tb["cfg"].bidirectional is True
    seqs = SEQS
    rel_close(tfn(seqs), jfn(seqs), FWD_TOL, "scores")
    causal = tcs.make_score_fn(tb["model"], tcfg, tb["tokenizer"], target_task="family",
                               target_class_idx=2)
    assert float(np.abs(causal(seqs) - tfn(seqs)).max()) > 1e-3


def _csv_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _assert_rows_close(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), what
        for key in w:
            try:
                gv, wv = float(g[key]), float(w[key])
            except (TypeError, ValueError):
                assert g[key] == w[key], (what, key)
                continue
            assert abs(gv - wv) <= FWD_TOL * max(1.0, abs(wv)), (what, key, gv, wv)


SCORING_CLIS = ("optimize_designs_langevin", "eval_multi_task_critic",
                "extract_protein_embeddings", "protein_critic_bridge",
                "benchmark_protein_critic_training")
TRAINING_CLIS = ("train_multi_task", "train_protein_lm", "train_ebm", "train_mlp_heads")


@pytest.mark.parametrize("cli", SCORING_CLIS + TRAINING_CLIS)
def test_protein_clis_match_jax(runs, cli, tmp_path, capsys):
    import importlib

    port = importlib.import_module(f"genomics_lm_torch.protein.{cli}").main
    ckpt, ebm = str(runs["ckpt"]), str(runs["ebm_ckpt"])
    data = runs["data"]
    if cli in TRAINING_CLIS:
        config = {"train_multi_task": runs["critic"], "train_protein_lm": runs["lm"],
                  "train_ebm": runs["ebm_cfg"], "train_mlp_heads": dict(
                      runs["critic"], pooling="attention")}[cli]
        (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(config))
        args = ["--config", str(tmp_path / "cfg.yaml"), "--device", "cpu"]
        if cli == "train_multi_task":
            assert port(args + ["--run_root", str(tmp_path)]) == 0
            got = tckpt.load_checkpoint(tmp_path / "critic" / "checkpoints" / "best_critic.npz")
            want = jckpt.load_checkpoint(runs["ckpt"])
        elif cli == "train_protein_lm":
            assert port(args + ["--run_root", str(tmp_path)]) == 0
            got = tckpt.load_checkpoint(tmp_path / "plm" / "checkpoints" / "last.npz")
            want = jckpt.load_checkpoint(
                runs["root"] / "jax_lm" / "plm" / "checkpoints" / "last.npz")
            assert sorted(p.name for p in (tmp_path / "plm" / "checkpoints").iterdir()) == \
                sorted(p.name for p in (runs["root"] / "jax_lm" / "plm" / "checkpoints")
                       .iterdir())
        elif cli == "train_ebm":
            assert port(args + ["--critic_ckpt", ckpt, "--epochs", "1", "--hidden_dim", "8",
                                "--run_root", str(tmp_path)]) == 0
            got = tckpt.load_checkpoint(tmp_path / "protein_ebm" / "checkpoints" /
                                        "best_ebm.npz")
            want = jckpt.load_checkpoint(runs["ebm_ckpt"])
            assert curves_of(tmp_path / "protein_ebm" / "scores" / "curves.csv")
        else:
            assert port(args + ["--critic_ckpt", ckpt, "--epochs", "2",
                                "--out_dir", str(tmp_path)]) == 0
            assert_heads_report(json.loads((tmp_path / "metrics.json").read_text()))
            capsys.readouterr()
            return
        # the port draws its own init: the payloads agree in keys, in every
        # bookkeeping entry and in the model tree's shapes
        skip = {"model", "model_state_dict", "optimizer", "optimizer_state_dict",
                "rng_state", "run_fingerprint", "cfg", "val_loss", "loss", "best_val",
                "best_val_loss"}
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k not in skip} == \
            {k: v for k, v in want.items() if k not in skip}
        key = "model" if "model" in want else "model_state_dict"
        assert jax.tree.structure(jax.tree.map(np.shape, got[key])) == jax.tree.structure(
            jax.tree.map(np.shape, want[key]))
        assert [np.shape(x) for x in jax.tree.leaves(got[key])] == \
            [np.shape(x) for x in jax.tree.leaves(want[key])]
        capsys.readouterr()
        return

    import importlib as il

    jax_main = il.import_module(f"scripts.{cli}").main
    outputs = {}
    for name, main, extra in (("jax", jax_main, []), ("port", port, ["--device", "cpu"])):
        out = tmp_path / name
        out.mkdir()
        if cli == "optimize_designs_langevin":
            designs = tmp_path / "designs.csv"
            designs.write_text("id,protein\nd0,MKVLAGDSGG\nd1,HIGHW\n")
            args = ["--designs_csv", str(designs), "--critic_ckpt", ckpt, "--ebm_ckpt", ebm,
                    "--steps", "3", "--noise_std", "0", "--out", str(out / "opt.csv")]
            assert main(args + extra) == 0
            outputs[name] = _csv_rows(out / "opt.csv")
        elif cli == "eval_multi_task_critic":
            assert main(["--ckpt", ckpt, "--jsonl", data["val_data"], "--batch_size", "2",
                         "--out", str(out / "eval.json")] + extra) == 0
            outputs[name] = json.loads((out / "eval.json").read_text())
        elif cli == "extract_protein_embeddings":
            assert main(["--critic_ckpt", ckpt, "--input", data["val_data"], "--batch_size",
                         "2", "--out", str(out / "emb.npz")] + extra) == 0
            with np.load(out / "emb.npz") as f:
                outputs[name] = {"X": f["X"], "ids": f["ids"].tolist()}
        elif cli == "protein_critic_bridge":
            dna = tmp_path / "dna.csv"
            dna.write_text("id,dna\nc0,ATGAAAGTTCTGTAA\nc1,ATGTAAGGGTAA\nc2,ATGGATTCTGGCTGA\n")
            assert main(["--dna_csv", str(dna), "--critic_ckpt", ckpt, "--target_task",
                         "family", "--target_class", "1", "--min_score", "-1.1",
                         "--out", str(out / "bridge.csv")] + extra) == 0
            outputs[name] = _csv_rows(out / "bridge.csv")
        else:
            assert main(["--jsonl", data["train_data"], "--batch_sizes", "2,3", "--n_layer",
                         "1", "--n_head", "2", "--n_embd", "16", "--block_size", "32",
                         "--sample", "4", "--measure_steps", "1",
                         "--out", str(out / "bench.json")] + extra) == 0
            outputs[name] = json.loads((out / "bench.json").read_text())
    capsys.readouterr()
    got, want = outputs["port"], outputs["jax"]
    if cli == "extract_protein_embeddings":
        assert got["ids"] == want["ids"]
        rel_close(got["X"], want["X"], FWD_TOL, cli)
    elif cli == "eval_multi_task_critic":
        assert got["samples"] == want["samples"] and got["tasks"].keys() == want["tasks"].keys()
        for task, row in want["tasks"].items():
            assert got["tasks"][task].keys() == row.keys()
            rel_close(list(got["tasks"][task].values()), list(row.values()), FWD_TOL, task)
    elif cli == "benchmark_protein_critic_training":
        assert [r.keys() for r in got] == [r.keys() for r in want]
        assert [r["batch_size"] for r in got] == [2, 3]
        assert all(r["sequences_per_sec"] > 0 for r in got)
    else:
        _assert_rows_close(got, want, cli)
        if cli == "protein_critic_bridge":
            assert [r["passed"] for r in got] == [r["passed"] for r in want]
