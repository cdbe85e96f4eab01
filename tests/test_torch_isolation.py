"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

A fresh interpreter imports every module of ``genomics_lm_torch`` and the
``chip_smoke`` script and finds neither ``jax``, ``genomics_lm_tpu`` nor the
JAX package's ``scripts`` in ``sys.modules``; a source scan finds no import
of any of them, static or dynamic (docstrings may still name the JAX twin
of a module). No port source names a path under ``genomics_lm_tpu/`` or
the JAX package's ``libgenomics_native.so`` outside its docstrings and
comments, apart from the ``file:line`` citations of the kernels each port
kernel replaces. The port's copy of the codon vocabulary equals the JAX
package's.

The card's machine has neither sklearn nor xgboost: no port source imports
sklearn, and the one import of xgboost is the JAX contract's inside
``evals/probes.py::fit_kmer_xgb``. In a fresh interpreter whose
``sys.meta_path`` refuses both, ``mine_motifs``, ``train_classifier`` (every
kind but ``mlp``; ``kmer_xgb`` raises the JAX package's ``RuntimeError``),
``eval_classifier``, ``probe_linear``, ``benchmark_xgboost_dna`` and
``probe_ss_linear`` run to their reports on a tiny run of the port's own.
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "genomics_lm_torch"
PORT_SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
NATIVE_SOURCES = sorted(p for ext in ("*.cu", "*.cuh", "*.cpp", "*.h") for p in PORT.rglob(ext))
CITATION = re.compile(r"^genomics_lm_tpu/[\w/]+\.py:\d*$")  # "replaces": file:line, never opened


def jax_paths_named(text: str) -> list[str]:
    """The non-docstring string constants of a Python source that name the JAX
    package's files, citations aside."""
    tree = ast.parse(text)
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs
            and ("libgenomics_native" in node.value
                 or ("genomics_lm_tpu" in node.value and not CITATION.match(node.value)))]


def test_importing_the_port_pulls_in_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'genomics_lm_tpu', 'scripts'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_neither_jax_nor_the_jax_package():
    static = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|genomics_lm_tpu|scripts)\b", re.M)
    dynamic = re.compile(r"(import_module|__import__)\(\s*[\"'](jax|genomics_lm_tpu|scripts)")
    offenders = [str(p.relative_to(REPO)) for p in PORT_SOURCES
                 if static.search(p.read_text()) or dynamic.search(p.read_text())]
    assert not offenders


def test_vocabulary_copy_matches_the_jax_package():
    from genomics_lm_tpu.tokenizers import codon as jax_codon
    from genomics_lm_torch.tokenizers import codon

    assert codon.VOCAB == jax_codon.VOCAB and codon.stoi == jax_codon.stoi
    assert (codon.PAD_ID, codon.BOS_ID, codon.EOS_ID, codon.SEP_ID) == (
        jax_codon.PAD_ID, jax_codon.BOS_ID, jax_codon.EOS_ID, jax_codon.SEP_ID)
    assert codon.STOP_IDS == jax_codon.STOP_IDS
    rng = np.random.default_rng(0)
    dna = "".join(rng.choice(list("ACGT"), 60))
    for term in ("eos", "sep", "none"):
        assert codon.to_ids(dna, term) == jax_codon.to_ids(dna, term)
    assert codon.decode_ids(codon.to_ids(dna)) == jax_codon.decode_ids(jax_codon.to_ids(dna))
    for bad in ("ATGNNN", "ATGA"):
        try:
            jax_codon.to_ids(bad)
            want = None
        except ValueError as e:
            want = type(e).__name__
        try:
            codon.to_ids(bad)
            got = None
        except ValueError as e:
            got = type(e).__name__
        assert got == want


def test_no_source_names_a_path_of_the_jax_package():
    assert sorted(jax_paths_named(
        'from pathlib import Path\n'
        'LIB = Path(__file__).parent.parent / "genomics_lm_tpu" / "native"\n'
        'SO = "libgenomics_native.so"\n')) == ["genomics_lm_tpu", "libgenomics_native.so"]
    offenders = {str(p.relative_to(REPO)): named for p in PORT_SOURCES
                 if (named := jax_paths_named(p.read_text()))}
    assert not offenders
    comment = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
    offenders = [str(p.relative_to(REPO)) for p in NATIVE_SOURCES
                 if re.search(r"genomics_lm_tpu|libgenomics_native",
                              comment.sub("", p.read_text()))]
    assert NATIVE_SOURCES and not offenders


def sklearn_and_xgboost_imports(path: Path) -> list[tuple[str, str | None]]:
    """Each static import of sklearn or xgboost in a source: (package, the
    innermost function holding it, None at module level)."""
    tree = ast.parse(path.read_text())
    owner = {}
    for node in ast.walk(tree):  # breadth first: an inner function overwrites its outer one
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for child in ast.walk(node):
                owner[id(child)] = node.name
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        found += [(name.split(".")[0], owner.get(id(node))) for name in names
                  if name.split(".")[0] in ("sklearn", "xgboost")]
    return found


def test_only_fit_kmer_xgb_imports_xgboost_and_nothing_imports_sklearn():
    assert sklearn_and_xgboost_imports(REPO / "tests" / "test_torch_isolation.py") == []
    found = {str(p.relative_to(REPO)): hits for p in PORT_SOURCES
             if (hits := sklearn_and_xgboost_imports(p))}
    assert found == {"genomics_lm_torch/evals/probes.py": [("xgboost", "fit_kmer_xgb")]}
    dynamic = re.compile(r"(import_module|__import__|find_spec)\(\s*[\"'](sklearn|xgboost)")
    assert not [str(p.relative_to(REPO)) for p in PORT_SOURCES if dynamic.search(p.read_text())]


BLOCKED_CLIS = r"""
import importlib.machinery
import sys


class Refuse:
    # finds sklearn and xgboost first, with no file, and fails their import as
    # an absent package's (a spec without an origin: torch's own probe for
    # installed packages reads that as nothing to trace)

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("sklearn", "xgboost"):
            return importlib.machinery.ModuleSpec(name, self)
        return None

    def create_module(self, spec):
        raise ModuleNotFoundError(f"No module named {spec.name!r}", name=spec.name)

    def exec_module(self, module):
        pass


sys.meta_path.insert(0, Refuse())

import contextlib, csv, functools, io, json, pickle
from pathlib import Path

import numpy as np
import torch

from genomics_lm_torch.data.demo_corpus import main as demo_corpus
from genomics_lm_torch.data.pipeline import prepare_dataset
from genomics_lm_torch.evals import probes
from genomics_lm_torch.evals.benchmark_xgboost_dna import main as xgb_cli
from genomics_lm_torch.evals.eval_classifier import main as eval_cli
from genomics_lm_torch.evals.extract_embeddings import main as extract_cli
from genomics_lm_torch.evals.mine_motifs import main as mine_cli
from genomics_lm_torch.evals.probe_linear import main as linear_cli
from genomics_lm_torch.evals.probe_ss_linear import main as ss_cli
from genomics_lm_torch.evals.train_classifier import main as train_cli
from genomics_lm_torch.models.codon_gpt import CodonGPT
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.tokenizers.codon import write_itos
from genomics_lm_torch.training.checkpoints import save_checkpoint
from genomics_lm_torch.utils.weights import params_to_jax

from genomics_lm_torch.evals import metrics

torch.set_num_threads(1)
# the CLIs' bootstrap at 50 resamples, not 1,000: this run checks what imports, not the intervals
metrics.compute_metrics = functools.partial(metrics.compute_metrics, n_resamples=50)
w = Path(sys.argv[1])
out = {}


def run(name, main, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        out[name] = main(argv)


with contextlib.redirect_stdout(io.StringIO()):
    demo_corpus(["--out", str(w / "records.tsv"), "--genes", "60", "--seed", "3",
                 "--min_codons", "30", "--max_codons", "90"])
records = list(csv.DictReader((w / "records.tsv").open(), delimiter="\t"))
manifest = prepare_dataset(records, w / "ds", block_size=64, split_seed=2, skip_homology=True)
model_cfg = dict(vocab_size=68, block_size=64, n_layer=1, n_head=2, n_embd=32, dropout=0.0,
                 sep_id=3)
torch.manual_seed(0)
cfg = CodonGPTConfig(**model_cfg)
run_dir = w / "runs" / "tiny"
save_checkpoint({"model": params_to_jax(CodonGPT(cfg), cfg),
                 "cfg": dict(model_cfg, dataset_manifest={"dataset_id": manifest["dataset"]["id"]})},
                run_dir / "checkpoints" / "best.npz")
write_itos(run_dir / "itos.txt")

run("mine_motifs", mine_cli, [str(run_dir), "--npz", str(w / "ds" / "train_bs64.npz"),
                              "--max_windows", "6", "--n_clusters", "5", "--out",
                              str(w / "motifs.json"), "--device", "cpu"])
genes = records[:56]
gc = np.asarray([sum(c in "GC" for c in g["sequence"][2::3]) for g in genes]) / np.asarray(
    [len(g["sequence"]) // 3 for g in genes])
labels = np.searchsorted(np.quantile(gc, [1 / 3, 2 / 3]), gc, side="right")
(w / "labels.csv").write_text("id,label\n" + "".join(
    f"{g['source_id']},{y}\n" for g, y in zip(genes, labels)))
for name, rows in (("train", slice(0, 36)), ("test", slice(36, 56))):
    part = list(zip(genes[rows], labels[rows]))
    (w / f"{name}.fasta").write_text("".join(f">{g['source_id']}\n{g['sequence']}\n"
                                             for g, _ in part))
    (w / f"{name}.csv").write_text("id,sequence,label\n" + "".join(
        f"{g['source_id']},{g['sequence']},{y}\n" for g, y in part))
    run(f"extract_{name}", extract_cli, [str(run_dir), "--input", str(w / f"{name}.fasta"),
                                         "--out", str(w / f"{name}.npz"), "--dataset_manifest",
                                         str(w / "ds" / "manifest.json"), "--device", "cpu"])
    with np.load(w / f"{name}.npz") as z:
        np.savez(w / f"{name}_seq.npz", X=z["X"], ids=z["ids"],
                 sequences=np.asarray([g["sequence"] for g, _ in part]))
for kind in ("probe_logreg", "probe_svm", "kmer_logreg", "kmer_svm", "kmer_xgb"):
    pack = "{}_seq.npz" if kind.startswith("kmer") else "{}.npz"
    (w / f"{kind}.yaml").write_text(json.dumps(dict(
        kind=kind, train_npz=str(w / pack.format("train")), test_npz=str(w / pack.format("test")),
        train_labels=str(w / "labels.csv"), test_labels=str(w / "labels.csv"))))
    try:
        run(f"train_{kind}", train_cli, ["--config", str(w / f"{kind}.yaml"), "--out_dir",
                                         str(w / kind), "--device", "cpu"])
    except RuntimeError as exc:
        out[f"train_{kind}"] = str(exc)
with (w / "vectorizer.pkl").open("wb") as f:
    pickle.dump(probes._tfidf(3, True).fit([g["sequence"] for g in genes[:36]]), f)
run("eval_probe", eval_cli, ["--kind", "probe", "--model", str(w / "probe_svm" / "model.pkl"),
                             "--embeddings", str(w / "test.npz"), "--labels",
                             str(w / "labels.csv"), "--out", str(w / "eval_probe")])
run("eval_kmer", eval_cli, ["--kind", "kmer", "--model", str(w / "kmer_logreg" / "model.pkl"),
                            "--vectorizer", str(w / "vectorizer.pkl"), "--seqs",
                            str(w / "test.csv"), "--labels", str(w / "labels.csv"), "--out",
                            str(w / "eval_kmer")])
for kind in ("logreg", "svm"):
    run(f"probe_linear_{kind}", linear_cli,
        ["--train_npz", str(w / "train.npz"), "--test_npz", str(w / "test.npz"),
         "--train_labels", str(w / "labels.csv"), "--test_labels", str(w / "labels.csv"),
         "--kind", kind, "--out", str(w / f"linear_{kind}.json")])
run("benchmark_xgboost_dna", xgb_cli, ["--train_csv", str(w / "train.csv"), "--test_csv",
                                       str(w / "test.csv"), "--out", str(w / "xgb.json")])
rng = np.random.default_rng(0)
H = rng.normal(size=(12, 20, 8)).astype(np.float32)
np.savez(w / "tokens.npz", H=H, Y=np.argmax(H[..., :3], axis=-1), M=np.ones((12, 20)))
run("probe_ss_linear", ss_cli, ["--emb_npz", str(w / "tokens.npz"), "--out_dir", str(w / "ss")])
out["engine"] = json.loads((w / "xgb.json").read_text())["engine"]
out["reports"] = sorted(str(p.relative_to(w)) for p in w.rglob("*.json")
                        if p.parent.name != "ds" and not p.name.endswith("provenance.json"))
out["imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("sklearn", "xgboost"))
print(json.dumps(out))
"""


def test_the_clis_run_with_sklearn_and_xgboost_refused(tmp_path):
    proc = subprocess.run([sys.executable, "-c", BLOCKED_CLIS, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("imported") == []
    assert out.pop("train_kmer_xgb") == "xgboost not installed; pip install xgboost"
    assert out.pop("engine") == "port_hist_gbdt (xgboost not installed)"
    assert out.pop("reports") == sorted(
        ["motifs.json", "eval_kmer/metrics.json", "eval_probe/metrics.json", "xgb.json",
         "linear_logreg.json", "linear_svm.json", "ss/metrics.json"]
        + [f"{kind}/metrics.json" for kind in ("probe_logreg", "probe_svm", "kmer_logreg",
                                               "kmer_svm")])
    assert set(out.values()) == {0}, out
