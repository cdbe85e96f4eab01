"""Fine-tuning and the trainer's one-card options: the port against the JAX package.

On the CPU, float32, the same seeded numpy inputs through both packages:

- LoRA forwards (separate and fused QKV, GELU and SwiGLU, ``attn`` and
  ``attn+mlp``, ``lora_alpha`` != rank, GQA with RoPE) from a JAX adapted
  tree: logits to ``LOGIT_RTOL``; the tree survives ``params_from_jax`` /
  ``params_to_jax`` bit for bit (adapters and the shape encoder); an
  unmerged adapted model decodes the merged model's greedy tokens;
- ``merge_lora``, ``adapter_state`` and ``apply_adapter_state`` to
  ``MERGE_RTOL``, and their int8 and MoE refusals;
- ``param_group_labels`` equal to JAX's leaf for leaf for every flag
  combination;
- the optimizer fed the same gradients as optax over 3 steps: AdamW with
  ``grad_clip`` active and inactive, Adafactor on factored and unfactored
  leaves with fused QKV at width 128, and ``lora_only``; parameters to
  ``OPT_RTOL``; the frozen ones unchanged;
- remat: the port's group step with ``use_checkpoint`` equals the one
  without bit for bit (dropout 0.1, one generator), and JAX's
  ``use_checkpoint`` step at dropout 0 to ``STEP_RTOL``;
- ``validate_primary_training_config``: the same result or the same
  violations; ``expand_params``: the same report, copies and shapes;
- the CLIs: pretrain, LoRA fine-tune from it, resume, merge; the frozen
  weights unchanged bit for bit, the trainable count equal to
  ``lora_param_count``, the checkpoints read by the JAX package, and the
  LoRA efficiency protocol at a small width.
"""

from __future__ import annotations

import copy
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import biophysics as jbio
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.ops.quant import quantize_params
from genomics_lm_tpu.training import checkpoints as jckpt
from genomics_lm_tpu.training import contracts as jcontracts
from genomics_lm_tpu.training import expansion as jexpansion
from genomics_lm_tpu.training import lora as jlora
from genomics_lm_tpu.training import optim as jax_optim
from genomics_lm_tpu.training import train_step as jax_step
from genomics_lm_torch.generation.decode import generate_tokens
from genomics_lm_torch.models import codon_gpt
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.training import checkpoints as tckpt
from genomics_lm_torch.training import contracts
from genomics_lm_torch.training import expansion
from genomics_lm_torch.training import lora
from genomics_lm_torch.training import optim
from genomics_lm_torch.training.train_step import LossConfig, make_train_step
from genomics_lm_torch.utils.weights import jax_leaves, params_from_jax, params_to_jax

LOGIT_RTOL = 1e-5
MERGE_RTOL = 1e-6
OPT_RTOL = 1e-5
STEP_RTOL = 1e-5
T = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_rel(got, want, rtol, what="", floor=1e-12):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / scale
    assert err <= rtol, f"{what}: {err} > {rtol}"


def flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def kw(**over):
    out = dict(vocab_size=68, block_size=T, n_layer=2, n_head=4, n_embd=64, dropout=0.0,
               label_smoothing=0.05, sep_id=3)
    out.update(over)
    return out


def adapted_tree(cfg_kw, rank=4, alpha=None, targets="attn", seed=0):
    """A JAX tree with adapters whose ``lora_b`` is moved off zero."""
    params = jax_gpt.init(jax.random.PRNGKey(seed), JaxConfig(**cfg_kw))
    tree = jlora.add_lora_adapters(params, jax.random.PRNGKey(seed + 1), rank=rank,
                                   alpha=alpha, targets=targets)
    tree = jax.tree.map(np.asarray, tree)
    rng = np.random.default_rng(seed)
    for path, leaf in flat(tree).items():
        if path.endswith("lora_b"):
            node = tree
            for key in path.split("/")[:-1]:
                node = node[key]
            node["lora_b"] = (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
    return tree


LORA_CASES = {
    "separate_attn": ({}, dict()),
    "fused_attn": ({"fused_qkv": True}, dict()),
    "separate_gelu_attn_mlp_alpha2": ({}, dict(targets="attn+mlp", alpha=2.0)),
    "fused_swiglu_attn_mlp_alpha16": ({"fused_qkv": True, "use_swiglu": True},
                                      dict(targets="attn+mlp", alpha=16.0)),
    "fused_gqa_rope_untied": ({"fused_qkv": True, "n_kv_head": 2, "use_rope": True,
                               "tie_embeddings": False}, dict()),
}


@pytest.mark.parametrize("case", list(LORA_CASES))
def test_lora_forward_and_weights_match_jax(case):
    over, lora_kw = LORA_CASES[case]
    tree = adapted_tree(kw(**over), **lora_kw)
    jcfg, tcfg = JaxConfig(**kw(**over)), CodonGPTConfig(**kw(**over))
    x = np.random.default_rng(3).integers(4, 68, (2, T))
    x[:, ::9] = 3
    want, _ = jax_gpt.forward(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(x))
    model = params_from_jax(tree, tcfg, "cpu")
    with torch.no_grad():
        got, _ = codon_gpt.forward(model, tcfg, torch.from_numpy(x))
    assert_rel(got.numpy(), np.asarray(want), LOGIT_RTOL, "adapted logits")
    back = flat(params_to_jax(model, tcfg))
    want_leaves = flat(tree)
    assert set(back) == set(want_leaves)
    for path, leaf in want_leaves.items():
        assert np.array_equal(back[path], leaf), path
    assert codon_gpt.param_count(model) == jax_gpt.param_count(tree)
    assert not any(p.requires_grad for n, p in model.named_parameters() if "lora_scale" in n)

    # an unmerged adapted model decodes as the merged one (cached decode reuses _qkv)
    merged = params_from_jax(lora.merge_lora(tree), tcfg, "cpu")
    prompt = torch.from_numpy(x[:, :8])
    a = generate_tokens(model, tcfg, prompt, 12, temperature=0.0, device="cpu")
    b = generate_tokens(merged, tcfg, prompt, 12, temperature=0.0, device="cpu")
    assert torch.equal(a, b)


def test_merge_and_adapter_state_match_jax():
    tree = adapted_tree(kw(fused_qkv=True), targets="attn+mlp", alpha=3.0)
    jtree = jax.tree.map(jnp.asarray, tree)
    got, want = flat(lora.merge_lora(tree)), flat(jlora.merge_lora(jtree))
    assert set(got) == set(want) and not lora.has_lora(lora.merge_lora(tree))
    for path in want:
        assert_rel(got[path], want[path], MERGE_RTOL, f"merged {path}")
    ad, jad = flat(lora.adapter_state(tree)), flat(jlora.adapter_state(jtree))
    assert set(ad) == set(jad)
    for path in jad:
        assert np.array_equal(ad[path], jad[path]), path
    base = jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(0), JaxConfig(**kw(
        fused_qkv=True))))
    grafted = flat(lora.apply_adapter_state(base, lora.adapter_state(tree)))
    jgrafted = flat(jlora.apply_adapter_state(jax.tree.map(jnp.asarray, base),
                                              jlora.adapter_state(jtree)))
    assert set(grafted) == set(jgrafted) == set(flat(tree))
    for path in jgrafted:
        assert_rel(grafted[path], jgrafted[path], MERGE_RTOL, f"grafted {path}")
    assert lora.has_lora(tree) == jlora.has_lora(jtree) is True
    assert lora.lora_param_count(tree) == jlora.lora_param_count(jtree)
    with pytest.raises(ValueError, match="no LoRA"):
        lora.adapter_state(base)
    bad = lora.adapter_state(tree)
    bad["blocks"]["attn"]["query"]["lora_a"] = np.zeros((2, 3, 4), np.float32)
    with pytest.raises(ValueError, match="does not match"):
        lora.apply_adapter_state(base, bad)


def test_lora_refusals_match_jax():
    params = jax_gpt.init(jax.random.PRNGKey(0), JaxConfig(**kw()))
    quant = jax.tree.map(np.asarray, quantize_params(params))
    with pytest.raises(ValueError, match="int8"):
        lora.add_lora_adapters(quant, np.random.default_rng(0), rank=2)
    with pytest.raises(ValueError, match="int8"):
        jlora.add_lora_adapters(jax.tree.map(jnp.asarray, quant), jax.random.PRNGKey(0),
                                rank=2)
    moe = jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(0),
                                                JaxConfig(**kw(moe_experts=2))))
    for fn, arg in ((lora.add_lora_adapters, np.random.default_rng(0)),
                    (jlora.add_lora_adapters, jax.random.PRNGKey(0))):
        with pytest.raises(ValueError, match="MoE"):
            fn(moe, arg, rank=2, targets="attn+mlp")
    moe_attn = lora.add_lora_adapters(moe, np.random.default_rng(0), rank=2)
    assert "lora_a" in moe_attn["blocks"]["attn"]["query"]
    with pytest.raises(ValueError):
        lora.add_lora_adapters(jax.tree.map(np.asarray, params), np.random.default_rng(0),
                               rank=0)


# --- optimizer labels and updates ----------------------------------------------


LABEL_FLAGS = ("freeze_backbone", "unfreeze_encoder", "lora_only")


@pytest.mark.parametrize("fused", [False, True])
def test_param_group_labels_match_jax_leaf_for_leaf(fused):
    over = dict(fused_qkv=fused, termination_aux=True, multi_offset_targets=(2,),
                use_shape_guidance=True)
    tree = adapted_tree(kw(**over))
    tree["shape_encoder"] = jax.tree.map(np.asarray, jbio.init_encoder(jax.random.PRNGKey(2)))
    tcfg = CodonGPTConfig(**kw(**over))
    model = params_from_jax(tree, tcfg, "cpu")
    for bits in itertools.product([False, True], repeat=3):
        flags = dict(zip(LABEL_FLAGS, bits))
        want = flat(jax_optim.param_group_labels(tree, **flags))
        names = {id(p): n for n, p in model.named_parameters()}
        got = optim.param_group_labels(model, **flags)
        leaves = jax_leaves(model, tcfg)
        assert {leaf.path for leaf in leaves} == set(want)
        for leaf in leaves:
            for p, _, _ in leaf.parts:
                assert got[names[id(p)]] == str(want[leaf.path]), (flags, leaf.path)


def fake_grads(model, seed, frozen=()):
    """Random gradients, the same for both packages: (port .grad set, JAX tree)."""
    rng = np.random.default_rng(seed)
    for p in model.parameters():
        p.grad = torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
    tcfg = model.cfg
    grads = {}
    for leaf in jax_leaves(model, tcfg):
        g = leaf.gather(lambda p: p.grad).numpy().copy()
        grads[leaf.path] = np.zeros_like(g) if leaf.path in frozen else g
    for leaf in jax_leaves(model, tcfg):  # frozen leaves count 0 in the clip, as in JAX
        if leaf.path in frozen:
            leaf.write(lambda p: p.grad, torch.zeros_like(leaf.gather(lambda p: p.grad)))
    return grads


def unflatten(flat_map: dict) -> dict:
    tree: dict = {}
    for path, v in flat_map.items():
        node = tree
        *parents, name = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = jnp.asarray(v)
    return tree


OPT_CASES = {
    # name: (model overrides, run config, lora)
    "adamw_clip_active": ({}, {"grad_clip": 1.0}, False),
    "adamw_clip_inactive": ({}, {"grad_clip": 1e6}, False),
    "adafactor_fused_d128": ({"n_embd": 128, "fused_qkv": True, "termination_aux": True},
                             {"optimizer": "adafactor"}, False),
    "adafactor_clip_lora": ({"n_embd": 128, "fused_qkv": True},
                            {"optimizer": "adafactor", "grad_clip": 0.5, "lora_rank": 4}, True),
    "adamw_lora_only": ({"fused_qkv": True, "termination_aux": True},
                        {"lora_rank": 4, "lora_lr": 3e-3}, True),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_tracks_optax_on_the_same_gradients(case):
    over, extra, with_lora = OPT_CASES[case]
    run_cfg = dict({"lr": 1e-3, "lr_embedding": 2e-3, "min_lr": 1e-4,
                    "weight_decay": 0.05, "warmup_steps": 1, "scheduler": "cosine"}, **extra)
    tree = (adapted_tree(kw(**over)) if with_lora else
            jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(0),
                                                  JaxConfig(**kw(**over)))))
    tcfg = CodonGPTConfig(**kw(**over))
    model = params_from_jax(tree, tcfg, "cpu")
    bundle = optim.build_optimizer(run_cfg, model, total_steps=10)
    jtree = jax.tree.map(jnp.asarray, tree)
    jbundle = jax_optim.build_optimizer(run_cfg, jtree, total_steps=10)
    frozen = {p for p, lbl in flat(jbundle.labels).items() if str(lbl) == "frozen"}
    state = jbundle.tx.init(jtree)
    if extra.get("optimizer") == "adafactor":
        factored = [leaf for leaf in jax_leaves(model, tcfg)
                    if optim._factored_dims(tuple(leaf.gather().shape))]
        assert factored and len(factored) < len(jax_leaves(model, tcfg))
    for step, scale in enumerate((1.0, 0.5, 1.0)):
        grads = fake_grads(model, seed=step, frozen=frozen)
        updates, state = jbundle.tx.update(unflatten(grads), state, jtree)
        jtree = optax.apply_updates(jtree, jax.tree.map(lambda u: u * scale, updates))
        bundle.step(scale)
    assert bundle.applied_steps == 3
    got = flat(params_to_jax(model, tcfg))
    want = flat(jtree)
    for path, w in want.items():
        if path in frozen:
            assert np.array_equal(got[path], flat(tree)[path]), f"frozen {path} moved"
        else:
            assert_rel(got[path], w, OPT_RTOL, f"{case} {path}")
            assert not np.array_equal(got[path], flat(tree)[path]), f"{path} did not move"


def test_clip_is_optax_global_norm():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([[12.0]])]
    params = [torch.nn.Parameter(torch.zeros_like(x)) for x in g]
    for p, x in zip(params, g):
        p.grad = x.clone()
    optim.clip_by_global_norm(params, 6.5)  # norm 13
    assert torch.equal(params[0].grad, torch.tensor([3.0, 4.0]) / 13.0 * 6.5)
    optim.clip_by_global_norm(params, 100.0)
    assert torch.equal(params[1].grad, torch.tensor([[12.0]]) / 13.0 * 6.5)


# --- remat ----------------------------------------------------------------------


def group_batch(seed, G=2, B=2):
    rng = np.random.default_rng(seed)
    x = rng.integers(4, 68, (G, B, T))
    x[..., ::7] = 3
    y = np.roll(x, -1, axis=-1)
    y[..., -1] = 2
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


@pytest.mark.parametrize("fused", [False, True])
def test_remat_step_equals_the_plain_step_bit_for_bit(fused):
    over = dict(dropout=0.1, fused_qkv=fused, termination_aux=True)
    tree = adapted_tree(kw(**over))
    results = []
    for remat in (False, True):
        tcfg = CodonGPTConfig(**kw(**over, use_checkpoint=remat))
        model = params_from_jax(tree, tcfg, "cpu").train()
        bundle = optim.build_optimizer({"lr": 1e-3, "warmup_steps": 0, "lora_rank": 4},
                                       model, 10)
        gen = torch.Generator().manual_seed(5)
        step = make_train_step(tcfg, LossConfig())
        m = step(model, bundle, group_batch(1), gen, 1.0)
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        results.append((float(m["total_loss_sum"]), grads, params_to_jax(model, tcfg),
                        torch.rand(3, generator=gen)))
    (l0, g0, p0, r0), (l1, g1, p1, r1) = results
    assert l0 == l1 and torch.equal(r0, r1)  # the generator continues alike
    assert set(g0) == set(g1) and len(g0) > 0
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for path, leaf in flat(p0).items():
        assert np.array_equal(leaf, flat(p1)[path]), path


def test_remat_step_matches_jax_use_checkpoint():
    over = dict(fused_qkv=True, use_checkpoint=True)
    params = jax_gpt.init(jax.random.PRNGKey(4), JaxConfig(**kw(**over)))
    tx = optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    batch = group_batch(2)
    jstep = jax_step.make_train_step(JaxConfig(**kw(**over)), jax_step.LossConfig(), tx)
    _, jgrads, jm = jstep(params, tx.init(params),
                          {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                          jax.random.PRNGKey(0), jnp.float32(1.0))
    tcfg = CodonGPTConfig(**kw(**over))
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu").train()
    bundle = optim.build_optimizer({"lr": 0.0, "lr_embedding": 0.0, "warmup_steps": 0},
                                   model, 10)
    m = make_train_step(tcfg, LossConfig())(model, bundle, batch, None, 1.0)
    assert_rel(float(m["total_loss_sum"]), float(jm["total_loss_sum"]), STEP_RTOL, "loss")
    want = flat(jgrads)
    floor = 1e-3 * max(float(np.abs(g).max()) for g in want.values())
    for leaf in jax_leaves(model, tcfg):
        assert_rel(leaf.gather(lambda p: p.grad).numpy(), want[leaf.path], STEP_RTOL,
                   leaf.path, floor=floor)


# --- the contract and expansion ---------------------------------------------------


def contract_config(**changes):
    cfg = jcontracts.expected_primary_config("primary", "genome", 1337)
    cfg["seed"] = 1337
    cfg["primary_training_contract"] = {
        "schema": jcontracts.SCHEMA_NAME, "version": jcontracts.SCHEMA_VERSION,
        "release": jcontracts.RELEASE, "dataset_freeze_id": jcontracts.DATASET_FREEZE_ID,
        "role": "primary", "protocol": "genome",
        "dataset_id": jcontracts.DATASETS["genome"]["dataset_id"]}
    for key, value in changes.items():
        if value is None and key in ("drop_lr", "drop_header"):
            continue
        cfg[key] = value
    return cfg


CONTRACT_CASES = {
    "valid": {},
    "valid_free_keys": {"fused_qkv": True, "mesh_devices": 4},
    "drift": {"lr": 1e-3, "use_checkpoint": False},
    "undeclared": {"lora_rank": 8},
    "wrong_seed": {"seed": 7},
    "pilot_epochs": {"epochs": 3},
}


@pytest.mark.parametrize("case", list(CONTRACT_CASES))
def test_contract_validation_matches_jax(case):
    cfg = contract_config(**CONTRACT_CASES[case])
    if case == "pilot_epochs":
        cfg["primary_training_contract"]["role"] = "pilot"
    outcomes = []
    for fn in (contracts.validate_primary_training_config,
               jcontracts.validate_primary_training_config):
        try:
            outcomes.append(("ok", fn(copy.deepcopy(cfg))))
        except ValueError as exc:
            outcomes.append(("violation", getattr(exc, "violations", str(exc))))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("ok" if case.startswith("valid") else "violation")
    missing = copy.deepcopy(cfg)
    missing.pop("primary_training_contract")
    with pytest.raises(contracts.ContractViolation):
        contracts.validate_primary_training_config(missing)


def test_expand_params_copies_and_expands_as_jax():
    src_kw = kw(termination_aux=True)
    dst_kw = kw(termination_aux=True, n_layer=3, n_embd=96, n_head=4)
    src = jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(0), JaxConfig(**src_kw)))
    got, report = expansion.expand_params(src, CodonGPTConfig(**src_kw),
                                          CodonGPTConfig(**dst_kw), seed=3)
    want, jreport = jexpansion.expand_params(src, JaxConfig(**src_kw), JaxConfig(**dst_kw),
                                             seed=3)
    assert report == jreport
    fresh = flat(expansion.init_tree(CodonGPTConfig(**dst_kw), seed=3))
    g, w, s = flat(got), flat(want), flat(src)
    assert {p: v.shape for p, v in g.items()} == {p: np.asarray(v).shape for p, v in w.items()}
    for path, value in g.items():
        overlap = tuple(slice(0, min(a, b)) for a, b in zip(s[path].shape, value.shape))
        assert np.array_equal(value[overlap], np.asarray(w[path])[overlap]), path
        rest = np.ones(value.shape, bool)
        rest[overlap] = False
        assert np.array_equal(value[rest], fresh[path][rest]), path


def test_expansion_cli_round_trip(tmp_path):
    src_kw = kw()
    src = jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(0), JaxConfig(**src_kw)))
    tckpt.save_checkpoint({"model": src, "cfg": dict(src_kw)}, tmp_path / "src.npz")
    assert expansion.main(["--checkpoint", str(tmp_path / "src.npz"), "--out_checkpoint",
                           str(tmp_path / "dst.npz"), "--n_layer", "3", "--n_head", "4",
                           "--n_embd", "64"]) == 0
    out = jckpt.load_checkpoint(tmp_path / "dst.npz")
    assert out["cfg"]["n_layer"] == 3 and out["expansion_report"]["expanded"] > 0
    assert np.array_equal(out["model"]["blocks"]["ln1"]["scale"][:2],
                          src["blocks"]["ln1"]["scale"])


# --- the CLIs end to end ---------------------------------------------------------


def test_cli_pretrain_lora_resume_merge(tmp_path, capsys):
    from test_torch_trainer import make_fixture, small_cfg

    from genomics_lm_torch.training.merge_lora import main as merge_cli
    from genomics_lm_torch.training.train_codon_lm import main as train_cli

    make_fixture(tmp_path)
    runs = tmp_path / "runs"
    base_cfg = small_cfg(tmp_path, run_id="base", epochs=1, fused_qkv=True)
    (tmp_path / "base.yaml").write_text(yaml.safe_dump(base_cfg))
    assert train_cli(["--config", str(tmp_path / "base.yaml"), "--run_root", str(runs),
                      "--device", "cpu"]) == 0
    base_ckpt = runs / "base" / "checkpoints" / "last.npz"
    ft = small_cfg(tmp_path, run_id="ft", epochs=1, fused_qkv=True, dropout=0.1,
                   lora_rank=4, lora_alpha=8, lr=3e-3, scheduler_total_steps=8)
    (tmp_path / "ft.yaml").write_text(yaml.safe_dump(ft))
    argv = ["--config", str(tmp_path / "ft.yaml"), "--run_root", str(runs), "--device", "cpu",
            "--transfer_from", str(base_ckpt)]
    assert train_cli(argv) == 0
    assert "[lora] rank=4 targets=attn trainable=" in capsys.readouterr().out
    ft_ckpts = runs / "ft" / "checkpoints"
    ft_last = tckpt.load_checkpoint(ft_ckpts / "last.npz")
    base = flat(tckpt.load_checkpoint(base_ckpt)["model"])
    tuned = flat(ft_last["model"])
    for path, leaf in base.items():
        assert np.array_equal(tuned[path], leaf), f"frozen {path} moved"
    adapters = [p for p in tuned if "lora_" in p]
    assert adapters and any(not np.array_equal(tuned[p], 0) for p in adapters
                            if p.endswith("lora_b"))
    state_names = set(ft_last["optimizer"]["state"])
    assert state_names and all("lora_a" in n or "lora_b" in n for n in state_names)
    n_state = sum(np.size(s["exp_avg"]) for s in ft_last["optimizer"]["state"].values())
    assert n_state == lora.lora_param_count(ft_last["model"])

    # resume to epoch 2 equals a straight 2-epoch run
    ft["epochs"] = 2
    (tmp_path / "ft.yaml").write_text(yaml.safe_dump(ft))
    assert train_cli(argv + ["--resume", str(ft_ckpts / "last.npz")]) == 0
    straight = dict(ft, run_id="ft-straight")
    (tmp_path / "straight.yaml").write_text(yaml.safe_dump(straight))
    assert train_cli(["--config", str(tmp_path / "straight.yaml"), "--run_root", str(runs),
                      "--device", "cpu", "--transfer_from", str(base_ckpt)]) == 0
    a = tckpt.load_checkpoint(ft_ckpts / "last.npz")
    b = tckpt.load_checkpoint(runs / "ft-straight" / "checkpoints" / "last.npz")
    assert a["val_loss"] == b["val_loss"]
    for path, leaf in flat(b["model"]).items():
        assert np.array_equal(flat(a["model"])[path], leaf), path

    # merge; both packages read both checkpoints and agree
    merged_path = tmp_path / "merged.npz"
    assert merge_cli([str(ft_ckpts / "last.npz"), str(merged_path)]) == 0
    assert merge_cli([str(merged_path), str(tmp_path / "again.npz")]) == 2
    merged = tckpt.load_checkpoint(merged_path)
    assert "optimizer" not in merged and not lora.has_lora(merged["model"])
    assert not any(k.startswith("lora_") for k in merged["cfg"])
    tcfg = CodonGPTConfig.from_run_config(dict(a["cfg"]))
    jcfg = JaxConfig.from_run_config(dict(a["cfg"]))
    x = np.load(tmp_path / "val.npz")["X"][:4]
    with torch.no_grad():
        unmerged_logits, _ = codon_gpt.forward(params_from_jax(a["model"], tcfg, "cpu"),
                                               tcfg, torch.from_numpy(x).long())
        merged_logits, _ = codon_gpt.forward(params_from_jax(merged["model"], tcfg, "cpu"),
                                             tcfg, torch.from_numpy(x).long())
    assert_rel(merged_logits.numpy(), unmerged_logits.numpy(), LOGIT_RTOL, "merged vs unmerged")
    jread = jckpt.load_checkpoint(ft_ckpts / "last.npz")["model"]
    jlogits, _ = jax_gpt.forward(jax.tree.map(jnp.asarray, jread), jcfg, jnp.asarray(x))
    assert_rel(np.asarray(jlogits), unmerged_logits.numpy(), LOGIT_RTOL, "JAX reads the LoRA run")
    jmerged = jlora.merge_lora(jax.tree.map(jnp.asarray, jread))
    for path, leaf in flat(jmerged).items():
        assert_rel(flat(merged["model"])[path], leaf, MERGE_RTOL, f"merge {path}")


def test_lora_efficiency_protocol_small(tmp_path):
    from genomics_lm_torch.training import benchmark_lora

    args = benchmark_lora.parser().parse_args(
        ["--workdir", str(tmp_path), "--d512_batch", "2", "--d512_warmup", "1",
         "--d512_steps", "1", "--d512_rank", "4"])
    model = dict(benchmark_lora.D512_MODEL, n_layer=2, n_head=4, n_embd=64, block_size=64,
                 attention_impl="xla", compute_dtype="float32")
    r = benchmark_lora.run_d512_efficiency(args, "cpu", model)
    assert r["lora"]["trainable_params"] == r["adapter_params"] == 2 * 4 * (64 * 4 + 4 * 64)
    # AdamW: two moments and a step count per trainable tensor
    assert r["lora"]["opt_state_bytes"] == 8 * r["adapter_params"] + 4 * 2 * 4 * 2
    assert r["full_finetune"]["trainable_params"] > 10 * r["lora"]["trainable_params"]
    assert r["checkpoint_bytes"]["ratio"] < 0.2 and r["roundtrip_max_abs_err"] == 0.0


def test_contracts_module_is_the_jax_copy():
    """The contract's pinned values and engine are the JAX module's code."""
    import inspect

    want, got = inspect.getsource(jcontracts), inspect.getsource(contracts)
    assert got[got.index("from __future__"):] == want[want.index("from __future__"):]
