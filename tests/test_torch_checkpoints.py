"""Checkpoints of the port against the JAX package (``training/checkpoints.py``).

Exact, on the CPU: a checkpoint the JAX package writes (float32 and
bfloat16 leaves, int arrays, tuples, lists, nested dicts, scalars) loads in
the port with bit-identical arrays (bfloat16 as a ``torch.bfloat16`` tensor
with the same bits), and one the port writes (numpy arrays and torch
tensors, bfloat16 included) loads in the JAX package the same way;
``params_to_jax(params_from_jax(tree))`` gives back the JAX tree exactly
for every model layout the loader maps; ``transfer_load_params`` gives
JAX's report and rows on a shuffled vocabulary; the trainer's RNG snapshot
restores a generator's stream.
"""

from __future__ import annotations

import copy
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.training import checkpoints as jckpt
from genomics_lm_torch.models.codon_gpt import param_count
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.training import checkpoints as tckpt
from genomics_lm_torch.training.lifecycle import capture_rng_state, restore_rng_state
from genomics_lm_torch.utils.weights import params_from_jax, params_to_jax


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one thread: these small models gain nothing
    from more, and with several test processes on the machine torch's
    spinning worker threads slow every process many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _payload(rng, make_bf16):
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf_src = rng.standard_normal((4, 2)).astype(np.float32)
    return {
        "model": {"w": f32, "nested": {"b16": make_bf16(bf_src),
                                       "ints": np.arange(6, dtype=np.int32).reshape(2, 3)}},
        "pair": (np.float32(0.5) * f32[0], {"k": 3}),
        "items": [1, "two", None, 2.5],
        "flags": {"done": True, "step": 7},
    }, f32, bf_src


def _bits(x) -> np.ndarray:
    """uint16 bits of a bfloat16 leaf (a jax/ml_dtypes array or a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    payload, f32, bf_src = _payload(np.random.default_rng(0),
                                    lambda a: jnp.asarray(a, jnp.bfloat16))
    path = tmp_path / "jax.npz"
    jckpt.save_checkpoint(payload, path)
    got = tckpt.load_checkpoint(path)
    assert np.array_equal(got["model"]["w"], f32) and got["model"]["w"].dtype == np.float32
    b16 = got["model"]["nested"]["b16"]
    assert isinstance(b16, torch.Tensor) and b16.dtype == torch.bfloat16
    assert np.array_equal(_bits(b16), _bits(payload["model"]["nested"]["b16"]))
    assert np.array_equal(got["model"]["nested"]["ints"], np.arange(6).reshape(2, 3))
    assert isinstance(got["pair"], tuple) and got["pair"][1] == {"k": 3}
    assert np.array_equal(got["pair"][0], payload["pair"][0])
    assert got["items"] == [1, "two", None, 2.5] and got["flags"] == {"done": True, "step": 7}
    assert tckpt.load_checkpoint_meta(path) == jckpt.load_checkpoint_meta(path)
    assert np.array_equal(tckpt.checkpoint_array(path, "model/w"), f32)


def test_port_checkpoint_loads_in_jax(tmp_path):
    rng = np.random.default_rng(1)
    payload, f32, bf_src = _payload(rng, lambda a: torch.from_numpy(a).bfloat16())
    payload["tensor"] = torch.from_numpy(f32).requires_grad_()  # a live parameter
    path = tmp_path / "port.npz"
    tckpt.save_checkpoint(payload, path)
    got = jckpt.load_checkpoint(path)
    assert np.array_equal(got["model"]["w"], f32) and np.array_equal(got["tensor"], f32)
    assert got["model"]["nested"]["b16"].dtype == jnp.bfloat16
    assert np.array_equal(_bits(got["model"]["nested"]["b16"]),
                          _bits(payload["model"]["nested"]["b16"]))
    assert isinstance(got["pair"], tuple) and got["items"] == [1, "two", None, 2.5]
    # and back through the port, bit for bit
    again = tckpt.load_checkpoint(path)
    assert torch.equal(again["model"]["nested"]["b16"].view(torch.int16),
                       payload["model"]["nested"]["b16"].view(torch.int16))


def test_a_linked_checkpoint_keeps_its_bytes_when_the_source_is_saved_again(tmp_path):
    """The trainer links best.npz (and best_epoch, epoch_N) to the epoch's
    last.npz: a later save of last.npz must leave them as they were, and
    relinking must replace them, as a JAX reader sees them."""
    last, best = tmp_path / "last.npz", tmp_path / "best.npz"
    tckpt.save_checkpoint({"step": 1, "w": np.arange(4.0)}, last)
    tckpt.link_checkpoint(last, best)
    assert best.read_bytes() == last.read_bytes()
    tckpt.save_checkpoint({"step": 2, "w": np.arange(4.0) + 1}, last)
    assert tckpt.load_checkpoint(best)["step"] == 1
    assert jckpt.load_checkpoint(best)["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    tckpt.link_checkpoint(last, best)
    assert tckpt.load_checkpoint(best)["step"] == 2
    assert sorted(f.name for f in tmp_path.iterdir()) == ["best.npz", "last.npz"]


def test_async_checkpointer_orders_writes_and_surfaces_errors(tmp_path):
    path = tmp_path / "a.npz"
    t = torch.zeros(4)
    with tckpt.AsyncCheckpointer() as ck:
        for i in range(5):
            t += 1  # the copy happens at save: later changes do not leak in
            ck.save({"v": t, "i": i}, path)
    got = tckpt.load_checkpoint(path)
    assert got["i"] == 4 and np.array_equal(got["v"], np.full(4, 5.0, np.float32))
    ck = tckpt.AsyncCheckpointer()
    ck.save({"bad": object()}, tmp_path / "b.npz")
    with pytest.raises(TypeError):
        ck.wait()
    ck.close()


def _adamw_state():
    """A live AdamW state after one step, and a function that takes the
    next step: it changes the moments and the CPU ``step`` tensors in place."""
    torch.manual_seed(0)
    layer = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(layer.parameters(), lr=1e-2)

    def step():
        layer(torch.ones(1, 3)).sum().backward()
        opt.step()

    step()
    return {str(i): dict(s) for i, s in enumerate(opt.state.values())}, step


def _host_leaf(kind):
    """(leaf, in-place change) for a leaf kind that lies on the host."""
    if kind == "numpy":
        x = np.arange(6, dtype=np.float32)
        return x, lambda: x.__iadd__(1)
    if kind == "adamw":
        return _adamw_state()
    x = torch.arange(6, dtype=torch.float32).to(getattr(torch, kind))
    return x, lambda: x.add_(1)


@pytest.mark.parametrize("kind", ["numpy", "float32", "bfloat16", "adamw"])
def test_async_checkpointer_writes_the_values_at_save(tmp_path, monkeypatch, kind):
    """A leaf changed in place after ``save`` returns, while the write is
    still queued, reaches the file as it was at ``save``: the checkpointer
    copies host leaves too, not only the card's."""
    gate = threading.Event()
    write = tckpt.save_checkpoint

    def held_write(payload, path):
        assert gate.wait(30)
        write(payload, path)

    monkeypatch.setattr(tckpt, "save_checkpoint", held_write)
    leaf, change = _host_leaf(kind)
    path = tmp_path / "c.npz"
    want = copy.deepcopy(leaf)
    with tckpt.AsyncCheckpointer() as ck:
        ck.save({"x": leaf}, path)
        change()
        gate.set()
    got = tckpt.load_checkpoint(path)["x"]

    def same(a, b):
        return all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                   for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))

    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert not same(leaf, want)  # the change reached the live leaf ...
    assert same(got, want)       # ... and not the file


LAYOUTS = {
    "tied_qkv": {},
    "fused_qkv": {"fused_qkv": True},
    "fused_gqa_rope": {"fused_qkv": True, "n_kv_head": 2, "use_rope": True},
    "swiglu_untied": {"use_swiglu": True, "tie_embeddings": False},
    "aux_heads": {"termination_aux": True, "multi_offset_targets": (2, 3),
                  "use_shape_guidance": True},
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_params_to_jax_inverts_params_from_jax(layout):
    kw = dict(vocab_size=68, block_size=16, n_layer=2, n_head=4, n_embd=32)
    kw.update(LAYOUTS[layout])
    tree = jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(3), JaxConfig(**kw)))
    cfg = CodonGPTConfig(**kw)
    model = params_from_jax(tree, cfg, "cpu")
    back = params_to_jax(model, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and a.shape == b.shape and np.array_equal(a, b)
    assert param_count(model) == jax_gpt.param_count(tree)


def test_transfer_load_params_matches_jax_on_a_shuffled_vocabulary():
    kw = dict(vocab_size=68, block_size=16, n_layer=1, n_head=2, n_embd=16,
              tie_embeddings=False)
    source = jax.tree.map(np.asarray, jax_gpt.init(jax.random.PRNGKey(0), JaxConfig(**kw)))
    target_cfg = dict(kw, vocab_size=70, n_layer=2)  # extra layer: blocks skipped
    target = jax.tree.map(np.asarray,
                          jax_gpt.init(jax.random.PRNGKey(1), JaxConfig(**target_cfg)))
    source["stray"] = np.ones(3, np.float32)  # source-only leaf
    src_itos = [f"t{i}" for i in range(68)]
    rng = np.random.default_rng(2)
    tgt_itos = list(rng.permutation(src_itos[:66])) + ["new0", "new1", "new2", "new3"]
    kwargs = dict(source_itos=src_itos, target_itos=tgt_itos, vocab_axis_size=70)
    jparams, jreport = jckpt.transfer_load_params(target, source, **kwargs)
    tparams, treport = tckpt.transfer_load_params(target, source, **kwargs)
    assert treport == jreport
    assert "tok_emb" in treport["adapted"] and treport["missing"] == []
    assert any(s.endswith("stray") for s in treport["skipped"])
    for a, b in zip(jax.tree.leaves(tparams), jax.tree.leaves(jparams)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    row = tgt_itos.index("t5")
    assert np.array_equal(tparams["tok_emb"][row], source["tok_emb"][5])


@pytest.mark.parametrize("with_generator", [False, True])
def test_rng_snapshot_restores_the_streams(with_generator):
    gen = torch.Generator().manual_seed(11) if with_generator else None
    random.seed(1)
    np.random.seed(2)
    torch.manual_seed(3)
    snap = capture_rng_state(gen)
    want = (random.random(), np.random.rand(), torch.rand(2),
            torch.rand(3, generator=gen) if gen is not None else None)
    random.seed(9)
    np.random.seed(9)
    torch.manual_seed(9)
    fresh = torch.Generator().manual_seed(99) if with_generator else None
    assert restore_rng_state(snap, fresh) is with_generator
    got = (random.random(), np.random.rand(), torch.rand(2),
           torch.rand(3, generator=fresh) if fresh is not None else None)
    assert got[0] == want[0] and got[1] == want[1] and torch.equal(got[2], want[2])
    if with_generator:
        assert torch.equal(got[3], want[3])
