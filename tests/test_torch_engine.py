"""The port's Task/Strategy/Callback engine against JAX's, on the CPU.

Every scenario of ``tests/test_engine.py`` runs through both engines with
twin fake tasks (a one-parameter linear task with injectable NaN batches, a
wall timer that expires on a given check, an event recorder): the
event streams, ``history``, the engine state and the saved checkpoint
payloads are equal, floats within 1e-6.

Then a codon-LM task (2 layers, ``n_embd`` 32, flash attention through its
plain version here and JAX's Pallas kernel in interpret mode, dropout 0,
SGD with ``grad_clip``) from the same carried weights, G 2, 2 epochs of 8
microbatches with one NaN microbatch, through both engines: ``history``
within 1e-5 and the final weights within 1e-5. In the port a wall-time
stop after the first group, a restore into a fresh task and engine, and a
resume equal the straight run bit for bit: the final weights, the last
epoch's record, and every group and validation event.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_lm_tpu.models import CodonGPTConfig as JaxConfig
from genomics_lm_tpu.models import codon_gpt as jax_gpt
from genomics_lm_tpu.training import engine as jax_engine
from genomics_lm_tpu.training.runtime import PeriodicCheckpointPolicy as JaxPolicy
from genomics_lm_tpu.training.runtime import WallTimer as JaxWallTimer
from genomics_lm_torch.models import codon_gpt
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.training import engine
from genomics_lm_torch.training.runtime import PeriodicCheckpointPolicy, WallTimer
from genomics_lm_torch.utils.weights import params_from_jax, params_to_jax

FLOAT_TOL = 1e-6
LM_RTOL = 1e-5
BOTH = {"jax": (jax_engine, JaxWallTimer, JaxPolicy),
        "port": (engine, WallTimer, PeriodicCheckpointPolicy)}


class LinearTask:
    """1-param linear model with injectable nonfinite batches; ``grads``
    are a float32 array of the engine's package."""

    def __init__(self, pkg, n_batches=8, nonfinite_at=None, lr=0.1):
        self.pkg = pkg
        self.array = jnp.asarray if pkg == "jax" else (
            lambda v: torch.tensor(v, dtype=torch.float32))
        self.step_output = BOTH[pkg][0].StepOutput
        self.metric = BOTH[pkg][0].MetricValue
        self.w = 2.0
        self.lr = lr
        self.n_batches = n_batches
        self.nonfinite_at = set(nonfinite_at or ())
        self.seen = []

    def train_batches(self, epoch):
        for i in range(self.n_batches):
            yield (epoch, i)

    def training_step(self, batch):
        _, i = batch
        self.seen.append(i)
        if i in self.nonfinite_at:
            return self.step_output(loss=float("nan"), grads=self.array([float("nan")]))
        return self.step_output(loss=(self.w - 1.0) ** 2,
                                grads=self.array([2.0 * (self.w - 1.0)]))

    def apply_updates(self, grads):
        self.w -= self.lr * float(grads[0])

    def val_batches(self):
        yield "a"
        yield "b"

    def validation_step(self, batch):
        return {"val_loss": self.metric((self.w - 1.0) ** 2, weight=1.0)}

    def state_dict(self):
        return {"w": self.w}

    def load_state_dict(self, state):
        self.w = float(state["w"])


class WeightedTask(LinearTask):
    def val_batches(self):
        yield 1.0
        yield 2.0

    def validation_step(self, batch):
        return {"val_loss": self.metric(batch, weight=batch)}


def expire_after(pkg, checks):
    """A wall timer of ``pkg`` that expires from its ``checks + 1``-th check
    on (the engine checks once a microbatch)."""
    class Expire(BOTH[pkg][1]):
        def __init__(self):
            super().__init__(None)
            self.calls = 0

        def expired(self):
            self.calls += 1
            return self.calls > checks

    return Expire()


class EventRecorder:
    def __init__(self):
        self.events = []

    def on_event(self, name, payload):
        self.events.append((name, payload))


def make_engine(pkg, task, **kw):
    mod = BOTH[pkg][0]
    strategy = mod.AccumulatedGradsStrategy(task.apply_updates,
                                            grad_clip=kw.pop("grad_clip", None))
    return mod.TrainingEngine(task, strategy, **kw)


def assert_close(got, want, tol=FLOAT_TOL, where="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, got, want)
        for k in want:
            assert_close(got[k], want[k], tol, f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, tol, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), (where, got)
        assert (np.isnan(got) and np.isnan(want)) or abs(got - want) <= tol * max(1.0, abs(want)), (
            where, got, want)
    else:
        assert got == want, (where, got, want)


def run_scenario(pkg, name):
    """One scenario of ``tests/test_engine.py`` on ``pkg``'s engine: what it
    observes (events, history, state, saves, the task's weight and its
    error), for the two engines to be compared."""
    out = {"saved": [], "error": None}
    recorder = EventRecorder()
    if name == "converges":
        task = LinearTask(pkg, n_batches=8)
        eng = make_engine(pkg, task, group_size=2, max_epochs=3, callbacks=[recorder],
                          save_fn=out["saved"].append)
    elif name == "nonfinite_skip":
        task = LinearTask(pkg, n_batches=6, nonfinite_at={2})
        eng = make_engine(pkg, task, group_size=3, max_epochs=1, callbacks=[recorder])
    elif name == "nonfinite_limit":
        task = LinearTask(pkg, n_batches=4, nonfinite_at={0})
        eng = make_engine(pkg, task, group_size=2, max_epochs=1, max_aborted_groups=0,
                          callbacks=[recorder], save_fn=out["saved"].append)
    elif name == "wall_time":
        task = LinearTask(pkg, n_batches=10)
        eng = make_engine(pkg, task, group_size=2, max_epochs=5,
                          wall_timer=expire_after(pkg, 2),
                          callbacks=[recorder], save_fn=out["saved"].append)
    elif name == "mid_epoch_resume":
        task = LinearTask(pkg, n_batches=6)
        eng = make_engine(pkg, task, group_size=2, max_epochs=1, callbacks=[recorder])
        eng.state.microbatch = 4
    elif name == "weighted_validation":
        task = WeightedTask(pkg, n_batches=2)
        eng = make_engine(pkg, task, group_size=1, max_epochs=1, callbacks=[recorder])
    elif name == "grad_clip":
        task = LinearTask(pkg, n_batches=1, lr=1.0)
        eng = make_engine(pkg, task, group_size=1, max_epochs=1, grad_clip=0.5,
                          callbacks=[recorder])
    elif name == "periodic":
        task = LinearTask(pkg, n_batches=5)
        eng = make_engine(pkg, task, group_size=2, max_epochs=2, callbacks=[recorder],
                          checkpoint_policy=BOTH[pkg][2](every_steps=2),
                          save_fn=out["saved"].append)
    else:
        raise KeyError(name)
    try:
        eng.fit()
    except BOTH[pkg][0].NonFiniteStepError as exc:
        out["error"] = type(exc).__name__
    out.update(events=recorder.events, history=eng.history, state=eng.state.to_dict(),
               w=task.w, seen=task.seen, aborted=eng.aborted_groups,
               committed=eng.strategy.state_dict())
    return out


SCENARIOS = ["converges", "nonfinite_skip", "nonfinite_limit", "wall_time",
             "mid_epoch_resume", "weighted_validation", "grad_clip", "periodic"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_jax(name):
    want = run_scenario("jax", name)
    got = run_scenario("port", name)
    assert_close(got, want)
    # the scenario's own expectations (tests/test_engine.py)
    if name == "converges":
        assert len(got["history"]) == 3 and got["state"]["optimizer_step"] == 12
        assert abs(got["w"] - 1.0) < 1.0
    elif name == "nonfinite_skip":
        aborted = [p for n, p in got["events"] if n == "group_aborted"]
        assert len(aborted) == 1 and aborted[0]["discarded"] == 2
        assert got["state"]["optimizer_step"] == 1
    elif name == "nonfinite_limit":
        assert got["error"] == "NonFiniteStepError"
        assert got["saved"][-1]["metadata"]["reason"] == "nonfinite_group_limit"
    elif name == "wall_time":
        assert got["saved"][-1]["metadata"]["reason"] == "wall_time"
        assert got["saved"][-1]["contract_version"] == 1
    elif name == "mid_epoch_resume":
        assert got["seen"] == [4, 5]
    elif name == "weighted_validation":
        assert got["history"][0]["val_loss"] == pytest.approx(5 / 3)
    elif name == "grad_clip":
        assert got["w"] == pytest.approx(1.5)
    elif name == "periodic":
        assert [s["metadata"]["reason"] for s in got["saved"]].count("periodic") == 2


def test_protocols_runtime_checkable():
    task = LinearTask("port")
    assert isinstance(task, engine.TrainingTask)
    assert isinstance(EventRecorder(), engine.TrainingCallback)
    assert isinstance(engine.AccumulatedGradsStrategy(task.apply_updates),
                      engine.UpdateStrategy)


def test_checkpoint_roundtrip_and_resume_match_jax():
    out = {}
    for pkg in BOTH:
        saved = []
        task = LinearTask(pkg, n_batches=4)
        make_engine(pkg, task, group_size=2, max_epochs=2, save_fn=saved.append).fit()
        task2 = LinearTask(pkg, n_batches=4)
        eng2 = make_engine(pkg, task2, group_size=2, max_epochs=4)
        eng2.restore(saved[-1])
        restored = (eng2.state.to_dict(), task2.w)
        eng2.fit()
        out[pkg] = (saved, restored, eng2.history, eng2.state.to_dict(), task2.w)
    assert_close(out["port"], out["jax"])
    assert out["port"][1][0]["completed_epochs"] == 2 and out["port"][3]["completed_epochs"] == 4


def test_contract_version_check():
    for mod in (jax_engine, engine):
        with pytest.raises(ValueError, match="contract version"):
            mod.TrainingCheckpoint.from_payload({"contract_version": 99, "engine": {}})


# --- a codon-LM task through both engines -----------------------------------------

LM_MODEL = dict(vocab_size=68, block_size=32, n_layer=2, n_head=2, n_embd=32, dropout=0.0,
                sep_id=3, attention_impl="flash")
LM_B, LM_MICRO, LM_G, LM_EPOCHS, LM_LR, LM_CLIP = 4, 8, 2, 2, 0.5, 1.0
LM_NAN = (1, 5)  # (epoch, microbatch index) whose loss is made NaN


def lm_windows(epoch: int, n: int, seed: int = 0):
    rng = np.random.default_rng(seed * 1000 + epoch)
    succ = np.random.default_rng(99).integers(4, 68, (68, 3))
    x = np.zeros((n, LM_B, 32), np.int64)
    x[..., 0] = rng.integers(4, 68, (n, LM_B))
    for t in range(1, 32):
        x[..., t] = succ[x[..., t - 1], rng.integers(0, 3, (n, LM_B))]
    x[..., ::11] = 3
    y = np.roll(x, -1, axis=-1)
    y[..., -1] = 0
    return x, y


class JaxLMTask:
    def __init__(self, params, cfg):
        self.params, self.cfg = params, cfg

        def loss_fn(p, x, y):
            return jax_gpt.forward(p, cfg, x, y)[1]

        self.grad = jax.jit(jax.value_and_grad(loss_fn))
        self.loss = jax.jit(loss_fn)

    def train_batches(self, epoch):
        x, y = lm_windows(epoch, LM_MICRO)
        for i in range(LM_MICRO):
            yield epoch, i, jnp.asarray(x[i]), jnp.asarray(y[i])

    def training_step(self, batch):
        epoch, i, x, y = batch
        loss, grads = self.grad(self.params, x, y)
        loss = float(loss)
        if (epoch, i) == LM_NAN:
            loss = float("nan")
        return jax_engine.StepOutput(loss=loss, grads=grads)

    def apply_updates(self, grads):
        self.params = jax.tree.map(lambda p, g: p - LM_LR * g, self.params, grads)

    def val_batches(self):
        x, y = lm_windows(0, 2, seed=7)
        for i in range(2):
            yield jnp.asarray(x[i]), jnp.asarray(y[i])

    def validation_step(self, batch):
        x, y = batch
        return {"val_loss": jax_engine.MetricValue(float(self.loss(self.params, x, y)),
                                                   weight=float((y != 0).sum()))}

    def state_dict(self):
        return jax.tree.map(np.asarray, self.params)

    def load_state_dict(self, state):
        self.params = jax.tree.map(jnp.asarray, state)


class PortLMTask:
    """The port's twin: ``torch.autograd.grad`` returns the gradients, the
    strategy owns their sums, and ``apply_updates`` writes the SGD step."""

    def __init__(self, tree, cfg):
        self.cfg = cfg
        self.model = params_from_jax(tree, cfg, "cpu").train()
        self.params = dict(self.model.named_parameters())

    def train_batches(self, epoch):
        x, y = lm_windows(epoch, LM_MICRO)
        for i in range(LM_MICRO):
            yield epoch, i, torch.from_numpy(x[i]), torch.from_numpy(y[i])

    def training_step(self, batch):
        epoch, i, x, y = batch
        _, loss = codon_gpt.forward(self.model, self.cfg, x, y, train=True)
        grads = torch.autograd.grad(loss, list(self.params.values()))
        value = float(loss.detach())
        if (epoch, i) == LM_NAN:
            value = float("nan")
        return engine.StepOutput(loss=value, grads=dict(zip(self.params, grads)))

    @torch.no_grad()
    def apply_updates(self, grads):
        for name, p in self.params.items():
            p.sub_(LM_LR * grads[name])

    def val_batches(self):
        x, y = lm_windows(0, 2, seed=7)
        for i in range(2):
            yield torch.from_numpy(x[i]), torch.from_numpy(y[i])

    @torch.no_grad()
    def validation_step(self, batch):
        x, y = batch
        _, loss = codon_gpt.forward(self.model, self.cfg, x, y)
        return {"val_loss": engine.MetricValue(float(loss), weight=float((y != 0).sum()))}

    def state_dict(self):
        return {name: p.detach().clone() for name, p in self.params.items()}

    @torch.no_grad()
    def load_state_dict(self, state):
        for name, p in self.params.items():
            p.copy_(state[name])


def lm_engine(pkg, task, recorder, **kw):
    mod = BOTH[pkg][0]
    strategy = mod.AccumulatedGradsStrategy(task.apply_updates, grad_clip=LM_CLIP)
    return mod.TrainingEngine(task, strategy, group_size=LM_G, max_epochs=LM_EPOCHS,
                              callbacks=[recorder], **kw)


@pytest.fixture(scope="module")
def lm_runs():
    jcfg = JaxConfig(**LM_MODEL)
    params = jax_gpt.init(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree.map(np.asarray, params)
    tcfg = CodonGPTConfig(**LM_MODEL)
    out = {}
    jtask = JaxLMTask(params, jcfg)
    rec = EventRecorder()
    eng = lm_engine("jax", jtask, rec)
    out["jax"] = (eng.fit(), rec.events, jax.tree.map(np.asarray, jtask.params))
    ptask = PortLMTask(tree, tcfg)
    rec = EventRecorder()
    eng = lm_engine("port", ptask, rec)
    out["port"] = (eng.fit(), rec.events, params_to_jax(ptask.model, tcfg))
    # wall-time stop after the first group, restore, resume
    saved, rec1 = [], EventRecorder()
    first = PortLMTask(tree, tcfg)
    lm_engine("port", first, rec1, save_fn=saved.append,
              wall_timer=expire_after("port", LM_G - 1)).fit()  # as group 1 commits
    second = PortLMTask(tree, tcfg)
    rec2 = EventRecorder()
    eng2 = lm_engine("port", second, rec2)
    eng2.restore(saved[-1])
    out["resumed"] = (eng2.fit(), rec1.events + rec2.events, second, saved[-1])
    out["straight"] = ptask
    return out


def flat(tree, prefix=""):
    res = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        res.update(flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return res


def test_codon_lm_task_matches_jax(lm_runs):
    jhist, jevents, jparams = lm_runs["jax"]
    phist, pevents, pparams = lm_runs["port"]
    assert [n for n, _ in pevents] == [n for n, _ in jevents]
    aborted = [p for n, p in pevents if n == "group_aborted"]
    assert aborted == [p for n, p in jevents if n == "group_aborted"] == [
        {"epoch": 1, "microbatch": 6, "discarded": 1}]
    assert_close(phist, jhist, LM_RTOL)
    assert phist[-1]["val_loss"] < phist[0]["val_loss"]
    for path, w in flat(jparams).items():
        g = flat(pparams)[path]
        err = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-12)
        assert err <= LM_RTOL, (path, err)


def test_codon_lm_wall_time_resume_is_bit_exact(lm_runs):
    hist, events, task, payload = lm_runs["resumed"]
    straight = lm_runs["straight"]
    phist, pevents, _ = lm_runs["port"]
    assert payload["metadata"]["reason"] == "wall_time"
    assert payload["engine"]["microbatch"] == LM_G and payload["engine"]["optimizer_step"] == 1
    for name, p in straight.params.items():
        assert torch.equal(task.params[name], p), name
    assert hist[-1] == phist[-1]
    keep = ("group_committed", "group_aborted", "validation_completed")
    assert [e for e in events if e[0] in keep] == [e for e in pevents if e[0] in keep]
