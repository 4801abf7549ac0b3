"""The train step as one captured program (`train/trainer.py::
compile_train_step`), on the CPU, where it runs the same body op by op.

  * The program keys the steps ask for, over steps that cross the EMA's
    start, its first copy and an LR epoch boundary, at accumulate 1 and 2:
    one (two when accumulating: the micro-step and the applying step), so
    neither an LR nor an EMA gate is in a key: both are device inputs.
    Beside them `compile_train_step` equals `make_train_step` bit for bit,
    which on the CPU holds by construction (both run `TrainStep._body` op
    by op); the capture itself (static inputs, the shared pool, the
    stateful warm-up, capturable AdamW) is held only on the card, by
    `chip_smoke.py` phase 6, replay against eager.
  * A train state holds its own programs: a new state on the same model,
    made after the first is gone (in CPython commonly at the freed state's
    address), captures its own and its step writes its own tensors. The
    card is stood in for by `DADD.captures` and a program that runs its
    first call's body and keeps nothing of it.
  * The step's body makes no host sync: under a TorchDispatchMode that
    raises on `aten._local_scalar_dense`, `aten.nonzero`, `aten.is_nonzero`
    and `aten.equal`. torch's AdamW on the CPU (`capturable` refused there)
    reads its step count and LR on the host; those reads, from `torch/optim`
    frames, are the only ones let through (the card's capturable AdamW makes
    none). A planted `float()` in the body is caught.
  * The EMA's select form (`ema_apply_`) against psd_tpu's `ema_update` at
    gate off, the first copy and a blend.
  * The noise schedule's tables on the model's device: no gather copies
    from the host.
"""

import contextlib
import gc
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from psd_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from psd_tpu.train.ema import ema_init as jax_ema_init
from psd_tpu.train.ema import ema_update as jax_ema_update
from psd_tpu_torch.diffusion import dadd as dadd_module
from psd_tpu_torch.diffusion.dadd import DADD
from psd_tpu_torch.diffusion.graphs import program_key
from psd_tpu_torch.diffusion.schedule import NoiseSchedule
from psd_tpu_torch.testing import tiny_dadd
from psd_tpu_torch.train import (compile_train_step, create_train_state, ema_apply_, ema_flags,
                                 ema_init, make_train_step)
from psd_tpu_torch.train import trainer
from tests.torch_cli_parity import few_threads
from tests.torch_parity import configure

STEPS_PER_EPOCH = 2  # the LR schedule's epoch, in optimizer steps
EMA_START, EMA_EVERY = 1, 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    with few_threads():
        yield


def _batch(i: int, B: int = 2):
    rng = np.random.default_rng(100 + i)
    return {"latents": torch.from_numpy(rng.standard_normal((B, 8, 8, 4)).astype(np.float32)),
            "labels": torch.tensor([0.0, 2.5, 1.0, 3.0][:B]),
            "clip_feats": torch.from_numpy(rng.standard_normal((B, 17, 32)).astype(np.float32))}


def _state(accumulate: int):
    model = tiny_dadd(for_training=True, seed=3)
    configure(model.cfg)
    model.cfg.training.accumulate_grad_batches = accumulate
    model.cfg.training.update_starting_at_step = EMA_START
    model.cfg.training.update_every_n_steps = EMA_EVERY
    model.cfg.scheduler.warmup_epochs = 2  # epochs 0 and 1 at different LRs
    return create_train_state(model, steps_per_epoch=STEPS_PER_EPOCH, seed=5)


@contextlib.contextmanager
def recorded_keys(keys: list):
    """`DADD._replay_or_run` recording each call's program key, then running
    the body as the CPU does."""
    run = DADD._replay_or_run

    def recording(self, kind, body, inputs, *, stateful=False, pool=None, programs=None,
                  **knobs):
        keys.append(program_key(kind, inputs, **knobs))
        return run(self, kind, body, inputs, stateful=stateful, pool=pool, programs=programs,
                   **knobs)

    DADD._replay_or_run = recording
    try:
        yield
    finally:
        DADD._replay_or_run = run


def _assert_equal_states(a, b):
    pa, pb = dict(a.model.core.named_parameters()), dict(b.model.core.named_parameters())
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
        assert torch.equal(a.ema.params[name], b.ema.params[name]), name
        sa, sb = a.opt_state.adamw.state.get(pa[name]), b.opt_state.adamw.state.get(pb[name])
        assert bool(sa) == bool(sb), name
        for k in ("step", "exp_avg", "exp_avg_sq") if sa else ():
            assert torch.equal(sa[k], sb[k]), (name, k)
    oa, ob = a.opt_state, b.opt_state
    assert (oa.count, oa.mini_step, a.step, a.ema.count) == (ob.count, ob.mini_step, b.step,
                                                             b.ema.count)
    assert (oa.acc is None) == (ob.acc is None)
    if oa.acc is not None:
        assert all(torch.equal(x, y) for x, y in zip(oa.acc, ob.acc))


@pytest.mark.parametrize("accumulate", [1, 2])
def test_compiled_step_equals_the_eager_step_across_lr_and_ema_gates(accumulate):
    """Five optimizer steps: the EMA skips step 0, copies at 1, skips 2,
    blends at 3; the LR changes at optimizer step 2 (epoch 1). Both steps
    bit for bit, every metric, parameter, moment, EMA tensor and count."""
    eager, tx_e = _state(accumulate)
    graph, tx_g = _state(accumulate)
    step_e, step_g = make_train_step(eager.model, tx_e), compile_train_step(graph.model, tx_g)
    keys, lrs, ema_counts = [], [], []
    with recorded_keys(keys):
        for i in range(5 * accumulate):
            batch = _batch(i)
            eager, m_e = step_e(eager, batch)
            graph, m_g = step_g(graph, batch)
            assert sorted(m_e) == sorted(m_g)
            for k in m_e:
                assert torch.equal(m_e[k], m_g[k]), (i, k)
            _assert_equal_states(eager, graph)
            lrs.append(float(graph.opt_state.adamw.param_groups[0]["lr"]))
            ema_counts.append(graph.ema.count)
    # the steps crossed the LR boundary and every EMA gate
    assert lrs[0] != lrs[-1]
    applied = ema_counts[accumulate - 1::accumulate]
    assert applied == [0, 1, 1, 2, 2], ema_counts
    # the keys: one program (two when accumulating) for every step
    assert len(keys) == 5 * accumulate and len(set(keys)) == accumulate
    assert keys[0][0] == "train_step"


def test_one_program_key_is_a_device_input_layout():
    """The key's inputs are the batch, the draws and the step's device
    scalars, all on the model's device; a second TrainState asks for the
    same key, which it looks up in its own programs (a program writes the
    state it was captured for), so the key holds nothing of the state."""
    state, tx = _state(1)
    step = compile_train_step(state.model, tx)
    keys = []
    with recorded_keys(keys):
        step(state, _batch(0))
        other, _ = create_train_state(state.model, tx=tx, seed=5)
        step(other, _batch(1))
    (kind, shapes, knobs, _), key2 = keys
    assert key2 == keys[0] and "state" not in dict(knobs)
    names = dict(knobs)["names"]
    assert names == (tuple(("batch", k) for k in ("clip_feats", "labels", "latents"))
                     + tuple(("draws", k) for k in sorted(
                         ("noise", "t", "drop_mask", "aoe_noise", "offset_noise",
                          "perturb_noise"))))
    assert len(shapes) == len(names) + 2
    # the EMA's (do, first) follow the batch's and the draws' tensors
    assert shapes[-2:] == (((), torch.bool), ((), torch.bool))


def test_a_new_state_on_the_model_captures_its_own_program(monkeypatch):
    """A state steps (a capture, then a replay), is dropped, and a new one
    is made on the same model: its first step captures a program of its
    own, which writes the new state's moments, EMA and counts, and the
    model keeps no train program. Under a key shared through the model and
    an address that the new state reuses, its step would replay the dropped
    state's program and leave its own tensors where they were."""
    captured = []

    class Program:
        """Runs its first call's step and keeps nothing of the body (as a
        graph keeps addresses, not the state): a replay counts itself and
        returns the first output, moving no tensor."""

        def __init__(self, body, inputs, stateful=False, pool=None):
            assert stateful and pool is not None
            captured.append(self)
            self.replays = 0
            self.first_output = body(*inputs)
            self.output = {k: v.clone() for k, v in self.first_output.items()}

        def __call__(self, *inputs):
            self.replays += 1
            return self.output

    monkeypatch.setattr(dadd_module, "CapturedProgram", Program)
    monkeypatch.setattr(DADD, "captures", lambda self: True)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    state, tx = _state(1)
    model = state.model
    step = compile_train_step(model, tx)
    for i in range(2):
        state, _ = step(state, _batch(i))
    (first,) = state.programs.values()
    assert first.replays == 1 and len(captured) == 1
    # the new state's parts first, so that little is allocated between the
    # old state's end and the new one
    parts = dict(step=0, model=model, opt_state=tx.init(model.core),
                 ema=ema_init(dict(model.core.named_parameters())),
                 generator=torch.Generator().manual_seed(5))
    ema0 = {k: v.clone() for k, v in parts["ema"].params.items()}
    freed = id(state)
    del state
    gc.collect()
    # new states until one sits at the freed state's address (CPython hands
    # its block out again within a few), the others dropped unstepped
    made = [trainer.TrainState(**parts)]
    while id(made[-1]) != freed and len(made) < 1000:
        made.append(trainer.TrainState(**parts))
    other = made.pop()
    del made
    other, metrics = step(other, _batch(2))
    assert len(captured) == 2 and first.replays == 1
    assert list(other.programs.values()) == [captured[1]] and model.programs == {}
    assert torch.isfinite(metrics["loss"])
    named = dict(model.core.named_parameters())
    moments = [other.opt_state.adamw.state.get(p) for p in named.values()]
    assert all(m and float(m["step"]) == 1 for m in moments)
    assert (other.step, other.opt_state.count) == (1, 1)
    # EMA_START = 1: the first step's EMA is skipped, the average unmoved
    assert all(torch.equal(ema0[k], other.ema.params[k]) for k in ema0)
    other, _ = step(other, _batch(3))
    assert captured[1].replays == 1 and len(captured) == 2 and other.step == 2


def _callers():
    """The file names of the calling frames, innermost first."""
    frame = sys._getframe(1)
    while frame is not None:
        yield frame.f_code.co_filename
        frame = frame.f_back


class NoHostSync(TorchDispatchMode):
    """Raises at an op that reads a tensor's value on the host, unless it
    runs inside torch's own optimizer code (`allowed_from`) or reads a
    tensor the body made from a host number (`torch.tensor(x)`, lifted:
    split3's gate rounding, a host tensor on either machine)."""

    OPS = ("aten._local_scalar_dense.default", "aten.nonzero.default",
           "aten.is_nonzero.default", "aten.equal.default")

    def __init__(self, allowed_from=()):
        super().__init__()
        self.allowed_from = allowed_from
        self.allowed = 0
        self.from_host = []  # the tensors made from host numbers

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in self.OPS and not any(a is t for a in args for t in self.from_host):
            if any(p in f for f in _callers() for p in self.allowed_from):
                self.allowed += 1
            else:
                raise AssertionError(f"host sync in the train step's body: {func}")
        out = func(*args, **(kwargs or {}))
        if str(func) == "aten.lift_fresh.default":
            self.from_host.append(out)
        return out


@contextlib.contextmanager
def body_under(mode):
    """Every TrainStep._body runs under `mode`."""
    body = trainer.TrainStep._body

    def watched(self, *a, **k):
        with mode:
            return body(self, *a, **k)

    trainer.TrainStep._body = watched
    try:
        yield
    finally:
        trainer.TrainStep._body = body


@pytest.mark.parametrize("accumulate", [1, 2])
def test_the_step_body_makes_no_host_sync(accumulate):
    state, tx = _state(accumulate)
    step = compile_train_step(state.model, tx)
    mode = NoHostSync(allowed_from=("torch/optim/",))
    with body_under(mode):
        for i in range(2 * accumulate):
            state, _ = step(state, _batch(i))
    assert state.opt_state.count == 2
    # the CPU's AdamW read its counts (capturable is refused on the CPU)
    assert mode.allowed > 0


def test_no_host_sync_sees_a_planted_read(monkeypatch):
    """The check itself: a `float()` of the gradient norm in the body."""
    state, tx = _state(1)
    step = compile_train_step(state.model, tx)
    norm = trainer.global_norm
    monkeypatch.setattr(trainer, "global_norm", lambda *a: torch.tensor(float(norm(*a))))
    with body_under(NoHostSync(allowed_from=("torch/optim/",))):
        with pytest.raises(AssertionError, match="host sync"):
            step(state, _batch(0))


@pytest.mark.parametrize("case", ["gate_off", "first_copy", "blend"])
def test_ema_select_form_matches_psd_tpu(case):
    """`ema_apply_` with device flags against psd_tpu's `ema_update` (start
    10, every 4) at a step the gate skips, the first update (the copy) and
    a later one (the blend)."""
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": (17,), "c": (2, 3, 4)}
    avg = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    new = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    step, count = {"gate_off": (11, 1), "first_copy": (10, 0), "blend": (14, 1)}[case]
    decay = 0.999
    jstate = jax_ema_init({k: jnp.asarray(v) for k, v in avg.items()})._replace(
        count=jnp.asarray(count, jnp.int32))
    want = jax_ema_update(jstate, {k: jnp.asarray(v) for k, v in new.items()},
                          jnp.asarray(step), decay=decay, start_step=10, every=4)
    state = ema_init({k: torch.from_numpy(v) for k, v in avg.items()})
    state.count = count
    do = step >= 10 and (step - 10) % 4 == 0
    ema_apply_(state, {k: torch.from_numpy(v) for k, v in new.items()},
               *ema_flags(state, do, "cpu"), decay=decay)
    for k in shapes:
        np.testing.assert_array_equal(state.params[k].numpy(), np.asarray(want.params[k]))
    assert int(want.count) == count + int(do)


def test_schedule_tables_live_on_the_models_device():
    """The model's schedule holds its tables on the model's device and
    gathers there; a `t` on another device raises instead of copying the
    table (which on the card would be a pageable copy each step). Its
    q_sample and min_snr_weight stay psd_tpu's."""
    model = tiny_dadd(for_training=True, seed=0)
    assert all(t.device == model.device for t in model.schedule.tables.values())
    meta = NoiseSchedule(device="meta")
    assert meta.tables["snr"].device.type == "meta"
    with pytest.raises(ValueError, match="tables on meta"):
        meta.q_sample(torch.zeros(2, 4), torch.zeros(2, dtype=torch.long), torch.zeros(2, 4))
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    noise = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    t = np.array([0, 500, 999])
    js = JaxSchedule()
    ref = np.asarray(js.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    out = model.schedule.q_sample(torch.from_numpy(x0), torch.from_numpy(t),
                                  torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(model.schedule.min_snr_weight(torch.from_numpy(t), 5.0).numpy(),
                               np.asarray(js.min_snr_weight(jnp.asarray(t), 5.0)), rtol=1e-6)
