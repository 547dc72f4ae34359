"""The compiled step (``parallel.train.compile_step``) on the CPU.

On the CPU a ``CompiledStep`` runs its step as it is; the card captures
one CUDA graph per batch signature.  The capture-and-replay bookkeeping
(sightings, captures, replays, the kernel launch counters, ``state.step``,
the static inputs and loss, the held GroupNorm scratch, the reset on a
restore) is exercised here through a stand-in graph backend: a "capture"
runs the step once to record what it does and puts the state back, a
"replay" runs the recorded step again on the static inputs and undoes its
host-side effects (the wrappers' counting, ``state.step``), as a replay
never re-enters Python.  The card's own
captures are ``tests/test_torch_kernels_cuda.py``'s and ``chip_smoke.py``
phase 16's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tensorflowonspark_torch.examples import bert_squad
from tensorflowonspark_torch.kernels import group_norm, sparse_adagrad
from tensorflowonspark_torch.models import inception as port_inception
from tensorflowonspark_torch.models import resnet as port_resnet
from tensorflowonspark_torch.models import widedeep as port_wd
from tensorflowonspark_torch.parallel import train as train_lib
from tensorflowonspark_torch import trainer as trainer_mod
from tensorflowonspark_torch.trainer import Trainer as PortTrainer
from tensorflowonspark_tpu.models import resnet as ref_resnet
from tensorflowonspark_tpu.models import widedeep as ref_wd
from tensorflowonspark_tpu.trainer import Trainer as JaxTrainer

STEPS = 5
BATCH = 8
LR = 1e-3
#: the 5-step JAX trajectory tolerances of ``test_torch_train.py`` (ResNet,
#: f32) and ``test_torch_widedeep.py``, unchanged
RESNET_F32_LOSS_REL = 1e-5
RESNET_F32_PARAMS_ABS = 1e-5
WD_RTOL, WD_ATOL, WD_PARAMS_ATOL = 1e-5, 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class StandInGraphs:
    """The graph backend of :class:`train_lib.CompiledStep` on the CPU: a
    capture runs the step once and restores ``model`` and ``optimizer``
    (a capture records and runs nothing); a replay runs the recorded step
    on the static inputs, writes its loss into the captured loss tensor and
    undoes what a real replay never does: the wrappers' counting and
    ``state.step``."""

    def __init__(self, model, optimizer):
        self.model, self.optimizer = model, optimizer
        self.captured = 0
        self.scratch_during_capture = []

    @staticmethod
    def applies(batch):
        return True

    @staticmethod
    def device_leaf(leaf):
        return torch.is_tensor(leaf)

    def _snapshot(self):
        return ({k: v.clone() for k, v in self.model.state_dict().items()},
                {p: {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in s.items()}
                 for p, s in self.optimizer.state.items()})

    def _restore(self, snap):
        tensors, opt = snap
        with torch.no_grad():
            for k, v in self.model.state_dict().items():
                v.copy_(tensors[k])
        for p, saved in opt.items():
            live = self.optimizer.state[p]
            for k, v in saved.items():
                if torch.is_tensor(v):
                    live[k].copy_(v)
                else:
                    live[k] = v

    def capture(self, fn):
        self.scratch_during_capture.append(group_norm._CAPTURE_SCRATCH)
        snap = self._snapshot()
        out = fn()
        self._restore(snap)
        self.captured += 1
        return {"fn": fn, "loss": out[1]}, out

    @staticmethod
    def replay(graph):
        counts = _counters()
        state, loss = graph["fn"]()
        state.step -= 1
        graph["loss"].copy_(loss)
        _put_back(counts)


def _counters():
    return [(m.launches, dict(m.launches_by_path))
            for m in (group_norm, sparse_adagrad)]


def _put_back(counts):
    for m, (n, by_path) in zip((group_norm, sparse_adagrad), counts):
        m.launches = n
        m.launches_by_path.update(by_path)


def _graph_trainer(*args, **kwargs):
    """A CPU ``Trainer`` whose step captures and replays through the
    stand-in backend."""
    t = PortTrainer(*args, device="cpu", **kwargs)
    t.train_step = train_lib.compile_step(
        t.train_step.step, graphs=StandInGraphs(t.model, t.optimizer),
        shard=lambda batch: t.shard(batch))
    return t


def _eager_trainer(*args, **kwargs):
    """The same ``Trainer`` stepping the eager step directly (on the
    batch its ``shard`` stages)."""
    t = PortTrainer(*args, device="cpu", **kwargs)
    step = t.train_step.step
    t.train_step = lambda state, batch: step(state, t.shard(batch))
    return t


def _state(t):
    return {**{k: v.detach().clone() for k, v in t.model.state_dict().items()},
            **{f"opt/{n}/{k}": v.clone()
               for n, p in t.model.named_parameters()
               for k, v in t.optimizer.state[p].items()}}


def _assert_same_bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _resnet_batches(config, n=STEPS):
    return [ref_resnet.example_batch(config, BATCH, seed=i) for i in range(n)]


def _wd_batches(config, n=STEPS):
    return [ref_wd.example_batch(config, BATCH, seed=i) for i in range(n)]


def _inception_batches(config, n=STEPS):
    return [port_inception.example_batch(config, 4, seed=i)
            for i in range(n)]


CASES = {
    "resnet": (lambda: ("resnet50", port_resnet.Config.tiny()),
               lambda c: _resnet_batches(ref_resnet.Config(
                   **dataclasses.asdict(c)))),
    # BatchNorm: the running statistics update inside the step (a replay
    # updates them), and the bits compared include them
    "resnet_batch_norm": (lambda: ("resnet50", port_resnet.Config.tiny(
        "batch")), lambda c: _resnet_batches(ref_resnet.Config(
            **dataclasses.asdict(c)))),
    "inception_canonical_batch_norm": (lambda: ("inception_v3",
                                                dataclasses.replace(
        port_inception.Config.tiny_canonical(), norm="batch")),
        _inception_batches),
    "wide_deep_dense": (lambda: ("wide_deep", dataclasses.replace(
        port_wd.Config.tiny(), table_update="dense")),
        lambda c: _wd_batches(ref_wd.Config(**dataclasses.asdict(c)))),
    "wide_deep_sparse": (lambda: ("wide_deep", dataclasses.replace(
        port_wd.Config.tiny(), table_update="sparse")),
        lambda c: _wd_batches(ref_wd.Config(**dataclasses.asdict(c)))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_compiled_step_is_the_eager_step_bit_for_bit(case):
    """A CPU ``Trainer`` (its ``CompiledStep`` runs the step as it is) and
    one stepping the eager step directly: every loss and tensor the same
    bits."""
    name, config = CASES[case][0]()
    batches = CASES[case][1](config)
    compiled = PortTrainer(name, config=config, learning_rate=LR,
                           device="cpu")
    eager = _eager_trainer(name, config=config, learning_rate=LR)
    assert isinstance(compiled.train_step, train_lib.CompiledStep)
    for b in batches:
        assert torch.equal(compiled.step(b), eager.step(b))
    assert compiled.train_step.last == "cpu"
    assert compiled.train_step.captures == compiled.train_step.replays == 0
    _assert_same_bits(_state(compiled), _state(eager))


@pytest.mark.parametrize("case", sorted(CASES))
def test_captured_replays_are_the_eager_step_bit_for_bit(case):
    """Through the stand-in graphs (eager, capture, then replays of the
    static inputs refreshed from each batch): the eager trajectory's bits,
    the captures and replays counted, ``state.step`` booked."""
    name, config = CASES[case][0]()
    batches = CASES[case][1](config)
    graphs = _graph_trainer(name, config=config, learning_rate=LR)
    eager = _eager_trainer(name, config=config, learning_rate=LR)
    actions = []
    for b in batches:
        assert torch.equal(graphs.step(b), eager.step(b))
        actions.append(graphs.train_step.last)
    assert actions == ["eager", "capture"] + ["replay"] * (STEPS - 2)
    assert graphs.train_step.captures == 1
    assert graphs.train_step.replays == STEPS - 1
    assert graphs.state.step == eager.state.step == STEPS
    _assert_same_bits(_state(graphs), _state(eager))


def _jax_resnet(config):
    jax_t = JaxTrainer("resnet50", config=config, learning_rate=LR, seed=0)
    return jax_t, port_resnet.params_from_flax(
        jax.device_get(jax_t.state.params))


def test_captured_resnet_stays_within_the_jax_trainer_tolerances():
    """The stand-in graphs' ResNet trajectory (f32) against the JAX
    ``Trainer`` with ``test_torch_train.py``'s 5-step tolerances."""
    config = dataclasses.replace(ref_resnet.Config.tiny(), dtype="float32")
    jax_t, weights = _jax_resnet(config)
    port_t = _graph_trainer("resnet50", config=port_resnet.Config(
        **dataclasses.asdict(config)), learning_rate=LR)
    port_resnet.load_state(port_t.model, weights)
    losses = []
    for b in _resnet_batches(config):
        losses.append((float(jax_t.step(b)), float(port_t.step(b))))
    losses = np.array(losses)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0],
                               rtol=RESNET_F32_LOSS_REL)
    want = port_resnet.params_from_flax(
        jax.device_get(jax_t.state.params))["params"]
    got = port_resnet.state_of(port_t.model)["params"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=RESNET_F32_PARAMS_ABS, err_msg=k)
    assert port_t.train_step.replays == STEPS - 1


@pytest.mark.parametrize("table_update", ["dense", "sparse"])
def test_captured_wide_deep_stays_within_the_jax_trainer_tolerances(
        table_update):
    """The stand-in graphs' wide&deep trajectory against the JAX
    ``Trainer`` with ``test_torch_widedeep.py``'s 5-step tolerances."""
    config = dataclasses.replace(ref_wd.Config.tiny(),
                                 table_update=table_update)
    jax_t = JaxTrainer("wide_deep", config=config, learning_rate=LR, seed=0)
    port_t = _graph_trainer("wide_deep", config=port_wd.Config(
        **dataclasses.asdict(config)), learning_rate=LR)

    def converted():
        return port_wd.params_from_flax(
            jax.device_get(jax_t.state.params),
            jax.device_get(jax_t.state.collections))

    port_wd.load_state(port_t.model, converted())
    losses = np.array([(float(jax_t.step(b)), float(port_t.step(b)))
                       for b in _wd_batches(config)])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=WD_RTOL)
    got, want = port_wd.state_of(port_t.model), converted()
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=0,
                                   atol=WD_PARAMS_ATOL, err_msg=k)
    for group, leaves in want["collections"].items():
        for k, w in leaves.items():
            g = got["collections"][group][k]
            if group == "embedding":
                np.testing.assert_allclose(g, w, rtol=0, atol=WD_PARAMS_ATOL,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(g, w, rtol=WD_RTOL, atol=WD_ATOL,
                                           err_msg=k)
    assert port_t.train_step.replays == STEPS - 1


def _counting_step(launches_per_step=(2, 1)):
    """A step that "launches" ``launches_per_step`` = (GroupNorm one-pass
    forwards, groupings) through the wrappers' own counters, then returns a
    loss that depends on the batch, and counts ``state.step``."""
    n_gn, n_group = launches_per_step

    def step(state, batch):
        for _ in range(n_gn):
            group_norm.launches += 1
            group_norm.launches_by_path["one_pass"] += 1
        for _ in range(n_group):
            sparse_adagrad._count("group")
        state.step += 1
        return state, (batch["x"] * 2).sum()

    return step


class _State:
    def __init__(self):
        self.step = 0


def _bare(step):
    model = torch.nn.Linear(1, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    graphs = StandInGraphs(model, opt)
    return train_lib.compile_step(step, graphs=graphs), graphs


def _xbatch(value, n=4):
    return {"x": torch.full((n,), float(value))}


def test_signature_bookkeeping_eager_capture_replay():
    """First sighting eager, second captured (and replayed at once), later
    ones replayed; a signature seen once is never captured; ``reset``
    starts every signature over."""
    cs, graphs = _bare(_counting_step())
    state = _State()
    script = [(4, "eager"), (4, "capture"), (4, "replay"), (3, "eager"),
              (4, "replay"), (5, "eager"), (4, "replay")]
    for n, action in script:
        state, _ = cs(state, _xbatch(1, n))
        assert cs.last == action
    assert cs.captures == graphs.captured == 1
    assert cs.replays == 4
    sigs = {s[0][1]: k for s, k in cs.signatures.items()}
    assert sigs == {(4,): 5, (3,): 1, (5,): 1}
    assert state.step == len(script)
    cs.reset()
    assert cs.signatures == {}
    state, _ = cs(state, _xbatch(1, 4))
    assert cs.last == "eager" and cs.captures == 1


def test_wrappers_count_the_eager_and_capturing_steps_not_replays():
    """The wrappers count the launches they make: the eager step's and the
    capture's (recorded into the graph), none of a replay's, which calls
    no wrapper; ``replayed_steps`` counts the steps a replay ran alone, so
    a count planned per step holds for the steps less those."""
    cs, _ = _bare(_counting_step((2, 1)))
    group_norm.reset_launches()
    sparse_adagrad.reset_launches()
    replayed = train_lib.replayed_steps
    state = _State()
    counted = []
    for i in range(6):
        state, _ = cs(state, _xbatch(i))
        counted.append((group_norm.launches, sparse_adagrad.launches))
    assert counted == [(2, 1)] + [(4, 2)] * 5
    assert group_norm.launches_by_path["one_pass"] == 4
    assert sparse_adagrad.launches_by_path["group"] == 2
    assert cs.replays == 5  # the capture's own replay and four more
    steps_alone = train_lib.replayed_steps - replayed
    assert steps_alone == 4
    assert group_norm.launches == 2 * (6 - steps_alone)
    assert state.step == 6


def test_failed_capture_raises_and_books_nothing():
    """A capture that fails raises (no eager fallback), with ``state.step``
    as it was, no graph and no replay; the wrapper's launch call during
    the capture stays counted, as every launch it makes."""
    calls = []

    def step(state, batch):
        calls.append(1)
        group_norm.launches += 1
        state.step += 1
        if len(calls) == 2:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return state, batch["x"].sum()

    cs, _ = _bare(step)
    state = _State()
    cs(state, _xbatch(1))
    before, replayed = group_norm.launches, train_lib.replayed_steps
    with pytest.raises(RuntimeError, match="capturing"):
        cs(state, _xbatch(1))
    assert state.step == 1 and group_norm.launches == before + 1
    assert cs.captures == cs.replays == 0
    assert train_lib.replayed_steps == replayed
    assert cs.graph_of(_xbatch(1)) is None


def test_returned_loss_is_not_the_graph_s_own():
    """A replay overwrites the graph's static loss; the loss a step
    returned keeps its value."""
    cs, _ = _bare(_counting_step((0, 0)))
    state = _State()
    losses = [cs(state, _xbatch(v))[1] for v in (1, 2, 3, 4)]
    assert [float(v) for v in losses] == [8.0, 16.0, 24.0, 32.0]
    cap = cs.graph_of(_xbatch(0))
    assert all(v.data_ptr() != cap.loss.data_ptr() for v in losses)


def test_replays_copy_host_and_card_batches_into_the_static_inputs():
    """A replay takes the batch as the caller hands it: a numpy batch or
    tensors are copied straight into the captured signature's static
    inputs, never through ``shard``; the eager and capturing steps go
    through ``shard``, and so does a signature with no graph."""
    sharded = []

    def shard(batch):
        sharded.append(1)
        return {k: torch.as_tensor(v) for k, v in batch.items()}

    model = torch.nn.Linear(1, 1)
    graphs = StandInGraphs(model, torch.optim.SGD(model.parameters(),
                                                  lr=0.1))
    cs = train_lib.compile_step(_counting_step((0, 0)), graphs=graphs,
                                shard=shard)
    state = _State()
    cs(state, {"x": np.ones(4, np.float32)})
    cs(state, {"x": np.ones(4, np.float32)})
    assert cs.last == "capture" and len(sharded) == 2
    static = cs.graph_of(_xbatch(0)).static
    state, loss = cs(state, {"x": np.full(4, 5.0, np.float32)})
    assert float(loss) == 40.0 and cs.last == "replay"
    assert torch.equal(static["x"], torch.full((4,), 5.0))
    state, loss = cs(state, _xbatch(3))
    assert float(loss) == 24.0 and cs.last == "replay"
    assert len(sharded) == 2 and cs.input_s >= 0.0
    cs(state, {"x": np.ones(3, np.float32)})
    assert cs.last == "eager" and len(sharded) == 3


def test_trainer_stages_replays_into_the_static_inputs_and_books_compile():
    """A ``Trainer`` with the stand-in graphs: numpy batches go straight
    into the static inputs on a replay, and the capturing step books its
    compute wall as ``compile`` in the goodput ledger."""
    from tensorflowonspark_torch.obs import ledger

    ledger.reset()
    config = dataclasses.replace(port_wd.Config.tiny(), table_update="dense")
    t = _graph_trainer("wide_deep", config=config, learning_rate=LR)
    shards = []
    t.shard = lambda b, _shard=t.shard: shards.append(1) or _shard(b)
    batches = _wd_batches(ref_wd.Config(**dataclasses.asdict(config)), 4)
    for b in batches:
        t.step(b)
    assert len(shards) == 2  # the eager and the capturing step
    assert ledger.goodput()._noted["compile"] > 0
    assert ledger.goodput()._noted["input_wait"] > 0
    ledger.reset()
    t.step(batches[0])
    assert ledger.goodput()._noted.get("compile", 0.0) == 0.0


def test_restore_drops_the_graphs(tmp_path):
    """``restore`` and ``restore_latest`` reset the compiled step: the next
    step of a captured signature runs eagerly again, and the trajectory
    after a restore equals the uninterrupted one bit for bit."""
    config = dataclasses.replace(port_wd.Config.tiny(), table_update="sparse")
    batches = _wd_batches(ref_wd.Config(**dataclasses.asdict(config)), 8)
    run = _graph_trainer("wide_deep", config=config, learning_rate=LR)
    want = []
    for i, b in enumerate(batches):
        want.append(float(run.step(b)))
        if i == 3:
            run.save(str(tmp_path / "step4"))
    end = _state(run)
    run.restore(str(tmp_path / "step4"))
    assert run.train_step.signatures == {}
    got = [float(run.step(b)) for b in batches[4:]]
    assert got == want[4:]
    assert run.state.step == 8
    _assert_same_bits(_state(run), end)

    mgr_t = _graph_trainer("wide_deep", config=config, learning_rate=LR)
    mgr_t.checkpoint(str(tmp_path / "ckpt"), every_steps=2, async_save=False)
    for b in batches[:4]:
        mgr_t.step(b)
    assert mgr_t.train_step.captures == 1
    assert mgr_t.restore_latest() == 4
    assert mgr_t.train_step.signatures == {}
    mgr_t.step(batches[4])
    assert mgr_t.train_step.last == "eager"


def test_scratch_is_held_by_the_step_not_the_shared_cache(monkeypatch):
    """Under ``capture_scratch`` the backward's scratch lives in the
    capture's dict, past the shared cache's eviction bound, and the
    compiled step keeps that dict with its graph."""
    monkeypatch.setattr(group_norm, "_BWD_SCRATCH", {})
    plan = group_norm._plan_backward(2, 8, 8, 64, 32)
    cpu = torch.device("cpu")
    held = {}
    with group_norm.capture_scratch(held):
        bufs = [group_norm._bwd_scratch(cpu, 7, n, 64, 32, plan)
                for n in range(1, group_norm._SCRATCH_KEYS + 9)]
    assert group_norm._CAPTURE_SCRATCH is None
    assert group_norm._BWD_SCRATCH == {}
    assert len(held) == group_norm._SCRATCH_KEYS + 8
    assert all(held[(cpu, 7, n, 64, 32, plan.path)] is b
               for n, b in zip(range(1, group_norm._SCRATCH_KEYS + 9), bufs))

    def step(state, batch):
        group_norm._bwd_scratch(cpu, 7, 2, 64, 32, plan)
        state.step += 1
        return state, batch["x"].sum()

    cs, graphs = _bare(step)
    state = _State()
    for _ in range(3):
        cs(state, _xbatch(1))
    cap = cs.graph_of(_xbatch(1))
    assert graphs.scratch_during_capture == [cap.scratch]
    assert list(cap.scratch) == [(cpu, 7, 2, 64, 32, plan.path)]
    # the eager step's buffer went to the shared cache, the capture's not
    assert len(group_norm._BWD_SCRATCH) == 1
    # evicting the shared cache leaves the graph's buffer alive
    group_norm._BWD_SCRATCH.clear()
    assert cap.scratch[(cpu, 7, 2, 64, 32, plan.path)].numel() > 0


def test_capture_takes_only_card_tensors():
    """A batch leaf that is not a tensor on the card cannot be captured:
    the capture raises and names it (the CPU path never captures)."""
    cs = train_lib.CompiledStep(_counting_step((0, 0)))
    state = _State()
    cs(state, _xbatch(1))  # a CPU batch: the step as it is
    assert cs.last == "cpu" and cs.signatures == {}

    class _Always(train_lib.CudaGraphs):
        def applies(self, batch):
            return True

    cs = train_lib.CompiledStep(_counting_step((0, 0)), graphs=_Always())
    cs(state, _xbatch(1))
    with pytest.raises(TypeError, match=r"\('x',\) is cpu"):
        cs(state, _xbatch(1))


def test_pre_pr_checkpoint_restores_into_a_capturable_optimizer(tmp_path):
    """A checkpoint whose AdamW ``step`` is a host scalar (what an eager,
    non-capturable optimizer saves) restores into a capturable AdamW: the
    step count comes back as f32 on the parameter's device, the moments
    bit for bit, and the optimizer stays capturable."""
    config = port_resnet.Config.tiny()
    old = PortTrainer("resnet50", config=config, learning_rate=LR,
                      device="cpu")
    for b in _resnet_batches(ref_resnet.Config(
            **dataclasses.asdict(config)), 2):
        old.step(b)
    p0 = next(old.model.parameters())
    assert old.optimizer.state[p0]["step"].device.type == "cpu"
    old.save(str(tmp_path / "old"))
    new = PortTrainer("resnet50", config=config, learning_rate=LR, seed=3,
                      device="cpu",
                      optimizer=lambda params: torch.optim.AdamW(
                          params, lr=LR, capturable=True))
    new.restore(str(tmp_path / "old"))
    assert all(g["capturable"] for g in new.optimizer.param_groups)
    for (name, p), q in zip(new.model.named_parameters(),
                            old.model.parameters()):
        got, want = new.optimizer.state[p], old.optimizer.state[q]
        assert got["step"].dtype == torch.float32, name
        assert got["step"].device == p.device and float(got["step"]) == 2.0
        assert torch.equal(got["exp_avg"], want["exp_avg"]), name
        assert torch.equal(got["exp_avg_sq"], want["exp_avg_sq"]), name
    assert new.state.step == 2


def test_adamw_is_capturable_only_on_the_card(monkeypatch):
    """``_adamw`` and the BERT example's optimizer build a capturable,
    fused AdamW exactly when the parameters lie on a card, the default
    ``foreach`` one on the CPU."""
    params = [torch.nn.Parameter(torch.zeros(3))]
    assert not trainer_mod.on_card(params)
    for make in (trainer_mod._adamw, bert_squad.make_optimizer):
        defaults = make(LR)(params).defaults
        assert not defaults["capturable"] and not defaults["fused"]
    monkeypatch.setattr(trainer_mod, "on_card", lambda p: True)
    for make in (trainer_mod._adamw, bert_squad.make_optimizer):
        defaults = make(LR)(params).defaults
        assert defaults["capturable"] and defaults["fused"]


def test_an_optimizer_that_cannot_be_captured_raises_on_the_card():
    """On a card ``compile_step`` checks the optimizer: AdamW without
    ``capturable``, and an optimizer that keeps host state, raise with the
    reason; a capturable AdamW and SGD pass.  On the CPU nothing is
    checked."""
    params = [torch.nn.Parameter(torch.zeros(3))]

    class _OnCard:
        @staticmethod
        def parameters():
            return iter([type("P", (), {"is_cuda": True})()])

    def step(state, batch):
        return state, None

    with pytest.raises(ValueError, match="capturable=False"):
        train_lib.compile_step(step, _OnCard(), torch.optim.AdamW(params))
    with pytest.raises(ValueError, match="no capturable option"):
        train_lib.compile_step(step, _OnCard(), torch.optim.Adagrad(params))
    for ok in (torch.optim.AdamW(params, capturable=True),
               torch.optim.SGD(params, lr=0.1)):
        train_lib.compile_step(step, _OnCard(), ok)
    train_lib.compile_step(step, torch.nn.Linear(1, 1),
                           torch.optim.AdamW(params))


class _FakeGraph:
    def capture_begin(self, pool=None, capture_error_mode=None):
        pass

    def capture_end(self):
        pass


def test_two_threads_capturing_keep_the_collector_off_throughout(
        monkeypatch):
    """``CudaGraphs.capture`` switches the cyclic collector off for a
    capture; captures from two threads (the online tier's compute thread
    and ``add_tenant``'s caller) run one at a time, so the first one's end
    cannot switch the collector back on under the second.  The card's
    calls are stand-ins: the CPU has no graphs."""
    import contextlib
    import gc
    import threading

    for name, value in (("graph_pool_handle", lambda: object()),
                        ("Stream", lambda: object()),
                        ("CUDAGraph", _FakeGraph),
                        ("synchronize", lambda: None),
                        ("empty_cache", lambda: None),
                        ("stream", lambda s: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, value)
    first_in, first_done = threading.Event(), threading.Event()
    seen = {}

    def first():
        first_in.set()
        # the second thread's capture may start only after this one ends
        seen["overlap"] = second_in.wait(0.3)
        seen["first"] = gc.isenabled()

    second_in = threading.Event()

    def second():
        second_in.set()
        first_done.wait(10)
        seen["second"] = gc.isenabled()

    def run(fn, done=None):
        train_lib.CudaGraphs().capture(fn)
        if done is not None:
            done.set()

    assert gc.isenabled()
    a = threading.Thread(target=run, args=(first, first_done))
    a.start()
    assert first_in.wait(10)
    b = threading.Thread(target=run, args=(second,))
    b.start()
    a.join(10)
    b.join(10)
    assert not a.is_alive() and not b.is_alive()
    assert seen == {"overlap": False, "first": False, "second": False}
    assert gc.isenabled()
