"""The port's wide&deep model and its training step against the JAX
package's.

Both packages see the same weights (numpy draws in the JAX init's shapes,
or the JAX ``Trainer``'s own init, converted with
``widedeep.params_from_flax``) and the same numpy batches.  The forward,
the loss and the MLP gradients, and a 5-step trajectory of
``Trainer("wide_deep")`` in both ``table_update`` modes (losses, final
tables, accumulators and MLP params) must agree in f32 (rtol 1e-5, atol
1e-6; the trajectory's params atol 1e-5, as ``tests/test_torch_train.py``).
Batches of 16 over 50 buckets repeat ids, so the two modes differ and
each is held to its own reference.  A two-process gloo group must match
one process stepping the global batch, its replicas' tables bit-identical.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import ckpt, models, util
from tensorflowonspark_torch.models import widedeep as port
from tensorflowonspark_torch.trainer import Trainer as PortTrainer
from tensorflowonspark_tpu.models import widedeep as ref
from tensorflowonspark_tpu.trainer import Trainer as JaxTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
#: the trajectory's MLP params and tables, as ``tests/test_torch_train.py``
#: holds params: AdaGrad's step ``-lr·g·rsqrt(acc + eps)`` is ill-conditioned
#: where a row's duplicate gradients nearly cancel (a wide-table entry moved
#: 1.4e-6 away on the CPU, from a 1e-7 relative gap in ``g``), while a
#: wrong sign or a lost occurrence moves an entry by ~lr = 1e-2.  Not the
#: order of the sums: both packages add duplicates in batch order, and the
#: gap is the two f32 MLP backward passes' gradient gap amplified by up to
#: lr / sqrt(eps) (``test_torch_embedding.py::
#: test_cancelling_duplicates_gap_is_the_inputs_not_the_order``)
PARAMS_ATOL = 1e-5
STEPS = 5
BATCH = 16
LR = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _unbox(tree):
    return jax.tree_util.tree_map(
        lambda x: x.unbox() if hasattr(x, "unbox") else x, tree,
        is_leaf=lambda x: hasattr(x, "unbox"))


def _drawn(config, seed=0):
    """(flax module, variables, port state): numpy draws in the shapes of
    the JAX init (``jax.eval_shape``, no compile), nonzero everywhere so
    the wide table and the biases count."""
    module = ref.make_model(config)
    b = ref.example_batch(config, 2)
    shapes_ = _unbox(jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), b["dense"], b["cat"])))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.randn(*s.shape) * np.sqrt(2 / s.shape[0])).astype(
                np.float32)
        if "acc" in name:
            return np.abs(rng.randn(*s.shape)).astype(np.float32)
        return (0.05 * rng.randn(*s.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes_)
    state = port.params_from_flax(
        variables["params"], {k: variables[k]
                              for k in ("embedding", "embedding_opt")})
    return module, variables, state


def _port_model(state):
    return port.load_state(port.make_model(port.config_from_state(state)),
                           state)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


FORWARD_CONFIGS = {
    "tiny": port.Config.tiny(),
    "full_width_1000_buckets": port.Config(hash_buckets=1000),
}


@pytest.mark.parametrize("name", sorted(FORWARD_CONFIGS))
def test_forward_matches_the_jax_package(name):
    config = ref.Config(**{
        k: v for k, v in dataclasses.asdict(FORWARD_CONFIGS[name]).items()})
    module, variables, state = _drawn(config)
    batch = ref.example_batch(config, 8, seed=1)
    want = np.asarray(jax.nn.sigmoid(module.apply(
        variables, batch["dense"], batch["cat"])))
    model = _port_model(state)
    assert model.config == FORWARD_CONFIGS[name]
    forward = port.make_forward_fn(model, model.config)
    got = forward(model, _torch_batch(batch)).numpy()
    assert got.shape == (8,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_loss_and_mlp_gradients_match_the_jax_package():
    import optax

    config = ref.Config.tiny()
    module, variables, state = _drawn(config)
    batch = ref.example_batch(config, BATCH, seed=2)
    collections = {k: v for k, v in variables.items() if k != "params"}

    def loss_of(params):
        logit = module.apply({"params": params, **collections},
                             batch["dense"], batch["cat"])
        return optax.sigmoid_binary_cross_entropy(
            logit, batch["label"].astype(np.float32)).mean()

    want_loss, want_grads = jax.value_and_grad(loss_of)(variables["params"])
    want = port.params_from_flax(want_grads)["params"]
    model = _port_model(state)
    loss = port.make_loss_fn(model, model.config)(model, _torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=RTOL)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _train_both(table_update):
    config = dataclasses.replace(ref.Config.tiny(), table_update=table_update)
    jax_t = JaxTrainer("wide_deep", config=config, learning_rate=LR, seed=0)
    port_t = PortTrainer("wide_deep", config=port.Config(
        **dataclasses.asdict(config)), learning_rate=LR, device="cpu")

    def converted():
        return port.params_from_flax(
            jax.device_get(jax_t.state.params),
            jax.device_get(jax_t.state.collections))

    port.load_state(port_t.model, converted())
    losses = []
    for i in range(STEPS):
        batch = ref.example_batch(config, BATCH, seed=i)
        losses.append((float(jax_t.step(batch)), float(port_t.step(batch))))
    return np.array(losses), port.state_of(port_t.model), converted()


@pytest.mark.parametrize("table_update", ["dense", "sparse"])
def test_five_steps_match_the_jax_trainer(table_update):
    losses, got, want = _train_both(table_update)
    print(f"{table_update}: loss rel max "
          f"{np.max(np.abs(losses[:, 1] - losses[:, 0]) / losses[:, 0]):.2e}")
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=RTOL)
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=0,
                                   atol=PARAMS_ATOL, err_msg=k)
    for group, leaves in want["collections"].items():
        for k, w in leaves.items():
            g = got["collections"][group][k]
            print(f"{group}/{k}: max |diff| {np.abs(g - w).max():.2e}")
            if group == "embedding":
                np.testing.assert_allclose(g, w, rtol=0, atol=PARAMS_ATOL,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=k)
    # the tables trained: accumulators moved off their zero init
    assert np.abs(got["collections"]["embedding_opt"]["deep_acc"]).max() > 0


def test_the_two_modes_differ_on_repeated_ids():
    """Batches of 16 over 50 buckets repeat ids, so the per-occurrence and
    the summed accumulation give different accumulators (the reference's
    note on ``Config.table_update``)."""
    accs = []
    for table_update in ("dense", "sparse"):
        config = dataclasses.replace(port.Config.tiny(),
                                     table_update=table_update)
        t = PortTrainer("wide_deep", config=config, device="cpu")
        t.step(port.example_batch(config, BATCH, seed=0))
        accs.append(t.model.deep_acc.clone())
    assert not torch.allclose(*accs)


def test_half_pregathered_call_raises():
    config = port.Config.tiny()
    model = port.make_model(config)
    b = _torch_batch(port.example_batch(config, 4))
    ids = port.fold_ids(b["cat"], config)
    rows = port.gather_rows(model.deep, ids)
    with pytest.raises(ValueError, match="passed together"):
        model(b["dense"], b["cat"], emb_rows=rows)
    with pytest.raises(ValueError, match="passed together"):
        model(b["dense"], b["cat"], wide_rows=port.gather_rows(model.wide,
                                                               ids))
    full = model(b["dense"], b["cat"], emb_rows=rows,
                 wide_rows=port.gather_rows(model.wide, ids))
    torch.testing.assert_close(full, model(b["dense"], b["cat"]), rtol=0,
                               atol=0)


def test_unknown_table_update_raises():
    config = dataclasses.replace(port.Config.tiny(), table_update="ftrl")
    with pytest.raises(ValueError, match="table_update"):
        PortTrainer("wide_deep", config=config, device="cpu")


def test_export_strips_the_accumulators_and_serves_the_tables(tmp_path):
    """``Trainer.export``: params plus the ``embedding`` collection, no
    ``embedding_opt``; a model rebuilt from it by its shapes predicts as
    the trainer does."""
    config = port.Config.tiny()
    t = PortTrainer("wide_deep", config=config, device="cpu")
    t.step(port.example_batch(config, BATCH, seed=0))
    path = t.export(str(tmp_path / "export"))
    state = ckpt.load_pytree(path)
    assert sorted(state) == ["collections", "params"]
    assert sorted(state["collections"]) == ["embedding"]
    assert sorted(state["collections"]["embedding"]) == ["deep", "wide"]
    assert port.config_from_state(state) == config
    served = port.load_state(port.make_model(config), state)
    batch = port.example_batch(config, 4, seed=3)
    torch.testing.assert_close(
        port.make_forward_fn(served, config)(served, _torch_batch(batch)),
        t.predict(batch), rtol=0, atol=0)


def test_params_from_flax_raises_on_unmapped_leaves():
    _, variables, _ = _drawn(ref.Config.tiny())
    params = dict(_unbox(variables["params"]))
    params["Conv_0"] = {"kernel": np.zeros((3, 3))}
    with pytest.raises(KeyError, match="Conv_0"):
        port.params_from_flax(params)
    with pytest.raises(KeyError, match="moments"):
        port.params_from_flax(variables["params"],
                              {"embedding_opt": {"moments": np.zeros(3)}})


def test_zoo_registers_wide_deep_and_the_optimizer_hook():
    assert models.get_model("wide_deep") is port
    assert models.get_model("tiny_lm").__name__ == (
        "tensorflowonspark_torch.models.tinylm")
    assert len(models.available()) == 8
    calls = []

    def make_optimizer(config, learning_rate):
        calls.append(learning_rate)
        return lambda params: torch.optim.SGD(params, lr=learning_rate)

    lib = types.SimpleNamespace(**vars(port), make_optimizer=make_optimizer)
    t = PortTrainer(lib, config=port.Config.tiny(), learning_rate=0.5,
                    device="cpu")
    assert calls == [0.5] and isinstance(t.optimizer, torch.optim.SGD)
    assert set(t.state.collections) == {"embedding", "embedding_opt"}
    assert t.state.collections["embedding"]["deep"] is t.model.deep


_DP_WORKER = r"""
import dataclasses, json, sys
import numpy as np, torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[5])
from tensorflowonspark_torch.models import widedeep
from tensorflowonspark_torch.trainer import Trainer
torch.set_num_threads(1)
rank, world, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
if world > 1:
    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=world, rank=rank)
config = dataclasses.replace(widedeep.Config.tiny(), table_update=sys.argv[4])
t = Trainer("wide_deep", config=config, learning_rate=1e-2, seed=0,
            device="cpu")
losses = []
for i in range(3):
    b = widedeep.example_batch(config, 16, seed=i)
    share = {k: v[rank * 16 // world:(rank + 1) * 16 // world]
             for k, v in b.items()}
    losses.append(float(t.step(share)))
state = widedeep.state_of(t.model)
flat = {k: v.ravel().tolist() for k, v in state["params"].items()}
for group, leaves in state["collections"].items():
    flat.update({f"{group}/{k}": v.ravel().tolist() for k, v in leaves.items()})
print(json.dumps({"losses": losses, "state": flat}))
"""


def _run_dp(world, table_update):
    _, port_num = util.find_free_port("127.0.0.1")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DP_WORKER, str(r), str(world),
         f"127.0.0.1:{port_num}", table_update, REPO], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=240)
        assert p.returncode == 0, stderr
        out.append(json.loads(stdout.strip().splitlines()[-1]))
    return out


@pytest.mark.parametrize("table_update", ["dense", "sparse"])
def test_two_rank_gloo_step_equals_one_process_global_batch(table_update):
    """Each rank steps half of every batch: the row gradients, scaled by
    1/world, are all-gathered with the ids, so both replicas apply the
    global batch's table update — bit-identical to each other — and match
    one process stepping the whole batch (f32 sums in another order)."""
    [single] = _run_dp(1, table_update)
    ranks = _run_dp(2, table_update)
    assert ranks[0]["state"] == ranks[1]["state"]  # replicas stay equal
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], single["losses"],
                               rtol=RTOL)
    for k, v in single["state"].items():
        np.testing.assert_allclose(ranks[0]["state"][k], v, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
