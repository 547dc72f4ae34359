"""The port's ``Trainer`` checkpoints: cadence, restore, resume, and the
JAX package's checkpoints carried into the port.

Ports of ``tests/test_elastic.py``'s trainer checkpoint cases (the
cadence with ``restore_latest`` into a fresh trainer, the probe loss
round trip, ``TFOS_CKPT_EVERY_STEPS``), of ``tests/test_models.py``'s
checkpoint round trip and of ``tests/test_cluster.py``'s restart through
the cluster, on the tiny ResNet and the tiny wide&deep in both
``table_update`` modes.  On the CPU a resumed run equals an uninterrupted
one bit for bit.  A restore copies into the live tensors: the optimizer,
its state and wide&deep's step keep theirs.  JAX parity: the JAX
``Trainer`` takes k steps and saves; the checkpoint goes through
``params_from_flax`` + ``opt_state_from_optax`` into the port, and both
take m more steps: losses and params f32 1e-5 (``tests/test_torch_train.
py``'s tolerances), wide&deep's tables at ``PARAMS_ATOL`` 1e-5
(``tests/test_torch_widedeep.py``: AdaGrad's step amplifies the MLP
backward's 1e-7 gradient gap where a row's duplicates cancel).
"""

import dataclasses
import os
import sys
import time

import cloudpickle
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import TFCluster, TFManager, ckpt
from tensorflowonspark_torch.models import resnet, widedeep
from tensorflowonspark_torch.parallel import train as train_lib
from tensorflowonspark_torch.sparkapi import LocalSparkContext
from tensorflowonspark_torch.trainer import Trainer

cloudpickle.register_pickle_by_value(sys.modules[__name__])

F32_REL = 1e-5
F32_PARAMS_ABS = 1e-5
PARAMS_ATOL = 1e-5
LR = 1e-3
BATCH = 8

#: (zoo name, module, config) of every case
CASES = {
    "resnet": ("resnet50", resnet, resnet.Config.tiny()),
    "wide_deep_dense": ("wide_deep", widedeep, widedeep.Config.tiny()),
    "wide_deep_sparse": ("wide_deep", widedeep, dataclasses.replace(
        widedeep.Config.tiny(), table_update="sparse")),
    # BatchNorm: the running statistics ride the checkpoint's collections
    "resnet_batch_norm": ("resnet50", resnet, resnet.Config.tiny("batch")),
}


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _trainer(case, seed=0):
    name, _, config = CASES[case]
    return Trainer(name, config=config, learning_rate=LR, seed=seed,
                   device="cpu")


def _batches(case, n, start=0):
    _, lib, config = CASES[case]
    return [lib.example_batch(config, BATCH, seed=start + i)
            for i in range(n)]


def _snapshot(t):
    """Every tensor of the train state, as numpy copies."""
    tree = train_lib.state_tree(t.state)
    flat = ckpt._flatten(tree)
    return {k: (v.detach().numpy().copy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in flat.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_checkpoint_cadence_and_restore_latest(tmp_path, case):
    """Asynchronous cadence saves ride the step; ``restore_latest`` brings
    a FRESH trainer (another seed) to the saved step, and it trains on."""
    t = _trainer(case)
    t.checkpoint(str(tmp_path / "ck"), every_steps=2)
    batches = _batches(case, 5)
    for b in batches:
        t.step(b)
    t.finish_checkpoints()
    assert t.last_checkpoint_step == 4
    assert t._ckpt_mgr.latest_step() == 4
    assert t._ckpt_mgr.all_steps() == [2, 4]

    t2 = _trainer(case, seed=7)
    t2.checkpoint(str(tmp_path / "ck"), every_steps=2)
    assert t2.restore_latest() == 4
    assert t2.state.step == 4
    loss = float(t2.step(batches[4]))
    assert np.isfinite(loss) and t2.state.step == 5


@pytest.mark.parametrize("case", list(CASES))
def test_restore_latest_roundtrips_probe_loss(tmp_path, case):
    _, lib, config = CASES[case]
    t = _trainer(case)
    t.checkpoint(str(tmp_path / "ck"), every_steps=3)
    for b in _batches(case, 3):
        t.step(b)
    t.finish_checkpoints()
    probe = lib.example_batch(config, 16, seed=99)
    saved = t.predict(probe)
    t2 = _trainer(case, seed=3)
    t2.checkpoint(str(tmp_path / "ck"), every_steps=3)
    assert t2.restore_latest() == 3
    torch.testing.assert_close(t2.predict(probe), saved, rtol=0, atol=0)


def test_trainer_ckpt_every_steps_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TFOS_CKPT_EVERY_STEPS", "2")
    t = _trainer("resnet")
    t.checkpoint(str(tmp_path / "ck"))
    for b in _batches("resnet", 2):
        t.step(b)
    t.finish_checkpoints()
    assert t._ckpt_mgr.latest_step() == 2
    monkeypatch.delenv("TFOS_CKPT_EVERY_STEPS")
    t2 = _trainer("resnet")
    t2.checkpoint(str(tmp_path / "ck2"))  # manual only
    t2.step(_batches("resnet", 1)[0])
    assert t2._ckpt_mgr.latest_step() is None
    with pytest.raises(RuntimeError, match="never enabled"):
        _trainer("resnet").restore_latest()


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_checkpoint_roundtrip(tmp_path, case):
    _, lib, config = CASES[case]
    t = _trainer(case)
    batch = lib.example_batch(config, BATCH)
    t.step(batch)
    before = t.predict(batch)
    t.save(str(tmp_path / "ckpt"))
    t2 = _trainer(case, seed=123)
    t2.restore(str(tmp_path / "ckpt"))
    torch.testing.assert_close(t2.predict(batch), before, rtol=0, atol=0)
    assert t2.state.step == 1


@pytest.mark.parametrize("case", list(CASES))
def test_resumed_run_equals_an_uninterrupted_one_bit_for_bit(tmp_path,
                                                             case):
    """8 steps in one trainer against 4 steps, a checkpoint, and 4 more
    in a fresh trainer (another seed) restored from it: the same losses
    and the same final state, every tensor bit for bit."""
    batches = _batches(case, 8)
    whole = _trainer(case)
    want = [float(whole.step(b)) for b in batches]

    first = _trainer(case)
    first.checkpoint(str(tmp_path / "ck"), every_steps=4)
    got = [float(first.step(b)) for b in batches[:4]]
    first.finish_checkpoints()
    resumed = _trainer(case, seed=11)
    resumed.checkpoint(str(tmp_path / "ck"), every_steps=4)
    assert resumed.restore_latest() == 4
    got += [float(resumed.step(b)) for b in batches[4:]]
    resumed.finish_checkpoints()
    assert got == want
    a, b = _snapshot(whole), _snapshot(resumed)
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert resumed._ckpt_mgr.latest_step() == 8


@pytest.mark.parametrize("case", ["resnet", "wide_deep_dense"])
def test_restore_keeps_the_live_tensors(tmp_path, case):
    """A restore copies into the tensors the optimizer, its state and the
    model's own step hold; it rebinds none of them."""
    t = _trainer(case)
    batches = _batches(case, 3)
    t.step(batches[0])
    t.save(str(tmp_path / "ck"))
    t.step(batches[1])
    opt = t.optimizer
    params = dict(t.model.named_parameters())
    state_ids = {name: {k: id(v) for k, v in opt.state[p].items()}
                 for name, p in params.items()}
    buffers = {k: id(v) for k, v in t.model.named_buffers()}
    t.restore(str(tmp_path / "ck"))
    assert t.state.opt_state is opt
    assert all(t.state.params[k] is p for k, p in params.items())
    assert all(p is q for p, q in zip(opt.param_groups[0]["params"],
                                      t.model.parameters()))
    for name, p in params.items():
        assert {k: id(v) for k, v in opt.state[p].items()} == state_ids[name]
        assert float(opt.state[p]["step"]) == 1.0
    assert {k: id(v) for k, v in t.model.named_buffers()} == buffers
    assert t.state.step == 1
    # and it trains on from the restored state, updating those tensors
    w = next(iter(params.values()))
    before = w.detach().clone()
    t.step(batches[2])
    assert not torch.equal(w.detach(), before)
    assert float(opt.state[next(iter(params.values()))]["step"]) == 2.0


def test_restore_into_a_fresh_trainer_creates_the_optimizer_state(tmp_path):
    t = _trainer("resnet")
    t.step(_batches("resnet", 1)[0])
    t.save(str(tmp_path / "ck"))
    fresh = _trainer("resnet", seed=2)
    assert not fresh.optimizer.state
    fresh.restore(str(tmp_path / "ck"))
    for name, p in fresh.state.params.items():
        st = fresh.optimizer.state[p]
        assert float(st["step"]) == 1.0
        np.testing.assert_array_equal(
            st["exp_avg"].numpy(),
            t.optimizer.state[t.state.params[name]]["exp_avg"].numpy())
    # a tree without optimizer state (saved before any step) resets it
    t0 = _trainer("resnet", seed=4)
    t0.save(str(tmp_path / "step0"))
    fresh.restore(str(tmp_path / "step0"))
    assert not fresh.optimizer.state and fresh.state.step == 0


# ---------------------------------------------------------------------------
# JAX checkpoints carried into the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["resnet", "wide_deep_dense",
                                  "wide_deep_sparse"])
def test_port_resumed_from_a_jax_checkpoint_matches_jax(tmp_path, case):
    import jax

    from tensorflowonspark_tpu import ckpt as jax_ckpt
    from tensorflowonspark_tpu.models import resnet as ref_resnet
    from tensorflowonspark_tpu.models import widedeep as ref_widedeep
    from tensorflowonspark_tpu.trainer import Trainer as JaxTrainer

    name, lib, config = CASES[case]
    ref = ref_resnet if lib is resnet else ref_widedeep
    ref_config = ref.Config(**dataclasses.asdict(config))
    jt = JaxTrainer(name, config=ref_config, learning_rate=LR, seed=0)
    k, m = 3, 3
    for i in range(k):
        jt.step(ref.example_batch(ref_config, 16, seed=i))
    jt.save(str(tmp_path / "jax_ck"))
    tree = jax_ckpt.load_pytree(str(tmp_path / "jax_ck"))
    assert int(tree["step"]) == k

    converted = lib.params_from_flax(tree["params"],
                                     tree.get("collections"))
    port_tree = {"params": converted["params"],
                 "opt_state": lib.opt_state_from_optax(tree["opt_state"],
                                                       tree["params"]),
                 "step": tree["step"]}
    if "collections" in converted:
        port_tree["collections"] = converted["collections"]
    ckpt.save_pytree(port_tree, str(tmp_path / "port_ck"))
    pt = _trainer(case, seed=5)
    pt.restore(str(tmp_path / "port_ck"))
    assert pt.state.step == k

    losses = []
    for i in range(k, k + m):
        batch = ref.example_batch(ref_config, 16, seed=i)
        losses.append((float(jt.step(batch)), float(pt.step(batch))))
    losses = np.array(losses)
    print(f"{case}: loss rel max "
          f"{np.max(np.abs(losses[:, 1] - losses[:, 0]) / losses[:, 0]):.2e}")
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=F32_REL)
    want = lib.params_from_flax(jax.device_get(jt.state.params),
                                jax.device_get(jt.state.collections) or None)
    got = lib.state_of(pt.model)
    for key, w in want["params"].items():
        np.testing.assert_allclose(got["params"][key], w, rtol=0,
                                   atol=F32_PARAMS_ABS, err_msg=key)
    for group, leaves in want.get("collections", {}).items():
        for key, w in leaves.items():
            g = got["collections"][group][key]
            if group == "embedding":
                np.testing.assert_allclose(g, w, rtol=0, atol=PARAMS_ATOL,
                                           err_msg=key)
            else:
                np.testing.assert_allclose(g, w, rtol=F32_REL, atol=1e-6,
                                           err_msg=key)
    # the moments carried on as optax's did
    want_opt = lib.opt_state_from_optax(jax.device_get(jt.state.opt_state),
                                        jax.device_get(jt.state.params))
    got_opt = {n: pt.optimizer.state[p] for n, p in pt.state.params.items()}
    for key, w in want_opt.items():
        assert float(got_opt[key]["step"]) == float(w["step"]) == k + m
        np.testing.assert_allclose(got_opt[key]["exp_avg"].numpy(),
                                   w["exp_avg"], rtol=F32_REL, atol=1e-7,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# Restart from checkpoint through the cluster
# ---------------------------------------------------------------------------

ROWS = 64


def ckpt_train_fun(args, ctx):
    """Trainer-based map_fun of the restart model (fail fast, resume from
    the last checkpoint): the chief saves at the end; with ``restore``
    every node starts from the chief's checkpoint."""
    import numpy as np
    import torch

    from tensorflowonspark_torch.models import widedeep
    from tensorflowonspark_torch.trainer import Trainer

    torch.set_num_threads(1)
    t = Trainer("wide_deep", config=widedeep.Config.tiny(),
                learning_rate=1e-2)
    if args["restore"]:
        t.restore(args["model_dir"])
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping=["dense", "cat", "label"])
    ctx.mgr.set("ready", True)
    while not feed.should_stop():
        batch = feed.next_batch(16)
        if not batch or batch["dense"].shape[0] == 0:
            continue
        t.step({"dense": np.asarray(batch["dense"], np.float32),
                "cat": np.asarray(batch["cat"], np.int32),
                "label": np.asarray(batch["label"], np.int32)})
    ctx.mgr.set("step_count", int(t.state.step))
    if ctx.job_name == "chief":
        t.save(args["model_dir"])


def _await_ready(cluster, timeout=120.0):
    authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
    mgrs = [TFManager.connect(tuple(m["addr"]), authkey)
            for m in cluster.cluster_info]
    deadline = time.monotonic() + timeout
    while not all(m.get("ready") for m in mgrs):
        assert time.monotonic() < deadline, "trainers not ready"
        time.sleep(0.1)


def test_checkpoint_restart_through_cluster(tmp_path, monkeypatch):
    """Job 1 trains and checkpoints; job 2 restores and continues: the
    step counter carries across cluster restarts (the documented recovery
    model: spark.task.maxFailures=1 + restart from checkpoint)."""
    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("TFOS_FEED_SHM", "0")
    rng = np.random.RandomState(0)
    data = [(rng.rand(13).astype(np.float32),
             rng.randint(0, 50, size=26).astype(np.int32), int(i % 2))
            for i in range(ROWS)]
    model_dir = str(tmp_path / "ckpt")
    sc = LocalSparkContext("local-cluster[2,1,1024]", "torch-ckpt-restart")
    try:
        def run_job(restore):
            cluster = TFCluster.run(
                sc, ckpt_train_fun, {"model_dir": model_dir,
                                     "restore": restore},
                num_executors=2, master_node="chief",
                input_mode=TFCluster.InputMode.SPARK)
            _await_ready(cluster)
            cluster.train(sc.parallelize(data, 2), num_epochs=2,
                          feed_timeout=120)
            cluster.shutdown(grace_secs=60)
            authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
            return {meta["job_name"]: TFManager.connect(
                tuple(meta["addr"]), authkey).get("step_count")
                for meta in cluster.cluster_info}

        first = run_job(restore=False)
        assert all(s and s > 0 for s in first.values()), first
        assert os.path.exists(os.path.join(model_dir, "pytree.npz"))
        second = run_job(restore=True)
        # every node restored the chief's checkpoint: its counter goes on
        # from the first job's chief step count instead of restarting at 0
        for job, steps in second.items():
            assert steps > first["chief"], (first, second)
    finally:
        sc.stop()
