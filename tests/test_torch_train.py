"""The port's training step against the JAX package's, and data parallel.

Both ``Trainer``s train the tiny ResNet (``Config.tiny()``, GroupNorm) from
the same weights: the JAX ``Trainer``'s initial params, converted with
``resnet.params_from_flax`` and loaded into the port; both optimizers are
AdamW with ``optax.adamw``'s defaults and start at zero moments.  They take
the same 5 batches (numpy, seeded), and the per-step losses and the final
params must agree.  A two-process gloo group must leave the same params as
one process stepping the whole batch.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import ckpt, util
from tensorflowonspark_torch.kernels import group_norm
from tensorflowonspark_torch.models import resnet as port
from tensorflowonspark_torch.trainer import Trainer as PortTrainer
from tensorflowonspark_tpu.models import resnet as ref
from tensorflowonspark_tpu.trainer import Trainer as JaxTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
BATCH = 8
LR = 1e-3
#: f32: the same arithmetic in another order (these tests print what they
#: measure with ``-s``: loss rel 5e-7, params max |Δ| 3.6e-7 on the CPU); a
#: flipped AdamW update sign would move a param by 2·LR, far beyond it
F32_LOSS_REL = 1e-5
F32_PARAMS_ABS = 1e-5
#: bf16: the two packages round at different places (loss rel 2.3e-3,
#: params rel L2 1.8e-3 on the CPU)
BF16_LOSS_REL = 2e-2
BF16_PARAMS_REL_L2 = 2e-2


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One intra-op thread (and OMP_NUM_THREADS=1 for spawned processes):
    the suite runs in several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _train_both(dtype):
    config = dataclasses.replace(ref.Config.tiny(), dtype=dtype)
    jax_t = JaxTrainer("resnet50", config=config, learning_rate=LR, seed=0)
    port_t = PortTrainer("resnet50", config=port.Config(
        **dataclasses.asdict(config)), learning_rate=LR, device="cpu")
    port.load_state(port_t.model, port.params_from_flax(
        jax.device_get(jax_t.state.params)))
    losses = []
    for i in range(STEPS):
        batch = ref.example_batch(config, BATCH, seed=i)
        losses.append((float(jax_t.step(batch)), float(port_t.step(batch))))
    want = port.params_from_flax(jax.device_get(jax_t.state.params))["params"]
    got = port.state_of(port_t.model)["params"]
    assert sorted(got) == sorted(want)
    losses = np.array(losses)
    diff = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    norm = sum(float(np.sum(want[k] ** 2)) for k in want)
    print(f"{dtype}: loss rel max "
          f"{np.max(np.abs(losses[:, 1] - losses[:, 0]) / losses[:, 0]):.2e},"
          f" params max |diff| "
          f"{max(float(np.abs(got[k] - want[k]).max()) for k in want):.2e},"
          f" params rel L2 {(diff / norm) ** 0.5:.2e}")
    return losses, got, want


def test_five_steps_match_the_jax_trainer_f32():
    losses, got, want = _train_both("float32")
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=F32_LOSS_REL)
    assert losses[-1, 1] < losses[0, 1]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=F32_PARAMS_ABS, err_msg=k)


def test_five_steps_match_the_jax_trainer_bf16():
    losses, got, want = _train_both("bfloat16")
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=BF16_LOSS_REL)
    diff = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    norm = sum(float(np.sum(want[k] ** 2)) for k in want)
    assert (diff / norm) ** 0.5 <= BF16_PARAMS_REL_L2


def test_every_parameter_gets_a_gradient():
    """The step raises if the loss does not reach a parameter (the fault a
    forward invisible to autograd would cause) and otherwise updates all."""
    t = PortTrainer("resnet50", config=port.Config.tiny(), device="cpu")
    before = {k: v.detach().clone() for k, v in t.params.items()}
    t.step(port.example_batch(t.config, 4))
    assert all(not torch.equal(before[k], v) for k, v in t.params.items())
    t.model.norm_act = lambda x, *a, **k: x.detach()  # cuts the graph
    with pytest.raises(RuntimeError, match="got no gradient"):
        t.step(port.example_batch(t.config, 4))


def test_clip_by_global_norm_has_optax_semantics():
    import optax

    from tensorflowonspark_torch.parallel import train

    rng = np.random.RandomState(0)
    grads = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(
        np.float32)]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            grads, optax.EmptyState())
        got = [torch.from_numpy(g.copy()) for g in grads]
        train.clip_by_global_norm_(got, max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_clipped_step_moves_the_params_by_the_clip_norm():
    """SGD at lr 1 through ``make_train_step(clip_global_norm=c)``: the
    params move by exactly the clipped gradient, of global norm c."""
    from tensorflowonspark_torch.parallel import train

    model = port.make_model(port.Config.tiny(), seed=0)
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    step = train.make_train_step(port.make_loss_fn(model, port.Config.tiny()),
                                 opt, model, clip_global_norm=1e-3)
    before = [p.detach().clone() for p in model.parameters()]
    batch = {k: torch.from_numpy(v)
             for k, v in port.example_batch(port.Config.tiny(), 4).items()}
    state, loss = step(train.create_train_state(model, opt), batch)
    moved = torch.linalg.vector_norm(torch.cat(
        [(p.detach() - b).reshape(-1) for p, b in zip(model.parameters(),
                                                      before)]))
    assert state.step == 1 and loss.requires_grad is False
    assert abs(float(moved) - 1e-3) < 1e-8


def test_optimizer_factory_gets_the_model_params():
    t = PortTrainer("resnet50", config=port.Config.tiny(), device="cpu",
                    optimizer=lambda params: torch.optim.SGD(params, lr=0.1))
    assert isinstance(t.optimizer, torch.optim.SGD)
    assert [p for g in t.optimizer.param_groups for p in g["params"]] == \
        list(t.model.parameters())


_DP_WORKER = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
from tensorflowonspark_torch.models import resnet
from tensorflowonspark_torch.trainer import Trainer
torch.set_num_threads(1)
rank, world, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
if world > 1:
    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=world, rank=rank)
t = Trainer("resnet50", config=resnet.Config.tiny(), learning_rate=1e-2,
            seed=0, device="cpu")
losses = []
for i in range(3):
    b = resnet.example_batch(t.config, 8, seed=i)
    share = {k: v[rank * 8 // world:(rank + 1) * 8 // world]
             for k, v in b.items()}
    losses.append(float(t.step(share)))
params = {k: v.detach().numpy().ravel().tolist()
          for k, v in t.params.items()}
print(json.dumps({"losses": losses, "params": params}))
"""


def _run_dp(world):
    _, port_num = util.find_free_port("127.0.0.1")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DP_WORKER, str(r), str(world),
         f"127.0.0.1:{port_num}", REPO], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=240)
        assert p.returncode == 0, stderr
        out.append(json.loads(stdout.strip().splitlines()[-1]))
    return out


def test_two_rank_gloo_step_equals_one_process_whole_batch():
    """Each rank steps half of every batch; the gradient all-reduce makes
    both ranks' params, and the averaged loss, those of one process
    stepping the whole batch (f32 sums in another order)."""
    [single] = _run_dp(1)
    ranks = _run_dp(2)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=1e-5)
        for k, v in single["params"].items():
            np.testing.assert_allclose(r["params"][k], v, rtol=0, atol=1e-5,
                                       err_msg=k)
    assert ranks[0]["params"] == ranks[1]["params"]  # replicas stay equal


def test_full_width_gradients_on_the_cpu_stay_inside_the_card_gates():
    """ResNet-50 at full width on 64² images, on the CPU, where the
    wrapper's ``autograd.Function`` runs the kernels' plain twins: the
    quantities ``chip_smoke.py`` gates on the card, measured here first.
    One step's gradients (batch 4): the Function path against autograd of
    the plain forward, and bf16 against f32; then 8 AdamW steps (lr 1e-4)
    on one batch, Function path against plain.  Printed with ``-s``."""
    import chip_smoke

    config = dataclasses.replace(port.Config(), image_size=64)
    f32 = dataclasses.replace(config, dtype="float32")
    batch = {k: torch.from_numpy(v)
             for k, v in port.example_batch(config, 4, seed=0).items()}
    model = port.make_model(config, seed=0)
    model32 = port.load_state(port.make_model(f32), port.state_of(model))
    loss_fn = port.make_loss_fn(model, config)

    def grads(m, norm_act):
        m.norm_act = norm_act
        m.zero_grad(set_to_none=True)
        loss_fn(m, batch).backward()
        return {k: p.grad.clone() for k, p in m.named_parameters()}

    g_fn = grads(model, group_norm.group_norm_act)
    g_plain = grads(model, group_norm.group_norm_act_plain)
    g_f32 = grads(model32, group_norm.group_norm_act_plain)
    fn_vs_plain = chip_smoke._rel_l2(g_fn, g_plain)
    fn_vs_f32 = chip_smoke._rel_l2(g_fn, g_f32)
    plain_vs_f32 = chip_smoke._rel_l2(g_plain, g_f32)
    traj = {}
    for name, norm_act in (("fn", group_norm.group_norm_act),
                           ("plain", group_norm.group_norm_act_plain)):
        t = PortTrainer("resnet50", config=config, device="cpu",
                        learning_rate=chip_smoke.TRAIN_LR, seed=0)
        t.model.norm_act = norm_act
        traj[name] = [float(t.step(batch))
                      for _ in range(chip_smoke.TRAIN_STEPS)]
    gap = max(abs(a - b) for a, b in zip(traj["fn"], traj["plain"]))
    print(f"grads rel L2: function-vs-plain {fn_vs_plain:.3e}, "
          f"function-vs-f32 {fn_vs_f32:.3e}, plain-vs-f32 {plain_vs_f32:.3e};"
          f" trajectory gap {gap / traj['plain'][0]:.3e} of the first loss")
    bound = chip_smoke.GRADS_VS_F32_OVER_PLAIN * plain_vs_f32 + 0.02
    assert max(fn_vs_plain, fn_vs_f32) <= bound
    assert fn_vs_f32 <= chip_smoke.GRADS_BF16_VS_F32
    assert gap <= chip_smoke.TRAJECTORY_TOL * traj["plain"][0]
    assert traj["fn"][-1] < 0.5 * traj["fn"][0]


def test_planted_backward_faults_read_above_the_same_forward_gate(
        monkeypatch):
    """``chip_smoke.py``'s gate on the backward alone, on the CPU: a tiny
    bf16 ResNet's gradients with a fault planted in every norm's dx (a
    centering term added back, as ``chip_smoke._planted_fault`` does on
    the card) must read above ``GRADS_SAME_FORWARD`` from the true ones.
    On the CPU the ``autograd.Function`` calls the plain backward by name,
    so the fault wraps that."""
    import chip_smoke

    config = dataclasses.replace(port.Config.tiny(), dtype="bfloat16",
                                 width=16)
    batch = {k: torch.from_numpy(v)
             for k, v in port.example_batch(config, 4, seed=0).items()}
    model = port.make_model(config, seed=0)
    loss_fn = port.make_loss_fn(model, config)

    def grads():
        model.zero_grad(set_to_none=True)
        loss_fn(model, batch).backward()
        return {k: p.grad.float().clone() for k, p in model.named_parameters()}

    true = grads()
    plain = group_norm.group_norm_act_backward_plain
    monkeypatch.setattr(group_norm, "_launch_backward", plain)
    for drop in ("projection", "centering"):
        monkeypatch.setattr(group_norm, "group_norm_act_backward_plain",
                            chip_smoke._planted_fault(drop))
        faulty = grads()
        monkeypatch.setattr(group_norm, "group_norm_act_backward_plain",
                            plain)
        assert chip_smoke._rel_l2(faulty, true) > \
            chip_smoke.GRADS_SAME_FORWARD, drop
    assert chip_smoke._rel_l2(grads(), true) < 1e-6  # fault removed


# ---------------------------------------------------------------------------
# BatchNorm training (norm="batch"): flax's rule, the JAX Trainer's two
# data-parallel semantics, and predict without autograd
# ---------------------------------------------------------------------------

#: the BatchNorm oracles step SGD (optax.sgd / torch.optim.SGD, lr 0.1).
#: Under AdamW a leaf whose true gradient is exactly 0 steps ±lr on f32
#: rounding noise in both packages alike: the stem norm's bias channels
#: whose every max-pool window holds a positive value (the next convs are
#: 1×1 and their BatchNorms remove any shift of them) read |g| ≈ 1e-8 in
#: JAX, 1.8e-7 from the port's, and after 5 AdamW steps at lr 1e-3 sit
#: 2.4e-3 apart (measured on the CPU, tiny config, seed 0), while every
#: other leaf agrees within 1.2e-5.  SGD steps by lr·g, so that noise stays
#: noise (test_stem_bias_gradient_is_zero_under_batch_norm holds the zero).
BN_SGD_LR = 0.1


def _bn_jax_trainer(devices, mesh_config=None):
    import optax

    return JaxTrainer("resnet50", config=ref.Config.tiny("batch"),
                      mesh_config=mesh_config, seed=0, devices=devices,
                      optimizer=optax.sgd(BN_SGD_LR))


def _jax_bn_state(jax_t):
    return port.params_from_flax(
        jax.device_get(jax_t.state.params),
        jax.device_get(jax_t.state.collections["batch_stats"]))


def _split_mean_batch(i, n=BATCH):
    """Batch ``i`` with its second half shifted by +0.5: the halves' means
    differ, so per-half and whole-batch statistics differ."""
    b = ref.example_batch(ref.Config.tiny("batch"), n, seed=i)
    b["image"][n // 2:] += 0.5
    return b


def _flax_batch_norm_numpy(x, scale, bias, mean, var, train):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW ``x`` in
    numpy f64: ``(y, new running mean, new running var)``."""
    x = x.astype(np.float64)
    if train:
        mu = x.mean(axis=(0, 2, 3))
        v = np.maximum(0.0, (x * x).mean(axis=(0, 2, 3)) - mu * mu)
        mean, var = 0.9 * mean + 0.1 * mu, 0.9 * var + 0.1 * v
    else:
        mu, v = mean, var
    shape = (1, -1, 1, 1)
    y = ((x - mu.reshape(shape)) / np.sqrt(v.reshape(shape) + 1e-5)
         * scale.reshape(shape) + bias.reshape(shape))
    return y, mean, var


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("tail", ["plain", "residual_relu"])
def test_batch_norm_is_flax_s_rule_in_numpy(train, tail):
    """``_common.batch_norm`` in f32 against flax's rule in numpy f64: the
    output (normalised by the batch's biased statistics in training, by the
    running ones in eval), then the optional residual add and ReLU; the
    running statistics updated in place only in training, with momentum
    0.9 and the BIASED variance (not torch's unbiased running variance)."""
    from tensorflowonspark_torch.models import _common

    rng = np.random.RandomState(7)
    x = (rng.randn(4, 3, 5, 6) * 2 + 1.5).astype(np.float32)
    scale, bias = rng.rand(3).astype(np.float32) + 0.5, rng.randn(3).astype(
        np.float32)
    mean, var = rng.randn(3).astype(np.float32), rng.rand(3).astype(
        np.float32) + 0.5
    residual = rng.randn(*x.shape).astype(np.float32)
    want, want_mean, want_var = _flax_batch_norm_numpy(
        x, scale, bias, mean.astype(np.float64), var.astype(np.float64),
        train)
    if tail == "residual_relu":
        want = np.maximum(want + residual, 0.0)
    rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    got = _common.batch_norm(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        rm, rv, train,
        torch.from_numpy(residual) if tail == "residual_relu" else None,
        relu=tail == "residual_relu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rm.numpy(), want_mean, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rv.numpy(), want_var, rtol=1e-6, atol=1e-6)
    if train:  # torch's own running variance is the unbiased one
        n = x.shape[0] * x.shape[2] * x.shape[3]
        torch_var = 0.9 * var + 0.1 * x.astype(np.float64).var(
            axis=(0, 2, 3)) * n / (n - 1)
        assert np.abs(torch_var - want_var).max() > 1e-3


def test_batch_norm_one_process_matches_the_jax_global_view():
    """ResNet ``Config.tiny("batch")``: the port in one process against
    the JAX ``Trainer`` on ONE data shard (its monolithic step takes the
    whole batch's statistics), f32, from the same converted weights: 5
    steps' losses, then every parameter and running statistic, then
    ``predict`` over the running statistics, all within 1e-5."""
    jax_t = _bn_jax_trainer(jax.devices()[:1])
    assert jax_t.train_step.bucketed is False
    port_t = PortTrainer("resnet50", config=port.Config.tiny("batch"),
                         device="cpu", optimizer=lambda p: torch.optim.SGD(
                             p, lr=BN_SGD_LR))
    port.load_state(port_t.model, _jax_bn_state(jax_t))
    losses = np.array([(float(jax_t.step(b)), float(port_t.step(b)))
                       for b in map(_split_mean_batch, range(STEPS))])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=F32_LOSS_REL)
    want, got = _jax_bn_state(jax_t), port.state_of(port_t.model)
    for group in ("params", "collections"):
        w, g = ckpt._flatten(want[group]), ckpt._flatten(got[group])
        assert sorted(w) == sorted(g)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0,
                                       atol=F32_PARAMS_ABS, err_msg=k)
    batch = _split_mean_batch(9, 16)
    scores = port_t.predict(batch)
    assert not scores.requires_grad
    assert _rel_l2(scores.numpy(), np.asarray(jax_t.predict(batch))) < \
        F32_LOSS_REL


_BN_DP_WORKER = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
from tensorflowonspark_torch.models import resnet
from tensorflowonspark_torch.trainer import Trainer
torch.set_num_threads(1)
rank, world, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
state = np.load(sys.argv[5], allow_pickle=True).item()
if world > 1:
    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=world, rank=rank)
t = Trainer("resnet50", config=resnet.Config.tiny("batch"), device="cpu",
            optimizer=lambda p: torch.optim.SGD(p, lr=float(sys.argv[6])))
resnet.load_state(t.model, state)
losses = []
for b in np.load(sys.argv[7], allow_pickle=True):
    share = {k: v[rank * len(v) // world:(rank + 1) * len(v) // world]
             for k, v in b.items()}
    losses.append(float(t.step(share)))
out = resnet.state_of(t.model)
print(json.dumps({"losses": losses, "params": {
    k: v.ravel().tolist() for k, v in out["params"].items()},
    "stats": {k: v.ravel().tolist()
              for k, v in out["collections"]["batch_stats"].items()}}))
"""


def _run_bn_dp(world, tmp_path, state, batches):
    np.save(tmp_path / "state.npy", state, allow_pickle=True)
    np.save(tmp_path / "batches.npy", np.array(batches, dtype=object),
            allow_pickle=True)
    _, port_num = util.find_free_port("127.0.0.1")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BN_DP_WORKER, str(r), str(world),
         f"127.0.0.1:{port_num}", REPO, str(tmp_path / "state.npy"),
         str(BN_SGD_LR), str(tmp_path / "batches.npy")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=240)
        assert p.returncode == 0, stderr
        out.append(json.loads(stdout.strip().splitlines()[-1]))
    return out


def test_batch_norm_two_ranks_match_the_jax_bucketed_step(tmp_path):
    """Two gloo ranks, half of every batch each, against the JAX
    ``Trainer`` at ``dp=2``, whose default bucketed step normalises each
    shard by its own statistics and averages the loss, the gradients and
    every floating collection leaf across shards: the same losses,
    parameters and running statistics (the average of the ranks') within
    1e-5, on both ranks alike.  On batches whose halves' means differ, the
    one-process run (the global view) must differ from them."""
    from tensorflowonspark_tpu.parallel import MeshConfig

    jax_t = _bn_jax_trainer(jax.devices()[:2], MeshConfig(dp=2))
    assert jax_t.train_step.bucketed is True
    state = _jax_bn_state(jax_t)
    batches = [_split_mean_batch(i) for i in range(3)]
    want_losses = [float(jax_t.step(b)) for b in batches]
    want = _jax_bn_state(jax_t)
    ranks = _run_bn_dp(2, tmp_path, state, batches)
    [single] = _run_bn_dp(1, tmp_path, state, batches)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_losses,
                                   rtol=F32_LOSS_REL)
        for group, key in (("params", "params"), ("collections", "stats")):
            flat = (want["params"] if group == "params"
                    else want["collections"]["batch_stats"])
            for k, v in flat.items():
                np.testing.assert_allclose(r[key][k], np.ravel(v), rtol=0,
                                           atol=F32_PARAMS_ABS, err_msg=k)
    assert ranks[0]["stats"] == ranks[1]["stats"]
    assert ranks[0]["params"] == ranks[1]["params"]
    gap = max(float(np.abs(np.subtract(single["stats"][k],
                                       ranks[0]["stats"][k])).max())
              for k in single["stats"])
    assert gap > 1e-3  # per-rank statistics are not the global view's
    assert abs(single["losses"][0] - ranks[0]["losses"][0]) > 1e-4


def test_stem_bias_gradient_is_zero_under_batch_norm():
    """Why the BatchNorm oracles step SGD: channels of the stem norm's
    bias whose every max-pool window holds a positive value have a true
    gradient of 0 (the next convs are 1×1 and BatchNorms follow them), and
    both packages read it as f32 rounding noise of the same size: AdamW
    would step each by about ±lr on that noise."""
    from flax.core import meta

    from tensorflowonspark_tpu.models import _common as ref_common

    config = ref.Config.tiny("batch")
    module = ref.make_model(config)
    batch = ref.example_batch(config, BATCH, seed=0)
    variables = meta.unbox(module.init(jax.random.PRNGKey(0),
                                       batch["image"]))
    loss_fn = ref_common.make_stateful_classification_loss_fn(module)
    (_, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"], {"batch_stats": variables["batch_stats"]},
        batch)
    want = port.params_from_flax(jax.device_get(grads))["params"]
    model = port.load_state(port.make_model(config), port.params_from_flax(
        jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"])))
    port.make_loss_fn(model, config)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}).backward()
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    for k in want:  # f32: within 1e-5 of each leaf's largest gradient
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * float(
            np.abs(want[k]).max()), err_msg=k)
    bias = np.abs(want["norm.bias"])
    zero = bias < 1e-5 * bias.max()  # 2.4e-8 and 6.0e-8 of 1.8e-2
    assert zero.any() and (~zero).any()
    assert np.abs(got["norm.bias"][zero]).max() < 1e-5 * bias.max()


@pytest.mark.parametrize("name", ["mnist_mlp", "cifar10_cnn", "resnet50",
                                  "inception_v3", "mobilenet_v1",
                                  "wide_deep", "bert", "tiny_lm"])
def test_predict_never_requires_grad(name):
    """``Trainer.predict`` runs every zoo model's forward without autograd:
    no output leaf requires grad (the reference returns arrays)."""
    from tensorflowonspark_torch import models as zoo

    lib = zoo.get_model(name)
    t = PortTrainer(name, device="cpu")
    out = t.predict(lib.example_batch(t.config, batch_size=4))
    leaves = out if isinstance(out, (tuple, list)) else (
        out.values() if isinstance(out, dict) else (out,))
    assert all(not leaf.requires_grad for leaf in leaves)
    assert next(iter(leaves)).shape[0] == 4


def test_tiny_lm_trains_like_the_jax_trainer():
    """``Trainer("tiny_lm")`` against the JAX ``Trainer`` (one device, f32,
    AdamW with optax's defaults) from the same weights: 5 steps on one
    batch within 1e-5 and a falling loss; ``predict`` gives 16 rows that
    require no grad (reference ``tests/test_models.py``)."""
    from tensorflowonspark_torch.models import tinylm
    from tensorflowonspark_tpu.models import tinylm as ref_tinylm

    config = ref_tinylm.Config.tiny()
    jax_t = JaxTrainer("tiny_lm", config=config, learning_rate=1e-2, seed=0,
                       devices=jax.devices()[:1])
    port_t = PortTrainer("tiny_lm", config=tinylm.Config(
        **dataclasses.asdict(config)), learning_rate=1e-2, device="cpu")
    port_t.model.load_state_dict({
        k: torch.from_numpy(v) for k, v in tinylm.params_from_flax(
            jax.device_get(jax_t.state.params)).items()})
    batch = ref_tinylm.example_batch(config, batch_size=16)
    losses = np.array([(float(jax_t.step(batch)), float(port_t.step(batch)))
                       for _ in range(STEPS)])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=F32_LOSS_REL)
    assert losses[-1, 1] < losses[0, 1]
    want = tinylm.params_from_flax(jax.device_get(jax_t.state.params))
    for k, p in port_t.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0,
                                   atol=F32_PARAMS_ABS, err_msg=k)
    out = port_t.predict(batch)
    assert out.shape[0] == 16 and not out.requires_grad
    assert _rel_l2(out.numpy(), np.asarray(jax_t.predict(batch))) < \
        F32_LOSS_REL


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))
