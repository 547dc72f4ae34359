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

from tensorflowonspark_torch import util
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
