"""The port's Inception-v3 against the JAX package's, on the same weights.

Both variants at their tiny configs: the default (``SAME`` everywhere, no
aux head) and the canonical published net (``VALID`` stem and reductions,
the aux head's cross-entropy weighted 0.4 into the loss), for the logits,
the loss and every parameter's gradient; and the full-width canonical net
forward at 139², in f32.  The helpers and tolerances are
``tests/test_torch_zoo.py``'s; the JAX side is compiled once per config
and worker.  The rest runs the port alone on the ``meta`` device (shapes,
norm calls, the converter at full width: no FLOPs).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import ckpt
from tensorflowonspark_torch.models import inception as port
from tensorflowonspark_tpu.models import inception as ref
from test_torch_zoo import (F32_REL, check_parity, count_norm_calls,
                            flax_params, image_batch, jax_side, meta_model,
                            port_side, rel)


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def test_tiny_f32_matches_jax_with_gradients():
    """The default variant: logits, loss and every gradient within
    1e-5."""
    check_parity("inception", port, ref.Config.tiny())


def test_tiny_canonical_matches_jax_with_gradients():
    """The canonical variant, its loss with the aux term: logits and loss
    in f32, and every gradient, the aux head's included, in f64 (JAX's
    x64 mode and the plain twin's f64), all within 1e-5.  In f32 its
    gradients can differ where a ReLU input lies within the frameworks'
    1e-6 forward gap of 0 and the mask flips: at the seed here one such
    element (6.5e-6, the second InceptionB's 1×7 conv) moves the
    gradients by rel 2.8e-3."""
    config = ref.Config.tiny_canonical()
    params, want_logits, want_loss, _ = jax_side("inception", config,
                                                 grads=False)
    logits, loss, _ = port_side(port, config, params, image_batch(config))
    assert rel(logits.detach().numpy(), want_logits) < F32_REL
    assert abs(loss - want_loss) / want_loss < F32_REL
    with jax.enable_x64(True):
        _, grads = check_parity("inception", port, dataclasses.replace(
            config, dtype="float64"))
    assert any(k.startswith("aux.") for k in grads)
    assert all(float(np.abs(grads[k]).max()) > 0 for k in grads)


def test_tiny_bf16_matches_jax():
    config = dataclasses.replace(ref.Config.tiny(), dtype="bfloat16")
    check_parity("inception", port, config)


def test_canonical_loss_is_main_plus_weighted_aux():
    """The canonical loss is CE(logits) + 0.4·CE(aux) of the train
    forward, whose logits are the eval forward's."""
    config = port.Config.tiny_canonical()
    model = port.make_model(config, seed=2)
    batch = port.example_batch(config, batch_size=2, seed=3)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = model(t["image"], train=True)
        loss = port.make_loss_fn(model, config)(model, t)
        np.testing.assert_array_equal(model(t["image"]), logits)
    ce = torch.nn.functional.cross_entropy
    labels = t["label"].long()
    assert float(loss) == pytest.approx(
        float(ce(logits, labels) + 0.4 * ce(aux, labels)), rel=1e-6)


def test_full_width_canonical_f32_forward_matches_jax():
    """Inception-v3 at its published widths (groups 32, 1000 classes),
    canonical, at 139² and batch 1: converter, padding and tower-order
    errors show here."""
    config = dataclasses.replace(ref.Config(canonical=True), image_size=139,
                                 dtype="float32")
    images = np.random.RandomState(5).rand(1, 139, 139, 3).astype(np.float32)
    module, params = flax_params(ref, config, images)
    want = np.asarray(jax.jit(lambda p, x: module.apply({"params": p}, x))(
        params, images))
    state = port.params_from_flax(params)
    model = port.load_state(port.make_model(port.Config(
        **dataclasses.asdict(config))), state)
    got = port.make_forward_fn(model, config)(
        model, {"image": torch.from_numpy(images)}).numpy()
    assert got.shape == want.shape == (1, 1000)
    # f32 through 94 norms and convs summed in another order
    assert rel(got, want) < 10 * F32_REL
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=10 * F32_REL * np.abs(want).max())


def _stage_shapes(model, size):
    """(C, H, W) after the stem, each reduction and the last tower, from
    forward hooks on the ``meta`` device."""
    out = {}

    def hook(name):
        return lambda _m, _i, y: out.__setitem__(name, tuple(y.shape[1:]))

    handles = [model.inception_a[0].register_forward_hook(
        lambda _m, i, _y: out.__setitem__("stem", tuple(i[0].shape[1:])))]
    for name in ("reduction_a", "reduction_b"):
        handles.append(getattr(model, name).register_forward_hook(
            hook(name)))
    handles.append(model.inception_c[1].register_forward_hook(hook("last")))
    count_norm_calls(model, (2, size, size, 3))
    for h in handles:
        h.remove()
    return out


def test_canonical_stem_shapes_and_norm_calls():
    """The published net at 299: VALID stem 299 → 149 → 147 → 147 → 73 →
    71 → 35, reductions 35 → 17 → 8; 94 norm calls a forward, 96 in
    training (the aux head's 1×1 over 5×5×768 → 128 and its 5×5 VALID
    conv leaving 1×1×768), the aux logits (B, classes)."""
    model = meta_model(port, port.Config(canonical=True))
    stem = [c[:3] for c in count_norm_calls(model, (2, 299, 299, 3))[:5]]
    assert stem == [(32, 149, 149), (32, 147, 147), (64, 147, 147),
                    (80, 73, 73), (192, 71, 71)]
    assert _stage_shapes(model, 299) == {
        "stem": (192, 35, 35), "reduction_a": (768, 17, 17),
        "reduction_b": (1280, 8, 8), "last": (2048, 8, 8)}
    served = count_norm_calls(model, (2, 299, 299, 3))
    trained = count_norm_calls(model, (2, 299, 299, 3), train=True)
    assert len(served) == 94 and len(trained) == 96
    # stem 5, InceptionA 3 x 7, ReductionA 4, InceptionB 4 x 10: then aux
    assert trained[70:72] == [(128, 5, 5, 32, True), (768, 1, 1, 32, True)]
    assert trained[:70] + trained[72:] == served
    model.norm_act = lambda x, *a, **k: x
    logits, aux_logits = model(torch.zeros(2, 299, 299, 3, device="meta"),
                               train=True)
    assert tuple(logits.shape) == tuple(aux_logits.shape) == (2, 1000)
    assert tuple(model(torch.zeros(2, 299, 299, 3,
                                   device="meta")).shape) == (2, 1000)


def test_same_variant_shapes_and_group_widths():
    """The default variant: SAME halvings 299 → 150 → 75 → 38 → 19 → 10,
    94 norm calls in training too (no aux head), and the reference's
    ``gn_groups`` — channels per group 1 to 24 at Inception's widths."""
    model = meta_model(port, port.Config())
    calls = count_norm_calls(model, (2, 299, 299, 3), train=True)
    assert len(calls) == 94
    assert [c[:3] for c in calls[:5]] == [
        (32, 150, 150), (32, 150, 150), (64, 150, 150), (80, 75, 75),
        (192, 75, 75)]
    assert _stage_shapes(model, 299) == {
        "stem": (192, 38, 38), "reduction_a": (768, 19, 19),
        "reduction_b": (1280, 10, 10), "last": (2048, 10, 10)}
    cpg = {c: c // g for c, _h, _w, g, _ in calls}
    assert cpg == {32: 1, 48: 2, 64: 2, 80: 4, 96: 3, 160: 5, 192: 6,
                   320: 10, 384: 12, 448: 14, 128: 4}
    canonical = count_norm_calls(meta_model(port, port.Config(
        canonical=True)), (1, 299, 299, 3), train=True)
    assert {c: c // g for c, _h, _w, g, _ in canonical}[768] == 24


def test_converter_maps_every_leaf_at_full_width():
    """Every leaf of the full canonical net's params (aux head included)
    lands on the port model's name and shape by call order; an unknown
    module or leaf raises."""
    config = ref.Config(canonical=True)
    images = np.zeros((1, 299, 299, 3), np.float32)
    module = ref.make_model(config)
    from flax.core import meta

    shapes = meta.unbox(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), images))["params"])
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    state = port.params_from_flax(params)
    model = meta_model(port, port.Config(canonical=True))
    assert {k: v.shape for k, v in state["params"].items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert port.config_from_state(state) == port.Config(canonical=True)
    # call order, not sorted order: ConvNorm_10 is the tenth ConvNorm
    k = params["InceptionB_2"]["ConvNorm_8"]["Conv_0"]["kernel"]
    assert state["params"]["inception_b.2.cn.8.conv.weight"].shape == (
        k.shape[3], k.shape[2], k.shape[0], k.shape[1]) == (192, 160, 1, 7)
    for bad in ({"Extra_0": {"kernel": np.zeros((2, 2))}},
                {"InceptionA_3": params["InceptionA_2"]},
                {"aux": dict(params["aux"], Dense_1={"bias": np.zeros(2)})},
                {"Dense_0": dict(params["Dense_0"], w=np.zeros(3))}):
        with pytest.raises(KeyError, match="unmapped flax"):
            port.params_from_flax(dict(params, **bad))


@pytest.mark.parametrize("variant", ["tiny", "tiny_canonical"])
def test_batch_norm_trains_and_serves(variant):
    """``Trainer("inception_v3", config=Config(norm="batch"))`` trains both
    tiny variants (the canonical one through its aux loss, whose head's
    statistics update too); the state carries every norm's running mean
    and var as ``batch_stats``, ``config_from_state`` finds the BatchNorm
    config, and the serving model bound to params and statistics gives
    ``predict``'s logits, which require no grad."""
    from tensorflowonspark_torch import saved_model
    from tensorflowonspark_torch.trainer import Trainer

    config = dataclasses.replace(getattr(port.Config, variant)(),
                                 norm="batch")
    t = Trainer("inception_v3", config=config, learning_rate=1e-3,
                device="cpu")
    stats = t.state.collections["batch_stats"]
    assert len(stats) == 2 * sum(
        isinstance(m, port._common.BatchNorm) for m in t.model.modules())
    assert not any(isinstance(m, port._common.GroupNorm)
                   for m in t.model.modules())
    batch = port.example_batch(config, batch_size=4)
    losses = [float(t.step(batch)) for _ in range(3)]
    assert np.all(np.isfinite(losses))
    moved = [k for k, v in stats.items() if not torch.equal(
        v, torch.zeros_like(v) if k.endswith(".mean") else
        torch.ones_like(v))]
    assert sorted(moved) == sorted(stats)  # the aux head's included
    state = port.state_of(t.model)
    assert sorted(state["collections"]["batch_stats"]) == sorted(stats)
    assert port.config_from_state(state) == config
    want = t.predict(batch)
    assert not want.requires_grad
    serve = saved_model.wrap_state_forward(port.serving_forward,
                                           port.make_serving_model(config))
    got = serve({"params": {k: torch.from_numpy(v)
                            for k, v in state["params"].items()},
                 "collections": {"batch_stats": {
                     k: torch.from_numpy(v) for k, v in
                     state["collections"]["batch_stats"].items()}}},
                {"image": torch.from_numpy(batch["image"])})
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _bf16_statistics(plain):
    """A planted summation-precision fault, in ``_common.batch_norm``'s
    place: in training the batch's mean and biased variance kept in bf16
    (autograd through them); eval as ``plain``."""
    def batch_norm(x, scale, bias, running_mean, running_var, train,
                   residual=None, relu=True):
        if not train:
            return plain(x, scale, bias, running_mean, running_var, False,
                         residual, relu)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        mean, var = (mean.bfloat16().to(x.dtype),
                     var.bfloat16().to(x.dtype))
        port._common.update_running_(running_mean, running_var,
                                     mean.detach(),
                                     torch.rsqrt(var.detach() + 1e-5))
        shape = (1, -1, 1, 1)
        y = ((x - mean.view(shape))
             * (torch.rsqrt(var + 1e-5) * scale).view(shape)
             + bias.view(shape))
        if residual is not None:
            y = residual + y
        return torch.relu(y) if relu else y

    return batch_norm


#: the port's f32 step from the f64 answer against the JAX package's own:
#: the f32 rounding of either is a draw whose size moves with the order of
#: its sums (the port's one step, tiny config: gradients 1.4e-1 from f64
#: on one thread, 4.9e-3 on four; JAX's 3.0e-2), so the bound is an order
#: of magnitude
F32_ERROR_OVER_JAX = 10


@pytest.mark.parametrize("variant", ["tiny", "tiny_canonical"])
def test_batch_norm_step_matches_the_jax_trainer_in_f64(variant):
    """One step of the port's ``Trainer`` against the JAX ``Trainer`` on
    one data shard (the whole batch's statistics), SGD, from the same
    weights, in f64 (JAX's x64 mode; the f32 heads of both round alike):
    the loss (the canonical one with its aux term), every parameter after
    the step (so every gradient), every running statistic, then
    ``predict`` over them, within 1e-5.

    One step, not five: at these sizes the last stages' BatchNorms see 4
    values a channel (1×1 at batch 4; the canonical aux head too), where
    gradients reach 9e2 and training is chaotic.  In f64 the first step's
    gradients agree within 3.4e-7 of each leaf's largest (the f32 heads'
    rounding), and the losses part from the second step on (rel 1e-5 at
    step 2, 1e-1 by step 5, SGD at lr 1e-2 or 1e-3, also at 64² and batch
    16); in f32 the first train-mode forward already sits 1e-3 apart.

    So in f32 the same step is held to the JAX package's own f32 error:
    the JAX ``Trainer``'s f32 step sits above 1e-5 from its f64 answer in
    the loss, and the port's f32 step sits within ``F32_ERROR_OVER_JAX``
    times JAX's own f32 distance in the loss, the gradients (the step's
    change of every parameter, rel L2) and the change of every running
    statistic (rel L2).  Measured on the CPU on one thread, JAX f32 /
    port f32 from JAX f64: tiny, loss 9.8e-4 / 6.3e-4, gradients 3.0e-2 /
    1.4e-1, statistics 7.2e-4 / 6.2e-4; canonical, 2.4e-5 / 3.3e-5, 3.5e-2
    / 4.8e-2, 6.2e-5 / 7.2e-5.  With the statistics kept in bf16 planted
    in the port's BatchNorm (a summation-precision fault) every reading
    is above the bound (tiny: 1.6e-1, 1.1, 2.6e-1; canonical: 2.2e-3,
    1.2, 5.6e-2)."""
    import optax

    from tensorflowonspark_torch.trainer import Trainer
    from tensorflowonspark_tpu.trainer import Trainer as JaxTrainer

    lr = 1e-2
    config = dataclasses.replace(getattr(ref.Config, variant)(),
                                 norm="batch", dtype="float64")
    batch = ref.example_batch(config, 4, seed=0)
    probe = ref.example_batch(config, 4, seed=1)
    with jax.enable_x64(True):
        jax_t = JaxTrainer("inception_v3", config=config, seed=0,
                           devices=jax.devices()[:1],
                           optimizer=optax.sgd(lr))
        start = port.params_from_flax(
            jax.device_get(jax_t.state.params),
            jax.device_get(jax_t.state.collections["batch_stats"]))
        want_loss = float(jax_t.step(batch))
        want = port.params_from_flax(
            jax.device_get(jax_t.state.params),
            jax.device_get(jax_t.state.collections["batch_stats"]))
        want_scores = np.asarray(jax_t.predict(probe))
    t = Trainer("inception_v3", config=port.Config(
        **dataclasses.asdict(config)), device="cpu",
        optimizer=lambda p: torch.optim.SGD(p, lr=lr))
    port.load_state(t.model, start)
    loss = float(t.step(batch))
    got = port.state_of(t.model)
    assert abs(loss - want_loss) <= F32_REL * abs(want_loss)
    for group in ("params", "collections"):
        w, g = ckpt._flatten(want[group]), ckpt._flatten(got[group])
        assert sorted(w) == sorted(g)
        for k in w:
            scale = max(float(np.abs(w[k]).max()), 1.0)
            assert float(np.abs(g[k] - w[k]).max()) <= F32_REL * scale, k
    assert any(k.startswith("aux.") for k in got["collections"][
        "batch_stats"]) == config.canonical
    assert rel(t.predict(probe).numpy(), want_scores) < F32_REL

    # f32: the port's step within an order of JAX's own f32 error
    f32 = dataclasses.replace(config, dtype="float32")
    jax_t = JaxTrainer("inception_v3", config=f32, seed=0,
                       devices=jax.devices()[:1], optimizer=optax.sgd(lr))
    start32 = port.params_from_flax(jax.device_get(jax_t.state.params))
    for k, v in start["params"].items():
        np.testing.assert_array_equal(start32["params"][k], v)
    jax_loss = float(jax_t.step(batch))
    jax_state = port.params_from_flax(
        jax.device_get(jax_t.state.params),
        jax.device_get(jax_t.state.collections["batch_stats"]))

    def port_step(planted=False):
        t = Trainer("inception_v3", config=port.Config(
            **dataclasses.asdict(f32)), device="cpu",
            optimizer=lambda p: torch.optim.SGD(p, lr=lr))
        port.load_state(t.model, start)
        plain = port._common.batch_norm
        if planted:
            port._common.batch_norm = _bf16_statistics(plain)
        try:
            return float(t.step(batch)), port.state_of(t.model)
        finally:
            port._common.batch_norm = plain

    def change(tree):
        return {group: {k: v - ckpt._flatten(start[group])[k]
                        for k, v in ckpt._flatten(tree[group]).items()}
                for group in ("params", "collections")}

    def rel_l2(got, want):
        assert sorted(got) == sorted(want)
        num = sum(float(((got[k] - want[k]).astype(np.float64) ** 2).sum())
                  for k in want)
        den = sum(float((want[k].astype(np.float64) ** 2).sum())
                  for k in want)
        return float(np.sqrt(num / den))

    def gaps(loss, got):
        got, ref_change = change(got), change(want)
        return {"loss": abs(loss - want_loss) / abs(want_loss),
                "gradients": rel_l2(got["params"], ref_change["params"]),
                "statistics": rel_l2(got["collections"],
                                     ref_change["collections"])}

    own = gaps(jax_loss, jax_state)
    assert own["loss"] > F32_REL
    got = gaps(*port_step())
    for k, v in got.items():
        assert v <= F32_ERROR_OVER_JAX * own[k], (k, v, own[k])
    planted = gaps(*port_step(planted=True))
    assert all(planted[k] > F32_ERROR_OVER_JAX * own[k] for k in own), (
        planted, own)


@pytest.mark.parametrize("variant", ["tiny", "tiny_canonical"])
def test_trainer_steps_and_serving_model_agree(variant):
    """``Trainer`` trains both tiny variants (AdamW, the canonical one
    through its aux loss); the serving model bound to the state gives the
    eager forward's logits; ``config_from_state`` finds the variant."""
    from tensorflowonspark_torch import saved_model
    from tensorflowonspark_torch.trainer import Trainer

    config = getattr(port.Config, variant)()
    t = Trainer("inception_v3", config=config, learning_rate=1e-2,
                device="cpu")
    batch = port.example_batch(config, batch_size=4)
    losses = [float(t.step(batch)) for _ in range(3)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    state = port.state_of(t.model)
    assert port.config_from_state(state).canonical == config.canonical
    images = {"image": torch.from_numpy(batch["image"])}
    want = port.make_forward_fn(t.model, config)(t.model, images)
    serve = saved_model.wrap_state_forward(port.serving_forward,
                                           port.make_serving_model(config))
    got = serve({"params": {k: torch.from_numpy(v)
                            for k, v in state["params"].items()}}, images)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
