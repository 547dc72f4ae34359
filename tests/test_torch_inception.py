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


def test_batch_norm_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        port.make_model(port.Config(norm="batch"))


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
