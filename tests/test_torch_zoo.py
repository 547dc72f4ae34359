"""The port's MNIST MLP, CIFAR-10 CNN and MobileNet-v1 against the JAX
package's, on the same weights.

Flax weights are drawn with numpy from a seed in the shapes of the JAX
model's init (``jax.eval_shape``, no compile), carried across by each
module's ``params_from_flax`` and loaded into the port; both packages then
give the logits, the loss and (f32) every parameter's gradient of the same
batch.  The JAX side runs once per (model, config) and worker (a
module-scope cache).  The port's GroupNorm runs its plain twin here.
``tests/test_torch_inception.py`` does the same for Inception-v3 with the
helpers of this file.
"""

import dataclasses
import functools
import importlib

import jax
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import models
from tensorflowonspark_torch.kernels import group_norm
from tensorflowonspark_torch.models import cifar as port_cifar
from tensorflowonspark_torch.models import mnist as port_mnist
from tensorflowonspark_torch.models import mobilenet as port_mobilenet
from tensorflowonspark_tpu.models import cifar as ref_cifar
from tensorflowonspark_tpu.models import mnist as ref_mnist
from tensorflowonspark_tpu.models import mobilenet as ref_mobilenet

#: f32: the same arithmetic summed in another order
F32_REL = 1e-5
#: bf16: the two frameworks round at different places
BF16_REL = 2e-2
BF16_OVER_JAX = 1.25
BATCH = 4


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def flax_params(ref_lib, config, images, seed=0):
    """Numpy weights in the shapes of the JAX model's params: He-scaled
    kernels, and norm scales and every bias away from their init values
    so a mapping error shows."""
    module = ref_lib.make_model(config)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), images))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, s):
        s = s.unbox() if hasattr(s, "unbox") else s
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * np.sqrt(2 / fan_in)).astype(
                np.float32)
        if "scale" in name:
            return (1 + 0.2 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    from flax.core import meta

    return module, jax.tree_util.tree_map_with_path(draw, meta.unbox(shapes))


def image_batch(config, batch=BATCH, seed=1, flat=False):
    rng = np.random.RandomState(seed)
    shape = ((config.image_size ** 2,) if flat
             else (config.image_size, config.image_size, 3))
    return {"image": rng.rand(batch, *shape).astype(np.float32),
            "label": rng.randint(0, config.num_classes,
                                 size=batch).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def jax_side(ref_name: str, config, flat: bool = False, grads: bool = True):
    """The JAX package's params, logits, loss and (with ``grads``) the
    loss's gradients, all numpy, for ``config`` on :func:`image_batch`."""
    ref_lib = importlib.import_module(f"tensorflowonspark_tpu.models."
                                      f"{ref_name}")
    batch = image_batch(config, flat=flat)
    module, params = flax_params(ref_lib, config, batch["image"])
    logits = jax.jit(lambda p, x: module.apply({"params": p}, x))(
        params, batch["image"])
    loss_fn = ref_lib.make_loss_fn(module, config)
    if grads:
        loss, g = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
        g = jax.tree_util.tree_map(np.asarray, g)
    else:
        loss, g = jax.jit(loss_fn)(params, batch), None
    return params, np.asarray(logits), float(loss), g


def port_side(port_lib, config, params, batch, norm_act=None):
    """The port's logits, loss and gradients by parameter name on
    ``params`` (a flax tree, converted)."""
    pconfig = port_lib.Config(**dataclasses.asdict(config))
    model = port_lib.load_state(port_lib.make_model(pconfig),
                                port_lib.params_from_flax(params))
    if norm_act is not None:
        model.norm_act = norm_act
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = port_lib.make_forward_fn(model, pconfig)(model, tbatch)
    loss = port_lib.make_loss_fn(model, pconfig)(model, tbatch)
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return logits, float(loss.detach()), grads


def rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def tree_rel(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    return (num / sum(float(np.sum(want[k] ** 2)) for k in want)) ** 0.5


def check_parity(ref_name, port_lib, config, flat=False):
    """f32 (and f64): logits, loss and every gradient within ``F32_REL``
    (rel L2, and per-leaf max |Δ| of the largest gradient).  bf16: the
    loss within ``BF16_REL``, and the logits within ``BF16_REL`` or, where
    the JAX package's own bf16 logits lie further than that from its f32
    ones (a deep net's roundings), no further from those f32 logits than
    ``BF16_OVER_JAX`` times that distance."""
    bf16 = config.dtype == "bfloat16"
    params, want_logits, want_loss, want_grads = jax_side(
        ref_name, config, flat, grads=not bf16)
    logits, loss, grads = port_side(port_lib, config, params,
                                    image_batch(config, flat=flat))
    # f32 logits but where the reference's head computes in the dtype
    # (the MLP's)
    assert str(logits.dtype) == f"torch.{want_logits.dtype}"
    logits, want_logits = logits.float().numpy(), want_logits.astype(
        np.float32)
    assert logits.shape == want_logits.shape == (BATCH, config.num_classes)
    tol = BF16_REL if bf16 else F32_REL
    assert np.all(np.isfinite(logits))
    assert abs(loss - want_loss) / abs(want_loss) < tol
    if bf16:
        if rel(logits, want_logits) >= BF16_REL:
            f32 = jax_side(ref_name, dataclasses.replace(
                config, dtype="float32"), flat, grads=False)[1]
            jax_gap = rel(want_logits, f32)
            assert jax_gap > BF16_REL
            assert rel(logits, f32) <= BF16_OVER_JAX * jax_gap
        return logits, grads
    assert rel(logits, want_logits) < tol
    want = port_lib.params_from_flax(want_grads)["params"]
    assert tree_rel(grads, want) < tol
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k in want:
        np.testing.assert_allclose(grads[k], want[k], rtol=0,
                                   atol=tol * scale, err_msg=k)
    return logits, grads


def count_norm_calls(model, image_shape, **forward_kwargs):
    """The norm calls of one forward of ``model`` on the ``meta`` device
    (no FLOPs), as ``(C, H, W, groups, relu)``."""
    calls = []

    def count(x, gamma, beta, groups, eps, residual=None, relu=True):
        assert residual is None
        calls.append((*x.shape[1:], groups, relu))
        return torch.zeros_like(x)

    model.norm_act = count
    model(torch.zeros(*image_shape, device="meta"), **forward_kwargs)
    return calls


def meta_model(port_lib, config):
    with torch.device("meta"):
        return port_lib.make_model(config)


# ---------------------------------------------------------------------------
# MNIST MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mnist_mlp_matches_jax(dtype):
    config = dataclasses.replace(ref_mnist.Config.tiny(), dtype=dtype)
    check_parity("mnist", port_mnist, config, flat=True)


def test_mnist_mlp_full_width_matches_jax():
    """784 → 128 → 64 → 10, the acceptance config's widths."""
    check_parity("mnist", port_mnist, ref_mnist.Config(), flat=True)


# ---------------------------------------------------------------------------
# CIFAR-10 CNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cifar10_cnn_matches_jax(dtype):
    config = dataclasses.replace(ref_cifar.Config.tiny(), dtype=dtype)
    check_parity("cifar", port_cifar, config)


def test_cifar10_cnn_makes_6_norm_calls():
    model = meta_model(port_cifar, port_cifar.Config())
    calls = count_norm_calls(model, (2, 32, 32, 3))
    assert [c[:4] for c in calls] == [
        (64, 32, 32, 8), (64, 32, 32, 8), (128, 16, 16, 8),
        (128, 16, 16, 8), (256, 8, 8, 8), (256, 8, 8, 8)]
    assert all(relu for *_, relu in calls)


# ---------------------------------------------------------------------------
# MobileNet-v1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mobilenet_v1_matches_jax(dtype):
    config = dataclasses.replace(ref_mobilenet.Config.tiny(), dtype=dtype)
    check_parity("mobilenet", port_mobilenet, config)


def test_mobilenet_published_shapes_and_width_mult():
    """At 224 the published stride schedule ends at 7×7×1024 before the
    pool (the ``meta`` device: no FLOPs); depthwise kernels are one filter
    a channel; 27 norm calls a forward; the width multiplier scales
    channels in multiples of 8."""
    config = port_mobilenet.Config()
    model = meta_model(port_mobilenet, config)
    assert tuple(model.pw[12].weight.shape) == (1024, 1024, 1, 1)
    assert tuple(model.dw[12].weight.shape) == (1024, 1, 3, 3)
    calls = count_norm_calls(model, (2, 224, 224, 3))
    assert len(calls) == 27
    assert calls[0][:3] == (32, 112, 112) and calls[-1][:3] == (1024, 7, 7)
    assert port_mobilenet._scaled(1024, 0.25) == 256
    assert port_mobilenet._scaled(32, 0.25) == 8
    assert port_mobilenet._scaled(64, 0.1) == 8  # floor
    model.norm_act = lambda x, *a, **k: x
    assert tuple(model(torch.zeros(2, 224, 224, 3, device="meta")).shape) \
        == (2, 1000)


# ---------------------------------------------------------------------------
# Converters and the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ref_lib,port_lib,flat", [
    (ref_mnist, port_mnist, True), (ref_cifar, port_cifar, False),
    (ref_mobilenet, port_mobilenet, False)], ids=["mnist", "cifar",
                                                  "mobilenet"])
def test_converter_maps_every_leaf_and_rejects_others(ref_lib, port_lib,
                                                      flat):
    """At full width: the converted params are the port model's names and
    shapes, nothing missing or extra; a leaf of an unknown module, or an
    unknown leaf of a known one, raises."""
    config = ref_lib.Config()
    images = image_batch(config, batch=1, flat=flat)["image"]
    _, params = flax_params(ref_lib, config, images)
    state = port_lib.params_from_flax(params)
    model = meta_model(port_lib, port_lib.Config())
    assert {k: v.shape for k, v in state["params"].items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert port_lib.config_from_state(state) == port_lib.Config()
    first = sorted(params)[0]
    with pytest.raises(KeyError, match="Extra_0"):
        port_lib.params_from_flax(dict(params, Extra_0={"kernel": np.zeros(
            (2, 2))}))
    with pytest.raises(KeyError, match=f"{first}/w"):
        port_lib.params_from_flax(dict(params, **{first: dict(
            params[first], w=np.zeros(3))}))


def test_zoo_registers_the_four_models():
    assert models.get_model("mnist_mlp") is port_mnist
    assert models.get_model("cifar10_cnn") is port_cifar
    assert models.get_model("mobilenet_v1") is port_mobilenet
    assert models.get_model("inception_v3").__name__ == (
        "tensorflowonspark_torch.models.inception")
    assert models.get_model("bert").__name__ == (
        "tensorflowonspark_torch.models.bert")
    assert models.available() == sorted(
        ["mnist_mlp", "cifar10_cnn", "resnet50", "inception_v3",
         "mobilenet_v1", "wide_deep", "bert"])
    with pytest.raises(KeyError, match="not yet ported"):
        models.get_model("tiny_lm")


@pytest.mark.parametrize("name", ["mnist_mlp", "cifar10_cnn",
                                  "mobilenet_v1"])
def test_trainer_steps_and_state_round_trips(name):
    """The zoo surface ``Trainer`` and ``TFModel`` call: a few AdamW steps
    at the tiny config lower the loss, the state round-trips through
    ``state_of``/``load_state``/``config_from_state``, and the serving
    model (``meta``, the norm as ``torch.ops.tfos.group_norm_act``) bound
    to the state by ``functional_call`` gives the eager forward's logits."""
    from tensorflowonspark_torch import saved_model
    from tensorflowonspark_torch.trainer import Trainer

    t = Trainer(name, learning_rate=1e-2, device="cpu")
    batch = t.module_lib.example_batch(t.config, batch_size=8)
    losses = [float(t.step(batch)) for _ in range(4)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    lib = t.module_lib
    state = lib.state_of(t.model)
    assert lib.config_from_state(state) == t.config
    again = lib.load_state(lib.make_model(t.config, seed=1), state)
    images = {"image": torch.from_numpy(batch["image"])}
    want = lib.make_forward_fn(t.model, t.config)(t.model, images)
    np.testing.assert_array_equal(
        lib.make_forward_fn(again, t.config)(again, images), want)
    serve = saved_model.wrap_state_forward(lib.serving_forward,
                                           lib.make_serving_model(t.config))
    tensors = {"params": {k: torch.from_numpy(v)
                          for k, v in state["params"].items()}}
    np.testing.assert_allclose(serve(tensors, images), want, rtol=1e-6,
                               atol=1e-6)


def test_seeded_init_is_flax_shaped():
    """He-normal convs (fan-in 9 for a depthwise kernel), LeCun-normal
    heads, zero biases and unit norm scales, the same for the same seed."""
    a = port_mobilenet.state_of(port_mobilenet.make_model(
        port_mobilenet.Config.tiny(), seed=3))["params"]
    b = port_mobilenet.state_of(port_mobilenet.make_model(
        port_mobilenet.Config.tiny(), seed=3))["params"]
    assert all(np.array_equal(a[k], b[k]) for k in a)
    dw = port_mobilenet.make_model(port_mobilenet.Config(), seed=0).dw[10]
    std = float(dw.weight.detach().std())
    assert abs(std - np.sqrt(2 / 9)) < 0.05 * np.sqrt(2 / 9)
    np.testing.assert_array_equal(a["norms.0.scale"], 1.0)
    np.testing.assert_array_equal(a["classifier.bias"], 0.0)
    cifar = port_cifar.state_of(port_cifar.make_model(
        port_cifar.Config.tiny()))["params"]
    np.testing.assert_array_equal(cifar["convs.0.bias"], 0.0)


def test_group_norm_plain_twin_is_what_the_cpu_runs():
    """On the CPU the models' ``norm_act`` computes the plain twin: the
    same logits with it set explicitly."""
    config = port_cifar.Config.tiny()
    model = port_cifar.make_model(config)
    images = torch.from_numpy(image_batch(config)["image"])
    with torch.no_grad():
        want = model(images)
        model.norm_act = group_norm.group_norm_act_plain
        np.testing.assert_array_equal(model(images), want)
