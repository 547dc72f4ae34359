"""The port's ResNet against the JAX package's, on the same weights.

Flax weights are drawn with numpy from a seed in the shapes of the JAX
model's init (``jax.eval_shape``, no compile), converted with
``resnet.params_from_flax`` and loaded into the port; both forwards then
score the same NHWC images.  The port's GroupNorm runs its plain twin here.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax.core import meta

from tensorflowonspark_torch.models import resnet as port
from tensorflowonspark_tpu.models import resnet as ref


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One intra-op thread (and OMP_NUM_THREADS=1 for spawned executors):
    the suite runs in several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _flax_variables(config, images, seed=0, fill=None):
    """Numpy weights in the shapes of the JAX model's variables: He-scaled
    kernels, and scale/bias/mean/var away from their init values so a
    mapping error shows.  ``fill="index"`` gives each leaf the constant of
    its position instead (cheap, and still distinct per leaf)."""
    module = ref.make_model(config)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), images))
    rng = np.random.RandomState(seed)
    index = iter(range(1, 1 << 20))

    def draw(path, s):
        if fill == "index":
            return np.full(s.shape, next(index), np.float32)
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * np.sqrt(2 / fan_in)).astype(
                np.float32)
        if "var" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if "scale" in name:
            return (1 + 0.2 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return module, jax.tree_util.tree_map(np.asarray, variables)


def _both(config, batch=2, seed=0):
    size = config.image_size
    images = np.random.RandomState(seed + 1).rand(
        batch, size, size, 3).astype(np.float32)
    module, variables = _flax_variables(config, images, seed)
    want = np.asarray(jax.jit(module.apply)(variables, images))
    state = port.params_from_flax(variables["params"],
                                  variables.get("batch_stats"))
    pconfig = port.Config(**dataclasses.asdict(config))
    model = port.load_state(port.make_model(pconfig), state)
    got = port.make_forward_fn(model, pconfig)(
        model, {"image": torch.from_numpy(images)})
    assert got.dtype == torch.float32
    return got.numpy(), want, state


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_tiny_f32_matches_jax(norm):
    got, want, _ = _both(ref.Config.tiny(norm))
    assert got.shape == want.shape == (2, 10)
    # same f32 arithmetic, reduced in another order (measured ~2e-7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_tiny_bf16_matches_jax():
    got, want, _ = _both(dataclasses.replace(ref.Config.tiny(),
                                             dtype="bfloat16"))
    # bf16 compute rounds at other places in the two frameworks (the port
    # rounds a fused norm+add once); measured rel 2.5e-3
    assert np.all(np.isfinite(got))
    assert _rel(got, want) < 2e-2


def test_full_width_f32_matches_jax():
    """ResNet-50 at its real widths (stages (3, 4, 6, 3), width 64, groups
    32, 1000 classes) at 64² — converter and padding errors show here."""
    config = dataclasses.replace(ref.Config(), image_size=64, dtype="float32")
    got, want, state = _both(config)
    assert len(state["params"]) == 161
    assert got.shape == (2, 1000)
    # f32 through 53 norms and convs summed in another order (measured
    # rel 4e-6)
    assert _rel(got, want) < 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def test_converter_maps_every_leaf_by_block_number():
    config = ref.Config()
    images = np.zeros((1, 32, 32, 3), np.float32)
    _module, variables = _flax_variables(config, images, fill="index")
    state = port.params_from_flax(variables["params"])  # boxed, as init gives
    params = meta.unbox(variables["params"])
    with torch.device("meta"):
        model = port.ResNet(port.Config())
    assert {k: tuple(v.shape) for k, v in state["params"].items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert len(state["params"]) == 161
    # Bottleneck_10 sorts before Bottleneck_2 but must land on block 10
    k = params["Bottleneck_10"]["Conv_1"]["kernel"]
    np.testing.assert_array_equal(
        state["params"]["blocks.10.conv1.weight"], k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["params"]["head.weight"],
                                  params["Dense_0"]["kernel"].T)
    # strict load: nothing missing, nothing extra
    port.load_state(port.ResNet(port.Config.tiny()), port.params_from_flax(
        _flax_variables(ref.Config.tiny(), np.zeros((1, 16, 16, 3),
                                                     np.float32))[1]["params"]))

    extra = dict(params, Extra_0={"kernel": np.zeros((1, 1))})
    with pytest.raises(KeyError, match="Extra_0"):
        port.params_from_flax(extra)
    bad = dict(params, Dense_0=dict(params["Dense_0"], w=np.zeros(3)))
    with pytest.raises(KeyError, match="Dense_0/w"):
        port.params_from_flax(bad)


@pytest.mark.parametrize("size,k,stride,pads", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)), (64, 7, 2, (2, 3)),
])
def test_same_padding_is_xla_same(size, k, stride, pads):
    assert port.same_pads(size, k, stride) == pads


def test_resnet50_makes_53_norm_calls():
    calls = []
    with torch.device("meta"):
        model = port.ResNet(port.Config())

    def count(x, gamma, beta, groups, eps, residual=None, relu=True):
        calls.append((residual is not None, relu))
        return torch.zeros_like(x)

    model.norm_act = count
    with torch.inference_mode():
        model(torch.zeros(1, 32, 32, 3, device="meta"))
    assert len(calls) == 53
    assert calls.count((True, True)) == 16  # block ends
    assert calls.count((False, False)) == 4  # projection shortcuts
    assert calls.count((False, True)) == 33  # stem + two per block


def test_seeded_init_is_deterministic():
    a = port.state_of(port.make_model(port.Config.tiny(), seed=5))["params"]
    b = port.state_of(port.make_model(port.Config.tiny(), seed=5))["params"]
    c = port.state_of(port.make_model(port.Config.tiny(), seed=6))["params"]
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["conv.weight"], c["conv.weight"])
    np.testing.assert_array_equal(a["norm.scale"], 1.0)
    np.testing.assert_array_equal(a["head.bias"], 0.0)
