"""The port's MNIST MLP, CIFAR-10 CNN, MobileNet-v1 and tiny_lm against the
JAX package's, on the same weights.

Flax weights are drawn with numpy from a seed in the shapes of the JAX
model's init (``jax.eval_shape``, no compile), carried across by each
module's ``params_from_flax`` and loaded into the port; both packages then
give the logits, the loss and (f32) every parameter's gradient of the same
batch.  The JAX side runs once per (model, config) and worker (a
module-scope cache).  The port's GroupNorm runs its plain twin here.
``tests/test_torch_inception.py`` does the same for Inception-v3 with the
helpers of this file.
"""

import collections
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import models
from tensorflowonspark_torch.kernels import group_norm
from tensorflowonspark_torch.kernels import paged_attention as pa
from tensorflowonspark_torch.models import cifar as port_cifar
from tensorflowonspark_torch.models import mnist as port_mnist
from tensorflowonspark_torch.models import mobilenet as port_mobilenet
from tensorflowonspark_torch.models import tinylm as port_tinylm
from tensorflowonspark_tpu.models import cifar as ref_cifar
from tensorflowonspark_tpu.models import mnist as ref_mnist
from tensorflowonspark_tpu.models import mobilenet as ref_mobilenet
from tensorflowonspark_tpu.models import tinylm as ref_tinylm

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
    assert models.get_model("tiny_lm").__name__ == (
        "tensorflowonspark_torch.models.tinylm")
    assert models.available() == sorted(
        ["mnist_mlp", "cifar10_cnn", "resnet50", "inception_v3",
         "mobilenet_v1", "wide_deep", "bert", "tiny_lm"])


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


# ---------------------------------------------------------------------------
# tiny_lm: the decode surface and its paged-KV twins
# ---------------------------------------------------------------------------
#
# The port's ``models/tinylm.py`` against the JAX package's on the same
# weights (``params_from_flax``) and the same pools, drawn with numpy.  On
# the CPU ``kernels/paged_attention.py`` runs its plain twins; the CUDA
# kernels are held against them on the card
# (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 17).
# Tolerances: the two frameworks sum the f32 products and softmaxes in
# other orders, about 1e-7 apart at these widths; pools and logits are held
# within 1e-5 (page 0, the trash page, excluded: several positions may
# write one place of it and the winner is undefined), tokens exactly.

LM_TOL = 1e-5
LM_CFG = port_tinylm.Config.tiny()
LM_REF_CFG = ref_tinylm.Config.tiny()
PS = 8
P = LM_CFG.max_len // PS
NUM_PAGES = 1 + 4 * P


@pytest.fixture(scope="module")
def lm_weights():
    """The reference's init at seed 1: the JAX dict and the port's."""
    rp = ref_tinylm.init_params(LM_REF_CFG, seed=1)
    pp = port_tinylm.params_from_flax(jax.tree_util.tree_map(np.asarray, dict(rp)))
    return rp, {k: torch.from_numpy(v) for k, v in pp.items()}


def _pools(seed=0):
    rng = np.random.RandomState(seed)
    shape = ref_tinylm.kv_pool_shape(LM_REF_CFG, NUM_PAGES, PS)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _tables(rows):
    """``(len(rows), P)`` int32 tables: row i maps ``rows[i]`` pages."""
    out = np.zeros((len(rows), P), np.int32)
    for i, pages in enumerate(rows):
        out[i, :len(pages)] = pages
    return out


def _close(jax_out, torch_out, skip_trash=False):
    a = np.asarray(jax_out)
    b = torch_out.numpy() if isinstance(torch_out, torch.Tensor) else \
        np.asarray(torch_out)
    if skip_trash:
        a, b = a[:, 1:], b[:, 1:]
    return float(np.abs(a - b).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the model surface -------------------------------------------------------


def test_configs_match_the_reference():
    for pc, rc in ((port_tinylm.Config(), ref_tinylm.Config()),
                   (port_tinylm.Config.tiny(), ref_tinylm.Config.tiny()),
                   (port_tinylm.Config.draft_for(port_tinylm.Config()),
                    ref_tinylm.Config.draft_for(ref_tinylm.Config()))):
        assert pc.__dict__ == rc.__dict__
    assert port_tinylm.kv_pool_shape(LM_CFG, 9, 8) == ref_tinylm.kv_pool_shape(LM_REF_CFG, 9, 8)
    assert port_tinylm.SEQUENCE_AXES == ref_tinylm.SEQUENCE_AXES


def test_model_carries_the_reference_names_and_shapes(lm_weights):
    rp, _ = lm_weights
    model = port_tinylm.make_model(LM_CFG, seed=0)
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert got == {k: tuple(np.shape(v)) for k, v in rp.items()}
    init = port_tinylm.init_params(LM_CFG, seed=0)
    assert all(torch.equal(init[k], v) for k, v in model.named_parameters())
    assert all(float(v.std()) == pytest.approx(0.02, rel=0.2)
               for k, v in init.items() if k.startswith("w"))
    assert all(torch.all(v == 1) for k, v in init.items()
               if k.startswith("ln"))


def test_example_batch_is_the_references():
    a = port_tinylm.example_batch(LM_CFG, batch_size=3, seed=4, seq_len=9)
    b = ref_tinylm.example_batch(LM_REF_CFG, batch_size=3, seed=4, seq_len=9)
    assert a.keys() == b.keys()
    assert np.array_equal(a["tokens"], b["tokens"])


def test_params_from_flax_rejects_unknown_and_nested_leaves(lm_weights):
    rp, _ = lm_weights
    flat = jax.tree_util.tree_map(np.asarray, dict(rp))
    with pytest.raises(KeyError, match="extra_0"):
        port_tinylm.params_from_flax(dict(flat, extra_0=np.zeros(3)))
    with pytest.raises(KeyError, match="lnf"):
        port_tinylm.params_from_flax(dict(flat, lnf={"scale": np.zeros(3)}))


def test_apply_tokens_forward_and_loss_match_jax(lm_weights):
    rp, tp = lm_weights
    tokens = port_tinylm.example_batch(LM_CFG, batch_size=3, seed=2, seq_len=13)
    want = ref_tinylm.apply_tokens(rp, jnp.asarray(tokens["tokens"]), LM_REF_CFG)
    got = port_tinylm.apply_tokens(tp, _t(tokens["tokens"]), LM_CFG)
    assert _close(want, got) <= LM_TOL
    model = port_tinylm.make_model(LM_CFG)
    with torch.no_grad():
        for k, v in model.named_parameters():
            v.copy_(tp[k])
    fwd = port_tinylm.make_forward_fn(model, LM_CFG)(model, {"tokens": _t(
        tokens["tokens"])})
    assert torch.equal(fwd.detach(), got)
    module = ref_tinylm.make_model(LM_REF_CFG)
    ref_loss = ref_tinylm.make_loss_fn(module, LM_REF_CFG)(rp, tokens)
    port_loss = port_tinylm.make_loss_fn(model, LM_CFG)(model, {"tokens": _t(
        tokens["tokens"])})
    assert abs(float(ref_loss) - port_loss.item()) <= LM_TOL


# -- the incremental functions against JAX -----------------------------------


#: (start_lens, chunk_lens, pages a row maps): a full chunk from 0, a chunk
#: after a one-page prefix crossing into the next page, an idle row, and a
#: row whose positions run past max_len - 1 (clipped there)
CHUNK_ROWS = [
    (0, 16, [1, 2]),
    (8, 11, [3, 4, 5]),
    (0, 0, []),
    (58, 16, [6, 7, 8, 9, 10, 11, 12, 13]),
]


@pytest.mark.parametrize("L", [8, 16])
def test_prefill_chunk_fn_matches_jax(lm_weights, L):
    rp, tp = lm_weights
    rng = np.random.RandomState(L)
    C = len(CHUNK_ROWS)
    tokens = rng.randint(0, LM_CFG.vocab_size, size=(C, L)).astype(np.int32)
    starts = np.array([r[0] for r in CHUNK_ROWS], np.int32)
    lens = np.minimum(np.array([r[1] for r in CHUNK_ROWS], np.int32), L)
    tables = _tables([r[2] for r in CHUNK_ROWS])
    kp, vp = _pools(L)
    lg, kr, vr = ref_tinylm.prefill_chunk_fn(
        rp, jnp.asarray(tokens), jnp.asarray(starts), jnp.asarray(lens),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        config=LM_REF_CFG, page_size=PS)
    k2, v2 = _t(kp.copy()), _t(vp.copy())
    lg2, kout, vout = port_tinylm.prefill_chunk_fn(
        tp, _t(tokens), _t(starts), _t(lens), k2, v2, _t(tables),
        config=LM_CFG, page_size=PS)
    assert kout is k2 and vout is v2  # written in place
    live = lens > 0
    assert _close(np.asarray(lg)[live], lg2[live]) <= LM_TOL
    assert lg2.dtype == torch.float32 and lg2.shape == (C, LM_CFG.vocab_size)
    assert _close(kr, k2, skip_trash=True) <= LM_TOL
    assert _close(vr, v2, skip_trash=True) <= LM_TOL
    assert np.array_equal(np.asarray(lg)[live].argmax(-1),
                          lg2.numpy()[live].argmax(-1))


def test_prefill_chunk_rows_sharing_prefix_pages_read_them_only(lm_weights):
    """Two rows map the same prefix page (prefix sharing) and write only
    their private pages: the shared page is never written."""
    rp, tp = lm_weights
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, LM_CFG.vocab_size, size=(2, 8)).astype(np.int32)
    starts = np.array([8, 8], np.int32)
    lens = np.array([8, 5], np.int32)
    tables = _tables([[1, 2], [1, 3]])
    kp, vp = _pools(3)
    lg, kr, vr = ref_tinylm.prefill_chunk_fn(
        rp, jnp.asarray(tokens), jnp.asarray(starts), jnp.asarray(lens),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        config=LM_REF_CFG, page_size=PS)
    k2, v2 = _t(kp.copy()), _t(vp.copy())
    lg2, _, _ = port_tinylm.prefill_chunk_fn(tp, _t(tokens), _t(starts), _t(lens),
                                      k2, v2, _t(tables), config=LM_CFG,
                                      page_size=PS)
    assert np.array_equal(k2[:, 1].numpy(), kp[:, 1])  # shared, untouched
    assert _close(lg, lg2) <= LM_TOL
    assert _close(kr, k2, skip_trash=True) <= LM_TOL


def test_decode_fn_matches_jax(lm_weights):
    """Active slots mid-page and at a page's last position, an idle slot
    (zero table, seq_len 0), a slot at max_len - 1 and one past it
    (clipped there), two slots sharing a prefix page."""
    rp, tp = lm_weights
    rng = np.random.RandomState(7)
    seq = np.array([3, 0, 7, 63, 70, 9], np.int32)
    tables = _tables([[1], [], [2], list(range(6, 14)),
                      list(range(14, 22)), [2, 23]])
    tokens = rng.randint(0, LM_CFG.vocab_size, size=(len(seq),)).astype(
        np.int32)
    kp, vp = _pools(7)
    nt, kr, vr = ref_tinylm.decode_fn(rp, jnp.asarray(tokens), jnp.asarray(seq),
                               jnp.asarray(kp), jnp.asarray(vp),
                               jnp.asarray(tables), config=LM_REF_CFG,
                               page_size=PS)
    k2, v2 = _t(kp.copy()), _t(vp.copy())
    nt2, _, _ = port_tinylm.decode_fn(tp, _t(tokens), _t(seq), k2, v2, _t(tables),
                               config=LM_CFG, page_size=PS)
    assert nt2.dtype == torch.int32
    assert np.array_equal(np.asarray(nt), nt2.numpy())
    assert _close(kr, k2, skip_trash=True) <= LM_TOL
    assert _close(vr, v2, skip_trash=True) <= LM_TOL


@pytest.mark.parametrize("plen,bucket,pages", [(11, 16, [3, 5]),
                                               (1, 8, [4]),
                                               (9, 16, [2, 6])])
def test_prefill_fn_matches_jax(lm_weights, plen, bucket, pages):
    """The legacy one-prompt prefill: the same first token and every
    allocated page's K/V (padded positions inside them included)."""
    rp, tp = lm_weights
    rng = np.random.RandomState(plen)
    tokens = np.zeros((bucket,), np.int32)
    tokens[:plen] = rng.randint(0, LM_CFG.vocab_size, size=(plen,))
    row = _tables([pages])[0]
    kp, vp = _pools(plen)
    nt, kr, vr = ref_tinylm.prefill_fn(rp, jnp.asarray(tokens),
                                jnp.asarray(plen, jnp.int32),
                                jnp.asarray(kp), jnp.asarray(vp),
                                jnp.asarray(row), config=LM_REF_CFG,
                                page_size=PS)
    k2, v2 = _t(kp.copy()), _t(vp.copy())
    nt2, _, _ = port_tinylm.prefill_fn(tp, _t(tokens),
                                torch.tensor(plen, dtype=torch.int32), k2,
                                v2, _t(row), config=LM_CFG, page_size=PS)
    assert int(nt2) == int(nt) and nt2.dtype == torch.int32
    assert _close(kr, k2, skip_trash=True) <= LM_TOL
    assert _close(vr, v2, skip_trash=True) <= LM_TOL


#: verify rows ``(seq_len, step_len, pages)`` at k = 4 (L = 5): full
#: mid-page, crossing a page, idle (step 0, zero table), partial, a slot
#: whose last position is max_len - 1, two slots sharing a prefix page
#: (page 2, read only)
VERIFY_ROWS = [(3, 5, [1]), (6, 5, [16, 17]), (0, 0, []),
               (17, 2, [4, 5, 6]), (59, 5, list(range(7, 15))),
               (9, 3, [2, 15]), (12, 4, [2, 3])]


def test_verify_fn_matches_jax(lm_weights):
    """``verify_fn`` against the reference's on the same weights and pools:
    the logits of every valid position (t < step_lens; the others read
    the trash page, whose content is undefined) and both pools outside the
    trash page within 1e-5, the argmax exactly."""
    rp, tp = lm_weights
    rng = np.random.RandomState(23)
    S, L = len(VERIFY_ROWS), 5
    tokens = rng.randint(0, LM_CFG.vocab_size, size=(S, L)).astype(np.int32)
    seq = np.array([r[0] for r in VERIFY_ROWS], np.int32)
    steps = np.array([r[1] for r in VERIFY_ROWS], np.int32)
    tables = _tables([r[2] for r in VERIFY_ROWS])
    kp, vp = _pools(23)
    lg, kr, vr = ref_tinylm.verify_fn(
        rp, jnp.asarray(tokens), jnp.asarray(seq), jnp.asarray(steps),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        config=LM_REF_CFG, page_size=PS)
    k2, v2 = _t(kp.copy()), _t(vp.copy())
    lg2, kout, vout = port_tinylm.verify_fn(
        tp, _t(tokens), _t(seq), _t(steps), k2, v2, _t(tables),
        config=LM_CFG, page_size=PS)
    assert kout is k2 and vout is v2  # written in place
    assert lg2.dtype == torch.float32
    assert lg2.shape == (S, L, LM_CFG.vocab_size)
    valid = np.arange(L)[None, :] < steps[:, None]
    assert _close(np.asarray(lg)[valid], lg2.numpy()[valid]) <= LM_TOL
    assert np.array_equal(np.asarray(lg)[valid].argmax(-1),
                          lg2.numpy()[valid].argmax(-1))
    assert _close(kr, k2, skip_trash=True) <= LM_TOL
    assert _close(vr, v2, skip_trash=True) <= LM_TOL
    assert np.array_equal(k2[:, 2].numpy(), kp[:, 2])  # shared, unwritten
    assert np.array_equal(v2[:, 2].numpy(), vp[:, 2])


def test_verify_columns_are_successive_decode_steps(lm_weights):
    """Column t of one verify call is the decode step that takes column
    t's token t steps later: the same greedy token at every position and
    the same pools (1e-5), whatever the drafted tokens."""
    _, tp = lm_weights
    rng = np.random.RandomState(29)
    rows = [r for r in VERIFY_ROWS if r[1] == 5]
    S, L = len(rows), 5
    tokens = rng.randint(0, LM_CFG.vocab_size, size=(S, L)).astype(np.int32)
    seq = np.array([r[0] for r in rows], np.int32)
    tables = _tables([r[2] for r in rows])
    kp, vp = _pools(29)
    kv, vv = _t(kp.copy()), _t(vp.copy())
    lg, _, _ = port_tinylm.verify_fn(
        tp, _t(tokens), _t(seq), _t(np.full((S,), L, np.int32)), kv, vv,
        _t(tables), config=LM_CFG, page_size=PS)
    kd, vd = _t(kp.copy()), _t(vp.copy())
    for t in range(L):
        nt, _, _ = port_tinylm.decode_fn(
            tp, _t(tokens[:, t].copy()), _t(seq + t), kd, vd, _t(tables),
            config=LM_CFG, page_size=PS)
        assert np.array_equal(nt.numpy(), lg[:, t].argmax(-1).numpy())
    assert float((kv - kd)[:, 1:].abs().max()) <= LM_TOL
    assert float((vv - vd)[:, 1:].abs().max()) <= LM_TOL


def test_copy_page_fn_matches_jax():
    kp, vp = _pools(11)
    kr, vr = ref_tinylm.copy_page_fn(jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(3, jnp.int32),
                              jnp.asarray(7, jnp.int32))
    k2, v2 = _t(kp.copy()), _t(vp.copy())
    port_tinylm.copy_page_fn(k2, v2, torch.tensor(3, dtype=torch.int32),
                      torch.tensor(7, dtype=torch.int32))
    assert np.array_equal(np.asarray(kr), k2.numpy())
    assert np.array_equal(np.asarray(vr), v2.numpy())


def test_greedy_steps_continue_the_full_forward(lm_weights):
    """Chunked prefill then decode steps through the pool give the greedy
    continuation ``apply_tokens`` recomputes in full each token."""
    _, tp = lm_weights
    rng = np.random.RandomState(19)
    prompt = rng.randint(0, LM_CFG.vocab_size, size=(13,)).astype(np.int32)
    kp, vp = (torch.zeros(port_tinylm.kv_pool_shape(LM_CFG, NUM_PAGES, PS))
              for _ in range(2))
    table = _t(_tables([[5, 2, 9, 4]]))
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :13] = prompt
    lg, _, _ = port_tinylm.prefill_chunk_fn(
        tp, _t(tokens), torch.zeros(1, dtype=torch.int32),
        torch.tensor([13], dtype=torch.int32), kp, vp, table, config=LM_CFG,
        page_size=PS)
    got = [int(lg[0].argmax())]
    for n in range(13, 13 + 12):
        nt, _, _ = port_tinylm.decode_fn(
            tp, torch.tensor(got[-1:], dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32), kp, vp, table,
            config=LM_CFG, page_size=PS)
        got.append(int(nt[0]))
    seq = list(prompt)
    want = []
    for _ in range(len(got)):
        logits = port_tinylm.apply_tokens(tp, torch.tensor([seq]), LM_CFG)
        want.append(int(logits[0, -1].argmax()))
        seq.append(want[-1])
    assert got == want


# -- the plain twins against the reference math ------------------------------


def _twin_case(seed, R=5, L=4, H=2, K=16, num_pages=12):
    rng = np.random.RandomState(seed)
    pools = [rng.randn(2, num_pages, PS, H, K).astype(np.float32)
             for _ in range(2)]
    q, k, v = (rng.randn(R, L, H, K).astype(np.float32) for _ in range(3))
    tables = np.zeros((R, 4), np.int32)
    tables[0, :2] = [1, 2]       # crosses a page boundary below
    tables[1, :2] = [1, 3]       # shares page 1 with row 0
    tables[3, :4] = [4, 5, 6, 7]  # runs to max_len - 1
    tables[4, :1] = [11]
    start = np.array([6, 8, 0, 30, 2], np.int32)  # row 2 inactive
    lens = np.array([4, 3, 0, 4, 1], np.int32)
    return pools, q, k, v, tables, start, lens


def test_kv_append_plain_is_the_reference_scatter():
    (kp, vp), _, k, v, tables, start, lens = _twin_case(0)
    max_len = 4 * PS
    pos = np.minimum(start[:, None] + np.arange(4)[None], max_len - 1)
    valid = np.arange(4)[None] < lens[:, None]
    pages = np.where(valid, np.take_along_axis(tables, pos // PS, 1), 0)
    want_k = jnp.asarray(kp).at[1, pages, pos % PS].set(k)
    k2, v2 = _t(kp.copy()), _t(vp.copy())
    pa.kv_append(k2, v2, 1, _t(k), _t(v), _t(tables), _t(start), _t(lens),
                 max_len=max_len)
    assert np.array_equal(np.asarray(want_k)[:, 1:], k2.numpy()[:, 1:])
    assert np.array_equal(kp[0], k2[0].numpy())  # another layer untouched
    # lens None: every position valid (the decode step's)
    k3, v3 = _t(kp.copy()), _t(vp.copy())
    pa.kv_append(k3, v3, 0, _t(k[:, :1]), _t(v[:, :1]), _t(tables),
                 _t(start), None, max_len=max_len)
    p0 = np.minimum(start, max_len - 1)
    pg = tables[np.arange(5), p0 // PS]
    for r in range(5):
        if pg[r]:
            assert np.array_equal(k3[0, pg[r], p0[r] % PS].numpy(),
                                  k[r, 0])
            assert np.array_equal(v3[0, pg[r], p0[r] % PS].numpy(),
                                  v[r, 0])


def test_kv_append_plain_drops_a_page_outside_the_pool():
    (kp, vp), _, k, v, tables, start, lens = _twin_case(1)
    tables[4, 0] = 99
    k2, v2 = _t(kp.copy()), _t(vp.copy())
    pa.kv_append(k2, v2, 0, _t(k), _t(v), _t(tables), _t(start), _t(lens),
                 max_len=4 * PS)
    assert torch.isfinite(k2).all()


def _attend_reference(q, kp, vp, layer, tables, start, max_len, scale):
    """float64 loops: query (r, t, h) over j <= min(start + t, max_len-1)."""
    R, L, H, K = q.shape
    out = np.zeros((R, L, H, K))
    for r in range(R):
        for t in range(L):
            p = min(start[r] + t, max_len - 1)
            js = np.arange(p + 1)
            pages = tables[r, js // PS]
            kk = kp[layer, pages, js % PS].astype(np.float64)  # (n, H, K)
            vv = vp[layer, pages, js % PS].astype(np.float64)
            for h in range(H):
                s = kk[:, h] @ q[r, t, h].astype(np.float64) * scale
                w = np.exp(s - s.max())
                out[r, t, h] = (w / w.sum()) @ vv[:, h]
    return out


def _long_twin_case(seed, R=3, L=4, H=2, K=16, width=64):
    """Rows of ``width`` pages of ``PS`` (up to 512 positions): one mid
    table, one ending at max_len - 1 (its queries clamped there), one
    inactive; pages drawn without replacement."""
    rng = np.random.RandomState(seed)
    num_pages = 1 + 2 * width
    pools = [rng.randn(2, num_pages, PS, H, K).astype(np.float32)
             for _ in range(2)]
    q = rng.randn(R, L, H, K).astype(np.float32)
    tables = np.zeros((R, width), np.int32)
    tables[:2] = rng.permutation(np.arange(1, num_pages)).reshape(2, width)
    start = np.array([301, width * PS - 2, 0], np.int32)[:R]
    return pools, q, tables, start


@pytest.mark.parametrize("L,pages", [pytest.param(1, 4, id="1"),
                                     pytest.param(4, 4, id="4"),
                                     pytest.param(1, 64, id="long1"),
                                     pytest.param(4, 64, id="long4")])
def test_paged_attention_plain_is_the_reference_softmax(L, pages):
    if pages == 4:
        (kp, vp), q, _, _, tables, start, _ = _twin_case(2)
    else:  # P = 64 pages of 8 a row
        (kp, vp), q, tables, start = _long_twin_case(2)
    q = q[:, :L].copy()
    scale = 1 / np.sqrt(q.shape[-1])
    want = _attend_reference(q, kp, vp, 1, tables, start, pages * PS, scale)
    got = pa.paged_attention(_t(q), _t(kp), _t(vp), 1, _t(tables),
                             _t(start), max_len=pages * PS)
    assert float(np.abs(got.numpy() - want).max()) <= LM_TOL
    assert got.shape == q.shape and got.dtype == torch.float32


# -- the attention kernel's launch plan (pure Python) -------------------------


@pytest.mark.parametrize("max_len", [64, 128, 1024])
@pytest.mark.parametrize("K", [16, 32, 64, 128])
@pytest.mark.parametrize("L", [1, 4, 16, 32, 128])
def test_attention_plan_covers_every_query_once(L, K, max_len):
    """At the engine's row count, 8, and at 1 and 256 rows (the plan
    shrinks its query tile on small grids): the blocks, decoded as the
    kernel decodes ``blockIdx.x``, serve every (row, query, head) exactly
    once; the plan's shared memory is its layout's and fits 48 KB, or 227
    KB with the attribute flagged; an instantiation exists for it."""
    H, page_size = 4, 16
    for R in (1, 8, 256):
        p = pa.plan(R, L, H, K, page_size, max_len)
        seen = collections.Counter()
        for b in range(p.blocks):
            r, h, t0, n = pa.block_queries(p, R, L, H, b)
            assert 1 <= n <= p.q_tile
            seen.update((r, t, h) for t in range(t0, t0 + n))
        assert len(seen) == R * L * H and set(seen.values()) == {1}
        assert min(seen) == (0, 0, 0) and max(seen) == (R - 1, L - 1, H - 1)
        pages = -(-max_len // page_size)
        assert p.smem == pa._smem(p.q_tile, p.pos_tile, K, pages)
        assert p.smem <= (pa._SMEM_MAX if p.big_smem else pa._SMEM_DEFAULT)
        assert p.big_smem == (p.smem > pa._SMEM_DEFAULT)
        assert (p.score_rows, p.score_cols, p.out_rows) in pa._KERNEL_SHAPES
        assert p.threads == 128
        assert p.score_cols * 32 == p.pos_tile
        assert (p.q_tile == 1) == (L == 1)
        assert p.pos_tile % (4 * p.splits) == 0  # whole float4s a split
        assert p.splits == 1 or p.out_rows == 1  # split groups hold 1 query


@pytest.mark.parametrize("L", [1, 5, 16, 39, 128])
@pytest.mark.parametrize("R", [1, 3, 8, 37, 256])
def test_append_plan_covers_every_item_once(R, L):
    """The append's warps, decoded as the kernel decodes them, move every
    (row, position) exactly once, odd ``R * L`` (spare warps in the last
    block) included; the grid is the least that holds them."""
    p = pa.append_plan(R, L, 4, 32)
    warps = p.threads // 32
    seen = collections.Counter(
        pa.append_warp_item(p, R, L, b, w)
        for b in range(p.blocks) for w in range(warps))
    spare = seen.pop(None, 0)
    assert set(seen.values()) == {1}
    assert set(seen) == {(r, t) for r in range(R) for t in range(L)}
    assert spare == p.blocks * warps - R * L < warps  # no idle block


def test_append_grid_depends_on_the_shapes_alone():
    """``append_plan`` takes the shapes and nothing else (so a CUDA graph
    replays its grid with new ``start`` values), the same plan every call,
    and the blocks follow ``R * L``."""
    import inspect

    assert list(inspect.signature(pa.append_plan).parameters) == [
        "R", "L", "H", "K"]
    for R, L in ((8, 1), (8, 32), (256, 128), (1024, 128)):
        p = pa.append_plan(R, L, 4, 32)
        assert p == pa.append_plan(R, L, 4, 32)
        assert p.blocks == -(-(R * L) // (p.threads // 32))
    # the head split does not move the grid, only the row width
    assert pa.append_plan(8, 16, 4, 32) == pa.append_plan(8, 16, 1, 128)


def test_append_plan_for_tinylm_moves_an_item_a_warp():
    """``tinylm.Config()``'s shapes (4 heads of 32: a float4 of K and of V a
    lane): the decode step, the chunk rungs and 256 x 128 take a warp an
    item in blocks of 128 threads."""
    cfg = port_tinylm.Config()
    H, K = cfg.n_heads, cfg.dim // cfg.n_heads
    assert H * K == 128
    for R, L, blocks in ((8, 1, 2), (8, 16, 32), (8, 32, 64),
                         (256, 128, 8192), (1024, 128, 32768)):
        assert pa.append_plan(R, L, H, K) == pa.AppendPlan(128, blocks)


@pytest.mark.parametrize("args,match", [
    ((8, 1, 3, 5), "multiple of 4"),
    ((8, 1, 1, 18), "multiple of 4"),
    ((8, 1, 1, 2), "multiple of 4"),
    ((0, 1, 4, 32), "empty"),
    ((8, 0, 4, 32), "empty"),
    ((8, 1, 0, 32), "empty"),
    ((8, 1, 4, 0), "empty"),
    ((2 ** 16, 2 ** 15, 4, 32), "items"),
    ((1, 1, 2 ** 16, 2 ** 15), "items"),
])
def test_append_plan_refuses_what_the_kernel_cannot_take(args, match):
    with pytest.raises(ValueError, match=match):
        pa.append_plan(*args)


def test_attention_plan_for_tinylm_needs_no_opt_in():
    """``tinylm.Config()``'s shapes (4 heads of 32, pages of 16, 128
    positions) plan under the 48 KB default: the decode step, every chunk
    rung of the engine, and 256 rows of 128 causal positions; the engine's
    steps get enough blocks to spread over the card."""
    cfg = port_tinylm.Config()
    H, K = cfg.n_heads, cfg.dim // cfg.n_heads
    for R, L in ((8, 1), (8, 16), (8, 32), (256, 128), (1, 64)):
        p = pa.plan(R, L, H, K, 16, cfg.max_len)
        assert not p.big_smem, (R, L, p)
    assert pa.plan(8, 1, H, K, 16, 128).q_tile == 1
    assert pa.plan(8, 32, H, K, 16, 128).q_tile == 4
    assert pa.plan(256, 128, H, K, 16, 128).q_tile == 32


@pytest.mark.parametrize("shape,match", [
    ((8, 1, 4, 18, 16, 128), "multiple of 4"),
    ((8, 1, 4, 132, 16, 128), "head_dim"),
    ((8, 1, 4, 0, 16, 128), "head_dim"),
    ((0, 1, 4, 32, 16, 128), "empty"),
    ((8, 1, 4, 32, 1, 70000), "shared memory"),
    ((2 ** 20, 4096, 2 ** 10, 32, 16, 4096), "blocks"),
])
def test_attention_plan_refuses_what_the_kernel_cannot_take(shape, match):
    with pytest.raises(ValueError, match=match):
        pa.plan(*shape)


@pytest.mark.parametrize("tiles", [(3, 64, 32), (16, 48, 32), (64, 64, 32),
                                   (32, 32, 128), (16, 32, 32), (0, 64, 32)])
def test_attention_tiles_without_a_kernel_are_refused(tiles):
    """A tile the kernel has no instantiation or layout for raises before
    any launch (the entry would refuse it too)."""
    q_tile, pos_tile, head_dim = tiles
    with pytest.raises(ValueError, match="no kernel"):
        pa.tiled(4, 32, 4, head_dim, 16, 128, q_tile, pos_tile)


def test_paged_attention_reads_nothing_past_the_causal_bound():
    """Positions beyond p add exactly nothing: poisoning them (finite, as
    the twin's masked lm_weights are 0 and 0 * NaN is NaN) leaves every
    output bit unchanged.  The card test poisons the kernel's with NaN."""
    (kp, vp), q, _, _, tables, start, _ = _twin_case(3)
    got = pa.paged_attention(_t(q), _t(kp), _t(vp), 0, _t(tables),
                             _t(start), max_len=4 * PS)
    poisoned_k, poisoned_v = kp.copy(), vp.copy()
    r, p = 4, start[4] + 3  # row 4 sees positions 0..5 of page 11
    poisoned_k[0, 11, p + 1:] = 1e4
    poisoned_v[0, 11, p + 1:] = -1e4
    again = pa.paged_attention(_t(q), _t(poisoned_k), _t(poisoned_v), 0,
                               _t(tables), _t(start), max_len=4 * PS)
    assert torch.isfinite(again[r]).all()
    assert torch.equal(got[r], again[r])


def test_wrappers_count_nothing_on_the_cpu_and_refuse_mixed_devices():
    (kp, vp), q, k, v, tables, start, lens = _twin_case(4)
    before = (pa.launches, dict(pa.launches_by_kernel))
    pa.kv_append(_t(kp), _t(vp), 0, _t(k), _t(v), _t(tables), _t(start),
                 _t(lens), max_len=4 * PS)
    pa.paged_attention(_t(q), _t(kp), _t(vp), 0, _t(tables), _t(start),
                       max_len=4 * PS)
    assert (pa.launches, pa.launches_by_kernel) == before
    meta = torch.empty(q.shape, device="meta")
    with pytest.raises(ValueError, match="one device"):
        pa.paged_attention(meta, _t(kp), _t(vp), 0, _t(tables), _t(start),
                           max_len=4 * PS)
