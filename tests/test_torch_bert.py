"""The port's BERT (``models/bert.py``) against the JAX package's, on the
same weights.

The reference's ``Trainer`` cannot build BERT under its mesh here
(``tests/test_models.py::test_model_trains_and_predicts[bert]``), so its
module is driven directly: ``make_model(config)`` with no mesh, ``init``,
``meta.unbox``, and a jitted ``apply`` / ``value_and_grad`` / ``optax``
update.  Weights are numpy draws in the shapes of that init (biases and
LayerNorm scales away from their init values, so a mapping error shows),
carried across by ``params_from_flax``.  Batches have padding tails, and
their span labels lie inside each row's length, as ``synth_squad`` draws
them: a label on padding makes the loss ~1e29 in both packages.

Configs: ``Config.tiny()`` (f32) and a narrow bf16 one (2 layers, hidden
64, 4 heads, MLP 128, vocab 128).  Tolerances are the repo's: f32 1e-5,
bf16 2e-2 relative.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta

from tensorflowonspark_torch import models, saved_model
from tensorflowonspark_torch.models import bert as port
from tensorflowonspark_torch.parallel import train as train_lib
from tensorflowonspark_torch.trainer import Trainer
from tensorflowonspark_tpu.models import bert as ref

F32_REL = 1e-5
#: params after the AdamW steps (``tests/test_torch_train.py``'s): Adam's
#: normalised step turns an f32 gradient difference on a near-0 gradient
#: into ~1e-6 here; a flipped update sign moves a param by 2·LR
F32_PARAMS_ABS = 1e-5
BF16_REL = 2e-2
SEQ = 16
LENGTHS = (16, 11, 6, 13)  # padding tails in three rows
BF16 = ref.Config(vocab_size=128, hidden=64, layers=2, heads=4, mlp_dim=128,
                  max_len=SEQ, dtype="bfloat16")
CONFIGS = {"f32": ref.Config.tiny(), "bf16": BF16}
LR = 1e-3
STEPS = 5


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def squad_batch(config, lengths=LENGTHS, seq=SEQ, seed=1):
    """Token rows of the given lengths, zero-padded to ``seq``: question |
    context type halves, labels drawn inside each row (0 for an empty
    row), as ``synth_squad`` draws them."""
    rng = np.random.RandomState(seed)
    n = len(lengths)
    out = {k: np.zeros((n, seq), np.int32) for k in
           ("input_ids", "token_type_ids", "attention_mask")}
    out["start_positions"] = np.zeros(n, np.int32)
    out["end_positions"] = np.zeros(n, np.int32)
    for i, length in enumerate(lengths):
        out["input_ids"][i, :length] = rng.randint(5, config.vocab_size,
                                                   size=length)
        out["attention_mask"][i, :length] = 1
        out["token_type_ids"][i, length // 2:length] = 1
        if length:
            s = rng.randint(length // 2, length)
            out["start_positions"][i] = s
            out["end_positions"][i] = rng.randint(s, length)
    return out


def inputs(batch):
    return (batch["input_ids"], batch["token_type_ids"],
            batch["attention_mask"])


@functools.lru_cache(maxsize=None)
def flax_params(config, seed=0):
    """The reference module and numpy weights in its init's shapes:
    normal(0.02) kernels and tables, biases 0.02·N(0, 1), LayerNorm
    scales 1 + 0.2·N(0, 1)."""
    module = ref.make_model(config)
    batch = squad_batch(config)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *inputs(batch)))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1 + 0.2 * rng.randn(*s.shape)).astype(np.float32)
        return ((0.02 * rng.randn(*s.shape))).astype(np.float32)

    return module, jax.tree_util.tree_map_with_path(draw, meta.unbox(shapes))


@functools.lru_cache(maxsize=None)
def jax_side(config):
    """The reference's start and end logits, loss and gradients (numpy)
    on :func:`squad_batch`."""
    module, params = flax_params(config)
    batch = squad_batch(config)
    start, end = jax.jit(lambda p, *x: module.apply({"params": p}, *x))(
        params, *inputs(batch))
    loss, grads = jax.jit(jax.value_and_grad(ref.make_loss_fn(
        module, config)))(params, batch)
    return (np.asarray(start), np.asarray(end), float(loss),
            jax.tree_util.tree_map(np.asarray, grads))


def port_model(config, params=None):
    pconfig = port.Config(**dataclasses.asdict(config))
    if params is None:
        params = flax_params(config)[1]
    return pconfig, port.load_state(port.make_model(pconfig),
                                    port.params_from_flax(params))


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def check_logits(got, want, mask, tol):
    """Masked positions exactly -1e30 in both; the rest within ``tol``
    (relative L2)."""
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.all(got[mask == 0] == np.float32(port.MASKED))
    assert np.all(want[mask == 0] == np.float32(port.MASKED))
    assert rel(got[mask != 0], want[mask != 0]) < tol


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_loss_and_gradients_match_jax(name):
    """Start and end logits, the loss and every gradient leaf (through
    ``params_from_flax``) within f32 1e-5 or bf16 2e-2: the gradients by
    relative L2 over all leaves, and each leaf's max |Δ| of the largest
    gradient (the span head's bias and the last LayerNorm's have a true
    gradient of 0: the softmax gradients sum to 0 over positions)."""
    config = CONFIGS[name]
    tol = F32_REL if name == "f32" else BF16_REL
    want_start, want_end, want_loss, want_grads = jax_side(config)
    pconfig, model = port_model(config)
    batch = squad_batch(config)
    start, end = port.make_forward_fn(model, pconfig)(model,
                                                      torch_batch(batch))
    assert start.dtype == end.dtype == torch.float32
    check_logits(start, want_start, batch["attention_mask"], tol)
    check_logits(end, want_end, batch["attention_mask"], tol)
    loss = port.make_loss_fn(model, pconfig)(model, torch_batch(batch))
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) / want_loss < tol
    want = port.params_from_flax(want_grads)["params"]
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(grads) == sorted(want)
    num = sum(float(np.sum((grads[k] - want[k]) ** 2)) for k in want)
    assert (num / sum(float(np.sum(want[k] ** 2)) for k in want)) ** 0.5 \
        < tol
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k in want:
        np.testing.assert_allclose(grads[k], want[k], rtol=0,
                                   atol=tol * scale, err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_all_padding_row_matches_the_reference(name):
    """A row that is all padding (a serving tail's pad row): its encoder
    output is the reference's finite one (uniform attention weights over
    the -1e30 scores), and its span logits are all -1e30."""
    config = CONFIGS[name]
    tol = F32_REL if name == "f32" else BF16_REL
    module, params = flax_params(config)
    batch = squad_batch(config, lengths=(16, 0, 9))
    (start, _), state = jax.jit(lambda p, *x: module.apply(
        {"params": p}, *x, capture_intermediates=True))(params,
                                                        *inputs(batch))
    want = np.asarray(state["intermediates"][f"layer_{config.layers - 1}"][
        "__call__"][0][0]).astype(np.float32)
    pconfig, model = port_model(config)
    hidden = []
    model.layers[-1].register_forward_hook(
        lambda _m, _i, y: hidden.append(y.float().numpy()))
    got_start, _ = port.make_forward_fn(model, pconfig)(model,
                                                        torch_batch(batch))
    assert np.all(np.isfinite(hidden[0])) and np.all(np.isfinite(want))
    for row in range(3):
        assert rel(hidden[0][row], want[row]) < tol, row
    assert np.all(got_start[1].numpy() == np.float32(port.MASKED))
    check_logits(got_start, np.asarray(start), batch["attention_mask"], tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_sdpa_agrees_with_the_plain_version(dtype):
    """The card's SDPA path and the plain path on the same inputs (here on
    the CPU's SDPA), an all-padding row included: the additive bias gives
    the reference's uniform weights there, where a boolean mask gives NaN
    or zeros, by backend."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, 8, 2, 16, generator=g).to(dtype)
               for _ in range(3))
    mask = torch.ones(3, 8, dtype=torch.bool)
    mask[1, 5:] = False
    mask[2] = False
    bias = torch.where(mask, 0.0, port.MASKED).to(dtype)[:, None, None, :]
    plain = port.attention_plain(q, k, v, bias)
    sdpa = port.attention_sdpa(q, k, v, bias)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert rel(sdpa.float().numpy(), plain.float().numpy()) < tol
    uniform = v[2].float().mean(0, keepdim=True).expand(8, 2, 16)
    torch.testing.assert_close(plain[2].float(), uniform, rtol=tol, atol=tol)
    torch.testing.assert_close(sdpa[2].float(), uniform, rtol=tol, atol=tol)
    boolean = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None, None, :]).transpose(1, 2)
    assert not torch.allclose(boolean[2].float(), uniform, atol=tol)


def test_attention_plain_scores_are_f32_products():
    """bf16 q·k accumulated in f32 (the reference's
    ``preferred_element_type``), not a bf16 product rounded before the
    softmax; and flax's tanh GELU, not torch's exact default."""
    g = torch.Generator().manual_seed(1)
    q, k = (torch.randn(1, 4, 1, 64, generator=g).bfloat16()
            for _ in range(2))
    v = torch.eye(4)[None, :, None, :].bfloat16()  # o = p
    bias = torch.zeros(1, 1, 1, 4, dtype=torch.bfloat16)
    p = port.attention_plain(q, k, v, bias)[0, :, 0].float()
    s = (q.float()[0, :, 0] @ k.float()[0, :, 0].T) / 8.0
    want = torch.softmax(s, -1).bfloat16().float()
    torch.testing.assert_close(p, want, rtol=0, atol=0)
    x = jnp.linspace(-4, 4, 101, dtype=jnp.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.tensor(np.asarray(x)),
                                 approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(x)), rtol=0, atol=1e-6)


def test_five_adamw_steps_match_optax():
    """Five ``optax.adamw(lr, weight_decay=0.01)`` steps of the reference
    module against the port's ``Trainer`` with its AdamW, started from the
    converted params and ``opt_state_from_optax`` of optax's state: the
    losses, the params and the moments after the last step, within f32
    1e-5.  The span head's bias and the last LayerNorm's have a true
    gradient of 0 (the softmax gradients sum to 0 over positions): Adam
    steps them by ±LR on each framework's rounding noise, so they are
    held only to the ``STEPS · LR`` such steps can move them."""
    config = CONFIGS["f32"]
    module, params = flax_params(config)
    tx = optax.adamw(LR, weight_decay=0.01)
    opt_state = tx.init(params)
    loss_fn = ref.make_loss_fn(module, config)

    @jax.jit
    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    t = Trainer("bert", config=port.Config.tiny(), device="cpu",
                optimizer=lambda p: torch.optim.AdamW(
                    p, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                    weight_decay=0.01))
    train_lib.load_state_tree(t.state, {
        "params": port.params_from_flax(params)["params"],
        "opt_state": port.opt_state_from_optax(opt_state, params),
        "step": np.int64(0)})
    losses = []
    for i in range(STEPS):
        batch = squad_batch(config, seed=10 + i)
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append((float(loss), float(t.step(batch))))
    losses = np.array(losses)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=F32_REL)
    assert losses[-1, 1] < losses[0, 1]
    want = port.params_from_flax(params)["params"]
    got = port.state_of(t.model)["params"]
    start = port.params_from_flax(flax_params(config)[1])["params"]
    want_opt = port.opt_state_from_optax(opt_state, params)
    # the moments hold the gradients' differences: F32_REL of the largest
    scale = max(float(np.abs(w["exp_avg"]).max()) for w in want_opt.values())
    noise = ("span.bias", f"layers.{config.layers - 1}.ln_mlp.bias")
    for k in want:
        if k in noise:
            for p in (got[k], want[k]):
                assert np.abs(p - start[k]).max() <= STEPS * LR * 1.01
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=F32_PARAMS_ABS, err_msg=k)
        live = t.optimizer.state[t.state.params[k]]
        assert float(live["step"]) == float(want_opt[k]["step"]) == STEPS
        np.testing.assert_allclose(live["exp_avg"].numpy(),
                                   want_opt[k]["exp_avg"], rtol=0,
                                   atol=F32_REL * scale, err_msg=k)


def test_remat_gradients_are_bit_identical():
    """``Config(remat=True)`` recomputes each block in the backward (two
    block forwards a layer in a training step, one in eval) and gives
    the same gradients, bit for bit."""
    config = port.Config(**dataclasses.asdict(BF16))
    batch = torch_batch(squad_batch(config))
    grads, calls = [], []
    for remat in (False, True):
        model = port.make_model(dataclasses.replace(config, remat=remat),
                                seed=3)
        handle = model.layers[0].register_forward_pre_hook(
            lambda *_: calls.append(remat))
        port.make_loss_fn(model, config)(model, batch).backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
        model.eval()
        port.make_forward_fn(model, config)(model, batch)
        handle.remove()
    assert calls.count(False) == 2 and calls.count(True) == 3
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


@pytest.mark.parametrize("seed", [0, 3])
def test_example_batch_equals_the_reference(seed):
    for config in (ref.Config.tiny(), ref.Config()):
        want = ref.example_batch(config, batch_size=3, seed=seed)
        got = port.example_batch(port.Config(**dataclasses.asdict(config)),
                                 batch_size=3, seed=seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_converter_maps_every_leaf_splits_qkv_and_rejects_others():
    config = CONFIGS["bf16"]
    _, params = flax_params(config)
    state = port.params_from_flax(params)["params"]
    pconfig = port.Config(**dataclasses.asdict(config))
    with torch.device("meta"):
        model = port.build(pconfig)
    assert {k: v.shape for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    kernel = params["layer_1"]["attention"]["qkv"]["kernel"]
    bias = params["layer_1"]["attention"]["qkv"]["bias"]
    w = state["layers.1.attention.qkv.weight"]
    b = state["layers.1.attention.qkv.bias"]
    hd = pconfig.head_dim
    for part in range(3):  # q, k, v
        for head in range(pconfig.heads):
            row = (part * pconfig.heads + head) * hd
            np.testing.assert_array_equal(w[row:row + hd],
                                          kernel[:, part, head].T)
            np.testing.assert_array_equal(b[row:row + hd], bias[part, head])
    np.testing.assert_array_equal(state["span.weight"],
                                  params["span"]["kernel"].T)
    with pytest.raises(KeyError, match="layer_0/extra"):
        port.params_from_flax(dict(params, layer_0=dict(
            params["layer_0"], extra={"kernel": np.zeros((2, 2))})))
    with pytest.raises(KeyError, match="pooler"):
        port.params_from_flax(dict(params, pooler={"kernel": np.zeros(3)}))
    with pytest.raises(KeyError, match="embeddings/ln_embed/w"):
        port.params_from_flax(dict(params, embeddings=dict(
            params["embeddings"], ln_embed={"w": np.zeros(3)})))


def test_config_from_state_round_trips():
    tiny = port.make_model(port.Config.tiny())
    assert port.config_from_state(port.state_of(tiny)) == port.Config.tiny()
    for config in (port.Config(), port.Config.large()):
        with torch.device("meta"):
            shapes = {"params": dict(port.build(config).state_dict())}
        assert port.config_from_state(shapes) == config
    with pytest.raises(ValueError, match="match none"):
        port.config_from_state({"params": {"x": np.zeros(3)}})


def test_unsupported_configs_raise():
    for bad, err, match in ((dict(moe_experts=4), NotImplementedError,
                             "item 6"),
                            (dict(pp_stages=2), NotImplementedError,
                             "item 6"),
                            (dict(sp_impl="tree"), ValueError, "sp_impl")):
        with pytest.raises(err, match=match):
            port.make_model(dataclasses.replace(port.Config.tiny(), **bad))


def test_registry_trainer_and_export_serve(tmp_path):
    """``get_model("bert")`` is the port's module; ``Trainer("bert")``
    steps on the CPU with a falling loss; its export (int32 inputs, a
    symbolic batch, ``output_0``/``output_1``) serves int64 rows, as a
    DataFrame delivers them, with the eager forward's values."""
    assert models.get_model("bert") is port
    t = Trainer("bert", learning_rate=1e-2, device="cpu")
    batch = squad_batch(t.config, seq=64, lengths=(64, 40, 33, 50))
    losses = [float(t.step(batch)) for _ in range(4)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    export = str(tmp_path / "export")
    t.export(export)
    fn, signature = saved_model.load_forward(export, device="cpu")
    assert signature["batch"] == "polymorphic"
    assert {e["name"]: e["dtype"] for e in signature["inputs"]} == (
        dict.fromkeys(("input_ids", "token_type_ids", "attention_mask"),
                      "int32"))
    # a tuple's leaves, named as the reference's signature names them
    # (``TFModel`` emits them as the columns output_0 and output_1)
    assert [(e["name"], e["shape"], e["dtype"]) for e in
            signature["outputs"]] == [("0", [None, 64], "float32"),
                                      ("1", [None, 64], "float32")]
    rows = squad_batch(t.config, seq=64, lengths=(64, 0, 7), seed=4)
    served = fn(port.state_of(t.model), {
        k: v.astype(np.int64) for k, v in rows.items()
        if k in ("input_ids", "token_type_ids", "attention_mask")})
    t.model.eval()
    want = t.forward_fn(t.model, torch_batch(rows))
    for got, w in zip(served, want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
