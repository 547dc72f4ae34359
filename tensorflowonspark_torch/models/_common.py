"""Shared helpers of the port's models.

Reference anchor: ``tensorflowonspark_tpu/models/_common.py``
(``image_example_batch``, ``make_classification_forward_fn``,
``make_classification_loss_fn``), plus the seeded init and the flax-tree
walk that the models' weight converters share.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

#: std of a standard normal truncated to ±2 (flax's variance_scaling
#: divides by it so the truncated draw keeps the requested variance)
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(weight: torch.Tensor, gain: float,
                      generator: torch.Generator) -> None:
    """flax's ``variance_scaling(gain, "fan_in", "truncated_normal")`` in
    place: He normal for ``gain`` 2, LeCun normal for 1.  ``fan_in`` is
    ``weight[0].numel()`` (torch's ``(out, in, ...)`` layout)."""
    std = math.sqrt(gain / weight[0].numel()) / _TRUNC_STD
    torch.nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                generator=generator)


def flax_leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested mapping; flax's partitioning boxes
    (``nn.Partitioned``, from ``nn.with_partitioning``) are unboxed."""
    for k, v in tree.items():
        if hasattr(v, "unbox"):
            v = v.unbox()
        if hasattr(v, "items"):
            yield from flax_leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def classification_outputs(model: torch.nn.Module, batch) -> torch.Tensor:
    """Logits of ``model`` over ``batch['image']``: the serving forward an
    export traces (``saved_model.wrap_state_forward``)."""
    return model(batch["image"])


def classification_forward(model: torch.nn.Module, batch) -> torch.Tensor:
    """:func:`classification_outputs` without autograd.  ``model`` rides
    as the first argument, where the reference's forward takes its params
    pytree.  A BatchNorm model's forward defaults to ``train=False``, so
    this is also the reference's ``make_stateful_classification_forward_fn``:
    it reads the running statistics and never updates them, whatever the
    module's ``.training`` flag."""
    with torch.inference_mode():
        return classification_outputs(model, batch)


def adam_state_from_optax(opt_state, params_from_flax) -> dict:
    """The port's optimizer-state tree (``parallel.train.state_tree``'s
    ``opt_state``: AdamW's ``step``, ``exp_avg`` and ``exp_avg_sq`` by
    parameter name) from an ``optax.adamw`` state: the live chain of
    namedtuples, or the list of dicts a checkpoint restores as numpy.
    ``count`` becomes every parameter's ``step`` (torch counts completed
    steps, as optax does); ``mu`` and ``nu`` go through
    ``params_from_flax`` (flax tree → ``{name: array}``), so the moments
    take the weights' layout changes."""
    adam = None
    for part in opt_state:
        fields = part if isinstance(part, dict) else getattr(
            part, "_asdict", lambda: {})()
        if "mu" in fields and "nu" in fields:
            adam = fields
            break
    if adam is None:
        raise KeyError("no ScaleByAdamState (count, mu, nu) in the optax "
                       "state")
    step = np.float32(np.asarray(adam["count"]))
    mu, nu = params_from_flax(adam["mu"]), params_from_flax(adam["nu"])
    return {name: {"step": step, "exp_avg": mu[name],
                   "exp_avg_sq": nu[name]} for name in mu}


def make_classification_loss_fn(model: torch.nn.Module):
    """``loss(model, batch) -> scalar``: softmax cross-entropy in float32
    over ``batch['image']`` / integer ``batch['label']``, averaged over the
    batch (the reference's ``optax.softmax_cross_entropy_with_integer_labels``
    mean).  ``model`` rides as the loss's first argument, where the
    reference's loss takes its params pytree."""
    del model

    def loss_fn(model, batch):
        logits = model(batch["image"])
        return F.cross_entropy(logits.float(), batch["label"].long())

    return loss_fn


def make_stateful_classification_loss_fn(model: torch.nn.Module):
    """The BatchNorm models' loss (the reference's
    ``make_stateful_classification_loss_fn``): the softmax cross-entropy
    of :func:`make_classification_loss_fn` over ``model(image,
    train=True)``, whose every BatchNorm normalises by the batch's
    statistics and updates its running statistics in place (where the
    reference returns them as new collections).  Tagged ``stateful``: a
    data-parallel step averages the model's floating collections across
    ranks after it (``parallel.train.make_train_step``)."""
    del model

    def loss_fn(model, batch):
        logits = model(batch["image"], train=True)
        return F.cross_entropy(logits.float(), batch["label"].long())

    loss_fn.stateful = True
    return loss_fn


def image_example_batch(image_shape, num_classes: int, batch_size: int = 8,
                        seed: int = 0):
    """Synthetic ``{image, label}`` batch; ``image_shape`` excludes batch.
    The same ``RandomState`` draw as the reference, so both packages see
    the same images for the same seed."""
    rng = np.random.RandomState(seed)
    return {
        "image": rng.rand(batch_size, *image_shape).astype(np.float32),
        "label": rng.randint(0, num_classes, size=(batch_size,)).astype(
            np.int32
        ),
    }


# ---------------------------------------------------------------------------
# Layers the image models share (reference: flax ``nn.Conv``, ``nn.GroupNorm``,
# ``nn.avg_pool``/``nn.max_pool`` in NHWC; here NCHW shapes in channels_last)
# ---------------------------------------------------------------------------

GROUP_NORM_EPS = 1e-6  # flax nn.GroupNorm default
BATCH_NORM_EPS = 1e-5  # flax nn.BatchNorm default
#: the reference's ``nn.BatchNorm(momentum=0.9)``: the running statistics
#: keep 0.9 of themselves a step (torch's ``momentum`` is the other 0.1)
BATCH_NORM_MOMENTUM = 0.9


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding ``(low, high)`` for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kernel: tuple[int, int], stride: int,
          padding: str) -> tuple[int, int, int, int]:
    """``(left, right, top, bottom)`` of an XLA ``SAME`` or ``VALID``
    window over ``x``'s (H, W)."""
    if padding == "VALID":
        return 0, 0, 0, 0
    if padding != "SAME":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    (t, b), (left, right) = (same_pads(x.shape[2], kernel[0], stride),
                             same_pads(x.shape[3], kernel[1], stride))
    return left, right, t, b


def _pair(k) -> tuple[int, int]:
    return (k, k) if isinstance(k, int) else tuple(k)


class Conv(nn.Module):
    """flax ``nn.Conv`` in NCHW (``channels_last``): a ``(kh, kw)`` kernel
    with XLA ``SAME`` (per-dimension, asymmetric where the stride or an
    even kernel asks for it) or ``VALID`` padding, an optional bias and
    ``groups`` (``groups == cin``: a depthwise conv).  The f32 weight and
    bias are cast to the input's dtype at use.  ``forward``'s ``padding``
    overrides the constructed one (Inception's aux head picks it from its
    input's size, as the reference's does)."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding: str = "SAME", bias: bool = False, groups: int = 1):
        super().__init__()
        self.kernel = _pair(kernel)
        self.weight = nn.Parameter(torch.empty(cout, cin // groups,
                                               *self.kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x: torch.Tensor, padding: str | None = None):
        w = self.weight.to(x.dtype).contiguous(
            memory_format=torch.channels_last)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        left, right, t, bottom = _pads(x, self.kernel, self.stride,
                                       padding or self.padding)
        if left == right and t == bottom:
            return F.conv2d(x, w, b, self.stride, (t, left),
                            groups=self.groups)
        return F.conv2d(F.pad(x, (left, right, t, bottom)), w, b,
                        self.stride, groups=self.groups)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` (epsilon 1e-6, f32 ``scale``/``bias``) through
    the ``norm_act`` the model carries, with the ReLU that follows it
    folded in."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.groups = groups

    def forward(self, x, norm_act, relu: bool = True, train: bool = False):
        del train  # per sample: the same in training and in eval
        return norm_act(x, self.scale, self.bias, self.groups,
                        GROUP_NORM_EPS, None, relu)


def update_running_(running_mean: torch.Tensor, running_var: torch.Tensor,
                    mean: torch.Tensor, rstd: torch.Tensor) -> None:
    """flax's running update in place: ``r = 0.9·r + 0.1·batch`` for the
    mean and the BIASED variance, the latter recovered from the batch's
    ``rstd = 1/√(var + ε)`` as ``rstd⁻² − ε`` clipped at 0.  The buffers
    are written into, never rebound, so a captured step replays the update
    and a restore copies into the same tensors."""
    with torch.no_grad():
        var = torch.clamp_min(rstd.pow(-2) - BATCH_NORM_EPS, 0.0)
        running_mean.mul_(BATCH_NORM_MOMENTUM).add_(
            mean, alpha=1 - BATCH_NORM_MOMENTUM)
        running_var.mul_(BATCH_NORM_MOMENTUM).add_(
            var, alpha=1 - BATCH_NORM_MOMENTUM)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor,
               train: bool, residual: torch.Tensor | None = None,
               relu: bool = True) -> torch.Tensor:
    """flax ``nn.BatchNorm(use_running_average=not train, momentum=0.9,
    epsilon=1e-5, dtype=x.dtype)`` over an NCHW ``x`` in plain PyTorch,
    then the optional residual add and ReLU.  One fused
    ``torch.native_batch_norm`` normalises, in f32 for a bf16 ``x`` and
    in f64 for an f64 one (``(x − mean)·rsqrt(var + ε)·scale + bias``
    rounded to ``x``'s dtype):
    with ``train`` by the batch's mean and biased variance over N, H and
    W, which its backward differentiates through, and then the running
    statistics take flax's update (:func:`update_running_`); otherwise by
    the running statistics.  The add and ReLU run in ``x``'s dtype, as the
    reference's do.  Not torch's running update (``F.batch_norm`` with
    buffers): its running variance is the unbiased one."""
    f32 = torch.promote_types(x.dtype, torch.float32)  # f64 stays f64
    scale, bias = scale.to(f32), bias.to(f32)
    if train:
        y, mean, rstd = torch.native_batch_norm(
            x, scale, bias, None, None, True, 0.0, BATCH_NORM_EPS)
        update_running_(running_mean, running_var, mean, rstd)
    else:
        y = torch.native_batch_norm(
            x, scale, bias, running_mean.to(f32), running_var.to(f32),
            False, 0.0, BATCH_NORM_EPS)[0]
    if residual is not None:
        y = residual + y
    return torch.relu(y) if relu else y


class BatchNorm(nn.Module):
    """:func:`batch_norm` with f32 ``scale``/``bias`` and the running
    ``mean``/``var`` buffers (flax's ``batch_stats`` leaves, init 0 and
    1); ``forward`` takes the ``norm_act`` the models pass to every norm
    and ignores it."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def forward(self, x, norm_act=None, relu: bool = True,
                train: bool = False, residual=None):
        del norm_act
        return batch_norm(x, self.scale, self.bias, self.mean, self.var,
                          train, residual, relu)


def batch_stats_of(model: nn.Module) -> dict:
    """``{"batch_stats": {name: buffer}}``: the model's running statistics
    as live tensors (a model's ``collections()``, which the train state
    carries), under the names :func:`state_of` exports them by; ``{}``
    without BatchNorm."""
    stats = dict(model.named_buffers())
    return {"batch_stats": stats} if stats else {}


def max_pool(x: torch.Tensor, k: int, stride: int,
             padding: str = "VALID") -> torch.Tensor:
    """flax ``nn.max_pool``: ``SAME`` pads with ``-inf``."""
    pads = _pads(x, (k, k), stride, padding)
    if any(pads):
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, k, stride)


def avg_pool(x: torch.Tensor, k: int, stride: int,
             padding: str = "VALID") -> torch.Tensor:
    """flax ``nn.avg_pool`` (``count_include_pad=True``): ``SAME`` pads
    with zeros that count in every window's mean."""
    left, right, t, b = _pads(x, (k, k), stride, padding)
    if left == right and t == b:
        return F.avg_pool2d(x, k, stride, (t, left), count_include_pad=True)
    return F.avg_pool2d(F.pad(x, (left, right, t, b)), k, stride)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The spatial mean of an NCHW activation taken in f32 (f64 for f64)
    and rounded to its dtype (``jnp.mean`` over H, W of a bf16 array)."""
    return x.mean(dim=(2, 3), dtype=torch.promote_types(
        x.dtype, torch.float32)).to(x.dtype)


def to_nchw(image: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC float images → ``dtype`` NCHW in ``channels_last``."""
    return image.to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def init_weights_(model: nn.Module, seed: int) -> None:
    """flax's init of a zoo model, drawn by torch from ``seed``: He-normal
    conv kernels (4-D), LeCun-normal dense kernels (2-D), both truncated
    at ±2σ; biases 0, norm scales 1 (as constructed)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".weight") and p.dim() in (2, 4):
                variance_scaling_(p, 1.0 if p.dim() == 2 else 2.0, gen)
            elif name.endswith(".bias"):
                p.zero_()


# ---------------------------------------------------------------------------
# Export state, shape-matched configs and the flax converter
# ---------------------------------------------------------------------------


def state_of(model: nn.Module) -> dict:
    """The export state of ``model``: ``{"params": {name: f32 array}}``
    plus, for BatchNorm, ``{"collections": {"batch_stats": {name:
    array}}}`` — the reference's export layout, with torch names."""
    buffers = {n for n, _ in model.named_buffers()}
    params, stats = {}, {}
    for name, t in model.state_dict().items():
        (stats if name in buffers else params)[name] = (
            t.detach().cpu().float().numpy())
    state = {"params": params}
    if stats:
        state["collections"] = {"batch_stats": stats}
    return state


def load_state(model: nn.Module, state: dict) -> nn.Module:
    """Load :func:`state_of`'s tree into ``model``: every parameter and
    statistic must be present, and nothing else."""
    tensors = dict(state["params"])
    tensors.update((state.get("collections") or {}).get("batch_stats", {}))
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32))
         for k, v in tensors.items()}, strict=True)
    return model


def config_from_state(state: dict, build, configs) -> object:
    """The first of ``configs`` whose model (``build(config)``, on the
    ``meta`` device) has exactly ``state``'s parameter names and shapes,
    with ``norm="batch"`` where the state carries ``batch_stats`` (the
    reference's ``pipeline`` rule); ``ValueError`` when none has."""
    got = {k: tuple(getattr(v, "shape", ())) for k, v in
           state["params"].items()}
    batch = bool((state.get("collections") or {}).get("batch_stats"))
    for config in configs:
        if batch:
            config = dataclasses.replace(config, norm="batch")
        with torch.device("meta"):
            model = build(config)
        if got == {k: tuple(v.shape) for k, v in model.named_parameters()}:
            return config
    raise ValueError("the export's parameters match none of the configs "
                     f"{[type(c).__name__ for c in configs]} tried")


def params_from_flax(params, module_name, batch_stats=None) -> dict:
    """A flax ``params`` tree (and BatchNorm ``batch_stats``) as the
    export state :func:`state_of` writes: ``{"params": {torch name: f32
    array}}`` plus ``{"collections": {"batch_stats": ...}}``.

    ``module_name(path)`` maps a flax module path (a tuple of names) to the
    torch module's name and raises ``KeyError`` for a path it does not
    know.  Conv kernels go HWIO → OIHW (a depthwise ``(kh, kw, 1, C)`` to
    ``(C, 1, kh, kw)``), dense kernels ``(in, out)`` → ``(out, in)``;
    biases, norm ``scale``/``bias`` and the statistics' ``mean``/``var``
    keep their names.  A leaf of any other name or rank raises
    ``KeyError``."""
    out = {}
    for path, leaf in flax_leaves(params):
        name = module_name(path[:-1])
        a = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel" and a.ndim == 4:
            out[f"{name}.weight"] = np.ascontiguousarray(
                a.transpose(3, 2, 0, 1))
        elif path[-1] == "kernel" and a.ndim == 2:
            out[f"{name}.weight"] = np.ascontiguousarray(a.T)
        elif path[-1] in ("scale", "bias") and a.ndim == 1:
            out[f"{name}.{path[-1]}"] = a
        else:
            raise KeyError(f"unmapped flax leaf {'/'.join(path)} {a.shape}")
    state = {"params": out}
    if batch_stats is not None:
        stats = {}
        for path, leaf in flax_leaves(batch_stats):
            if path[-1] not in ("mean", "var"):
                raise KeyError(f"unmapped flax statistic {'/'.join(path)}")
            stats[f"{module_name(path[:-1])}.{path[-1]}"] = np.asarray(
                leaf, dtype=np.float32)
        state["collections"] = {"batch_stats": stats}
    return state


def numbered(path: tuple, kind: str) -> int:
    """``k`` of a one-element flax path ``(f"{kind}_{k}",)``; ``KeyError``
    for anything else."""
    if len(path) == 1 and path[0].startswith(kind + "_"):
        tail = path[0][len(kind) + 1:]
        if tail.isdigit():
            return int(tail)
    raise KeyError(f"unmapped flax module {'/'.join(path)}")


def opt_state_from_optax(opt_state, params, params_from_flax) -> dict:
    """A reference ``Trainer``'s ``optax.adamw`` state (live or restored
    as numpy) as the port's AdamW state by parameter name, the moments
    converted by the model's ``params_from_flax`` as its ``params`` are;
    ``KeyError`` when the moments and ``params`` name different leaves."""
    names = set(params_from_flax(params)["params"])
    out = adam_state_from_optax(
        opt_state, lambda tree: params_from_flax(tree)["params"])
    if set(out) != names:
        raise KeyError("the optax moments and the params name different "
                       "leaves")
    return out
