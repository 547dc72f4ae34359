"""The port's sparse embedding engine against the JAX package's.

``embedding.sparse_adagrad_update`` on CPU tensors (its plain version)
against ``tensorflowonspark_tpu.embedding.sparse_adagrad_update`` and, with
``combine=True``, against the wide&deep ``_dense_adagrad`` full-table pass
after the gather's VJP (``tensorflowonspark_tpu/models/widedeep.py:283-289``,
restated below in ``jax.numpy``), on the same numpy-drawn inputs: the cases
of ``tests/test_embedding.py``.  f32: rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import embedding as port
from tensorflowonspark_torch.kernels import sparse_adagrad
from tensorflowonspark_tpu import embedding as ref

RTOL, ATOL = 1e-5, 1e-6
LR = 0.1


def _jax_dense_adagrad(table, acc, ids, grad_rows, lr, eps=1e-10):
    """widedeep.py's dense table update: the gather's VJP (a scatter-add
    into a zero table-sized gradient), then ``_dense_adagrad``."""
    row = table.shape[1:]
    flat = jnp.asarray(ids).reshape(-1)
    g = jnp.zeros(table.shape, jnp.float32).at[flat].add(
        jnp.asarray(grad_rows).reshape((flat.shape[0],) + row))
    acc = jnp.asarray(acc) + g * g
    update = -lr * g * jax.lax.rsqrt(acc + eps)
    return jnp.asarray(table) + update, acc


def _reference(table, acc, ids, g, lr, combine):
    if combine:
        t, a = _jax_dense_adagrad(table, acc, ids, g, lr)
    else:
        t, a = ref.sparse_adagrad_update(jnp.asarray(table), jnp.asarray(acc),
                                         jnp.asarray(ids), jnp.asarray(g), lr)
    return np.asarray(t), np.asarray(a)


def _port(table, acc, ids, g, lr, combine):
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    out_t, out_a = port.sparse_adagrad_update(
        t, a, torch.from_numpy(ids), torch.from_numpy(g), lr,
        combine=combine)
    assert out_t is t and out_a is a  # in place
    return t.numpy(), a.numpy()


def _case(name, id_dtype=np.int32):
    rng = np.random.RandomState({"unique": 0, "dups": 1, "multi": 2,
                                 "scalar": 3, "heavy": 4}[name])
    if name == "unique":
        table = rng.randn(32, 4).astype(np.float32)
        acc = np.abs(rng.randn(32, 4)).astype(np.float32)
        ids = rng.permutation(32)[:8]
        g = rng.randn(8, 4)
    elif name == "dups":  # row 2 hit twice
        table = rng.randn(8, 3).astype(np.float32)
        acc = np.zeros((8, 3), np.float32)
        ids = np.array([2, 2, 5])
        g = rng.randn(3, 3)
    elif name == "multi":  # multi-dim ids, a duplicate across rows
        table = rng.randn(64, 5).astype(np.float32)
        acc = np.abs(rng.randn(64, 5)).astype(np.float32)
        ids = np.array([[3, 9], [17, 3]])
        g = rng.randn(2, 2, 5)
    elif name == "scalar":  # the wide column: row shape ()
        table = rng.randn(10).astype(np.float32)
        acc = np.abs(rng.randn(10)).astype(np.float32)
        ids = np.array([1, 1, 4, 7, 1])
        g = rng.randn(5)
    else:  # a batch of a wide&deep step over 50 buckets: many duplicates
        table = (0.01 * rng.randn(50, 4)).astype(np.float32)
        acc = np.abs(rng.randn(50, 4)).astype(np.float32)
        ids = rng.randint(0, 50, size=(16, 26))
        g = 1e-2 * rng.randn(16, 26, 4)
    return table, acc, ids.astype(id_dtype), g.astype(np.float32)


CASES = ["unique", "dups", "multi", "scalar", "heavy"]


@pytest.mark.parametrize("combine", [False, True], ids=["sparse", "combine"])
@pytest.mark.parametrize("name", CASES)
def test_plain_update_matches_the_jax_package(name, combine):
    table, acc, ids, g = _case(name)
    want_t, want_a = _reference(table, acc, ids, g, LR, combine)
    got_t, got_a = _port(table, acc, ids, g, LR, combine)
    np.testing.assert_allclose(got_a, want_a, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_t, want_t, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("combine", [False, True], ids=["sparse", "combine"])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_untouched_rows_bit_identical(combine, id_dtype):
    table, acc, ids, g = _case("multi", id_dtype)
    got_t, got_a = _port(table, acc, ids, g, 0.5, combine)
    untouched = np.setdiff1d(np.arange(64), ids.reshape(-1))
    np.testing.assert_array_equal(got_t[untouched], table[untouched])
    np.testing.assert_array_equal(got_a[untouched], acc[untouched])
    touched = np.unique(ids.reshape(-1))
    assert not np.allclose(got_t[touched], table[touched])


def test_modes_differ_exactly_where_ids_repeat():
    """Without duplicates the two modes are one function; a repeated id
    makes them two (summed-then-squared against per-occurrence)."""
    table, acc, ids, g = _case("unique")
    np.testing.assert_array_equal(_port(table, acc, ids, g, LR, False)[0],
                                  _port(table, acc, ids, g, LR, True)[0])
    table, acc, ids, g = _case("dups")
    sparse, combine = (_port(table, acc, ids, g, LR, c)[1] for c in (0, 1))
    assert not np.allclose(sparse[2], combine[2])
    np.testing.assert_array_equal(sparse[5], combine[5])


def test_scalar_rows_by_hand():
    """The reference test's numbers: row 1's two duplicates each apply
    -1/sqrt(2); row 4 -2/sqrt(4).  Combined: row 1 takes one -2/sqrt(4)."""
    def run(combine):
        t, a = torch.zeros(10), torch.zeros(10)
        port.sparse_adagrad_update(t, a, torch.tensor([1, 1, 4]),
                                   torch.tensor([1.0, 1.0, 2.0]), 1.0,
                                   combine=combine)
        return t.numpy(), a.numpy()

    t, a = run(False)
    np.testing.assert_allclose(a, [0, 2, 0, 0, 4, 0, 0, 0, 0, 0])
    np.testing.assert_allclose(t[[1, 4]], [-2 / np.sqrt(2), -1.0], rtol=1e-6)
    t, a = run(True)
    np.testing.assert_allclose(a, [0, 4, 0, 0, 4, 0, 0, 0, 0, 0])
    np.testing.assert_allclose(t[[1, 4]], [-1.0, -1.0], rtol=1e-6)


def test_out_of_range_ids_are_dropped():
    """Ids as JAX's ``.at[ids]`` takes them, on the same ids on both sides:
    ids 8 and -9 lie outside ``[-vocab, vocab)`` and are dropped, ids -1
    and -8 name rows 7 and 0 and update them beside the in-range
    occurrences of those rows."""
    table, acc, ids, g = _case("dups")
    bad = np.array([2, 8, 5, -1, 7, -9, -8, 0])
    g8 = np.concatenate([g, g, g[:2]])
    wrapped = np.array([2, 5, 7, 7, 0, 0])
    keep = np.array([True, False, True, True, True, False, True, True])
    untouched = np.setdiff1d(np.arange(8), wrapped)
    for combine in (False, True):
        got_t, got_a = _port(table, acc, bad, g8, LR, combine)
        want_t, want_a = _reference(table, acc, bad, g8, LR, combine)
        np.testing.assert_allclose(got_t, want_t, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_a, want_a, rtol=RTOL, atol=ATOL)
        # -1 and -8 are rows 7 and 0 exactly; 8 and -9 move nothing
        np.testing.assert_array_equal(
            got_t, _port(table, acc, wrapped, g8[keep], LR, combine)[0])
        np.testing.assert_array_equal(got_t[untouched], table[untouched])


def test_sparse_sgd_matches_and_momentum_rejected():
    table = np.ones((6, 2), np.float32)
    ids = np.array([0, 5, 5], np.int32)
    g = np.ones((3, 2), np.float32)
    want = np.asarray(ref.sparse_sgd_update(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(g), lr=0.5))
    got = port.sparse_sgd_update(torch.from_numpy(table.copy()),
                                 torch.from_numpy(ids), torch.from_numpy(g),
                                 lr=0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="momentum"):
        port.sparse_sgd_update(torch.from_numpy(table), torch.from_numpy(ids),
                               torch.from_numpy(g), lr=0.5, momentum=0.9)


@pytest.mark.parametrize("bad", ["float_ids", "grad_shape", "acc_shape",
                                 "acc_dtype", "int_grads"])
def test_bad_arguments_raise(bad):
    table, acc = torch.zeros(8, 3), torch.zeros(8, 3)
    ids, g = torch.tensor([1, 2]), torch.zeros(2, 3)
    if bad == "float_ids":
        ids = ids.float()
    elif bad == "grad_shape":
        g = torch.zeros(2, 4)
    elif bad == "acc_shape":
        acc = torch.zeros(8, 4)
    elif bad == "acc_dtype":
        acc = acc.double()
    else:
        g = g.long()
    with pytest.raises((TypeError, ValueError)):
        port.sparse_adagrad_update(table, acc, ids, g, LR)


def test_cpu_takes_the_plain_path_and_counts_no_launch():
    """A CPU tensor runs the plain version: the kernel's count stays."""
    before = dict(sparse_adagrad.launches_by_path)
    table, acc, ids, g = _case("heavy")
    _port(table, acc, ids, g, LR, True)
    assert sparse_adagrad.launches_by_path == before
    assert sparse_adagrad.launches == sum(before.values())


def test_sort_ids_groups_occurrences_in_batch_order():
    ids = torch.tensor([[7, 3], [-3, 1], [3, 7]], dtype=torch.int32)
    sorted_ids, perm = port.sort_ids(ids, 10)  # -3 is row 7
    assert sorted_ids.tolist() == [1, 3, 3, 7, 7, 7]
    assert perm.tolist() == [3, 1, 4, 0, 2, 5]
    assert sorted_ids.dtype == torch.int32 and perm.dtype == torch.int64
