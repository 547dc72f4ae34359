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
    """CPU tensors run the plain versions: the kernels' counts stay."""
    before = dict(sparse_adagrad.launches_by_path)
    table, acc, ids, g = _case("heavy")
    _port(table, acc, ids, g, LR, True)
    port.sparse_adagrad_update_tables(
        [(torch.from_numpy(table.copy()), torch.from_numpy(acc.copy()))],
        torch.from_numpy(ids), [torch.from_numpy(g)], LR)
    port.group_ids(torch.from_numpy(ids), 50)
    assert sparse_adagrad.launches_by_path == before
    assert sparse_adagrad.launches == sum(before.values())


@pytest.mark.parametrize("combine", [False, True], ids=["sparse", "combine"])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_two_table_entry_equals_two_single_table_calls(combine, id_dtype):
    """The wide&deep step's entry (a deep and a scalar wide table sharing
    the ids) is, on the CPU, exactly one plain call a table: the same bits,
    returned in place, negative and out-of-range ids included."""
    rng = np.random.RandomState(7)
    deep = (0.01 * rng.randn(50, 4)).astype(np.float32)
    wide = (0.01 * rng.randn(50)).astype(np.float32)
    accs = [np.abs(rng.randn(*t.shape)).astype(np.float32)
            for t in (deep, wide)]
    ids = rng.randint(-60, 60, size=(16, 26)).astype(id_dtype)
    grads = [(1e-2 * rng.randn(16, 26, *t.shape[1:])).astype(np.float32)
             for t in (deep, wide)]
    tables = [(torch.from_numpy(t.copy()), torch.from_numpy(a.copy()))
              for t, a in zip((deep, wide), accs)]
    out = port.sparse_adagrad_update_tables(
        tables, torch.from_numpy(ids), [torch.from_numpy(g) for g in grads],
        LR, combine=combine)
    assert all(o[0] is t[0] and o[1] is t[1] for o, t in zip(out, tables))
    for (t, a), table, acc, g in zip(tables, (deep, wide), accs, grads):
        want_t, want_a = _port(table, acc, ids, g, LR, combine)
        np.testing.assert_array_equal(t.numpy(), want_t)
        np.testing.assert_array_equal(a.numpy(), want_a)


@pytest.mark.parametrize("bad", ["no_tables", "three_tables", "grads_count",
                                 "vocab_mismatch", "device_mismatch",
                                 "grad_shape", "float_ids"])
def test_two_table_entry_rejects_what_it_does_not_take(bad):
    def pair(vocab, *row, device="cpu"):
        return (torch.zeros(vocab, *row, device=device),
                torch.zeros(vocab, *row, device=device))

    tables = [pair(8, 3), pair(8)]
    ids = torch.tensor([1, 2, 2])
    grads = [torch.zeros(3, 3), torch.zeros(3)]
    if bad == "no_tables":
        tables, grads = [], []
    elif bad == "three_tables":
        tables, grads = tables + [pair(8)], grads + [torch.zeros(3)]
    elif bad == "grads_count":
        grads = grads[:1]
    elif bad == "vocab_mismatch":
        tables[1] = pair(9)
    elif bad == "device_mismatch":
        tables[1] = pair(8, device="meta")
    elif bad == "grad_shape":
        grads[1] = torch.zeros(3, 2)
    else:
        ids = ids.float()
    with pytest.raises((TypeError, ValueError)):
        port.sparse_adagrad_update_tables(tables, ids, grads, LR)


def _grouping(ids, vocab):
    got = port.group_ids(torch.tensor(ids, dtype=torch.int64), vocab)
    count = int(got.meta[0])
    return (got.keys.tolist(), got.pos.tolist(), got.seg_start.tolist(),
            got.seg_row[:count].tolist(), got.meta.tolist())


@pytest.mark.parametrize("name,ids,vocab,want", [
    # keys, positions, segment starts (the in-range count past the last),
    # segment rows, [segments, in-range]
    ("rows", [7, 3, -3, 1, 3, 7], 10,
     ([1, 3, 3, 7, 7, 7], [3, 1, 4, 0, 2, 5], [0, 1, 3, 6, 6, 6, 6],
      [1, 3, 7], [3, 6])),
    ("dropped_tail", [12, 2, -11, 2, 10], 10,
     ([2, 2, 10, 10, 10], [1, 3, 0, 2, 4], [0, 2, 2, 2, 2, 2], [2],
      [1, 2])),
    ("empty", [], 10, ([], [], [0], [], [0, 0])),
    ("all_equal", [4] * 5, 10,
     ([4] * 5, [0, 1, 2, 3, 4], [0, 5, 5, 5, 5, 5], [4], [1, 5])),
    ("all_out_of_range", [10, -11, 99], 10,
     ([10, 10, 10], [0, 1, 2], [0, 0, 0, 0], [], [0, 0])),
], ids=lambda v: v if isinstance(v, str) else None)
def test_plain_grouping_layout(name, ids, vocab, want):
    """``group_ids`` on the CPU (``group_ids_plain``, from ``sort_ids``):
    in-range occurrences by row in batch order, then the dropped tail under
    key ``vocab`` in batch order; the segment starts, then the in-range
    count in every later entry; each segment's row: the layout the
    grouping kernel writes on the card."""
    assert _grouping(ids, vocab) == want


def test_plain_grouping_of_a_zipf_batch_matches_sort_ids():
    rng = np.random.RandomState(3)
    ids = (rng.zipf(1.1, size=(64, 26)) - 1) % 1000 - 100
    got = port.group_ids(torch.from_numpy(ids), 900)
    sorted_ids, perm = port.sort_ids(torch.from_numpy(ids), 900)
    inside = (sorted_ids >= 0) & (sorted_ids < 900)
    m = int(got.meta[1])
    assert torch.equal(got.keys[:m].long(), sorted_ids[inside])
    assert torch.equal(got.pos[:m].long(), perm[inside])
    assert bool((got.keys[m:] == 900).all())
    rows, counts = torch.unique_consecutive(sorted_ids[inside],
                                            return_counts=True)
    assert int(got.meta[0]) == rows.numel()
    starts = torch.cumsum(counts, 0) - counts
    assert torch.equal(got.seg_start[:rows.numel()].long(), starts)
    assert torch.equal(got.seg_row[:rows.numel()].long(), rows)
    assert bool((got.seg_start[rows.numel():] == m).all())
    assert got.keys.dtype == got.pos.dtype == torch.int32


# --- why the JAX-vs-port trajectory needs atol 1e-5 on the tables ----------

def _sequential_f32(ids, g, vocab, lr, combine, eps=1e-10):
    """The update of a scalar table at zero accumulators, one f32 rounding
    an operation, occurrences in batch order, rsqrt as rn(1/rn(sqrt))."""
    f = np.float32
    acc, table = np.zeros(vocab, f), np.zeros(vocab, f)
    if combine:
        s = np.zeros(vocab, f)
        for i, v in zip(ids, g):
            s[i] = f(s[i] + v)
        acc = (acc + s * s).astype(f)
        r = (f(1) / np.sqrt((acc + f(eps)).astype(f))).astype(f)
        return (table + (f(-lr) * s) * r).astype(f), acc
    for i, v in zip(ids, g):
        acc[i] = f(acc[i] + f(v * v))
    r = (f(1) / np.sqrt((acc + f(eps)).astype(f))).astype(f)
    for i, v in zip(ids, g):
        table[i] = f(table[i] + f(f(f(-lr) * v) * r[i]))
    return table, acc


def _f64(ids, g, vocab, lr, combine, eps=1e-10):
    """The same update in float64, additions in the same batch order."""
    g = np.asarray(g, np.float64)
    acc, table, s = np.zeros(vocab), np.zeros(vocab), np.zeros(vocab)
    for i, v in zip(ids, g):
        if combine:
            s[i] += v
        else:
            acc[i] += v * v
    if combine:
        acc = s * s
        return -lr * s / np.sqrt(acc + eps), acc
    for i, v in zip(ids, g):
        table[i] += -lr * v / np.sqrt(acc[i] + eps)
    return table, acc


@pytest.mark.parametrize("combine", [False, True], ids=["sparse", "combine"])
def test_cancelling_duplicates_gap_is_the_inputs_not_the_order(combine):
    """Row 0 takes five gradients that nearly cancel (their sum is 3e-9
    against terms of 1e-2), at zero accumulators, as a wide-table row of
    the 5-step trajectory does.

    - Both packages add a row's occurrences in batch order: each one's
      accumulator, and the port's table, equal the sequential f32
      emulation bit for bit; JAX's table differs only by its CPU rsqrt,
      which is not rn(1/rn(sqrt)) (a few ulps of the terms).
    - Each side sits within f32 rounding of the float64 evaluation in that
      order: the sums' rounding carried through the update's slope (up to
      lr / sqrt(eps) = 1e3 for combine's s / sqrt(s^2 + eps)).  In combine
      mode that is ill-conditioned: the f32 result lies hundreds of ulps
      from the float64 one, on both sides alike.
    - What moves an entry past 1e-6 is its input: a 1e-7 relative change of
      the gradients (the gap between the packages' f32 MLP backward
      passes) moves the combined update by 2.8e-6.

    So the trajectory's table gap (1.4e-6 on a wide entry) is not a fault
    of either update, and ``PARAMS_ATOL`` stays 1e-5."""
    lr, eps, vocab = 0.01, 1e-10, 3
    g = np.array([0.0123, -0.0061, 0.004, -0.0102, 0.0], np.float32)
    g[4] = np.float32(3e-9 - np.float64(g[:4]).sum())
    ids = np.zeros(len(g), np.int64)
    port_t, port_a = (x.numpy() for x in port.sparse_adagrad_update_plain(
        torch.zeros(vocab), torch.zeros(vocab), torch.from_numpy(ids),
        torch.from_numpy(g), lr, eps, combine))
    jax_t, jax_a = _reference(np.zeros(vocab, np.float32),
                              np.zeros(vocab, np.float32), ids, g, lr,
                              combine)
    seq_t, seq_a = _sequential_f32(ids, g, vocab, lr, combine, eps)
    exact_t, exact_a = _f64(ids, g, vocab, lr, combine, eps)
    # one order on both sides: batch order
    np.testing.assert_array_equal(port_a, seq_a)
    np.testing.assert_array_equal(port_t, seq_t)
    np.testing.assert_array_equal(jax_a, seq_a)
    u = float(np.finfo(np.float32).eps) / 2
    g64 = np.abs(np.float64(g))
    # the terms the table entry sums, in magnitude
    terms = (lr * g64.sum() / np.sqrt(exact_a[0]) if not combine
             else abs(exact_t[0]))
    assert abs(float(jax_t[0]) - float(seq_t[0])) <= 8 * u * terms
    # each side within f32 rounding of its own order's float64 result
    gamma = 2 * (len(g) + 3) * u
    bound = gamma * (lr / np.sqrt(eps) * g64.sum() if combine else terms)
    for got in (port_t, jax_t):
        assert abs(float(got[0]) - exact_t[0]) <= bound
    if combine:
        assert abs(float(port_t[0]) - exact_t[0]) > 100 * u * abs(exact_t[0])
        signs = np.array([1, -1, 1, -1, 1])
        moved = _sequential_f32(
            ids, (np.float64(g) * (1 + 1e-7 * signs)).astype(np.float32),
            vocab, lr, combine, eps)[0]
        assert abs(float(moved[0]) - float(port_t[0])) > 1e-6
