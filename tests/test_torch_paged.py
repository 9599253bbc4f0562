"""The port's paged KV cache against the JAX package's, bit for bit: the
host-side page allocator and ``build_tables``, and the paged write / gather
data movement."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import paged as jpaged  # noqa: E402
from repro_torch.models import paged as tpaged  # noqa: E402
from repro_torch.models.convert import _to_torch  # noqa: E402

torch.set_num_threads(1)


def _script(rs, n_pages, steps):
    """A random but valid op sequence over a pool of ``n_pages``."""
    ops = []
    for _ in range(steps):
        r = rs.rand()
        if r < 0.45:
            ops.append(("alloc", int(rs.randint(0, 4))))
        elif r < 0.6:
            ops.append(("try_alloc", int(rs.randint(0, 6))))
        elif r < 0.75:
            ops.append(("share", None))
        elif r < 0.95:
            ops.append(("free", None))
        else:
            ops.append(("reset_peak", None))
    return ops


def _run(alloc_cls, ops, seed, n_pages):
    """Drive an allocator through ``ops``; returns every observable."""
    rs = np.random.RandomState(seed)
    a = alloc_cls(n_pages)
    held, trace = [], []
    for op, n in ops:
        if op in ("alloc", "try_alloc"):
            if op == "alloc" and n > a.n_free:
                with pytest.raises(MemoryError):
                    a.alloc(n)
                got = "MemoryError"
            else:
                got = getattr(a, op)(n)
                if got:
                    held.extend(got)
        elif op == "share" and held:
            pick = [held[int(rs.randint(len(held)))]]
            got = a.share(pick)
            held.extend(got)
        elif op == "free" and held:
            i = int(rs.randint(len(held)))
            got = a.free([held.pop(i)])
        elif op == "reset_peak":
            got = a.reset_peak()
        else:
            got = None
        trace.append((op, got, a.stats(),
                      {p: a.refcount(p) for p in range(n_pages)}))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_allocator_same_ops_same_state(seed):
    n_pages = 12
    ops = _script(np.random.RandomState(seed), n_pages, steps=80)
    assert (_run(tpaged.PageAllocator, ops, seed, n_pages)
            == _run(jpaged.PageAllocator, ops, seed, n_pages))


def test_page_allocator_misuse_raises_like_jax():
    for cls in (tpaged.PageAllocator, jpaged.PageAllocator):
        a = cls(4)
        ids = a.alloc(2)
        assert a.free(ids[:1]) == 1
        with pytest.raises(ValueError):
            a.free(ids[:1])
        with pytest.raises(ValueError):
            a.share(ids[:1])
        assert a.try_alloc(5) is None


@pytest.mark.parametrize("shared", [0, 2])
def test_build_tables_and_layout_helpers_match(shared):
    ta, ja = tpaged.PageAllocator(20), jpaged.PageAllocator(20)
    t = tpaged.build_tables(ta, 3, 4, shared_pages=shared)
    j = jpaged.build_tables(ja, 3, 4, shared_pages=shared)
    np.testing.assert_array_equal(t, j)
    assert ta.stats() == ja.stats()
    np.testing.assert_array_equal(tpaged.identity_block_table(3, 5),
                                  jpaged.identity_block_table(3, 5))
    assert all(tpaged.num_pages(n, 16) == jpaged.num_pages(n, 16)
               for n in (1, 15, 16, 17, 48))


@pytest.mark.parametrize("dtype", [ml_dtypes.bfloat16,
                                   ml_dtypes.float8_e5m2])
@pytest.mark.parametrize("pos", ["scalar", "rows", "past_capacity"])
def test_paged_update_rows_and_gather_bitwise(dtype, pos):
    b, hkv, s, dh, page, mp = 3, 2, 5, 8, 4, 4
    n_pages = b * mp + 2
    rs = np.random.RandomState(3)
    pool = rs.randn(n_pages, hkv, page, dh).astype(dtype)
    table = rs.permutation(n_pages)[:b * mp].reshape(b, mp).astype(np.int32)
    table[2, 0] = table[1, 0]         # an aliased page (read, not written)
    new = rs.randn(b, hkv, s, dh).astype(np.float32)
    p = {"scalar": 6, "rows": np.asarray([0, 7, 11], np.int32),
         "past_capacity": 13}[pos]                    # 13 + 5 > 4 * 4
    if pos == "rows":
        new = new[:, :, :1]                           # one decode step
        jp, tp_ = jnp.asarray(p), torch.from_numpy(p)
    else:
        jp = tp_ = p
    want = jpaged.paged_update_rows(jnp.asarray(pool), jnp.asarray(table),
                                    jnp.asarray(new), jp)
    got = tpaged.paged_update_rows(_to_torch(pool, "cpu"),
                                   torch.from_numpy(table),
                                   torch.from_numpy(new), tp_)
    raw = np.uint16 if dtype == ml_dtypes.bfloat16 else np.uint8
    bits = lambda t: t.view(torch.uint16 if raw == np.uint16
                            else torch.uint8).numpy()
    np.testing.assert_array_equal(bits(got),
                                  np.asarray(want).view(raw))
    gw = jpaged.gather_paged_kv(want, jnp.asarray(table))
    gt = tpaged.gather_paged_kv(got, torch.from_numpy(table))
    np.testing.assert_array_equal(bits(gt), np.asarray(gw).view(raw))


@pytest.mark.parametrize("pos", [[2, 6], [17, 9], [9, 4]])
def test_paged_update_rows_per_row_pos_past_capacity(pos):
    """A per-row ``pos`` whose write runs past the table's capacity drops
    the positions beyond it, as the JAX scatter does, and never indexes
    the table out of range: pool [6, 1, 4, 2], table [[1, 2], [3, 4]], a
    3-token write.  [2, 6] drops position 8 of row 1 ([7, 8] and [9, 10]
    land in page 4); [17, 9] drops all of both rows; [9, 4] drops all of
    row 0 and keeps all of row 1."""
    pool = np.zeros((6, 1, 4, 2), np.float32)
    table = np.asarray([[1, 2], [3, 4]], np.int32)
    new = np.arange(1, 13, dtype=np.float32).reshape(2, 1, 3, 2)
    p = np.asarray(pos, np.int32)
    want = np.asarray(jpaged.paged_update_rows(
        jnp.asarray(pool), jnp.asarray(table), jnp.asarray(new),
        jnp.asarray(p)))
    got = tpaged.paged_update_rows(torch.from_numpy(pool),
                                   torch.from_numpy(table),
                                   torch.from_numpy(new),
                                   torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)
    if pos == [2, 6]:
        np.testing.assert_array_equal(got[4, 0, 2:], [[7, 8], [9, 10]])
