"""Paged KV cache: a shared block pool + per-sequence block tables.

  * ``k_pool`` / ``v_pool`` — ``[n_pages, Hkv, page, Dh]``: a page holds
    ``page`` tokens of K or V for every KV head.  Head-major pages reshape
    (zero-copy) to the kernels' flat ``[n_pages * Hkv, page, Dh]`` pools.
  * ``block_table`` — ``[B, max_pages]`` int32: row ``b``'s logical token
    block ``j`` lives in physical page ``block_table[b, j]``.

Rows sharing a prompt prefix may point at the same page; a finished row's
pages go back to the host-side ``PageAllocator``.  Writes update the pools
IN PLACE (``paged_update_rows`` returns the same tensor it was given).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch


class PagedKVCache(NamedTuple):
    """One attention layer's paged cache."""
    k_pool: torch.Tensor       # [n_pages, Hkv, page, Dh]
    v_pool: torch.Tensor       # [n_pages, Hkv, page, Dh]
    block_table: torch.Tensor  # [B, max_pages] int32 (physical page ids)

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[2]


def num_pages(max_len: int, page: int) -> int:
    """Pages needed to hold ``max_len`` tokens (the table width)."""
    return -(-max_len // page)


def identity_block_table(batch: int, max_pages: int) -> np.ndarray:
    """The unshared layout as a table: row ``b`` owns pages
    ``[b * max_pages, (b + 1) * max_pages)``."""
    return np.arange(batch * max_pages, dtype=np.int32).reshape(
        batch, max_pages)


def init_paged_kv_cache(batch: int, n_kv_heads: int, max_len: int, page: int,
                        head_dim: int, dtype, *, device, block_table=None,
                        n_pages: Optional[int] = None) -> PagedKVCache:
    """Zero pools + a block table (default: the identity table).
    ``n_pages`` sizes the pool — default ``batch * max_pages``."""
    mp = num_pages(max_len, page)
    if block_table is None:
        block_table = identity_block_table(batch, mp)
    block_table = (block_table.to(device=device, dtype=torch.int32)
                   if isinstance(block_table, torch.Tensor) else
                   torch.as_tensor(np.asarray(block_table, np.int32),
                                   device=device))
    assert tuple(block_table.shape) == (batch, mp), (block_table.shape,
                                                      batch, mp)
    n_pages = batch * mp if n_pages is None else n_pages
    shape = (n_pages, n_kv_heads, page, head_dim)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device),
                        block_table)


def paged_update_rows(pool, table, new, pos, slots=None):
    """Write ``new`` [B, Hkv, S, Dh] into ``pool`` [n_pages, Hkv, page, Dh]
    at token positions ``pos .. pos + S`` per row, through ``table``
    [B, max_pages], IN PLACE; returns ``pool``.  ``pos`` is a scalar or a
    per-row [B] vector.  Positions past the table's ``max_pages * page``
    capacity (the padded tail of a prompt's last chunk, a row's write
    beyond its pages) are dropped, as the JAX package's scatter drops
    them.  The table is never indexed out of range: a per-row ``pos``
    clamps the page index before the gather and turns each dropped write
    into a copy of the call's first kept write (same slot, same value),
    so the scatter needs no host sync and no bounds trap.  ``slots``
    (``write_slots``'s result) lets a layer's K and V writes share one
    index computation."""
    n, hkv, page, dh = pool.shape
    if not _is_vec(pos):
        new = new[:, :, :max(0, table.shape[1] * page - int(pos))]
    b, _, s, _ = new.shape
    if b * s == 0:
        return pool
    blk, off, src, any_kept = (write_slots(table, pos, s, page)
                               if slots is None else slots)
    vals = new.transpose(1, 2).reshape(b * s, hkv, dh).to(pool.dtype)
    if src is not None:
        vals = torch.where(any_kept, vals[src], pool[blk, :, off])
    pool[blk, :, off] = vals
    return pool


def _is_vec(pos) -> bool:
    return isinstance(pos, torch.Tensor) and pos.dim() >= 1


def write_slots(table, pos, s: int, page: int):
    """Where ``paged_update_rows`` puts a write of ``s`` tokens at ``pos``:
    ``(blk, off, src, any_kept)``, the flat [B*S] page ids and in-page
    offsets, and — for a per-row ``pos`` — the entry each write copies
    (itself if kept, else the call's first kept write) and whether any
    write is kept (else every write rewrites its slot's own value).  A
    scalar ``pos`` (already cut to the capacity) gives ``src = None``.
    One computation serves a layer's K and V pools."""
    b = table.shape[0]
    cap = table.shape[1] * page
    vec = _is_vec(pos)
    pos = torch.as_tensor(pos, device=table.device).reshape(-1).to(
        torch.int64).expand(b)
    t_idx = pos[:, None] + torch.arange(s, device=table.device)[None, :]
    blk = torch.gather(table.to(torch.int64), 1,
                       (t_idx // page).clamp(max=table.shape[1] - 1))
    blk, off = blk.reshape(-1), (t_idx % page).reshape(-1)
    if not vec:
        return blk, off, None, None
    keep = (t_idx < cap).reshape(-1)
    src = torch.where(keep, torch.arange(b * s, device=table.device),
                      keep.to(torch.int8).argmax())
    return blk[src], off[src], src, keep.any()


def gather_paged_kv(pool, table):
    """Materialize the contiguous view: [n_pages, Hkv, page, Dh] gathered
    through [B, max_pages] -> [B, Hkv, max_pages * page, Dh]."""
    b, mp = table.shape
    n, hkv, page, dh = pool.shape
    g = pool.index_select(0, table.reshape(-1).to(torch.int64))
    g = g.reshape(b, mp, hkv, page, dh).permute(0, 2, 1, 3, 4)
    return g.reshape(b, hkv, mp * page, dh)


# ---------------------------------------------------------------------------
# host-side page allocator (serving-loop boundary)
# ---------------------------------------------------------------------------
class PageAllocator:
    """Refcounted free-list over ``n_pages`` physical pages, the same
    bookkeeping as the JAX package's: ``alloc`` hands out pages (refcount
    1, LIFO reuse), ``share`` adds a reference, ``free`` drops one and
    returns the number of pages released; ``peak_live`` is the pool's
    high-water mark.  Misuse raises ``ValueError``; an exhausted pool
    raises ``MemoryError`` (``try_alloc`` returns None instead)."""

    def __init__(self, n_pages: int):
        assert n_pages > 0, n_pages
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._refs: dict = {}
        self.peak_live = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"of {self.n_pages} free")
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._refs[i] = 1
        self.peak_live = max(self.peak_live, self.n_live)
        return ids

    def try_alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        return self.alloc(n)

    def reset_peak(self) -> None:
        self.peak_live = self.n_live

    def stats(self) -> dict:
        return {"n_pages": self.n_pages, "n_live": self.n_live,
                "n_free": self.n_free, "peak_live": self.peak_live}

    def refcount(self, pid: int) -> int:
        return self._refs.get(pid, 0)

    def share(self, ids: Sequence[int]) -> List[int]:
        for i in ids:
            if self._refs.get(i, 0) <= 0:
                raise ValueError(f"share of dead page {i}")
            self._refs[i] += 1
        return list(ids)

    def free(self, ids: Sequence[int]) -> int:
        released = 0
        for i in ids:
            if self._refs.get(i, 0) <= 0:
                raise ValueError(f"double free of page {i}")
            self._refs[i] -= 1
            if self._refs[i] == 0:
                del self._refs[i]
                self._free.append(i)
                released += 1
        return released


def dtype_name(dtype) -> str:
    """The name the JAX package writes for a container dtype
    (``"bfloat16"``, ``"float8_e5m2"``, ``"float32"``) from a torch dtype
    or such a name."""
    return str(dtype).replace("torch.", "")


class SwapBlobTag(NamedTuple):
    """Provenance tag on a swapped-out page payload: which replica's pool
    it came from, the pool's container dtype (as ``dtype_name`` spells it,
    byte-compatible with the JAX package's tags) and the page size."""
    replica: int
    dtype: str
    page: int


def check_blob_tag(tag: Optional[SwapBlobTag], *, dtype, page: int) -> None:
    """Refuse a swap-in whose payload tag mismatches the receiving pool's
    (dtype, page): installing it would reinterpret page bytes.  ``None``
    (an untagged payload) is accepted; a replica mismatch alone is fine."""
    if tag is None:
        return
    want_dt, want_pg = dtype_name(dtype), int(page)
    got_dt, got_pg = dtype_name(tag.dtype), int(tag.page)
    if got_dt != want_dt or got_pg != want_pg:
        raise ValueError(
            f"foreign swap blob refused: payload from replica "
            f"{tag.replica} is ({got_dt}, page={got_pg}) but the receiving "
            f"pool is ({want_dt}, page={want_pg}) — migrating it would "
            f"reinterpret page bytes; re-ingest the request instead")


def aggregate_stats(allocators: Sequence[PageAllocator]) -> dict:
    """Fleet-level pool stats across per-replica allocators (data-parallel
    serving: each engine replica owns a DISJOINT pool, so the totals are
    plain sums — ``peak_live`` sums because replica peaks are peaks of
    independent pools, not a max over a shared one)."""
    agg = {"n_pages": 0, "n_live": 0, "n_free": 0, "peak_live": 0}
    per = []
    for a in allocators:
        s = a.stats()
        per.append(s)
        for k in agg:
            agg[k] += s[k]
    agg["replicas"] = per
    return agg


def build_tables(alloc: PageAllocator, batch: int, max_pages: int,
                 *, shared_pages: int = 0) -> np.ndarray:
    """Allocate one ``[batch, max_pages]`` table whose first
    ``shared_pages`` entries alias ONE page run in every row (a common
    prompt prefix); the rest are private per row."""
    table = np.zeros((batch, max_pages), np.int32)
    prefix = alloc.alloc(shared_pages) if shared_pages else []
    for b in range(batch):
        run = list(prefix) if b == 0 else alloc.share(prefix)
        run += alloc.alloc(max_pages - shared_pages)
        table[b] = run
    return table
