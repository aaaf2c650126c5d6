"""Paged KV cache: fixed page pool + per-request page tables (counterpart
of ``repro.serve.paged_cache``).

A fixed pool of ``num_pages`` pages of ``page_size`` tokens is shared by
all in-flight requests: a request holds only ``ceil((prompt + max_new) /
page_size)`` pages, so admission capacity is a page budget, not a
batch-slot budget.

Layout
------
  * pools: k/v each ``(L, num_pages + 1, page_size, K, hd)``.  Page index
    ``num_pages`` is the **scratch page**: inactive request slots route
    their decode writes there, so no real page is ever corrupted.
  * page table: ``(R, max_pages_per_seq)`` int32 per request slot; unused
    entries point at the scratch page, so a gather of an inactive slot
    reads only trash that positional masking discards.
  * allocation is host-side (`PageAllocator`): a free list with
    all-or-nothing grants and double-free/leak detection.

Device ops here are *per layer* (the engine loops them over the layer dim)
and write in place: the reference returns updated copies of a donated pool.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PagedCacheConfig:
    """Pool geometry. ``num_pages`` excludes the scratch page (the pool
    tensors carry ``num_pages + 1`` pages)."""

    page_size: int = 16
    num_pages: int = 64
    max_requests: int = 8        # request slots (R) of the decode step
    max_pages_per_seq: int = 16  # page-table width per slot

    @property
    def scratch_page(self) -> int:
        return self.num_pages

    @property
    def tokens_capacity(self) -> int:
        return self.num_pages * self.page_size

    def pages_needed(self, total_len: int) -> int:
        """Pages for a request of ``total_len = prompt + max_new`` tokens."""
        n = -(-total_len // self.page_size)
        if n > self.max_pages_per_seq:
            raise ValueError(
                f"request of {total_len} tokens needs {n} pages > "
                f"max_pages_per_seq={self.max_pages_per_seq}")
        return n


def init_page_pool(n_layers: int, n_kv_heads: int, head_dim: int,
                   pcfg: PagedCacheConfig, device=None):
    """Zeroed bf16 (k_pages, v_pages), each (L, P+1, page_size, K, hd)."""
    shape = (n_layers, pcfg.num_pages + 1, pcfg.page_size, n_kv_heads,
             head_dim)
    return (torch.zeros(shape, dtype=torch.bfloat16, device=device),
            torch.zeros(shape, dtype=torch.bfloat16, device=device))


class PageAllocator:
    """Host-side free-list allocator with leak/double-free detection.

    Grants are all-or-nothing: ``alloc`` returns None (and takes nothing)
    when fewer than ``n`` pages are free.
    """

    def __init__(self, pcfg: PagedCacheConfig):
        self.pcfg = pcfg
        self._free: list[int] = list(range(pcfg.num_pages))
        self._owned: dict = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, rid, n: int):
        """Grant ``n`` pages to request ``rid``; None if not available."""
        if rid in self._owned:
            raise ValueError(f"request {rid!r} already holds pages")
        if n <= 0:
            raise ValueError(f"alloc of {n} pages")
        if n > len(self._free):
            return None
        pages, self._free = self._free[:n], self._free[n:]
        self._owned[rid] = pages
        return list(pages)

    def free(self, rid) -> int:
        """Return ``rid``'s pages to the pool; raises on double-free."""
        if rid not in self._owned:
            raise ValueError(f"request {rid!r} holds no pages (double free?)")
        pages = self._owned.pop(rid)
        self._free.extend(pages)
        return len(pages)

    def check(self) -> None:
        """Invariant: free + owned partition the pool (no leak, no dup)."""
        seen = list(self._free)
        for pages in self._owned.values():
            seen.extend(pages)
        assert sorted(seen) == list(range(self.pcfg.num_pages)), (
            "page pool leak/duplication", sorted(seen))


# ---------------------------------------------------------------------------
# per-layer device ops
# ---------------------------------------------------------------------------

def write_token_kv(pages: torch.Tensor, new: torch.Tensor,
                   page_idx: torch.Tensor,
                   offset: torch.Tensor) -> torch.Tensor:
    """Write one token's KV per request slot into a (P+1, ps, K, hd) pool,
    in place.  new: (R, K, hd); page_idx/offset: (R,).  Rows of inactive
    slots must point page_idx at the scratch page (collisions there are
    harmless: scratch contents are never read unmasked)."""
    pages[page_idx.long(), offset.long()] = new.to(pages.dtype)
    return pages


def gather_all(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Full-table gather: (P+1, ps, K, hd), (R, n) -> (R, n*ps, K, hd).

    Token j of the result is absolute position j: with the table's pages
    in order this reproduces the dense cache layout exactly."""
    r, n = table.shape
    out = pages[table.long()]                 # (R, n, ps, K, hd)
    return out.reshape(r, n * pages.shape[1], *pages.shape[2:])


def window_slots(pos: torch.Tensor, window: int, pcfg: PagedCacheConfig,
                 n_table: int):
    """Which table slots a windowed decode read must touch.

    For a query at ``pos`` the live keys are [pos-window+1, pos]: that span
    crosses at most ``n_win = ceil(window / ps) + 1`` pages.  Returns
    (start (R,), n_win) with start clipped so the fixed-width slice stays
    in-table; the slice [start, start+n_win) always covers the window."""
    ps = pcfg.page_size
    n_win = min(-(-window // ps) + 1, n_table)
    start = torch.clamp(torch.div(pos, ps, rounding_mode="floor")
                        - (n_win - 1), 0, n_table - n_win)
    return start, n_win


def gather_window(pages: torch.Tensor, table: torch.Tensor,
                  start: torch.Tensor, n_win: int):
    """Windowed gather: only ``n_win`` pages per request.

    Returns (keys (R, n_win*ps, K, hd), base (R,) int32) where ``base`` is
    the absolute position of each row's token 0."""
    r = table.shape[0]
    cols = start.long()[:, None] + torch.arange(n_win, device=table.device)
    slots = torch.gather(table.long(), 1, cols)   # (R, n_win)
    out = pages[slots]                            # (R, n_win, ps, K, hd)
    ps = pages.shape[1]
    base = (start * ps).to(torch.int32)
    return out.reshape(r, n_win * ps, *pages.shape[2:]), base
