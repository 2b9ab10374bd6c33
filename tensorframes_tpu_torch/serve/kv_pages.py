"""Paged KV cache: a static-shape page pool + per-sequence page tables.

The port of ``tensorframes_tpu/serve/kv_pages.py`` (the shared-prefix
``PrefixCache`` waits for a later slice):

- **device**: one pool of fixed-size pages per layer,
  ``[n_layers, num_pages + 1, page_size, n_kv_heads, head_dim]``. The
  extra row at index ``num_pages`` is the TRASH page: writes from idle
  slots land there, keeping every step input in bounds.
- **host**: a LIFO free-list allocator with refcounts and per-sequence
  page tables (:class:`SequencePages`). A finished sequence's pages
  return to the pool at once, so device memory holds LIVE tokens.

Exhaustion raises :class:`~..utils.failures.PagePoolExhausted`, the
scheduler's cue to preempt and requeue, never a crash.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

from ..utils.config import resolve_device
from ..utils.failures import PagePoolExhausted

__all__ = ["PagePool", "SequencePages", "pages_needed"]


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages required to hold ``tokens`` positions."""
    return -(-int(tokens) // int(page_size))


class PagePool:
    """Fixed-size KV page pool: device tensors with a STATIC shape plus a
    host-side free-list allocator. ``k``/``v`` are updated in place by the
    engine's steps; the pool only tracks WHICH pages are live."""

    def __init__(
        self,
        n_layers: int,
        n_kv_heads: int,
        head_dim: int,
        num_pages: int,
        page_size: int,
        dtype=torch.float32,
        device="cuda",
    ):
        if num_pages < 1 or page_size < 1:
            raise ValueError(
                f"need num_pages >= 1 and page_size >= 1; got "
                f"{num_pages}, {page_size}"
            )
        self.n_layers = int(n_layers)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.device = resolve_device(device)
        self.dtype = dtype
        #: index of the trash page (valid to write, never read unmasked)
        self.trash_page = self.num_pages
        self.k = self._zeros()
        self.v = self._zeros()
        self._lock = threading.Lock()
        # LIFO free list: recently-freed pages are reused first; the
        # shadow set keeps the double-free guard O(1) per page
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._free_set = set(self._free)
        #: per-page reference count: 1 at alloc, +1 per ref(), -1 per free()
        self._refcount = np.zeros(self.num_pages, np.int32)

    def _zeros(self) -> torch.Tensor:
        shape = (
            self.n_layers, self.num_pages + 1, self.page_size,
            self.n_kv_heads, self.head_dim,
        )
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # -- allocation --------------------------------------------------------

    def alloc(self, n: int = 1) -> List[int]:
        """Take ``n`` pages off the free list — all or nothing. Raises
        :class:`PagePoolExhausted` when fewer than ``n`` are free."""
        with self._lock:
            if n > len(self._free):
                raise PagePoolExhausted(
                    f"KV page pool exhausted: need {n} page(s), "
                    f"{len(self._free)}/{self.num_pages} free"
                )
            grant = self._free[-n:][::-1]
            del self._free[len(self._free) - n :]
            self._free_set.difference_update(grant)
            self._refcount[grant] = 1
            return grant

    def ref(self, pages: Iterable[int]) -> None:
        """Take one more reference on each LIVE page."""
        with self._lock:
            pages = [int(p) for p in pages]
            for p in pages:
                if not 0 <= p < self.num_pages:
                    raise ValueError(f"page {p} is not a pool page")
                if p in self._free_set or self._refcount[p] < 1:
                    raise ValueError(f"cannot ref free page {p}")
            for p in pages:
                self._refcount[p] += 1

    def free(self, pages: Iterable[int]) -> int:
        """Drop one reference per page; pages whose last reference this
        was return to the free list. Returns how many actually freed."""
        freed = 0
        with self._lock:
            for p in pages:
                p = int(p)
                if not 0 <= p < self.num_pages:
                    raise ValueError(f"page {p} is not a pool page")
                if p in self._free_set or self._refcount[p] < 1:
                    raise ValueError(f"double free of page {p}")
                self._refcount[p] -= 1
                if self._refcount[p] == 0:
                    self._free.append(p)
                    self._free_set.add(p)
                    freed += 1
        return freed

    @property
    def pages_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.pages_free

    @property
    def pages_shared(self) -> int:
        """Pages named by more than one reference."""
        with self._lock:
            return int((self._refcount > 1).sum())

    def reset(self) -> None:
        """Crash recovery: fresh zeroed page tensors and every page back on
        the free list. The caller must first requeue every live sequence."""
        with self._lock:
            self.k = self._zeros()
            self.v = self._zeros()
            self._free = list(range(self.num_pages - 1, -1, -1))
            self._free_set = set(self._free)
            self._refcount[:] = 0

    # -- defragmentation ---------------------------------------------------

    def defragment(self, sequences: Sequence["SequencePages"]) -> Dict[int, int]:
        """Compact every live page to the lowest pool indices: one gather
        per pool tensor rewrites page CONTENTS, and each sequence's table
        is renumbered in place. Returns the ``old -> new`` remap."""
        with self._lock:
            owners: Dict[int, int] = {}
            all_lists: List[List[int]] = [seq.pages for seq in sequences]
            for pages in all_lists:
                for p in pages:
                    owners[p] = owners.get(p, 0) + 1
            for p, n in owners.items():
                if n > int(self._refcount[p]):
                    raise ValueError(
                        f"page {p} named by {n} owners but refcount is "
                        f"{int(self._refcount[p])}"
                    )
            remap = {old: new for new, old in enumerate(sorted(owners))}
            # perm[new] = old for live pages; free pages fill the tail in
            # index order; trash stays trash
            tail = [p for p in range(self.num_pages) if p not in remap]
            perm = np.empty(self.num_pages + 1, np.int64)
            for old, new in remap.items():
                perm[new] = old
            perm[len(remap) : self.num_pages] = tail
            perm[self.num_pages] = self.trash_page
            idx = torch.from_numpy(perm).to(self.device)
            self.k = self.k[:, idx]
            self.v = self.v[:, idx]
            self._refcount = self._refcount[perm[: self.num_pages]]
            for pages in all_lists:
                pages[:] = [remap[p] for p in pages]
            self._free = list(range(self.num_pages - 1, len(remap) - 1, -1))
            self._free_set = set(self._free)
            return remap

    def __repr__(self) -> str:
        return (
            f"PagePool(pages={self.num_pages}, page_size={self.page_size}, "
            f"in_use={self.pages_in_use})"
        )


class SequencePages:
    """One sequence's slice of the pool: the ordered page list (page ``i``
    holds positions ``i*page_size .. (i+1)*page_size - 1``). Pure host
    state; the device-visible form is :meth:`table`."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.pages: List[int] = []

    def ensure(self, tokens: int) -> None:
        """Grow until ``tokens`` positions fit (all or nothing); raises
        :class:`PagePoolExhausted` with holdings unchanged."""
        missing = pages_needed(tokens, self.pool.page_size) - len(self.pages)
        if missing > 0:
            self.pages.extend(self.pool.alloc(missing))

    def release(self) -> None:
        """Return every held page to the pool (idempotent)."""
        if self.pages:
            self.pool.free(self.pages)
            self.pages = []

    def table(self, max_pages: int) -> np.ndarray:
        """The ``[max_pages]`` int32 page table: held pages in position
        order, trash-filled past the end."""
        if len(self.pages) > max_pages:
            raise ValueError(
                f"sequence holds {len(self.pages)} pages > max_pages "
                f"{max_pages}"
            )
        out = np.full(max_pages, self.pool.trash_page, np.int32)
        out[: len(self.pages)] = self.pages
        return out
