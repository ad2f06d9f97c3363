"""Shared fixed-shape KV arenas + slot pool for continuous batching.

Two arena layouts share one contract (``cache`` dict + ``positions`` +
``load_slot`` / ``release_slot``):

* :class:`KVArena` — the contiguous layout: one ``init_cache(n_slots,
  max_seq)`` allocation whose batch dimension is the slot pool, a full
  ``max_seq`` KV lane per slot.
* :class:`PagedKVArena` — fixed-size pages in a shared pool with a
  per-slot page table (vLLM-style).  A slot owns only the pages its
  request can reach (``ceil(min(prompt + max_new, kv_len) / page_size)``),
  so admission is gated on free *pages*, not free slots.

Either way every serving tick is one model call over all slots, while each
slot advances independently through a per-slot ``(n_slots,)`` position
vector.  Free lanes compute garbage that is never sampled; in the paged
layout their page-table row holds the sentinel, so they write nothing.
The arenas update their tensors in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from ..device import resolve_device

# cache entries with a (layers, batch/slot, ...) layout that admission copies
# lane by lane, as in the reference; "pos" (per-slot scalar) is handled
# separately
_LANE_KEYS = ("k", "v", "state", "xk", "xv")


def snap_page_size(kv_len: int, page_size: int) -> int:
    """Largest divisor of ``kv_len`` that is ``<= page_size``.

    Keeping pages an exact tiling of the cache length means a slot's
    gathered page view is exactly ``kv_len`` positions, so the tuned
    ``attention_decode`` workload key (static in ``t``) matches the
    contiguous layout's."""
    if kv_len < 1:
        return max(1, page_size)
    return max(
        d for d in range(1, min(page_size, kv_len) + 1) if kv_len % d == 0
    )


class SlotPool:
    """Free-list slot allocator (lowest slot first, deterministic)."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots))

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_slots - len(self._free)

    def alloc(self) -> int:
        """Claim a free slot; raises IndexError when the pool is full."""
        if not self._free:
            raise IndexError("slot pool exhausted")
        self._free.sort()
        return self._free.pop(0)

    def release(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} outside pool of {self.n_slots}")
        if slot in self._free:
            raise ValueError(f"slot {slot} already free")
        self._free.append(slot)


class KVArena:
    """The shared contiguous cache all slots decode through.

    ``model`` only needs ``init_cache(batch, max_seq, device)``.
    ``cache["pos"]`` is widened from the scalar the model allocates to a
    per-slot vector — the layout ``decode_step`` detects to switch to
    per-lane ring writes and per-lane length masking.
    """

    def __init__(self, model: Any, n_slots: int, max_seq: int, device="cuda"):
        dev = resolve_device(device)
        self.n_slots = n_slots
        self.max_seq = max_seq
        cache = dict(model.init_cache(n_slots, max_seq, device=dev))
        cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.cache: Dict[str, Any] = cache

    @property
    def positions(self) -> torch.Tensor:
        return self.cache["pos"]

    def load_slot(self, slot: int, req_cache: Dict[str, Any]) -> None:
        """Copy a batch=1 prefill cache into a slot lane (admission): every
        lane the model's cache has (``k``/``v``, the SSD ``state``, the
        encoder's ``xk``/``xv``) and the slot's position.  The prefill cache's kv length matches the arena's
        by construction (both derive from the same config + max_seq)."""
        for key in _LANE_KEYS:
            if key in self.cache:
                self.cache[key][:, slot] = req_cache[key][:, 0].to(self.cache[key].dtype)
        self.cache["pos"][slot] = int(req_cache["pos"])

    def release_slot(self, slot: int, used: int = -1) -> None:
        """Zero a lane and reset its position (the slot goes back to the
        pool).  ``used`` — how many positions the request wrote (its final
        ``pos``): only that prefix of ``k``/``v`` is zeroed, the rest of the
        lane is still zero from the previous release; the SSD ``state``,
        which every decode tick rewrites, and the encoder's ``xk``/``xv``
        are zeroed whole."""
        for key in _LANE_KEYS:
            if key not in self.cache:
                continue
            if used >= 0 and key in ("k", "v"):
                self.cache[key][:, slot, :, : min(used, self.cache[key].shape[3])] = 0
            else:
                self.cache[key][:, slot] = 0
        self.cache["pos"][slot] = 0


class PagedKVArena:
    """Paged KV cache: a shared page pool + per-slot page tables.

    Layout (per ``k`` / ``v``): ``(L, total_pages, KVH, page_size, D)``
    pools and one ``page_table`` of shape ``(n_slots, pages_per_slot)``
    holding physical page ids, with the sentinel ``total_pages`` (one past
    the pool) in unallocated entries — ``serve_step`` writes nothing
    through a sentinel entry, and the attention view clamps it to a page
    the per-slot length mask never exposes.

    ``page_size`` is snapped down to a divisor of the cache length so a
    slot's gathered view is exactly ``kv_len`` positions — the tuned
    ``attention_decode`` workload key (static in ``t = kv_len``) is the
    contiguous layout's.
    """

    def __init__(
        self,
        model: Any,
        n_slots: int,
        max_seq: int,
        page_size: int = 16,
        total_pages: int = 0,
        device="cuda",
    ):
        from ..models.transformer import cache_max_len

        cfg = model.cfg
        if cfg.attn_free or cfg.ssm_state or cfg.enc_layers:
            raise ValueError(
                "paged KV arena needs a pure-attention decoder "
                f"({cfg.name} has SSD state / encoder layers)"
            )
        dev = resolve_device(device)
        kv_len = cache_max_len(cfg, max_seq)
        ps = snap_page_size(kv_len, page_size)
        self.page_size = ps
        self.pages_per_slot = kv_len // ps
        self.kv_len = kv_len
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.total_pages = int(total_pages) or n_slots * self.pages_per_slot
        spec = model.cache_specs(1, max_seq)
        Ln, _, kvh, _, hd = spec["k"].shape
        pool_shape = (Ln, self.total_pages, kvh, ps, hd)
        self.cache: Dict[str, Any] = {
            "k": torch.zeros(pool_shape, dtype=spec["k"].dtype, device=dev),
            "v": torch.zeros(pool_shape, dtype=spec["k"].dtype, device=dev),
            "page_table": torch.full(
                (n_slots, self.pages_per_slot), self.total_pages,
                dtype=torch.int32, device=dev,
            ),
            "pos": torch.zeros((n_slots,), dtype=torch.int32, device=dev),
        }
        self._free: List[int] = list(range(self.total_pages))
        self._owned: Dict[int, List[int]] = {}

    @property
    def positions(self) -> torch.Tensor:
        return self.cache["pos"]

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, tokens: int) -> int:
        """Pages a request reaching ``tokens`` positions needs (ring-capped)."""
        reach = min(max(int(tokens), 1), self.kv_len)
        return math.ceil(reach / self.page_size)

    def can_admit(self, tokens: int) -> bool:
        return len(self._free) >= self.pages_needed(tokens)

    def reserve(self, slot: int, tokens: int) -> int:
        """Claim pages for a request's full reach (prompt + budget) and
        point the slot's page table at them.  Returns the page count."""
        if slot in self._owned:
            raise ValueError(f"slot {slot} already holds pages")
        need = self.pages_needed(tokens)
        if need > len(self._free):
            raise IndexError(
                f"page pool exhausted: need {need}, have {len(self._free)}"
            )
        self._free.sort()
        pages = [self._free.pop(0) for _ in range(need)]
        self._owned[slot] = pages
        row = self.cache["page_table"][slot]
        row.fill_(self.total_pages)
        row[: len(pages)] = torch.tensor(pages, dtype=torch.int32, device=row.device)
        return need

    def load_slot(self, slot: int, req_cache: Dict[str, Any]) -> None:
        """Scatter a batch=1 prefill cache into the slot's pages.

        Whole-prompt prefill path (``prefill_chunk=0``): the contiguous
        ``(L, 1, KVH, kv_len, D)`` lane is resliced into page-sized rows and
        written to the slot's reserved pages; the rows of unreserved
        (sentinel) entries are dropped, as the reference's scatter drops
        them."""
        pages = self._owned.get(slot, [])
        idx = torch.tensor(pages, dtype=torch.long, device=self.cache["k"].device)
        for key in ("k", "v"):
            lane = req_cache[key][:, 0].to(self.cache[key].dtype)
            Ln, kvh, _, hd = lane.shape
            paged = lane.reshape(
                Ln, kvh, self.pages_per_slot, self.page_size, hd
            ).permute(0, 2, 1, 3, 4)  # (L, P, KVH, ps, D)
            self.cache[key][:, idx] = paged[:, : len(pages)]
        self.cache["pos"][slot] = int(req_cache["pos"])

    def release_slot(self, slot: int, used: int = -1) -> None:
        """Return the slot's pages to the free pool, zeroing only them; the
        page-table row reverts to the sentinel."""
        pages = self._owned.pop(slot, [])
        if pages:
            idx = torch.tensor(pages, dtype=torch.long, device=self.cache["k"].device)
            self.cache["k"][:, idx] = 0
            self.cache["v"][:, idx] = 0
        self.cache["page_table"][slot] = self.total_pages
        self.cache["pos"][slot] = 0
        self._free.extend(pages)
