"""Block-based paged KV pool with per-sequence block tables.

Counterpart of `repro/serve/kv_pool.py`, paged pools only. Each cache kind
is carved into fixed-size blocks of `block_size` token positions handed to
sequences on demand; a per-slot block table (n_slots, max_blocks) maps
logical block -> physical block, and unallocated entries hold the OOB-HIGH
sentinel `n_blocks` (docs/CONVENTIONS.md §2 — never -1). Token kinds are
"kv" (gqa: a (k, v) pair of (P, BS, KV, hd) leaves) and "mla" (the shared
latent pools (cc, kc) of shapes (P, BS, kv_lora) and (P, BS, rope)).

With `quantized=True` every token leaf is a `PackedKV`: NVFP4 e2m1 code
pairs plus e4m3 scale bits (0.28125x the bf16 bytes), quantized per token at
scatter time (`core.formats.nvfp4_cache_encode`, deterministic RTN) and
dequantized by the packed-operand decode kernels, or exactly to bf16 by
`gather_view`.

JAX drops out-of-range scatter rows and fills out-of-range gathers with
zeros; PyTorch indexing raises instead, so this port masks explicitly:

  - every pool leaf (both leaves of a `PackedKV`) holds n_blocks + 1 blocks.
    Block `n_blocks` is a write-only SCRATCH block: `scatter_tokens` routes
    every dropped write (inactive rows, negative positions, sentinel or
    out-of-table entries) there, so a scatter never needs a host sync and
    never touches a real block. Readers are handed `readable(leaf)` (the
    first n_blocks blocks), for which the sentinel is out of bounds exactly
    as in the reference;
  - `gather_view` reads zeros for sentinel (and negative) entries.

Pool leaves are updated IN PLACE (the reference rebinds donated buffers).

Left for later slices: dense per-slot caches, shards, refcounted prefix
sharing / COW, and the host spill tier.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import formats as F
from repro_torch.models import lm

TOKEN_MIXERS = ("gqa", "lattn", "mla")


class PackedKV(NamedTuple):
    """One NVFP4-quantized token pool leaf (`KVPool(quantized=True)`).

    Two uint8 tensors sharing the leading (layer, pool block, block offset)
    axes of the bf16 leaf they replace: e2m1 codes packed two per byte over
    the LAST feature axis (..., d/2) and e4m3 group scales as raw bits
    (..., d/16): 0.5625 bytes per cached element against 2 for bf16."""

    codes: torch.Tensor   # uint8 (..., d // 2): packed e2m1 pairs
    scales: torch.Tensor  # uint8 (..., d // GROUP): e4m3 scale bits


def index_leaf(leaf, idx):
    """`leaf[idx]` of a bf16 leaf, or of both tensors of a PackedKV."""
    if isinstance(leaf, PackedKV):
        return PackedKV(leaf.codes[idx], leaf.scales[idx])
    return leaf[idx]


def readable(leaf):
    """A layer's pool leaf without its write-only scratch block: what the
    readers (gather_view, the decode kernels) are handed."""
    rows = (leaf.codes if isinstance(leaf, PackedKV) else leaf).shape[0]
    return index_leaf(leaf, slice(0, rows - 1))


def reclaim_window(cfg: ArchConfig, specs=None) -> int | None:
    """Sliding window W when EVERY token-cache layer is `lattn` (blocks may
    then be freed mid-sequence); None for stacks with full attention."""
    specs = specs if specs is not None else lm.layer_specs(cfg)
    mixers = {m for pattern, _ in specs for m, _ in pattern
              if m in TOKEN_MIXERS}
    if mixers == {"lattn"} and cfg.griffin is not None:
        return cfg.griffin.window
    return None


# --------------------------------------------------------------------------
# device-side primitives
# --------------------------------------------------------------------------

def gather_view(pool, table: torch.Tensor) -> torch.Tensor:
    """Materialize per-sequence logical views from the pool.

    pool: (P, BS, ...) (no scratch block); table: (B, MAXB), entries outside
    [0, P) are the sentinel. Returns (B, MAXB*BS, ...): each row's blocks in
    logical order, zeros for sentinel entries. A PackedKV pool gathers both
    leaves and dequantizes to bf16 (exact); sentinel blocks decode to 0."""
    if isinstance(pool, PackedKV):
        return F.nvfp4_cache_decode(gather_view(pool.codes, table),
                                    gather_view(pool.scales, table))
    p = pool.shape[0]
    ok = (table >= 0) & (table < p)
    v = pool[torch.where(ok, table, 0).long()]            # (B, MAXB, BS, ...)
    v = torch.where(ok.reshape(*ok.shape, *([1] * (pool.dim() - 1))), v,
                    torch.zeros((), dtype=pool.dtype, device=pool.device))
    b, mb = table.shape
    return v.reshape(b, mb * pool.shape[1], *pool.shape[2:])


def split_tables(block_table: torch.Tensor):
    """(read_table, write_table) from a (B, MAXB) table (its own write view)
    or a stacked (B, 2, MAXB) pair; both contiguous."""
    if block_table.dim() == 3:
        return (block_table[:, 0].contiguous(),
                block_table[:, 1].contiguous())
    return block_table, block_table


def scatter_tokens(pool, table: torch.Tensor, positions: torch.Tensor,
                   vals: torch.Tensor, valid: torch.Tensor) -> None:
    """Write per-token values through the block table, IN PLACE.

    pool: a full leaf (n_blocks + 1, BS, ...) whose last block is scratch;
    positions: (B, S) absolute positions; vals: (B, S, ...); valid: (B, S).
    Invalid rows, negative positions, positions past the table and sentinel
    entries all land in the scratch block, which no reader sees. A PackedKV
    pool quantizes each token (`nvfp4_cache_encode`) and scatters codes and
    scale bits to the same block and offset."""
    if isinstance(pool, PackedKV):
        codes, scales = F.nvfp4_cache_encode(vals)
        scatter_tokens(pool.codes, table, positions, codes, valid)
        scatter_tokens(pool.scales, table, positions, scales, valid)
        return
    n_blocks, bs = pool.shape[0] - 1, pool.shape[1]
    maxb = table.shape[1]
    valid = valid & (positions >= 0)
    p = positions.clamp(min=0).long()
    logical = p // bs
    blk = table.gather(1, logical.clamp(max=maxb - 1)).long()
    ok = valid & (logical < maxb) & (blk >= 0) & (blk < n_blocks)
    blk = torch.where(ok, blk, n_blocks)
    off = torch.where(ok, p % bs, 0)
    pool[blk, off] = vals.to(pool.dtype)


def init_cache(cfg: ArchConfig, *, n_blocks: int, block_size: int,
               device="cuda", specs=None, quantized: bool = False):
    """Stage-aligned paged pool, zero-initialized: per stage {"l<i>": {"kv":
    (k, v)}} for gqa/lattn layers, each leaf (count, n_blocks + 1,
    block_size, KV, hd), or {"l<i>": {"mla": (cc, kc)}} for MLA layers,
    leaves (count, n_blocks + 1, block_size, kv_lora | rope). Leaves are
    bf16, or PackedKV with `quantized` (zero codes and zero scale bits
    decode to exactly 0, as the bf16 pool's zeros)."""
    def tok(count, mixer, *feat):
        lead = (count, n_blocks + 1, block_size, *feat[:-1])
        d = feat[-1]
        if not quantized:
            return torch.zeros((*lead, d), dtype=torch.bfloat16, device=device)
        if d % F.GROUP:
            raise ValueError(
                f"quantized KV pool needs feature dims divisible by "
                f"{F.GROUP} (got {d} for mixer '{mixer}'): NVFP4 groups lie "
                "along the last cache axis")
        return PackedKV(
            torch.zeros((*lead, d // 2), dtype=torch.uint8, device=device),
            torch.zeros((*lead, d // F.GROUP), dtype=torch.uint8,
                        device=device))

    stages = []
    for pattern, count in (specs if specs is not None else lm.layer_specs(cfg)):
        one = {}
        for i, (mixer, _ff) in enumerate(pattern):
            if mixer in ("gqa", "lattn"):
                one[f"l{i}"] = {"kv": tuple(
                    tok(count, mixer, cfg.n_kv_heads, cfg.hd)
                    for _ in range(2))}
            elif mixer == "mla":
                m = cfg.mla
                one[f"l{i}"] = {"mla": (tok(count, mixer, m.kv_lora_rank),
                                        tok(count, mixer, m.qk_rope_head_dim))}
            else:
                raise NotImplementedError(
                    f"{mixer} caches come with a later slice")
        stages.append(one)
    return stages


# --------------------------------------------------------------------------
# host-side allocator
# --------------------------------------------------------------------------

class OutOfBlocks(RuntimeError):
    pass


class SlotError(RuntimeError):
    """Allocator misuse: double-free, or operating on an unbound slot."""


class KVPool:
    """Host-side block allocator + owner of the device pool leaves.

    Slot lifecycle: `commit(slot, total)` (bind + reserve growth) ->
    `ensure(slot, n)` before each forward so every position < n has a
    backing block -> `release(slot)` (unbind; blocks return to the free
    list). Misuse raises SlotError. Token blocks are never zeroed: stale
    values sit behind the position mask. Blocks are owned by one slot at a
    time (no prefix sharing in this slice).

    Pure sliding-window stacks (`reclaim_window`) free blocks mid-sequence
    once they fall out of every future query's window (`ensure` reclaims
    before growing), keeping live blocks O(window) per slot.

    `quantized=True` stores every token leaf as an NVFP4 `PackedKV`; it
    requires `paged=True`, as the reference does. `paged=False` (dense
    per-slot caches) is not ported yet.
    """

    def __init__(self, cfg: ArchConfig, n_slots: int, max_len: int, *,
                 paged: bool = True, block_size: int = 16,
                 n_blocks: int | None = None, device="cuda",
                 quantized: bool = False):
        assert max_len % block_size == 0, \
            f"max_len {max_len} must be a multiple of block_size {block_size}"
        if quantized and not paged:
            raise ValueError(
                "quantized=True requires paged=True: the NVFP4 cache format "
                "is a property of pool blocks")
        if not paged:
            raise NotImplementedError(
                "dense per-slot caches come with a later slice")
        self.cfg = cfg
        self.quantized = quantized
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks = max_len // block_size
        self.n_blocks = n_blocks if n_blocks is not None else \
            n_slots * self.max_blocks
        self.sentinel = self.n_blocks
        self.device = torch.device(device)
        self.specs = lm.layer_specs(cfg)
        self.caches = init_cache(cfg, n_blocks=self.n_blocks,
                                 block_size=block_size, device=device,
                                 specs=self.specs, quantized=quantized)
        self._table = np.full((n_slots, self.max_blocks), self.sentinel,
                              np.int32)
        # pop() -> the lowest free block id first
        self._free = list(range(self.n_blocks - 1, -1, -1))
        self._owned: list[list[int]] = [[] for _ in range(n_slots)]
        self._committed = [0] * n_slots  # reserved blocks per admitted seq
        self._bound = [False] * n_slots
        self._lengths = [0] * n_slots    # logical tokens backed per slot
        self._table_dev = None
        self.window = reclaim_window(cfg, self.specs)
        self._alloc_upto = [0] * n_slots   # logical blocks ever allocated
        self._live_from = [0] * n_slots    # first logical block still owned

    # ---- block accounting ----

    @property
    def free_block_count(self) -> int:
        return len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.block_size)

    def max_live_blocks(self, total_tokens: int,
                        max_growth: int | None = None) -> int:
        """Most blocks a sequence of total_tokens can own at once (a window
        bounds it at window + one growth chunk, plus block slack)."""
        need = self.blocks_for(total_tokens)
        if self.window is None or max_growth is None:
            return need
        return min(need, self.blocks_for(self.window + max_growth) + 2)

    def can_ever_admit(self, total_tokens: int,
                       max_growth: int | None = None) -> bool:
        if total_tokens > self.max_len:
            return False
        return self.max_live_blocks(total_tokens, max_growth) <= self.n_blocks

    def can_admit(self, total_tokens: int,
                  max_growth: int | None = None) -> bool:
        """Can a sequence of total_tokens be fully served alongside every
        already-admitted one? Subtracts outstanding commitments (reserved,
        not yet allocated) so growing sequences never exhaust the pool."""
        if total_tokens > self.max_len:
            return False
        outstanding = sum(self._committed[i] - len(self._owned[i])
                          for i in range(self.n_slots))
        need = self.max_live_blocks(total_tokens, max_growth)
        return self.free_block_count - outstanding >= need

    def commit(self, slot: int, total_tokens: int,
               max_growth: int | None = None) -> None:
        """Bind `slot` and reserve (without allocating) its growth blocks."""
        if self._bound[slot]:
            raise SlotError(f"slot {slot}: commit on a bound slot "
                            "(release it first)")
        if total_tokens > self.max_len:
            raise OutOfBlocks(f"slot {slot}: {total_tokens} > max_len")
        self._bound[slot] = True
        self._committed[slot] = self.max_live_blocks(total_tokens, max_growth)

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Allocate blocks so positions [0, n_tokens) of `slot` are backed."""
        if not self._bound[slot]:
            raise SlotError(f"slot {slot}: ensure on an unbound slot")
        need = self.blocks_for(n_tokens)
        if need > self.max_blocks:
            raise OutOfBlocks(f"slot {slot}: {n_tokens} tokens exceed the "
                              f"{self.max_blocks}-entry block table")
        if self.window is not None:
            self._reclaim(slot)
        while self._alloc_upto[slot] < need:
            if not self._free:
                raise OutOfBlocks(f"slot {slot}: pool exhausted")
            blk = self._free.pop()
            self._table[slot, self._alloc_upto[slot]] = blk
            self._owned[slot].append(blk)
            self._alloc_upto[slot] += 1
            self._table_dev = None
        self._lengths[slot] = max(self._lengths[slot], n_tokens)

    def _reclaim(self, slot: int) -> None:
        """Return out-of-window blocks of `slot` to the free list.

        Block j (keys [j*BS, (j+1)*BS)) is dead once its newest key leaves
        the window of every future query (qpos >= the committed length):
        (j+1)*BS - 1 <= cur - window. Freed entries become the sentinel."""
        cur = self._lengths[slot]
        first_live = min(max(0, (cur + 1 - self.window) // self.block_size),
                         self._alloc_upto[slot])
        if first_live <= self._live_from[slot]:
            return
        for j in range(self._live_from[slot], first_live):
            blk = int(self._table[slot, j])
            self._table[slot, j] = self.sentinel
            self._owned[slot].remove(blk)
            self._free.append(blk)
        self._live_from[slot] = first_live
        self._table_dev = None

    def length(self, slot: int) -> int:
        return self._lengths[slot]

    def release(self, slot: int) -> None:
        """Unbind `slot`; its blocks return to the free list."""
        if not self._bound[slot]:
            raise SlotError(f"slot {slot}: release on an unbound slot "
                            "(double-free?)")
        self._bound[slot] = False
        self._committed[slot] = 0
        self._lengths[slot] = 0
        # reversed so the first-allocated block pops first next time
        self._free.extend(reversed(self._owned[slot]))
        self._owned[slot] = []
        if self._alloc_upto[slot]:
            self._table[slot, :] = self.sentinel
            self._table_dev = None
        self._alloc_upto[slot] = 0
        self._live_from[slot] = 0

    def tables_device(self) -> torch.Tensor:
        """Device copy of the (n_slots, max_blocks) int32 block table, cached
        until the host table changes. Without prefix sharing the read and
        write views coincide, so one table serves both."""
        if self._table_dev is None:
            self._table_dev = torch.tensor(self._table, device=self.device)
        return self._table_dev
