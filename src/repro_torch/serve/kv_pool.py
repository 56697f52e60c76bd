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

Blocks are REFCOUNTED for the prefix cache (`serve/prefix_cache.py`): a
physical block may back the same logical prefix of several slots and the
cache at once. `adopt_prefix` aliases cached blocks read-only into a fresh
slot, `cow_block` gives a slot a private copy of a cached block, and
`_decref` is the only way back to the free list. `tables_device` stacks a
READ table and a WRITE table whose adopted entries hold the sentinel, so a
scatter through a shared block lands in the scratch block: the masking is
in the data. The host tier snapshots a block's bytes into host memory
(`read_block_host`, pinned buffers reused through a free list on a card)
and writes them back with a non-blocking copy on the current stream
(`write_block_host`), which orders every later step after it.

Left for later slices: dense per-slot caches and mesh shards (one shard
here: `shard_of_slot` is 0).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
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


def token_leaves(caches):
    """Every token-pool tensor of a cache tree, in a fixed order (stage,
    layer, kind, leaf; a PackedKV gives its codes, then its scales)."""
    out = []
    for stage in caches:
        for kinds in stage.values():
            for pair in kinds.values():
                for leaf in pair:
                    out.extend(leaf if isinstance(leaf, PackedKV) else (leaf,))
    return out


def _like_tree(caches, leaves):
    """`leaves` (in `token_leaves` order) laid out in `caches`' structure."""
    it = iter(leaves)
    out = []
    for stage in caches:
        one = {}
        for lk, kinds in stage.items():
            one[lk] = {kind: tuple(
                PackedKV(next(it), next(it)) if isinstance(leaf, PackedKV)
                else next(it) for leaf in pair) for kind, pair in kinds.items()}
        out.append(one)
    return out


@dataclass
class HostBlock:
    """One pool block's bytes in host memory: a host-tier snapshot.

    `stages` mirrors the token kinds of `KVPool.caches` (a list of stages of
    {"l<i>": {kind: (leaf, leaf)}}), each leaf of shape (count, BS, ...) in
    the pool leaf's dtype; a PackedKV stays a PackedKV of uint8 codes and
    scale bits, never dequantized. Every leaf is a view of `buf`, one flat
    uint8 buffer, pinned when the pool lies on a card. `done` is the CUDA
    event recorded on the stream after the last copy out of `buf` was
    dispatched (None on the CPU, where copies are synchronous); the pool
    reuses `buf` only once that event has completed."""

    stages: list
    buf: torch.Tensor
    done: object = None


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
    backing block -> `release(slot)` (unbind; each block loses this slot's
    reference). Misuse raises SlotError. Token blocks are
    never zeroed: stale values sit behind the position mask.

    Blocks are refcounted (`_ref`): one reference per slot table row that
    holds the block plus at most one prefix-cache hold. A block is free iff
    its count is 0, and `_decref` is the only path back to the free list,
    so a shared block is never double-freed. `adopt_prefix` aliases cached
    blocks read-only (masked out of the write table), `cow_block` copies a
    cached block privately, `alloc_cache_block` takes a block owned by the
    cache alone (a swap-in target), and `evict_hook` (set by the prefix
    cache) frees cached blocks when the free list runs dry.

    Pure sliding-window stacks (`reclaim_window`) free blocks mid-sequence
    once they fall out of every future query's window (`ensure` reclaims
    before growing), keeping live blocks O(window) per slot.

    `quantized=True` stores every token leaf as an NVFP4 `PackedKV`; it
    requires `paged=True`, as the reference does. `paged=False` (dense
    per-slot caches) is not ported yet, and neither are mesh shards: the
    pool has one shard.
    """

    def __init__(self, cfg: ArchConfig, n_slots: int, max_len: int, *,
                 paged: bool = True, block_size: int = 16,
                 n_blocks: int | None = None, device="cuda",
                 quantized: bool = False, specs=None):
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
        self.paged = paged
        self.quantized = quantized
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks = max_len // block_size
        self.n_blocks = n_blocks if n_blocks is not None else \
            n_slots * self.max_blocks
        self.sentinel = self.n_blocks
        self.device = torch.device(device)
        # `specs`: the layer specs the pool backs (a draft stack passes
        # lm.prefix_specs); default the full model's
        self.specs = specs if specs is not None else lm.layer_specs(cfg)
        # recurrent state kinds (rwkv, griffin) come with their families:
        # every ported stack holds token kinds only, which a speculative
        # rollback truncates for free
        self.has_state_kinds = False
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
        self._ref = np.zeros(self.n_blocks, np.int32)
        # leading logical blocks of each slot that are aliased (read-only)
        self._shared_upto = [0] * n_slots
        # set by the prefix cache: callable(shard, need) -> blocks freed
        self.evict_hook = None
        self._tables_dev = None
        self.window = reclaim_window(cfg, self.specs)
        self._alloc_upto = [0] * n_slots   # logical blocks ever allocated
        self._live_from = [0] * n_slots    # first logical block still owned
        self._floor = [0] * n_slots        # least length `truncate` allows
        # host tier: flat buffers of one block's bytes, reused; the bytes of
        # free buffers kept are bounded by host_keep_bytes (None: unbounded)
        leaves = token_leaves(self.caches)
        self._host_shapes = [(t.dtype, (t.shape[0], *t.shape[2:]))
                             for t in leaves]
        self._host_offsets, off = [], 0
        for t in leaves:
            self._host_offsets.append(off)
            off += -(-t[:, 0].numel() * t.element_size() // 16) * 16
        self.host_block_bytes = off
        self.host_keep_bytes: int | None = None
        self.host_allocs = 0
        self._host_free: list[torch.Tensor] = []
        self._host_pending: list[HostBlock] = []

    # ---- block accounting ----

    def shard_of_slot(self, slot: int) -> int:
        return 0

    @property
    def free_block_count(self) -> int:
        return len(self._free)

    def _outstanding(self) -> int:
        return sum(self._committed[i] - len(self._owned[i])
                   for i in range(self.n_slots))

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

    def can_admit(self, total_tokens: int, max_growth: int | None = None,
                  slot: int | None = None, cached_blocks: int = 0) -> bool:
        """Can a sequence of total_tokens be fully served alongside every
        already-admitted one? Subtracts outstanding commitments (reserved,
        not yet allocated) so growing sequences never exhaust the pool;
        `cached_blocks` (prefix-cache blocks the candidate would adopt, not
        allocate) reduce its demand."""
        if total_tokens > self.max_len:
            return False
        return self.admission_shortfall(total_tokens, max_growth, slot,
                                        cached_blocks) == 0

    def admission_shortfall(self, total_tokens: int,
                            max_growth: int | None = None,
                            slot: int | None = None,
                            cached_blocks: int = 0) -> int:
        """Free blocks missing for `can_admit` to pass (0 when it passes):
        what the engine asks the prefix cache to evict before admitting."""
        if total_tokens > self.max_len:
            return 0
        need = max(0, self.max_live_blocks(total_tokens, max_growth)
                   - cached_blocks)
        return max(0, need - (len(self._free) - self._outstanding()))

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

    def _pop_free(self, what: str) -> int:
        """The lowest free block, evicting cached blocks when none is free
        (the caller checks every other precondition first)."""
        if not self._free and not (self.evict_hook is not None
                                   and self.evict_hook(0, 1) > 0):
            raise OutOfBlocks(what)
        blk = self._free.pop()
        self._ref[blk] = 1
        return blk

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
            blk = self._pop_free(f"slot {slot}: pool exhausted")
            self._table[slot, self._alloc_upto[slot]] = blk
            self._owned[slot].append(blk)
            self._alloc_upto[slot] += 1
            self._dirty()
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
            self._decref(blk)
        self._live_from[slot] = first_live
        self._dirty()
        # freed keys end at first_live*BS - 1; a truncate to n keeps windows
        # sound only while n - window >= that newest freed key
        self._floor[slot] = first_live * self.block_size + self.window - 1

    def truncate(self, slot: int, n_tokens: int) -> None:
        """Logically shrink `slot` to n_tokens positions (speculative
        rollback). The slot keeps every block it owns (the next rounds grow
        back into them), and stale values past n_tokens stay behind the
        position mask until overwritten: only the length moves. Below the
        window-reclaim floor the rolled-back windows would need freed keys,
        so that is a SlotError."""
        if not self._bound[slot]:
            raise SlotError(f"slot {slot}: truncate on an unbound slot")
        if n_tokens < 0 or n_tokens > self._lengths[slot]:
            raise SlotError(
                f"slot {slot}: truncate to {n_tokens} outside "
                f"[0, {self._lengths[slot]}]")
        if n_tokens < self._floor[slot]:
            raise SlotError(
                f"slot {slot}: truncate to {n_tokens} below the "
                f"window-reclaim floor {self._floor[slot]}")
        self._lengths[slot] = n_tokens

    def length(self, slot: int) -> int:
        """Logical backed length of `slot` (ensure grows it, truncate cuts)."""
        return self._lengths[slot]

    def release(self, slot: int) -> None:
        """Unbind `slot`, dropping its block references: blocks nobody else
        holds return to the free list."""
        if not self._bound[slot]:
            raise SlotError(f"slot {slot}: release on an unbound slot "
                            "(double-free?)")
        self._bound[slot] = False
        self._committed[slot] = 0
        self._lengths[slot] = 0
        # reversed so an exclusive slot's first-allocated block pops first
        for blk in reversed(self._owned[slot]):
            self._decref(blk)
        self._owned[slot] = []
        if self._alloc_upto[slot]:
            self._table[slot, :] = self.sentinel
            self._dirty()
        self._alloc_upto[slot] = 0
        self._live_from[slot] = 0
        self._floor[slot] = 0
        self._shared_upto[slot] = 0

    def _dirty(self) -> None:
        self._tables_dev = None

    def tables_device(self) -> torch.Tensor:
        """The (n_slots, 2, max_blocks) int32 device tables, cached until the
        host table changes: [:, 0] the READ table, [:, 1] the WRITE table,
        in which every adopted (shared) logical block holds the sentinel,
        so a scatter through it lands in the scratch block. Stored as a
        (2, n_slots, max_blocks) tensor and returned permuted, so each view
        `[:, k]` is contiguous."""
        if self._tables_dev is None:
            wt = self._table.copy()
            for s, k in enumerate(self._shared_upto):
                wt[s, :k] = self.sentinel
            self._tables_dev = torch.from_numpy(
                np.stack([self._table, wt])).to(self.device).permute(1, 0, 2)
        return self._tables_dev

    # ---- prefix sharing (refcounted aliasing + copy-on-write) ----

    def _decref(self, block: int) -> None:
        """Drop one reference; the last reference frees the block."""
        self._ref[block] -= 1
        if self._ref[block] < 0:
            raise SlotError(f"block {block}: decref below zero (double free)")
        if self._ref[block] == 0:
            self._free.append(block)

    def incref(self, block: int) -> None:
        """Add an external (prefix-cache) hold on an allocated block."""
        if self._ref[block] <= 0:
            raise SlotError(f"block {block}: incref on a free block")
        self._ref[block] += 1

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    def adopt_prefix(self, slot: int, blocks: list[int],
                     n_tokens: int) -> None:
        """Alias cached `blocks` READ-ONLY as `slot`'s logical prefix: each
        is incref'd and masked out of the write table. Only on a freshly
        committed slot, and not on sliding-window pools (a reclaimed prefix
        is not fully resident)."""
        if not self._bound[slot]:
            raise SlotError(f"slot {slot}: adopt_prefix on an unbound slot")
        if self._owned[slot]:
            raise SlotError(f"slot {slot}: adopt_prefix after allocation")
        if self.window is not None:
            raise SlotError("adopt_prefix on a sliding-window pool: "
                            "reclaimed prefixes are not fully resident")
        if n_tokens > len(blocks) * self.block_size:
            raise SlotError(f"slot {slot}: {n_tokens} tokens exceed "
                            f"{len(blocks)} adopted blocks")
        for j, blk in enumerate(blocks):
            self.incref(blk)
            self._table[slot, j] = blk
            self._owned[slot].append(blk)
        self._alloc_upto[slot] = len(blocks)
        self._shared_upto[slot] = len(blocks)
        self._lengths[slot] = max(self._lengths[slot], n_tokens)
        self._dirty()

    def cow_block(self, slot: int, src: int) -> int:
        """Copy-on-write: append a PRIVATE copy of block `src` as `slot`'s
        next logical block (the divergence or a partial tail lies inside a
        cached block). Returns the new block id."""
        if not self._bound[slot]:
            raise SlotError(f"slot {slot}: cow_block on an unbound slot")
        if self._ref[src] <= 0:
            raise SlotError(f"block {src}: COW from a free block")
        j = self._alloc_upto[slot]
        if j >= self.max_blocks:
            # checked BEFORE popping: a pop-then-raise would strand the
            # popped block at refcount 1 with no owner
            raise OutOfBlocks(f"slot {slot}: table full at COW")
        dst = self._pop_free(f"slot {slot}: no free block for COW")
        self._table[slot, j] = dst
        self._owned[slot].append(dst)
        self._alloc_upto[slot] = j + 1
        self._copy_block_device(src, dst)
        self._dirty()
        return dst

    def _copy_block_device(self, src: int, dst: int) -> None:
        """Device copy of block `src` -> `dst` in every token leaf, one
        indexed copy a leaf on the current stream; a PackedKV's codes and
        scales both move before any later step can read the block."""
        for leaf in token_leaves(self.caches):
            leaf[:, dst] = leaf[:, src]

    def alloc_cache_block(self, shard: int = 0) -> int:
        """One block OWNED BY THE PREFIX CACHE (ref 1, no slot): a swap-in
        target. Evicts like `ensure` under pressure; pin (acquire) the cache
        path being materialized first."""
        return self._pop_free(f"shard {shard}: no free block for the cache")

    # ---- host spill tier ----
    #
    # The prefix cache's host tier keeps IMMUTABLE snapshots of block
    # bytes: host -> device -> host is the identity, for bf16 and for the
    # packed uint8 bytes of a PackedKV pool alike.

    def _host_buffer(self) -> torch.Tensor:
        self.poll_host()
        if self._host_free:
            return self._host_free.pop()
        self.host_allocs += 1
        return torch.empty(self.host_block_bytes, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")

    def read_block_host(self, block: int):
        """Snapshot block `block` of every token leaf into host memory.

        Returns `(payload, nbytes)`: a `HostBlock` and its leaves' bytes.
        Synchronous (the copies complete before it returns). On a card the
        buffer is pinned, taken from the pool's free list when one is
        there, so a spill allocates pinned memory (through PyTorch's
        caching host allocator, which calls `cudaHostAlloc` when it holds
        no freed block) only when the tier grows past its high-water mark."""
        buf = self._host_buffer()
        views = []
        for leaf, off, (dtype, shape) in zip(token_leaves(self.caches),
                                              self._host_offsets,
                                              self._host_shapes):
            n = math.prod(shape) * leaf.element_size()
            v = buf[off:off + n].view(dtype).view(shape)
            v.copy_(leaf[:, block])
            views.append(v)
        nbytes = sum(v.numel() * v.element_size() for v in views)
        return HostBlock(_like_tree(self.caches, views), buf), nbytes

    def write_block_host(self, block: int, payload: HostBlock) -> None:
        """Write a `read_block_host` payload into block `block`.

        Dispatch-only: on a card, non-blocking host-to-device copies from
        the pinned buffer on the current stream, which orders every later
        step after them; the event recorded behind them (`payload.done`)
        keeps the buffer from reuse until they have run. A pageable source
        would make the copy synchronous, so it is refused."""
        if self.device.type == "cuda" and not payload.buf.is_pinned():
            raise ValueError("write_block_host needs a pinned host buffer: "
                             "a pageable source makes the copy synchronous")
        for leaf, src in zip(token_leaves(self.caches),
                             token_leaves(payload.stages)):
            leaf[:, block].copy_(src, non_blocking=True)
        if self.device.type == "cuda":
            payload.done = torch.cuda.Event()
            payload.done.record()

    def release_host(self, payload: HostBlock) -> None:
        """The prefix cache dropped `payload`: its buffer returns to the
        free list once every copy out of it has run."""
        self._host_pending.append(payload)
        self.poll_host()

    def poll_host(self) -> None:
        """Recycle released buffers whose copies have completed (kept while
        the free buffers' bytes stay within `host_keep_bytes`)."""
        keep = []
        for p in self._host_pending:
            if p.done is not None and not p.done.query():
                keep.append(p)
            elif (self.host_keep_bytes is None
                  or (len(self._host_free) + 1) * self.host_block_bytes
                  <= self.host_keep_bytes):
                self._host_free.append(p.buf)
        self._host_pending = keep
