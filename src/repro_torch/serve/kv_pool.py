"""Block-based paged KV pool with per-sequence block tables.

Counterpart of `repro/serve/kv_pool.py`, paged pools only. Each cache kind
is carved into fixed-size blocks of `block_size` token positions handed to
sequences on demand; a per-slot block table (n_slots, max_blocks) maps
logical block -> physical block, and unallocated entries hold the OOB-HIGH
sentinel `n_blocks` (docs/CONVENTIONS.md §2 — never -1). Token kinds are
"kv" (gqa, lattn: a (k, v) pair of (P, BS, KV, hd) leaves) and "mla" (the
shared latent pools (cc, kc) of shapes (P, BS, kv_lora) and (P, BS, rope)).
The recurrent STATE kinds ("wkv", "tm_prev", "cm_prev", "lru": rwkv6 and
griffin) are slot leaves (layers, n_slots, ...), O(1) per sequence: one
implicit block per slot, zeroed at admission (`reset_slot`), and for a
speculative rollback copied and restored (`snapshot_states`,
`restore_states`), since they integrate every token irreversibly.

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

With `paged=False` the pool holds dense per-slot caches instead
(`lm.init_cache`: (count, n_slots, max_len + 1, ...) leaves, position
max_len of each row the write-only scratch position), the layout of the
reference's dense mode and of the fixed-batch loop: the same masking
conventions and the same attention arithmetic, with no blocks. It tracks
bindings and lengths only; the block-level operations raise SlotError.

With `n_shards > 1` the allocator is SLOT-AFFINE over a mesh "data" axis
(mesh-sharded serving, `serve/engine.py`): slots and physical blocks split
into `n_shards` contiguous ranges (`dist.sharding.serve_shard_sizes`), and
a slot only ever receives blocks homed on its own shard (per-shard free
lists). Each shard owns its own cache tree on its own device
(`shard_caches[s]`, on `devices[s]`): token leaves of blocks_per_shard + 1
blocks, the last its own scratch block, and state kinds / dense caches of
slots_per_shard slots. A contiguous cut of one (n_blocks + 1)-block leaf
would leave every shard but the last without a scratch block, and shard
s's local sentinel would index shard s + 1's first real block. Host-side
ids stay global; the device tables carry SHARD-LOCAL ids (the global id
minus the shard's base, the sentinel mapped to blocks_per_shard, still out
of bounds for the shard's readable leaves), so the gather, the scatter and
the decode kernels run unchanged on a shard's tree, and no step ever moves
a block between shards. Block copies, host snapshots and recurrent slot
state route to the owning shard by `shard_of_block` / `shard_of_slot`.
With `n_shards=1` every id, table and leaf is what the unsharded pool has.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import formats as F
from repro_torch.dist.sharding import serve_shard_sizes
from repro_torch.models import lm

TOKEN_MIXERS = ("gqa", "lattn", "mla")
TOKEN_KINDS = ("kv", "mla")
STATE_KINDS = ("wkv", "tm_prev", "cm_prev", "lru")


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


def scatter_dense(cache: torch.Tensor, positions: torch.Tensor,
                  vals: torch.Tensor, valid: torch.Tensor) -> None:
    """Write per-token values into a dense per-slot cache leaf, IN PLACE.

    cache: (B, max_len + 1, ...) whose last position is the write-only
    scratch position; positions: (B, S) absolute positions; vals: (B, S,
    ...); valid: (B, S). Row b's token at position p lands at [b, p];
    invalid tokens and positions outside [0, max_len) land in the scratch
    position, which no reader sees (the reference's dropped writes)."""
    cap = cache.shape[1] - 1
    ok = valid & (positions >= 0) & (positions < cap)
    idx = torch.where(ok, positions, cap).long()
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[rows, idx] = vals.to(cache.dtype)


def init_cache(cfg: ArchConfig, *, n_blocks: int, block_size: int,
               n_slots: int, device="cuda", specs=None,
               quantized: bool = False):
    """Stage-aligned paged pool, zero-initialized: per stage {"l<i>": {"kv":
    (k, v)}} for gqa/lattn layers, each leaf (count, n_blocks + 1,
    block_size, KV, hd), or {"l<i>": {"mla": (cc, kc)}} for MLA layers,
    leaves (count, n_blocks + 1, block_size, kv_lora | rope). Token leaves
    are bf16, or PackedKV with `quantized` (zero codes and zero scale bits
    decode to exactly 0, as the bf16 pool's zeros). The recurrent layers
    hold their state kinds as slot leaves (count, n_slots, ...), laid out
    as `lm.state_cache` makes them."""
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
        for i, (mixer, ff) in enumerate(pattern):
            c = {}
            if mixer in ("gqa", "lattn"):
                c["kv"] = tuple(tok(count, mixer, cfg.n_kv_heads, cfg.hd)
                                for _ in range(2))
            elif mixer == "mla":
                m = cfg.mla
                c["mla"] = (tok(count, mixer, m.kv_lora_rank),
                            tok(count, mixer, m.qk_rope_head_dim))
            c.update(lm.state_cache(mixer, ff, cfg, n_slots, device, (count,)))
            one[f"l{i}"] = c
        stages.append(one)
    return stages


def token_leaves(caches):
    """Every token-pool tensor of a cache tree, in a fixed order (stage,
    layer, kind, leaf; a PackedKV gives its codes, then its scales)."""
    out = []
    for stage in caches:
        for kinds in stage.values():
            for kind, pair in kinds.items():
                if kind not in TOKEN_KINDS:
                    continue
                for leaf in pair:
                    out.extend(leaf if isinstance(leaf, PackedKV) else (leaf,))
    return out


def state_leaves(caches):
    """Every state-kind tensor of a cache tree, in a fixed order (stage,
    layer, kind, leaf)."""
    out = []
    for stage in caches:
        for kinds in stage.values():
            for kind, v in kinds.items():
                if kind in STATE_KINDS:
                    out.extend(v if isinstance(v, tuple) else (v,))
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
                else next(it) for leaf in pair)
                for kind, pair in kinds.items() if kind in TOKEN_KINDS}
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
    event recorded on the stream after the last copy into or out of `buf`
    was dispatched (None on the CPU, where copies are synchronous, and
    after a synchronous read); the pool reuses `buf` only once that event
    has completed."""

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

    Slot lifecycle: `reset_slot(slot)` (zero the recurrent state of an
    UNBOUND slot) -> `commit(slot, total)` (bind + reserve growth) ->
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
    requires `paged=True`, as the reference does. `paged=False` builds
    dense per-slot caches: `ensure` tracks lengths only, admission is
    bounded by max_len alone, `tables_device` is None (the step attends the
    dense caches), and adopting, COW and the host tier raise SlotError.

    `n_shards > 1` makes allocation SLOT-AFFINE (module docstring): shard s
    owns slots [s*n_slots/S, (s+1)*n_slots/S) and blocks [s*n_blocks/S,
    (s+1)*n_blocks/S), each shard runs its own free list, a slot allocates
    only from its shard, and admission is per shard (`can_admit(...,
    slot=i)`): one shard can be full while another has room; without a
    slot they answer for the shard that could take it, as the reference's
    "can any shard take it". `devices` names each shard's device (default:
    every shard on `device`).
    """

    def __init__(self, cfg: ArchConfig, n_slots: int, max_len: int, *,
                 paged: bool = True, block_size: int = 16,
                 n_blocks: int | None = None, device="cuda",
                 quantized: bool = False, specs=None, n_shards: int = 1,
                 devices=None):
        assert max_len % block_size == 0, \
            f"max_len {max_len} must be a multiple of block_size {block_size}"
        if quantized and not paged:
            raise ValueError(
                "quantized=True requires paged=True: the NVFP4 cache format "
                "is a property of pool blocks")
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
        self.n_shards = n_shards
        self.slots_per_shard, self.blocks_per_shard = serve_shard_sizes(
            n_slots, self.n_blocks, n_shards)
        self.devices = tuple(torch.device(d) for d in (
            devices if devices is not None else [device] * n_shards))
        if len(self.devices) != n_shards:
            raise ValueError(f"{len(self.devices)} devices for {n_shards} "
                             "shards: name one a shard")
        self.device = self.devices[0]
        # `specs`: the layer specs the pool backs (a draft stack passes
        # lm.prefix_specs); default the full model's
        self.specs = specs if specs is not None else lm.layer_specs(cfg)
        # one tree a shard, on the shard's device (module docstring). A
        # dense pool's sliding-window layers keep full capacity (no ring):
        # chunked prefill writes several positions a step
        self.shard_caches = [
            init_cache(cfg, n_blocks=self.blocks_per_shard,
                       block_size=block_size, n_slots=self.slots_per_shard,
                       device=d, specs=self.specs, quantized=quantized)
            if paged else
            lm.init_cache(cfg, self.slots_per_shard, max_len, device=d,
                          specs=self.specs, lattn_ring=False)
            for d in self.devices]
        # the one tree of an unsharded pool (what its step is handed)
        self.caches = self.shard_caches[0] if n_shards == 1 else None
        # recurrent state kinds (rwkv, griffin): a speculative rollback
        # snapshots and restores them; token kinds truncate for free
        self.has_state_kinds = bool(state_leaves(self.shard_caches[0]))
        self._table = np.full((n_slots, self.max_blocks), self.sentinel,
                              np.int32)
        # per-shard free lists; pop() -> the shard's lowest free block first
        bps = self.blocks_per_shard
        self._frees: list[list[int]] = [
            list(range((s + 1) * bps - 1, s * bps - 1, -1))
            for s in range(n_shards)]
        self._owned: list[list[int]] = [[] for _ in range(n_slots)]
        self._committed = [0] * n_slots  # reserved blocks per admitted seq
        self._bound = [False] * n_slots
        self._lengths = [0] * n_slots    # logical tokens backed per slot
        self._ref = np.zeros(self.n_blocks, np.int32)
        # leading logical blocks of each slot that are aliased (read-only)
        self._shared_upto = [0] * n_slots
        # set by the prefix cache: callable(shard, need) -> blocks freed
        self.evict_hook = None
        # observability hook (obs/instrumentation.py Instrumentation), set
        # by the engine when EngineConfig(obs=...) is on; None costs one
        # `is not None` test per allocation event
        self.obs = None
        self._tables_dev = None
        # sliding-window reclamation frees blocks: paged pools only
        self.window = reclaim_window(cfg, self.specs) if paged else None
        self._alloc_upto = [0] * n_slots   # logical blocks ever allocated
        self._live_from = [0] * n_slots    # first logical block still owned
        self._floor = [0] * n_slots        # least length `truncate` allows
        # host tier: flat buffers of one block's bytes, reused; the bytes of
        # free buffers kept are bounded by host_keep_bytes (None: unbounded).
        # A dense pool has no blocks, hence no host tier. Every shard's
        # leaves have the same per-block shapes.
        leaves = token_leaves(self.shard_caches[0]) if paged else []
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
        """The data shard homing `slot` (contiguous split)."""
        return slot // self.slots_per_shard

    def shard_of_block(self, block: int) -> int:
        return block // self.blocks_per_shard

    def _local(self, block: int) -> tuple[int, int]:
        """(shard, shard-local id) of a global block id."""
        sh = self.shard_of_block(block)
        return sh, block - sh * self.blocks_per_shard

    def _shard_slots(self, shard: int) -> range:
        sps = self.slots_per_shard
        return range(shard * sps, (shard + 1) * sps)

    @property
    def _free(self) -> list[int]:
        """Every free block, shard by shard (each shard's list in pop
        order): the free list of an unsharded pool."""
        return [b for free in self._frees for b in free]

    @property
    def free_block_count(self) -> int:
        return sum(len(free) for free in self._frees)

    def free_blocks_in_shard(self, shard: int) -> int:
        return len(self._frees[shard])

    def utilization(self) -> dict:
        """Host-side occupancy for the per-tick gauges
        (obs/instrumentation.py): free blocks per shard, allocated blocks,
        and internal fragmentation: token capacity in allocated blocks that
        no live position occupies (partial tail blocks plus window-reclaim
        slack). A dense pool reports zero blocks."""
        if not self.paged:
            return {"free_by_shard": [0] * self.n_shards,
                    "allocated_blocks": 0, "frag_tokens": 0,
                    "frag_ratio": 0.0}
        free = [len(f) for f in self._frees]
        cap = live = 0
        for i in range(self.n_slots):
            if not self._bound[i]:
                continue
            cap += len(self._owned[i]) * self.block_size
            live += self._lengths[i] - self._live_from[i] * self.block_size
        frag = max(cap - live, 0)
        return {"free_by_shard": free,
                "allocated_blocks": self.n_blocks - sum(free),
                "frag_tokens": frag,
                "frag_ratio": frag / cap if cap else 0.0}

    def _outstanding(self, shard: int | None = None) -> int:
        """Blocks reserved by `commit` and not yet allocated, over the
        slots of `shard` (None: every slot)."""
        slots = range(self.n_slots) if shard is None else \
            self._shard_slots(shard)
        return sum(self._committed[i] - len(self._owned[i]) for i in slots)

    def effective_free_blocks(self, shard: int) -> int:
        """Free blocks of `shard` less its slots' outstanding commitments:
        what a new request could draw on there. The engine's placement
        ranks shards by it, so a freshly committed sequence already steers
        the next admission elsewhere."""
        return len(self._frees[shard]) - self._outstanding(shard)

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
        """Can any pool state back a sequence of total_tokens? A slot never
        borrows from another shard, so one shard's blocks bound it."""
        if total_tokens > self.max_len:
            return False
        return (not self.paged) or (
            self.max_live_blocks(total_tokens, max_growth)
            <= self.blocks_per_shard)

    def can_admit(self, total_tokens: int, max_growth: int | None = None,
                  slot: int | None = None, cached_blocks: int = 0) -> bool:
        """Can a sequence of total_tokens be fully served alongside every
        already-admitted one? Subtracts outstanding commitments (reserved,
        not yet allocated) so growing sequences never exhaust the pool;
        `cached_blocks` (prefix-cache blocks the candidate would adopt, not
        allocate) reduce its demand. A dense pool is bounded by max_len
        alone. With `n_shards > 1` only the shard of `slot` counts; without
        a slot the answer is the reference's "can ANY shard take it", each
        shard asked with its first slot and no cached blocks (as the
        reference asks; free blocks of several shards back no single slot,
        so there is no whole-pool answer)."""
        if total_tokens > self.max_len:
            return False
        if not self.paged:
            return True
        if self.n_shards > 1 and slot is None:
            return any(self.can_admit(total_tokens, max_growth,
                                      slot=sh * self.slots_per_shard)
                       for sh in range(self.n_shards))
        return self.admission_shortfall(total_tokens, max_growth, slot,
                                        cached_blocks) == 0

    def admission_shortfall(self, total_tokens: int,
                            max_growth: int | None = None,
                            slot: int | None = None,
                            cached_blocks: int = 0) -> int:
        """Free blocks missing on `slot`'s shard for `can_admit` to pass (0
        when it passes): what the engine asks the prefix cache to evict
        there before admitting. Without a slot on a sharded pool, the least
        over the shards, each asked with no cached blocks: 0 exactly when
        `can_admit(slot=None)` passes (the reference's slot-less call
        raises a TypeError here)."""
        if not self.paged or total_tokens > self.max_len:
            return 0
        if self.n_shards > 1 and slot is None:
            return min(self.admission_shortfall(
                total_tokens, max_growth, slot=sh * self.slots_per_shard)
                for sh in range(self.n_shards))
        sh = 0 if slot is None else self.shard_of_slot(slot)
        need = max(0, self.max_live_blocks(total_tokens, max_growth)
                   - cached_blocks)
        return max(0, need - self.effective_free_blocks(sh))

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

    def _pop_free(self, shard: int, what: str) -> int:
        """The lowest free block of `shard`, evicting cached blocks there
        when none is free (the caller checks every other precondition
        first)."""
        free = self._frees[shard]
        if not free and not (self.evict_hook is not None
                             and self.evict_hook(shard, 1) > 0):
            raise OutOfBlocks(what + (f" (shard {shard})"
                                      if self.n_shards > 1 else ""))
        blk = free.pop()
        self._ref[blk] = 1
        return blk

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Allocate blocks so positions [0, n_tokens) of `slot` are backed."""
        if not self._bound[slot]:
            raise SlotError(f"slot {slot}: ensure on an unbound slot")
        if not self.paged:
            if n_tokens > self.max_len:
                raise OutOfBlocks(f"slot {slot}: {n_tokens} > max_len")
            self._lengths[slot] = max(self._lengths[slot], n_tokens)
            return
        need = self.blocks_for(n_tokens)
        if need > self.max_blocks:
            raise OutOfBlocks(f"slot {slot}: {n_tokens} tokens exceed the "
                              f"{self.max_blocks}-entry block table")
        if self.window is not None:
            self._reclaim(slot)
        taken = 0
        sh = self.shard_of_slot(slot)
        while self._alloc_upto[slot] < need:
            blk = self._pop_free(sh, f"slot {slot}: pool exhausted")
            self._table[slot, self._alloc_upto[slot]] = blk
            self._owned[slot].append(blk)
            self._alloc_upto[slot] += 1
            taken += 1
            self._dirty()
        if taken and self.obs is not None:
            self.obs.on_pool_alloc(taken)
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
        if self.obs is not None:
            self.obs.on_pool_reclaim(first_live - self._live_from[slot])
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
        if not self.paged:
            return
        # reversed so an exclusive slot's first-allocated block pops first
        # (slot affinity: every block it owns homes on its shard)
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

    @property
    def local_sentinel(self) -> int:
        """The sentinel of the device tables: blocks_per_shard when sharded
        (out of bounds for a shard's readable leaves), else n_blocks."""
        return self.blocks_per_shard if self.n_shards > 1 else self.sentinel

    def _local_table_np(self) -> np.ndarray:
        """The (n_slots, max_blocks) host table as the device sees it:
        shard-local ids when sharded (each entry less its slot's shard
        base; the sentinel mapped to `local_sentinel`), else the table."""
        if self.n_shards == 1:
            return self._table.copy()
        base = (np.arange(self.n_slots, dtype=np.int32)
                // self.slots_per_shard)[:, None] * self.blocks_per_shard
        return np.where(self._table == self.sentinel, self.blocks_per_shard,
                        self._table - base).astype(np.int32)

    def tables_device(self):
        """The int32 device tables, cached until the host table changes:
        (n_slots, 2, max_blocks) with [:, 0] the READ table and [:, 1] the
        WRITE table, in which every adopted (shared) logical block holds the
        sentinel, so a scatter through it lands in the scratch block. Stored
        as a (2, n_slots, max_blocks) tensor and returned permuted, so each
        view `[:, k]` is contiguous. A sharded pool returns one such
        (slots_per_shard, 2, max_blocks) tensor a shard, on the shard's
        device, over shard-local ids. None for a dense pool (no block
        table)."""
        if not self.paged:
            return None
        if self._tables_dev is None:
            rt = self._local_table_np()
            wt = rt.copy()
            for s, k in enumerate(self._shared_upto):
                wt[s, :k] = self.local_sentinel
            both = np.stack([rt, wt])
            if self.n_shards == 1:
                self._tables_dev = torch.from_numpy(both).to(
                    self.device).permute(1, 0, 2)
            else:
                self._tables_dev = tuple(
                    torch.from_numpy(np.ascontiguousarray(
                        both[:, self._shard_slots(s)])).to(d).permute(1, 0, 2)
                    for s, d in enumerate(self.devices))
        return self._tables_dev

    # ---- prefix sharing (refcounted aliasing + copy-on-write) ----

    def _decref(self, block: int) -> None:
        """Drop one reference; the last reference frees the block."""
        self._ref[block] -= 1
        if self._ref[block] < 0:
            raise SlotError(f"block {block}: decref below zero (double free)")
        if self._ref[block] == 0:
            self._frees[self.shard_of_block(block)].append(block)
            if self.obs is not None:
                self.obs.on_pool_free(1)

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
        committed slot, with every block homed on the slot's shard (slot
        affinity), and not on sliding-window pools (a reclaimed prefix is
        not fully resident)."""
        if not self.paged:
            raise SlotError("adopt_prefix on a dense pool: no block table")
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
        sh = self.shard_of_slot(slot)
        if any(self.shard_of_block(b) != sh for b in blocks):
            raise SlotError(f"slot {slot} (shard {sh}): adopting off-shard "
                            "blocks violates slot affinity")
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
        if not self.paged:
            raise SlotError("cow_block on a dense pool: no block table")
        if not self._bound[slot]:
            raise SlotError(f"slot {slot}: cow_block on an unbound slot")
        sh = self.shard_of_slot(slot)
        if self.shard_of_block(src) != sh:
            raise SlotError(f"slot {slot} (shard {sh}): COW source {src} "
                            "homes on another shard")
        if self._ref[src] <= 0:
            raise SlotError(f"block {src}: COW from a free block")
        j = self._alloc_upto[slot]
        if j >= self.max_blocks:
            # checked BEFORE popping: a pop-then-raise would strand the
            # popped block at refcount 1 with no owner
            raise OutOfBlocks(f"slot {slot}: table full at COW")
        dst = self._pop_free(sh, f"slot {slot}: no free block for COW")
        self._table[slot, j] = dst
        self._owned[slot].append(dst)
        self._alloc_upto[slot] = j + 1
        self._copy_block_device(src, dst)
        self._dirty()
        if self.obs is not None:
            self.obs.on_pool_alloc(1)
            self.obs.on_pool_cow()
        return dst

    def _copy_block_device(self, src: int, dst: int) -> None:
        """Device copy of block `src` -> `dst` (global ids of one shard) in
        every token leaf of that shard, one indexed copy a leaf on the
        current stream; a PackedKV's codes and scales both move before any
        later step can read the block."""
        sh, s = self._local(src)
        d = self._local(dst)[1]
        for leaf in token_leaves(self.shard_caches[sh]):
            leaf[:, d] = leaf[:, s]

    def alloc_cache_block(self, shard: int = 0) -> int:
        """One block of `shard` OWNED BY THE PREFIX CACHE (ref 1, no slot):
        the target of a swap-in or a cross-shard replica. Evicts like
        `ensure` under pressure; pin (acquire) the cache path being
        materialized first."""
        blk = self._pop_free(shard, "no free block for the cache")
        if self.obs is not None:
            self.obs.on_pool_alloc(1)
        return blk

    # ---- recurrent slot state ----

    def reset_slot(self, slot: int) -> None:
        """Zero the recurrent state of `slot` (a new sequence is admitted).
        Only on an UNBOUND slot: resetting a live sequence's state would
        silently corrupt it, so that is a SlotError."""
        if self._bound[slot]:
            raise SlotError(f"slot {slot}: reset_slot on a bound slot")
        sh = self.shard_of_slot(slot)
        for leaf in state_leaves(self.shard_caches[sh]):
            leaf[:, slot - sh * self.slots_per_shard] = 0

    # Token kinds truncate for free (position-masked); the recurrent kinds
    # integrate every token irreversibly, so a speculative rollback is
    # snapshot -> verify chunk -> restore the rejected slots -> replay.

    def snapshot_states(self):
        """Copies of every state-kind leaf in `state_leaves` order, shard
        after shard (None when the stack has none): real copies, since the
        steps update the leaves in place."""
        if not self.has_state_kinds:
            return None
        return [leaf.clone() for tree in self.shard_caches
                for leaf in state_leaves(tree)]

    def restore_states(self, snapshot, slots) -> None:
        """Write `slots`' rows of every state-kind leaf back from
        `snapshot`, IN PLACE, each on its slot's shard."""
        if snapshot is None or not slots:
            return
        per = len(snapshot) // self.n_shards
        for sh, (tree, dev) in enumerate(zip(self.shard_caches,
                                             self.devices)):
            rows = [i - sh * self.slots_per_shard for i in slots
                    if self.shard_of_slot(i) == sh]
            if not rows:
                continue
            idx = torch.as_tensor(rows, dtype=torch.long, device=dev)
            for leaf, snap in zip(state_leaves(tree),
                                  snapshot[sh * per:(sh + 1) * per]):
                leaf[:, idx] = snap[:, idx]

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

    def read_block_host(self, block: int, non_blocking: bool = False):
        """Snapshot block `block` of every token leaf into host memory.

        Returns `(payload, nbytes)`: a `HostBlock` and its leaves' bytes.
        Synchronous by default (the copies complete before it returns: the
        prefix cache's spill). With `non_blocking` on a card (a
        disaggregated handoff's export) the device-to-host copies are only
        dispatched on the current stream and `payload.done` is the event
        recorded behind them: the host must not read the bytes before it
        has completed, and later kernels on the stream (a write into the
        released block, the decode pool's import from the buffer) run after
        the copies. On a card the buffer is pinned, taken from the pool's
        free list when one is there, so a spill allocates pinned memory
        (through PyTorch's caching host allocator, which calls
        `cudaHostAlloc` when it holds no freed block) only when the tier
        grows past its high-water mark."""
        if not self.paged:
            raise SlotError("read_block_host on a dense pool: no blocks")
        sh, block = self._local(block)
        buf = self._host_buffer()
        views = []
        for leaf, off, (dtype, shape) in zip(
                token_leaves(self.shard_caches[sh]), self._host_offsets,
                self._host_shapes):
            n = math.prod(shape) * leaf.element_size()
            v = buf[off:off + n].view(dtype).view(shape)
            v.copy_(leaf[:, block], non_blocking=non_blocking)
            views.append(v)
        nbytes = sum(v.numel() * v.element_size() for v in views)
        payload = HostBlock(_like_tree(self.shard_caches[sh], views), buf)
        if non_blocking and self.device.type == "cuda":
            payload.done = self._event_behind(sh)
        return payload, nbytes

    def _event_behind(self, shard: int):
        """A CUDA event recorded on the current stream of `shard`'s card,
        behind the copies just dispatched there."""
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.devices[shard]))
        return done

    def write_block_host(self, block: int, payload: HostBlock) -> None:
        """Write a `read_block_host` payload into block `block`.

        Dispatch-only: on a card, non-blocking host-to-device copies from
        the pinned buffer on the current stream, which orders every later
        step after them; the event recorded behind them (`payload.done`)
        keeps the buffer from reuse until they have run. A pageable source
        would make the copy synchronous, so it is refused."""
        if not self.paged:
            raise SlotError("write_block_host on a dense pool: no blocks")
        if self.device.type == "cuda" and not payload.buf.is_pinned():
            raise ValueError("write_block_host needs a pinned host buffer: "
                             "a pageable source makes the copy synchronous")
        sh, block = self._local(block)
        for leaf, src in zip(token_leaves(self.shard_caches[sh]),
                             token_leaves(payload.stages)):
            leaf[:, block].copy_(src, non_blocking=True)
        if self.device.type == "cuda":
            payload.done = self._event_behind(sh)

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
