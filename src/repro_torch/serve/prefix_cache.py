"""Radix-tree prefix cache over the paged KV pool, with a host spill tier.

Counterpart of `repro/serve/prefix_cache.py`. Serving fleets
see much shared-prompt overlap (system prompts, few-shot preambles,
multi-turn histories). This module keeps a token-level radix tree whose
nodes OWN refcounted physical blocks of the pool, and on admission the
engine

  1. matches the longest cached prefix of the new prompt,
  2. aliases the fully matched blocks READ-ONLY into the new slot's table
     (`KVPool.adopt_prefix`: their prefill is skipped),
  3. copies the block holding the first divergent token or the partial
     tail privately (`KVPool.cow_block`), so the whole matched prefix costs
     no prefill forward.

On retirement the stream's full blocks are inserted; when the pool runs out
of blocks, unpinned nodes are evicted leaf-first in LRU order (a node that
a live slot aliases is pinned by its `refs` count, and its ancestors with
it, since adoption pins the whole path).

With `spill=True` eviction copies the block to host memory instead of
dropping it: the node keeps an immutable host snapshot (`KVPool.
read_block_host`, packed bytes for a PackedKV pool) and stays matchable; a
later match swaps the block back in (`materialize`) by dispatching a
non-blocking host-to-device copy on the current stream, which orders every
later step after it. Under `scheme="bf16"` a spill-hot stream is therefore
bitwise the cold one (host -> device -> host is the identity).

Over a slot-affine sharded pool (`KVPool(n_shards > 1)`) nodes are
MULTI-SHARD: `blocks` maps shard -> block, one refcounted copy a shard.
Without the host tier a prefix serves only slots of its own shard, and an
insertion never extends a path across shards. With it a cross-shard match
materializes on the placed shard from the host snapshot, and
`replicate_hot` copies the blocks of nodes matched `replicate_hits` times
into peer shards through the host tier, into free blocks only (it never
evicts), a bounded number a tick.

Tree shape: children are keyed by the `block_size`-token tuple a child's
block covers, so every node owns exactly one full physical block and the
tree needs no edge splitting. Matching is still token-level: a prompt that
diverges inside a block gets the in-block common prefix via COW. Under bf16
the decode forward is row-local, so a cached block's K/V equals what the
new request's own prefill would write, bit for bit, wherever both compute
each token in the same step shape; quantizing schemes share an activation
absmax across the batch, so quartet2 hot runs are deterministic but not
bit-comparable to cold runs.

Exclusions (`supported`): sliding-window pools (`reclaim_window`) free
blocks mid-sequence, so a cached prefix is not fully resident. The engine
then runs with `cache=None`. (The port's pools are paged and hold no
recurrent state, the reference's other two exclusions.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.serve.kv_pool import KVPool


class _Node:
    """One cached full block: `tokens` (block_size ids) -> physical copies.

    `blocks` maps shard -> device block id (one copy a shard; empty while
    the block lives only in the host tier). `host` is the immutable host
    snapshot (a `kv_pool.HostBlock`, None until spilled or replicated);
    `hits` counts admission matches through this node (the replication
    trigger)."""

    __slots__ = ("parent", "children", "tokens", "blocks", "host",
                 "host_bytes", "hits", "refs", "last_used")

    def __init__(self, parent, tokens: tuple[int, ...], block: int,
                 shard: int, clock: int):
        self.parent = parent
        self.children: dict[tuple[int, ...], _Node] = {}
        self.tokens = tokens
        self.blocks: dict[int, int] = {} if block < 0 else {shard: block}
        self.host = None
        self.host_bytes = 0
        self.hits = 0
        self.refs = 0          # live slots currently aliasing this path
        self.last_used = clock

    @property
    def shard(self) -> int:
        """The shard of the (first) device copy; -1 when host-only."""
        return next(iter(self.blocks), -1)

    @property
    def block(self) -> int:
        return next(iter(self.blocks.values()), -1)

    def available(self) -> bool:
        """Matchable: a device copy or a host snapshot."""
        return bool(self.blocks) or self.host is not None


@dataclass
class Match:
    """Longest cached prefix of a prompt: `nodes` fully matched (len(nodes)
    * block_size tokens), then `partial` more tokens (0 < partial <
    block_size) inside `partial_node`'s block."""
    nodes: list[_Node] = field(default_factory=list)
    partial_node: _Node | None = None
    partial: int = 0

    @property
    def tokens(self) -> int:
        return sum(len(n.tokens) for n in self.nodes) + self.partial

    @property
    def shard(self) -> int | None:
        """The home shard of the match (without the host tier a path lies
        on one shard); None for an empty match."""
        if self.nodes:
            return self.nodes[0].shard
        if self.partial_node is not None:
            return self.partial_node.shard
        return None

    def plan(self, cap: int, block_size: int):
        """(m, adopt_nodes, tail_node) for a match capped at `cap` tokens:
        adopt_nodes' blocks alias read-only (full blocks below m), and
        tail_node (if any) is the COW source for m's partial block."""
        m = min(self.tokens, cap)
        full = m // block_size
        adopt = self.nodes[:full]
        tail = None
        if m % block_size:
            tail = (self.nodes[full] if full < len(self.nodes)
                    else self.partial_node)
        return m, adopt, tail


class PrefixCache:
    """Host-side radix cache bound to one KVPool.

    Laws it keeps (tests/test_torch_prefix_cache.py):
      - a cached node holds exactly ONE pool reference per device copy
        (taken at insertion or swap-in, dropped at eviction);
      - a node is evictable iff no slot aliases its path (`refs == 0`);
      - eviction is leaf-first LRU through `KVPool._decref`, so free +
        referenced == n_blocks at every step; with `spill=True`,
        `host_bytes` is the sum of every node's snapshot bytes.
    """

    def __init__(self, pool: KVPool, *, spill: bool = False,
                 host_budget_bytes: int | None = None,
                 replicate_hits: int | None = None, clock=None):
        if not self.supported(pool):
            raise ValueError(
                "PrefixCache requires a pool without a sliding-window "
                "reclaim horizon")
        self.pool = pool
        self.block_size = pool.block_size
        self.spill = spill
        self.host_budget_bytes = host_budget_bytes
        self.replicate_hits = replicate_hits
        self.wall = clock if clock is not None else time.perf_counter
        self.host_bytes = 0
        # swap-in blocks dispatched this tick (cleared by complete_swaps)
        self._inflight: list[int] = []
        self.root = _Node(None, (), -1, -1, 0)
        self._clock = 0
        # bumped whenever matchability changes (node added or removed, a
        # host snapshot dropped): a Match stays valid until it moves
        self.epoch = 0
        self.stats = {"lookups": 0, "hits": 0, "hit_tokens": 0,
                      "inserted_blocks": 0, "evicted_blocks": 0,
                      "spilled_blocks": 0, "swapped_in_blocks": 0,
                      "replicated_blocks": 0, "swapin_s": 0.0}
        # observability hook (set by the engine with EngineConfig(obs=...)):
        # mirrors these events into registry counters
        self.obs = None
        pool.evict_hook = self.evict
        pool.host_keep_bytes = host_budget_bytes

    @staticmethod
    def supported(pool: KVPool) -> bool:
        """Sharing is by physical block: a paged pool without window
        reclaim (a reclaimed prefix is not resident) and without recurrent
        state kinds. A shared PackedKV block is shared packed bytes,
        immutable once written (per-token deterministic RTN): no special
        casing."""
        return pool.paged and pool.window is None and not pool.has_state_kinds

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ---- lookup ----

    def record(self, match: Match | None) -> None:
        """Book one lookup (and its hit): once per admission, with None for
        an admission that did not use its match."""
        self.stats["lookups"] += 1
        hit = match is not None and match.tokens
        if hit:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += match.tokens
            for n in match.nodes:
                n.hits += 1
            if match.partial_node is not None:
                match.partial_node.hits += 1
        if self.obs is not None:
            self.obs.on_cache_record(bool(hit), match.tokens if hit else 0)

    def hint_tokens(self, match: Match) -> int:
        """Scheduler hint (Request.cached_hint): device-resident matched
        tokens count in full, host-only ones half (a swap-in is cheaper than
        prefill but not free)."""
        if not self.spill:
            return match.tokens
        t = 0
        for n in match.nodes:
            t += len(n.tokens) if n.blocks else len(n.tokens) // 2
        if match.partial_node is not None:
            t += (match.partial if match.partial_node.blocks
                  else match.partial // 2)
        return t

    def match(self, prompt: list[int]) -> Match:
        """Longest cached prefix of `prompt` (may end inside a block). Pins
        nothing and books nothing; spilled nodes match like resident ones."""
        bs = self.block_size
        node, nodes = self.root, []
        d = 0
        while (d + 1) * bs <= len(prompt):
            child = node.children.get(tuple(prompt[d * bs:(d + 1) * bs]))
            if child is None or not child.available():
                break
            nodes.append(child)
            node = child
            d += 1
        rest = prompt[d * bs:]
        best, best_len = None, 0
        for child in node.children.values():
            if not child.available():
                continue
            n = 0
            for a, b in zip(rest, child.tokens):
                if a != b:
                    break
                n += 1
            if n > best_len:
                best, best_len = child, n
        return Match(nodes=nodes, partial_node=best, partial=best_len)

    # ---- pinning ----

    def acquire(self, nodes: list[_Node]) -> None:
        """Pin `nodes` (a slot now aliases or is copying their blocks)."""
        clock = self._tick()
        for n in nodes:
            n.refs += 1
            n.last_used = clock

    def release(self, nodes: list[_Node]) -> None:
        clock = self._tick()
        for n in nodes:
            if n.refs <= 0:
                raise RuntimeError("prefix-cache release without acquire")
            n.refs -= 1
            n.last_used = clock

    # ---- host tier ----

    def _snapshot(self, node: _Node):
        """The node's immutable host payload, read from its device copy on
        first use (a block's bytes never change once written)."""
        if node.host is None:
            src = next(iter(node.blocks.values()))
            node.host, node.host_bytes = self.pool.read_block_host(src)
            self.host_bytes += node.host_bytes
        return node.host

    def _drop_snapshot(self, node: _Node) -> None:
        self.host_bytes -= node.host_bytes
        self.pool.release_host(node.host)
        node.host, node.host_bytes = None, 0

    def materialize(self, nodes: list[_Node], shard: int = 0) -> int:
        """Give every node a device copy on `shard`, swapping spilled blocks
        back in, or copying a peer shard's block through a fresh host
        snapshot: the writes are dispatched, not awaited. Pin the nodes
        first (the allocations may evict). Returns the blocks swapped in;
        raises OutOfBlocks when the shard cannot hold the path."""
        missing = [n for n in nodes if shard not in n.blocks]
        if not missing:
            return 0
        t0 = self.wall()
        pool = self.pool
        for n in missing:
            payload = self._snapshot(n)
            blk = pool.alloc_cache_block(shard)
            pool.write_block_host(blk, payload)
            n.blocks[shard] = blk
            self._inflight.append(blk)
        dt = self.wall() - t0
        self.stats["swapped_in_blocks"] += len(missing)
        self.stats["swapin_s"] += dt
        if self.obs is not None:
            self.obs.on_cache_swap_in(len(missing), dt)
        self._trim_host()
        return len(missing)

    def complete_swaps(self) -> None:
        """Tick-boundary accounting: this tick's swap-ins become plain
        cached blocks (the stream orders their writes before any later
        read; nothing waits here), and host buffers whose copies have run
        go back to the pool's free list."""
        self._inflight.clear()
        self.pool.poll_host()

    def replicate_hot(self, budget: int = 1) -> int:
        """Copy up to `budget` blocks of HOT nodes (matched at least
        `replicate_hits` times) into shards that lack them, through the host
        tier. Only blocks free already are taken (replication never
        evicts), so a loaded shard is left alone; the engine calls it once
        a tick. Returns the blocks copied."""
        if (not self.spill or self.replicate_hits is None
                or self.pool.n_shards == 1 or budget <= 0):
            return 0
        pool, done = self.pool, 0
        targets = [s for s in range(pool.n_shards) if pool._frees[s]]
        if not targets:
            return 0

        def walk(node):
            nonlocal done
            for c in node.children.values():
                if done >= budget:
                    return
                if c.hits >= self.replicate_hits and c.available():
                    for s in targets:
                        if done >= budget:
                            break
                        if s in c.blocks or not pool._frees[s]:
                            continue
                        payload = self._snapshot(c)
                        blk = pool.alloc_cache_block(s)
                        pool.write_block_host(blk, payload)
                        c.blocks[s] = blk
                        self._inflight.append(blk)
                        done += 1
                walk(c)

        walk(self.root)
        if done:
            self.stats["replicated_blocks"] += done
            if self.obs is not None:
                self.obs.on_cache_replicate(done)
            self._trim_host()
        return done

    def _trim_host(self) -> None:
        """Best-effort host budget: drop LRU snapshots, preferring nodes
        that keep a device copy; a host-only childless node goes outright.
        Host-only inner nodes keep theirs (their subtree hangs on them)."""
        if self.host_budget_bytes is None:
            return
        while self.host_bytes > self.host_budget_bytes:
            resident, sole = [], []

            def walk(node):
                for c in node.children.values():
                    if c.host is not None and c.refs == 0:
                        if c.blocks:
                            resident.append(c)
                        elif not c.children:
                            sole.append(c)
                    walk(c)

            walk(self.root)
            pick = min(resident, key=lambda n: n.last_used) if resident \
                else min(sole, key=lambda n: n.last_used) if sole else None
            if pick is None:
                return
            self._drop_snapshot(pick)
            if not pick.blocks and not pick.children:
                del pick.parent.children[pick.tokens]
                self.epoch += 1

    # ---- insertion (request retirement) ----

    def insert(self, tokens: list[int], slot: int) -> int:
        """Cache the FULL blocks of `tokens`, the stream whose K/V `slot`
        holds. An existing node with a copy on the slot's shard dedups (the
        slot's own block is dropped by its later release); a missing node
        takes the slot's block with one cache reference. With the host tier
        a node lacking this shard's copy takes the slot's block as another
        replica; without it, insertion stops at the first node homed on
        another shard (paths never mix shards). Call BEFORE
        `pool.release(slot)`. Returns the number of newly cached blocks."""
        pool = self.pool
        shard = pool.shard_of_slot(slot)
        clock = self._tick()
        node, added = self.root, 0
        bs = self.block_size
        for d in range(len(tokens) // bs):
            key = tuple(tokens[d * bs:(d + 1) * bs])
            child = node.children.get(key)
            if child is not None and child.available():
                child.last_used = clock
                if shard in child.blocks:
                    node = child
                    continue
                if not self.spill:
                    break
                blk = int(pool._table[slot, d])
                if blk == pool.sentinel:
                    break
                pool.incref(blk)
                child.blocks[shard] = blk
                node = child
                added += 1
                continue
            blk = int(pool._table[slot, d])
            if blk == pool.sentinel:
                break
            pool.incref(blk)
            if child is not None:  # a trimmed husk: revive in place
                child.blocks = {shard: blk}
                child.last_used = clock
            else:
                child = _Node(node, key, blk, shard, clock)
                node.children[key] = child
            node = child
            added += 1
        self.stats["inserted_blocks"] += added
        if self.obs is not None:
            self.obs.on_cache_insert(added)
        if added:
            self.epoch += 1
        return added

    # ---- eviction ----

    def _evictable_leaves(self, shard: int | None):
        """Unpinned nodes none of whose descendants holds a device copy
        (leaf-first, so an adoptable path stays contiguous); a host-only
        descendant does not pin its ancestors."""
        out = []

        def blocked(c, sh):
            return any((sh in g.blocks if sh is not None else bool(g.blocks))
                       or blocked(g, sh) for g in c.children.values())

        def walk(n):
            for c in n.children.values():
                if (c.refs == 0 and not blocked(c, shard)
                        and (shard is None or shard in c.blocks)):
                    if c.blocks:
                        out.append(c)
                else:
                    walk(c)

        walk(self.root)
        return out

    def evict(self, shard: int | None, need: int) -> int:
        """Free >= `need` blocks by LRU leaf eviction (best effort; returns
        the number freed). Also the pool's `evict_hook`. With `spill` the
        bytes go to the host tier first and the node stays matchable."""
        freed = 0
        while freed < need:
            leaves = self._evictable_leaves(shard)
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for n in leaves:
                for sh in ([shard] if shard is not None else sorted(n.blocks)):
                    if self.spill:
                        self._snapshot(n)
                        self.stats["spilled_blocks"] += 1
                        if self.obs is not None:
                            self.obs.on_cache_spill(1, n.host_bytes)
                    self.pool._decref(n.blocks.pop(sh))
                    freed += 1
                    if freed >= need:
                        break
                if not n.available():
                    del n.parent.children[n.tokens]
                    self.epoch += 1
                if freed >= need:
                    break
        self.stats["evicted_blocks"] += freed
        if self.obs is not None and freed:
            self.obs.on_cache_evict(freed)
        if self.spill and freed:
            self._trim_host()
        return freed

    # ---- introspection ----

    def _nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def cached_blocks(self) -> int:
        """Device blocks the cache holds, EXCLUDING this tick's swap-ins."""
        return sum(len(n.blocks) for n in self._nodes()) - len(self._inflight)

    @property
    def inflight_swaps(self) -> int:
        """Swap-in and replica blocks dispatched this tick."""
        return len(self._inflight)

    def host_nodes(self) -> int:
        """Nodes holding a host-tier snapshot."""
        return sum(n.host is not None for n in self._nodes())
