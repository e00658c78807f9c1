"""Cross-request KV prefix cache: radix tree with copy-on-write sharing —
the port of ``deepspeed_tpu/inference/v2/prefix_cache.py`` (host-only,
copied line for line; ``tests/test_torch_prefix_cache.py`` holds the two
copies to identical matches, stats and free lists).

RadixAttention-shaped (SGLang, Zheng et al. 2024) cache over the blocked
allocator: a tree keyed on ``block_size``-token chunks whose nodes own KV
block ids.  A finished sequence *donates* its full prefix blocks into the
tree instead of freeing them; a new request walks the tree and seeds its
block table with the shared blocks, so prefill starts at the first
uncached token.  Sharing is pure block-table indirection — the ragged
forward and the paged-attention kernels (B4, B5) never change; they read
shared blocks through the block table like any other.

Ownership model (see ``BlockedAllocator`` refcounts):

- every tree node holds exactly one reference on its block;
- ``match`` takes an extra reference per returned block on behalf of the
  caller (released through the sequence's normal free path);
- ``donate`` transfers the sequence's reference to the tree when the
  chunk is new, and drops it when the chunk is already cached (dedupe);
- ``evict`` removes LRU *leaves* whose block has no owner besides the
  tree, returning those blocks to the pool.

Memory hierarchy (``inference/v2/paging.py``): with a block pager
attached, ``evict`` *demotes* instead — the victim's KV bytes move to the
host tier, its device block returns to the pool, and the NODE STAYS IN
THE TREE with ``tier != "device"`` and a pager handle.  A later ``match``
that reaches a demoted node promotes it back into a fresh device block
(engine callback) instead of recomputing prefill.  Invariant: a
non-device node never has a device descendant — demotion picks nodes
whose children are all demoted already (so whole subtrees go cold
together), and ``donate`` re-adopts a demoted node on its path by giving
it the sequence's own (identical) device block.

All mutation happens on the engine thread (the serving broker serializes
every engine call); gauge reads from other threads only touch ints.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .ragged import BlockedAllocator


def prefix_digests(tokens: Sequence[int], block_size: int,
                   max_chunks: Optional[int] = None) -> List[str]:
    """Cumulative per-chunk digests of a token prefix: ``d_i = blake2b(
    d_{i-1} || chunk_i)``.  blake2b (not Python ``hash``) because the
    digests cross process boundaries — the balancer compares a request's
    prompt digests against summaries heartbeated from remote workers, and
    ``hash()`` is salted per process."""
    out: List[str] = []
    prev = b""
    n = len(tokens) // block_size
    if max_chunks is not None:
        n = min(n, max_chunks)
    for i in range(n):
        chunk = tokens[i * block_size:(i + 1) * block_size]
        h = hashlib.blake2b(prev, digest_size=8)
        h.update(struct.pack(f"<{block_size}I", *chunk))
        prev = h.digest()
        out.append(prev.hex())
    return out


@dataclasses.dataclass(eq=False)
class _Node:
    chunk: Tuple[int, ...]  # edge label from parent: block_size token ids
    block: int  # KV block holding this chunk's keys/values (-1 if demoted)
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)
    last_used: int = 0
    #: which memory tier holds this chunk's KV bytes: "device" (block is a
    #: live pool id), "host", "spill" or "cold" (block is -1, ``handle``
    #: names the pager entry).  Anything != "device" is paged out.
    tier: str = "device"
    handle: Optional[int] = None


def chain_tokens(node: _Node) -> List[int]:
    """The full token prefix from the root through ``node`` — the durable
    identity of a radix chunk (its cold-store key is the chain digest of
    exactly these tokens, see ``engine._demote_node``)."""
    chunks: List[Tuple[int, ...]] = []
    while node is not None and node.parent is not None:
        chunks.append(node.chunk)
        node = node.parent
    out: List[int] = []
    for chunk in reversed(chunks):
        out.extend(int(t) for t in chunk)
    return out


@dataclasses.dataclass
class PrefixMatch:
    """Result of a tree walk.  ``blocks`` are full shared blocks covering
    ``tokens`` prompt tokens; ``cow_src`` (if set) is a block whose first
    ``cow_tokens`` positions also match and can be copy-on-write forked.
    Every returned block carries one reference taken for the caller."""

    blocks: List[int]
    tokens: int
    cow_src: Optional[int] = None
    cow_tokens: int = 0


class PrefixCache:
    """Radix tree of cached KV prefixes over a shared block pool.

    ``eviction``: ``"lru"`` frees least-recently-used unreferenced leaves
    under pool pressure; ``"none"`` never evicts (donated blocks stay
    pinned until ``reset`` — debugging / bounded workloads only, and such
    blocks are not counted as reclaimable for admission).
    """

    def __init__(self, allocator: BlockedAllocator, block_size: int,
                 min_prefix_tokens: int = 0, eviction: str = "lru"):
        if eviction not in ("lru", "none"):
            raise ValueError(f"unknown eviction policy {eviction!r}")
        self.allocator = allocator
        self.block_size = block_size
        self.min_prefix_tokens = min_prefix_tokens
        self.eviction = eviction
        self._root = _Node(chunk=(), block=-1, parent=None)
        self._nodes: List[_Node] = []  # every non-root node
        self._clock = 0
        # counters (engine/serving metrics read these as monotonic)
        self.lookups = 0
        self.hits = 0
        self.tokens_skipped = 0
        self.evictions = 0
        self.cow_copies = 0
        # memory hierarchy (attach_pager): demote/promote are engine
        # callbacks because only the engine can read/scatter device KV
        self.pager = None
        self._demote_cb = None   # _Node -> Optional[(handle, tier)]
        self._promote_cb = None  # _Node -> bool (True: node is device again)

    def attach_pager(self, pager, demote_cb, promote_cb) -> None:
        """Enable demote-instead-of-evict (``inference/v2/paging.py``).
        ``demote_cb(node)`` serializes the node's device block into the
        pager and returns ``(handle, tier)`` or ``None`` when the pager is
        full; ``promote_cb(node)`` fetches a demoted node's bytes back into
        a fresh device block and returns success."""
        self.pager = pager
        self._demote_cb = demote_cb
        self._promote_cb = promote_cb

    # -- lookup --------------------------------------------------------

    def match(self, tokens: Sequence[int], limit: int) -> Optional[PrefixMatch]:
        """Longest cached prefix of ``tokens[:limit]``.

        ``limit`` must leave at least one token to prefill (the scheduler
        passes ``cur_len - 1``): a fully-cached prompt still needs one
        forward to produce its first output logit.  Returns ``None`` when
        nothing (or less than ``min_prefix_tokens``) matches.  Increments
        ``lookups`` only; the engine counts hits/skipped tokens once the
        match survives admission.
        """
        self.lookups += 1
        self._clock += 1
        bs = self.block_size
        limit = min(limit, len(tokens))
        node = self._root
        blocks: List[int] = []
        matched = 0
        while matched + bs <= limit:
            child = node.children.get(tuple(tokens[matched:matched + bs]))
            if child is None:
                break
            if child.tier != "device":
                # demoted prefix: a miss becomes a host→device promote
                # instead of a recompute.  On failure (pager entry gone,
                # or no device block even after demoting others) the walk
                # stops here and the tail prefills normally.
                if self._promote_cb is None or not self._promote_cb(child):
                    break
            node = child
            node.last_used = self._clock
            # pin the walked path immediately (not at the end): promoting
            # a deeper node may demote-to-make-room, and an unpinned
            # ancestor on this very path would be a legal victim — its
            # freed block id would go stale in ``blocks``
            self.allocator.incref(node.block)
            blocks.append(node.block)
            matched += bs
        # partial-block divergence: find the child sharing the longest
        # sub-chunk prefix — its block is the copy-on-write source
        cow_src: Optional[int] = None
        cow_tokens = 0
        room = min(limit - matched, bs)
        if room > 0:
            rest = tuple(tokens[matched:matched + room])
            for chunk, child in node.children.items():
                if child.tier != "device":
                    continue  # COW forks read device bytes only
                m = 0
                while m < room and chunk[m] == rest[m]:
                    m += 1
                # m < bs always: a full-chunk match would have been taken
                # by the tree walk above
                if m > cow_tokens:
                    cow_tokens = m
                    cow_src = child.block
                    child.last_used = self._clock
        total = matched + cow_tokens
        if total == 0 or total < self.min_prefix_tokens:
            if blocks:
                self.allocator.free(blocks)  # drop the walk's pins
            return None
        if cow_src is not None:
            self.allocator.incref(cow_src)
        return PrefixMatch(blocks=blocks, tokens=matched, cow_src=cow_src,
                           cow_tokens=cow_tokens)

    def walk_full_blocks(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Full-block tree walk for KV handoff export: returns (blocks,
        matched_tokens) with one caller reference taken per block (released
        through ``allocator.free`` when the export is done).  Unlike
        :meth:`match` it moves no hit/lookup counters and never returns a
        copy-on-write source — the unit of transfer is whole radix-subtree
        blocks."""
        bs = self.block_size
        node = self._root
        blocks: List[int] = []
        matched = 0
        while matched + bs <= len(tokens):
            child = node.children.get(tuple(tokens[matched:matched + bs]))
            if child is None or child.tier != "device":
                break  # exports ship device bytes; demoted tails stay put
            node = child
            blocks.append(node.block)
            matched += bs
        for b in blocks:
            self.allocator.incref(b)
        return blocks, matched

    def summary(self, max_digests: int = 1024) -> Dict[str, Any]:
        """Routing summary: the cumulative digests of every cached chunk
        path (see :func:`prefix_digests`).  Small enough to ride the worker
        heartbeat; the balancer counts how many leading blocks of a prompt
        a replica already holds by digest-set intersection, without ever
        shipping token ids over the wire."""
        digests: List[str] = []
        stack: List[Tuple[_Node, bytes]] = [(self._root, b"")]
        while stack and len(digests) < max_digests:
            node, prev = stack.pop()
            for chunk, child in node.children.items():
                h = hashlib.blake2b(prev, digest_size=8)
                h.update(struct.pack(f"<{len(chunk)}I", *chunk))
                d = h.digest()
                digests.append(d.hex())
                if len(digests) >= max_digests:
                    break
                stack.append((child, d))
        return {"block_size": self.block_size, "digests": digests}

    # -- insertion -----------------------------------------------------

    def donate(self, tokens: Sequence[int], seen_tokens: int,
               blocks: List[int]) -> None:
        """Absorb a finished/cancelled sequence's blocks.

        ``seen_tokens`` is the number of tokens actually written to KV;
        only full blocks are cacheable.  For each full chunk: if the tree
        already has it, the sequence's reference is dropped (the shared
        block was the same one, or a duplicate we don't need); otherwise
        the node adopts the sequence's reference.  A *demoted* node on the
        path is re-adopted instead: the sequence's device block holds the
        identical KV bytes, so the node takes it, goes back to tier
        "device", and the paged copy is dropped — promotion for free,
        preserving the no-device-under-paged subtree invariant.  Trailing
        partial / unused blocks go back to the pool.
        """
        self._clock += 1
        bs = self.block_size
        n_full = min(seen_tokens // bs, len(blocks))
        node = self._root
        for i in range(n_full):
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk=chunk, block=blocks[i], parent=node)
                node.children[chunk] = child
                self._nodes.append(child)
            elif child.tier != "device":
                child.block = blocks[i]  # adopt the sequence's reference
                child.tier = "device"
                if self.pager is not None and child.handle is not None:
                    self.pager.drop(child.handle)
                child.handle = None
                self.allocator.note_promote()
            else:
                self.allocator.free([blocks[i]])
            child.last_used = self._clock
            node = child
        if blocks[n_full:]:
            self.allocator.free(blocks[n_full:])

    def adopt_demoted(self, tokens: Sequence[int], handle: int,
                      tier: str = "cold") -> str:
        """Restart rehydration: re-adopt one surviving paged-out chunk as
        a demoted tree node (``block = -1``, pager ``handle``), WITHOUT
        touching the device.  ``tokens`` is the chunk's full chain prefix
        (a multiple of ``block_size``); every ancestor chunk must already
        be in the tree, so callers adopt parent-first.  Returns a status:
        ``"adopted"``, ``"orphan"`` (an ancestor chunk didn't survive —
        the chunk is unreachable and its entry should be dropped), or
        ``"duplicate"`` (the chain is already cached — the caller must
        unwind its handle WITHOUT deleting the durable entry, which a
        live node may share).  A later :meth:`match` promotes an adopted
        node through the normal engine callback, so rehydrated bytes
        re-enter the device path exactly like any demoted block."""
        bs = self.block_size
        if len(tokens) < bs or len(tokens) % bs != 0:
            return "orphan"
        node = self._root
        n = len(tokens) // bs
        for i in range(n - 1):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                return "orphan"
            node = child
        last = tuple(tokens[(n - 1) * bs:n * bs])
        if last in node.children:
            return "duplicate"
        self._clock += 1
        child = _Node(chunk=last, block=-1, parent=node, tier=tier,
                      handle=handle, last_used=self._clock)
        node.children[last] = child
        self._nodes.append(child)
        self.allocator.note_demote()
        return "adopted"

    # -- eviction ------------------------------------------------------

    def evict(self, n: int) -> int:
        """Free up to ``n`` device blocks, preferring *demotion* (pager
        attached: bytes to host tier, node stays in the tree) over true
        eviction.  Returns device blocks actually freed.

        Candidates are LRU device nodes whose block is referenced only by
        the tree and whose children (if any) are all paged out already —
        so subtrees demote root-last and "demoted subtrees" survive whole.
        Under ``eviction="none"`` a pager still demotes (lossless), but
        nothing is ever truly evicted.

        Nodes aliased to ONE block (a COW fork can leave two leaf paths on
        the same block id, each holding its own tree reference) are
        handled as a group: every alias node is detached and drops its
        reference, but the group counts as ONE freed block — the old code
        treated each alias as an independent victim, double-counting the
        block in pressure math and in the freed total."""
        if self.eviction != "lru" and self.pager is None:
            return 0
        freed = 0
        skipped: set = set()
        while freed < n:
            owners: Dict[int, List[_Node]] = {}
            for nd in self._nodes:
                if nd.tier == "device":
                    owners.setdefault(nd.block, []).append(nd)
            victim: Optional[_Node] = None
            for node in self._nodes:
                if node.tier != "device" or id(node) in skipped:
                    continue
                if any(c.tier == "device" for c in node.children.values()):
                    continue  # demote leaves-first (device-wise)
                # each alias node holds its own tree reference: the block
                # is tree-only iff refcount == number of owning nodes
                if self.allocator.refcount(node.block) != \
                        len(owners[node.block]):
                    continue  # pinned by a live sequence
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            aliases = [a for a in owners[victim.block] if a is not victim]
            if self._demote_cb is not None and not aliases:
                res = self._demote_cb(victim)
                if res is not None:
                    handle, tier = res
                    self.allocator.free([victim.block])
                    self.allocator.note_demote()
                    victim.block = -1
                    victim.tier = tier
                    victim.handle = handle
                    freed += 1
                    continue
            if self.eviction != "lru" or victim.children:
                # pager full (or eviction disabled): a node over a demoted
                # subtree must never be truly evicted — that would orphan
                # the subtree — so it is simply not reclaimable right now
                skipped.add(id(victim))
                continue
            group = [victim] + aliases
            if any(a.children for a in aliases):
                skipped.update(id(a) for a in group)
                continue
            for nd in group:
                del nd.parent.children[nd.chunk]
                self._nodes.remove(nd)
                self.allocator.free([nd.block])  # one tree ref per node
            self.evictions += 1
            freed += 1  # ONE device block returned to the pool
        return freed

    def reset(self) -> int:
        """Drop the whole tree, freeing every block no sequence shares.
        Blocks still referenced by live sequences lose only the tree's
        reference; demoted nodes drop their pager entries.  Returns the
        number of nodes dropped."""
        dropped = len(self._nodes)
        for node in self._nodes:
            if node.tier != "device":
                if self.pager is not None and node.handle is not None:
                    self.pager.drop(node.handle)
                self.allocator.note_promote()
            else:
                # every node holds exactly one reference — alias nodes
                # (two paths on one block) each drop their own
                self.allocator.free([node.block])
        self._nodes = []
        self._root.children = {}
        return dropped

    # -- accounting ----------------------------------------------------

    @property
    def cached_blocks(self) -> int:
        return len(self._nodes)

    @property
    def device_blocks(self) -> int:
        """Distinct device blocks the tree holds (alias nodes deduped)."""
        return len({nd.block for nd in self._nodes if nd.tier == "device"})

    @property
    def demoted_blocks(self) -> int:
        """Tree nodes whose KV bytes live in the pager (host or spill)."""
        return sum(1 for nd in self._nodes if nd.tier != "device")

    def _device_owners(self) -> Dict[int, int]:
        """block id -> number of device-tier tree nodes owning it (alias
        nodes from a COW fork can put two nodes on one block; each holds
        its own reference)."""
        owners: Dict[int, int] = {}
        for nd in self._nodes:
            if nd.tier == "device":
                owners[nd.block] = owners.get(nd.block, 0) + 1
        return owners

    @property
    def evictable_blocks(self) -> int:
        """DISTINCT device blocks held only by the tree — reclaimable
        under pressure.  Deduped by block id: the old per-node count
        listed a COW-fork-aliased block twice, overstating reclaimable
        capacity in admission/pressure math."""
        return sum(1 for b, k in self._device_owners().items()
                   if self.allocator.refcount(b) == k)

    @property
    def shared_blocks(self) -> int:
        """Distinct tree blocks also referenced by a live sequence."""
        return sum(1 for b, k in self._device_owners().items()
                   if self.allocator.refcount(b) > k)

    @property
    def reclaimable_blocks(self) -> int:
        """What admission control may count as effectively-free.  A pager
        makes cached blocks recoverable even under ``eviction="none"``:
        demotion is lossless, so pressure can always push them out."""
        if self.eviction == "lru" or self.pager is not None:
            return self.evictable_blocks
        return 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def check_consistency(self) -> None:
        """Tier invariants on top of the allocator's pool check:
        ``device_free + evictable + pinned + demoted == total + demoted``
        (i.e. the resident KV footprint exactly partitions into tiers),
        with ``demoted`` verified three ways — allocator counter, pager
        residency, and tree nodes — so none of the terms is vacuous."""
        self.allocator.check_consistency()
        demoted_nodes = self.demoted_blocks
        if self.allocator.demoted != demoted_nodes:
            raise AssertionError(
                f"allocator says {self.allocator.demoted} demoted blocks, "
                f"tree holds {demoted_nodes} non-device nodes")
        if self.pager is not None:
            resident = self.pager.resident_blocks
            if resident != demoted_nodes:
                raise AssertionError(
                    f"pager holds {resident} blocks, tree references "
                    f"{demoted_nodes} demoted nodes")
            for nd in self._nodes:
                if nd.tier != "device" and nd.handle is None:
                    raise AssertionError("demoted node without a handle")
        for nd in self._nodes:
            if nd.tier != "device":
                if any(c.tier == "device" for c in nd.children.values()):
                    raise AssertionError(
                        "device node under a demoted parent")
            elif nd.block < 0:
                raise AssertionError("device node with block -1")
        alloc = self.allocator
        live = sum(1 for b in range(alloc.num_blocks) if alloc.refcount(b) > 0)
        pinned = live - self.evictable_blocks
        lhs = alloc.free_blocks + self.evictable_blocks + pinned \
            + alloc.demoted
        if lhs != alloc.num_blocks + alloc.demoted:
            raise AssertionError(
                f"tier accounting broken: {alloc.free_blocks} free + "
                f"{self.evictable_blocks} evictable + {pinned} pinned + "
                f"{alloc.demoted} demoted != "
                f"{alloc.num_blocks} + {alloc.demoted}")

    def stats(self) -> Dict[str, float]:
        pg = self.pager
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hit_rate,
            "prefill_tokens_skipped": self.tokens_skipped,
            "evictions": self.evictions,
            "cow_copies": self.cow_copies,
            "cached_blocks": self.cached_blocks,
            "shared_blocks": self.shared_blocks,
            "evictable_blocks": self.evictable_blocks,
            # memory-hierarchy gauges (all zero without a pager)
            "tier_device_blocks": self.device_blocks,
            "tier_host_blocks": pg.host_blocks if pg else 0,
            "tier_spill_blocks": pg.spill_blocks if pg else 0,
            "tier_cold_blocks": pg.cold_blocks if pg else 0,
            "rehydrated_blocks": pg.rehydrated if pg else 0,
            "demotions": pg.demotions if pg else 0,
            "promotions": pg.promotions if pg else 0,
            "promote_wait_ms": pg.promote_wait_total_ms if pg else 0.0,
        }
