"""Radix prefix cache: token-block trie over the refcounted paged KV pool.

Port of ``repro.serving.prefix_cache`` (pure host code, copied without the
spill-tier restore path: the host spill tier is a later slice, and the
port's engine rejects ``spill=True``).

GLM-5's serving posture (§3.6) feeds agentic traffic whose prompts are
massively redundant: thousands of rollouts share one system prompt, and a
multi-turn session re-submits its whole conversation every turn.  The KV
state for a token prefix depends only on the tokens (positions are
absolute, blocks are position-ordered), so already-computed blocks can be
aliased into any new sequence whose prompt starts with the same tokens —
re-prefilling them is pure waste (the quadratic-cost dynamic
``agents/search_env.py`` models).

Structure: a trie whose edges are BLOCKS of tokens.  A node owns one
physical KV block holding ``length`` tokens; internal nodes are always
full (``length == block_size``), a leaf may be partial (the tail of a
retired sequence).  The cache holds ONE reference on every node's block;
readers add their own via ``PagedKVCache.retain``.

* ``match(tokens)`` walks full-block edges greedily, then takes the best
  partial overlap with any child (a shared prefix that diverges
  mid-block).  Matched blocks are retained for the caller.  A caller that
  matched into the middle of a block must copy-on-write fork it before
  writing (the engine owns the device copy); the cached copy is never
  mutated.
* ``insert(tokens, blocks)`` is called on retire: the sequence's blocks
  are adopted into the trie (ownership transfer) or, where an identical
  node already exists, the caller's reference is dropped — so concurrent
  retires of the same prefix deduplicate to one physical copy.
* ``evict(n)`` frees least-recently-used UNREFERENCED leaves (refcount 1
  == only the cache holds them); parents become evictable once their
  children go, so a cold chain unwinds tail-first and the prefix
  property (every cached block's ancestors are cached) is preserved.
  Registered as ``kv.evictor`` so allocation pressure reclaims cache
  space automatically instead of raising ``CacheFull``.

Weight-version awareness (the incremental-invalidation contract): KV is a
function of the tokens AND the weights, so a trainer weight push makes
every cached block numerically stale.  Instead of resetting the world,
the cache leans on the allocator's block version stamps
(``PagedKVCache.block_version`` vs ``kv.version``):

* ``match`` refuses to walk into a node whose block was written under an
  older version — admission simply never aliases stale KV into a newer
  forward (``stats["version_refused"]`` counts refused walks);
* ``insert`` REFRESHES a stale node in place when a retired sequence
  re-derives the same token content under the current weights: the
  node adopts the new block and the stale one is released
  (``stats["refreshed_blocks"]``) — so hot prefixes heal version by
  version without ever duplicating tree paths;
* ``evict`` reclaims stale blocks FIRST (they can never be matched
  again), then falls back to LRU among current-version leaves — a push
  invalidates lazily, under allocation pressure, never eagerly.

Because ``insert`` walks root-first, every fresh node's ancestors are
fresh, so ``match``'s stop-at-first-stale walk never misses a reachable
current-version prefix.

Eviction still calls the allocator's ``demote_hook`` (the evictor
protocol), so a spill tier can attach without changing this module's
eviction order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.paged import PagedKVCache


class _Node:
    __slots__ = ("key", "block", "length", "parent", "children", "stamp")

    def __init__(self, key: Tuple[int, ...], block: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.length = len(key)
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.stamp = 0


def _common_prefix(a: Tuple[int, ...], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class PrefixCache:
    """Block-granular radix tree mapping token prefixes to KV blocks."""

    def __init__(self, kv: PagedKVCache):
        self.kv = kv
        self.block_size = kv.block_size
        self.root = _Node((), None, None)
        self._tick = 0
        # registry-backed stats view (same keys/semantics as the old
        # dict); shares the allocator's registry so cache behavior lands
        # in the same snapshot as the engine latencies it shapes
        from repro_torch.obs.metrics import StatsView
        self.stats = StatsView(
            kv.registry, "prefix",
            ["hits", "misses", "matched_tokens", "evictions",
             "inserted_blocks", "deduped_blocks", "version_refused",
             "refreshed_blocks", "stale_evictions"])
        kv.evictor = self.evict

    # ------------------------------------------------------------- queries
    @property
    def cached_blocks(self) -> int:
        return sum(1 for _ in self._iter_nodes())

    @property
    def stale_cached_blocks(self) -> int:
        """Cached blocks written under an older weight version — dead
        weight awaiting lazy eviction (never matched, evicted first)."""
        return sum(1 for n in self._iter_nodes() if not self._fresh(n))

    def _fresh(self, node: _Node) -> bool:
        """Is the node's block aliasable at the CURRENT weight version?"""
        return self.kv.block_version(node.block) == self.kv.version

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.stamp = self._tick

    # --------------------------------------------------------------- match
    def match(self, tokens: Sequence[int], *,
              limit: Optional[int] = None) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens[:limit]``.

        Returns ``(m, blocks)``: ``m`` matched tokens whose KV lives in
        ``blocks`` (position order, ``ceil(m / block_size)`` of them), each
        retained on behalf of the caller.  If ``m % block_size != 0`` the
        final block is only partially matched and MUST be copy-on-write
        forked (and its reference released) before the caller writes into
        that position range."""
        bs = self.block_size
        L = len(tokens) if limit is None else min(limit, len(tokens))
        node, m = self.root, 0
        blocks: List[int] = []
        refused: Optional[_Node] = None
        while m + bs <= L:
            child = node.children.get(tuple(int(t) for t in tokens[m:m + bs]))
            if child is None:
                break
            if not self._fresh(child):
                # KV written under older weights: never alias it into a
                # newer forward — the caller re-prefills from here and
                # insert() will refresh the stale path on retire
                self.stats["version_refused"] += 1
                refused = child
                break
            node = child
            # retain as the walk advances: a block promised to the caller
            # is never reclaimable by a later allocation's eviction
            self.kv.retain([node.block])
            blocks.append(node.block)
            m += bs
            self._touch(node)
        # best partial overlap with any child (full or partial): a reader
        # diverging mid-block forks the copy, so any overlap >= 1 saves work
        best, best_k = None, 0
        rest = [int(t) for t in tokens[m:L]]
        if rest:
            for key, child in node.children.items():
                k = _common_prefix(key, rest)
                if k == 0:
                    continue
                if not self._fresh(child):
                    # a stale child refused mid-block counts exactly like
                    # the full-block walk's refusal — the telemetry must
                    # not undercount the partial-overlap case (but one
                    # node refused in BOTH phases counts once per match)
                    if child is not refused:
                        self.stats["version_refused"] += 1
                    continue
                if k > best_k:
                    best, best_k = child, k
        if best is not None:
            self.kv.retain([best.block])
            blocks.append(best.block)
            m += best_k
            self._touch(best)
        if blocks:
            self.stats["hits"] += 1
        else:
            self.stats["misses"] += 1
        self.stats["matched_tokens"] += m
        return m, blocks

    # -------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], blocks: List[int]) -> None:
        """Adopt a retired sequence's blocks into the trie.

        ``blocks`` must cover exactly ``ceil(len(tokens) / block_size)``
        blocks, position-ordered, with one reference each held by the
        caller.  Ownership transfers: where a path node is created the
        caller's reference becomes the cache's; where an identical node
        exists at the CURRENT weight version the duplicate block is
        released; where an identical node holds a STALE block (written
        under pre-push weights) the node is refreshed in place — it
        adopts the caller's current-version block and the cache's
        reference on the stale one is dropped (readers that still hold
        their own reference, e.g. a pinned session, are unaffected)."""
        bs = self.block_size
        toks = [int(t) for t in tokens]
        need = -(-len(toks) // bs) if toks else 0
        if len(blocks) != need:
            raise ValueError(f"insert: {len(toks)} tokens need {need} "
                             f"blocks, got {len(blocks)}")
        node, i, bi = self.root, 0, 0
        while i + bs <= len(toks):
            key = tuple(toks[i:i + bs])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, blocks[bi], node)
                node.children[key] = child
                self.stats["inserted_blocks"] += 1
            elif self._fresh(child):
                self.kv.release([blocks[bi]])       # duplicate content
                self.stats["deduped_blocks"] += 1
            else:
                self._refresh(child, blocks[bi])    # same tokens, new weights
            node = child
            self._touch(node)
            i += bs
            bi += 1
        rem = tuple(toks[i:])
        if rem:
            child = node.children.get(rem)
            if child is None:
                child = _Node(rem, blocks[bi], node)
                node.children[rem] = child
                self.stats["inserted_blocks"] += 1
            elif self._fresh(child):
                self.kv.release([blocks[bi]])
                self.stats["deduped_blocks"] += 1
            else:
                self._refresh(child, blocks[bi])
            self._touch(child)

    def _refresh(self, node: _Node, block: int) -> None:
        """Swap a stale node's block for a current-version re-derivation
        of the same token content (the caller's reference transfers)."""
        self.kv.release([node.block])
        node.block = block
        self.stats["refreshed_blocks"] += 1

    # ------------------------------------------------------------ eviction
    def _path(self, node: _Node) -> Tuple[int, ...]:
        """Full token path root -> ``node`` (the spill tier's key)."""
        keys = []
        while node.parent is not None:
            keys.append(node.key)
            node = node.parent
        out: List[int] = []
        for k in reversed(keys):
            out.extend(k)
        return tuple(out)

    def _evictable(self, node: _Node) -> bool:
        return (node.parent is not None
                and node.parent.children.get(node.key) is node
                and not node.children
                and self.kv.refcount(node.block) == 1)

    def evict(self, n: int) -> int:
        """Free up to ``n`` blocks — stale-version leaves first (a weight
        push made them unmatchable: pure dead weight), then LRU among
        current-version leaves; returns count freed.

        A leaf is evictable only when no sequence references its block;
        removing it may expose its parent as the next candidate, so a cold
        chain unwinds from the tail without ever orphaning a descendant.
        One trie walk seeds a min-heap of leaves; parents are pushed as
        their last child goes, so evicting k of N cached blocks is
        O((N + k) log N), not O(k·N)."""
        import heapq

        def key(nd):
            # fresh-ness dominates recency: (False, *) = stale sorts first
            return (self._fresh(nd), nd.stamp, id(nd))

        heap = [key(nd) + (nd,) for nd in self._iter_nodes()
                if self._evictable(nd)]
        heapq.heapify(heap)
        freed = 0
        while freed < n and heap:
            entry = heapq.heappop(heap)
            victim = entry[-1]
            # a heap entry goes stale when the tree/refcount state (or the
            # allocator version) moved on since it was pushed
            if not self._evictable(victim) or entry[:-1] != key(victim):
                continue
            parent = victim.parent
            del parent.children[victim.key]
            if not self._fresh(victim):
                self.stats["stale_evictions"] += 1
            elif self.kv.demote_hook is not None \
                    and victim.length == self.block_size:
                # demote instead of forget: the spill tier gathers the
                # block's bytes to host before the release frees it
                # (stale victims skip this — they could never be
                # restored; partial tails key on nothing restorable)
                self.kv.demote_hook(self._path(victim), victim.block,
                                    self.kv.block_version(victim.block))
            self.kv.release([victim.block])
            freed += 1
            self.stats["evictions"] += 1
            if parent is not self.root and self._evictable(parent):
                heapq.heappush(heap, key(parent) + (parent,))
        return freed

    def clear(self) -> None:
        """Drop every cached block (e.g. between benchmark runs)."""
        for node in list(self._iter_nodes()):
            self.kv.release([node.block])
        self.root.children.clear()
