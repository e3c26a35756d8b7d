"""KV memory hierarchy: prefix cache + host swap tier.

Mirrors ``deepspeed_tpu/inference/v2/kv_hierarchy.py`` on top of the
refcounted ``BlockedAllocator``:

1. **PrefixCache**: a host-side index of token-block-aligned prefixes over
   the live device pool. At every frame boundary the engine publishes each
   row's full blocks below its committed watermark (one allocator reference
   per published block: content below the watermark is final, so a
   published page is shared read-only). Admission matches a new prompt
   against the chain, maps the hit blocks into the request's block table
   (``allocator.share``) and starts prefill at the first uncached position.
   A hit that ends mid-block copies that page (copy-on-write,
   ``BlockedKVCache.copy_blocks``), so published content is never mutated.

2. **KVSwapTier**: a host tier on ``AsyncTensorSwapper`` (atomic ``.swp``
   commits through the port's aio engine) with a JSON index beside the
   pages. Cold prefix blocks spill to it under KV pressure, scheduler
   preemption swaps a victim's committed pages out and re-admission swaps
   them back in, and content-addressed prefix records share a prompt
   prefix across engines. Pages move through ``read_pages`` /
   ``scatter_pages`` at frame boundaries only.

The record format is the JAX package's: the same index schema, the dtype
named as JAX names it ("bfloat16", "float32", "int8"), the row ``layout``
stamp and the ``page_shape``, and the page files' raw bytes. A tier written
by either package restores into the other, byte for byte.
"""

import dataclasses
import functools
import hashlib
import json
import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ...runtime.swap_tensor.swapper import AsyncTensorSwapper, dtype_name

logger = logging.getLogger(__name__)

CHAIN_ROOT = -1          # parent id of depth-0 prefix blocks


def _locked(fn):
    """Serialize one ``KVSwapTier``'s public surface: a SHARED tier
    (``attach_kv_tier``) may be hit from several engines' threads, whose
    boundary drains and restores would otherwise race on the
    pending-commit queue and the index. Reentrant (internal cross-calls
    like restore -> drain keep working); uncontended, hence free, under
    one engine."""
    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with self._lock:
            return fn(self, *a, **kw)
    return wrapper


def token_fingerprint(tokens: Sequence[int]) -> str:
    """Content fingerprint of a token prefix (sha1 over the int64 bytes).
    Swap-tier request records carry it so a REUSED uid can never restore
    another request's pages: the pages are only valid under the exact
    token prefix they were committed for."""
    return hashlib.sha1(
        np.ascontiguousarray(np.asarray(tokens, np.int64)).tobytes()
    ).hexdigest()


@dataclasses.dataclass
class PrefixEntry:
    """One published token-block: node ``depth`` of a prefix chain. The
    cache holds ONE allocator reference on ``block`` while resident;
    ``block is None`` means the page content lives in the swap tier under
    ``kvblk_<eid>`` and can be restored into a fresh block on a match."""
    eid: int
    parent: int                 # parent entry id, CHAIN_ROOT at depth 0
    depth: int                  # block index within the prefix chain
    tokens: Tuple[int, ...]     # the block's token ids (len == block_size)
    block: Optional[int]        # device block id; None = swapped out
    source_uid: int             # publisher (quarantine invalidation)
    last_used: int = 0          # LRU clock stamp
    hits: int = 0               # admission matches served (victim scoring)


class PrefixCache:
    """Host-side prefix index with copy-on-write block sharing.

    ``max_blocks`` caps how many device blocks the cache may pin
    (LRU-evicting beyond it); ``swap`` (a ``KVSwapTier``) turns eviction
    into a spill to host RAM instead of a drop. The cache never owns the
    pools — it holds allocator references and block ids only."""

    def __init__(self, kv, max_blocks: Optional[int] = None, swap=None,
                 tag: str = ""):
        self.kv = kv
        self.bs = kv.block_size
        self.max_blocks = max_blocks
        self.swap = swap
        # spill-record namespace: several engines' prefix caches may share
        # ONE tier (the disaggregated fleet), and entry ids are per-cache —
        # the tag keeps their ``kvblk_`` keys from colliding
        self.tag = tag
        # set by the engine when a speculative draft is attached: spilled
        # prefix pages then carry the draft pool's page too, so a restored
        # block keeps draft acceptance instead of proposing against stale
        # pages (target-only restore would still be CORRECT — verification
        # rejects bad proposals — but throughput would silently collapse)
        self.draft_kv = None
        self._by_key: Dict[Tuple[int, Tuple[int, ...]], PrefixEntry] = {}
        self._by_id: Dict[int, PrefixEntry] = {}
        self._children: Dict[int, Set[int]] = {}
        self._next_id = 0
        self._clock = 0
        self.stats = dict(lookups=0, hits=0, hit_tokens=0, published=0,
                          cow_copies=0, evicted=0, swapped_out=0,
                          swapped_in=0)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._by_id)

    def resident_blocks(self) -> int:
        return sum(1 for e in self._by_id.values() if e.block is not None)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _bkey(self, e: PrefixEntry) -> str:
        return f"kvblk_{self.tag}{e.eid}"

    # ------------------------------------------------------------------
    # publish: full blocks below the committed watermark enter the index
    # ------------------------------------------------------------------

    def publish(self, uid: int, stream: Sequence[int], blocks: List[int],
                upto_tokens: int, start_depth: int = 0,
                parent: int = CHAIN_ROOT) -> Tuple[int, int, int]:
        """Walk the stream's full blocks below ``upto_tokens`` (the
        committed watermark) and index any not yet published, taking one
        allocator reference each. ``stream`` starts at token
        ``start_depth * block_size`` — the caller passes only the
        unpublished suffix, so a long-context row's boundary publish
        never copies its whole history. Idempotent: existing entries are
        kept (first publisher wins — re-publishing the same content under
        a different physical block would just waste a page).

        ``start_depth``/``parent`` resume an earlier walk (the caller
        caches the last published chain position per sequence, keeping
        per-boundary publish cost O(new blocks), not O(stream)); a stale
        ``parent`` — its entry reclaimed since — restarts from the root.
        Returns (newly published count, final chain parent eid, depth
        actually reached) — the caller must advance its publish cursor
        only to the REACHED depth: an early stop (cache at capacity)
        otherwise leaves a positional gap the chain would silently paper
        over, and a later match against the gapped chain could map pages
        from the wrong absolute position."""
        if parent != CHAIN_ROOT and parent not in self._by_id:
            # the cached chain position was reclaimed since the last walk;
            # the caller's suffix no longer lines up with any live entry —
            # reset its cursor (the next boundary republishes from the
            # root with the full stream)
            return 0, CHAIN_ROOT, 0
        new = 0
        d_done = start_depth
        walked: Set[int] = set() if parent == CHAIN_ROOT else {parent}
        for d in range(start_depth,
                       min(upto_tokens // self.bs, len(blocks))):
            rel = d - start_depth          # stream is the suffix from here
            toks = tuple(int(t)
                         for t in stream[rel * self.bs:(rel + 1) * self.bs])
            key = (parent, toks)
            e = self._by_key.get(key)
            if e is None:
                # protect the walked ancestors: an unprotected reclaim
                # here could drop this very chain mid-walk and the new
                # child would attach to a dead parent (an unreachable,
                # unclearable block reference)
                if self.max_blocks is not None and \
                        self.resident_blocks() >= self.max_blocks:
                    if not self.reclaim(1, protect=walked):
                        break  # cache full and nothing evictable: stop here
                    if parent != CHAIN_ROOT and parent not in self._by_id:
                        # a resumed walk doesn't hold its deep ancestors
                        # in ``walked``; if the reclaim dropped one, its
                        # subtree took ``parent`` with it — stop, the
                        # next publish restarts from the root
                        break
                self.kv.allocator.share([blocks[d]])
                e = PrefixEntry(eid=self._next_id, parent=parent, depth=d,
                                tokens=toks, block=blocks[d],
                                source_uid=uid, last_used=self._tick())
                self._next_id += 1
                self._by_key[key] = e
                self._by_id[e.eid] = e
                self._children.setdefault(parent, set()).add(e.eid)
                new += 1
            parent = e.eid
            walked.add(parent)
            d_done = d + 1
        self.stats["published"] += new
        return new, parent, d_done

    # ------------------------------------------------------------------
    # match: longest published chain covering a new prompt
    # ------------------------------------------------------------------

    def match(self, prompt: Sequence[int]
              ) -> Tuple[List[PrefixEntry], Optional[Tuple[PrefixEntry, int]]]:
        """Longest full-block chain matching ``prompt`` plus, past it, the
        best PARTIAL child match ``(entry, m)`` — a published block whose
        first ``m`` tokens continue the prompt (the copy-on-write source:
        the caller copies the page and diverges mid-block). Pure lookup:
        reference counts and LRU stamps move in ``map_hit``."""
        self.stats["lookups"] += 1
        out: List[PrefixEntry] = []
        parent, pos = CHAIN_ROOT, 0
        prompt = [int(t) for t in prompt]
        while pos + self.bs <= len(prompt):
            e = self._by_key.get((parent, tuple(prompt[pos:pos + self.bs])))
            if e is None:
                break
            out.append(e)
            parent, pos = e.eid, pos + self.bs
        partial = None
        rem = prompt[pos:pos + self.bs]
        if rem:
            best_m = 0
            for ceid in self._children.get(parent, ()):
                ce = self._by_id[ceid]
                m = 0
                for a, b in zip(ce.tokens, rem):
                    if a != b:
                        break
                    m += 1
                if m > best_m:
                    best_m, partial = m, (ce, m)
        return out, partial

    def ensure_resident(self, entry: PrefixEntry,
                        protect: Optional[Set[int]] = None) -> bool:
        """Swapped-out entries restore into a freshly allocated block
        (swap tier read + one boundary scatter). False when the entry
        cannot be made resident (no tier, or the pool is truly full even
        after reclaiming). ``protect`` must cover every OTHER entry the
        caller intends to map from this match: until ``map_hit`` shares
        them they sit at refcount 1 and an unprotected reclaim here could
        spill a chain-mate the caller already vetted."""
        if entry.block is not None:
            return True
        if self.swap is None:
            return False
        alloc = self.kv.allocator
        protect = (protect or set()) | {entry.eid}
        if alloc.free_blocks < 1 and not self.reclaim(1, protect=protect):
            return False
        block = alloc.allocate(1)[0]
        try:
            self.swap.restore_block(self._bkey(entry), self.kv, block,
                                    draft_kv=self.draft_kv)
        except Exception as e:       # noqa: BLE001 — degrade to a miss
            alloc.free([block])
            logger.warning(f"prefix cache: restore of swapped block "
                           f"eid={entry.eid} failed ({e}); treating as miss")
            self._drop_subtree(entry)
            return False
        entry.block = block
        self.stats["swapped_in"] += 1
        return True

    def touch(self, entries: Sequence[PrefixEntry], hit_tokens: int) -> None:
        """Stamp a successful hit (LRU + per-entry hit frequency +
        counters)."""
        now = self._tick()
        for e in entries:
            e.last_used = now
            e.hits += 1
        if hit_tokens > 0:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += hit_tokens

    # ------------------------------------------------------------------
    # eviction / invalidation
    # ------------------------------------------------------------------

    def _drop_subtree(self, root: PrefixEntry) -> int:
        """Remove ``root`` and every descendant from the index (children
        are unreachable once their parent's chain link is gone): drop the
        cache's block reference (sharers keep the page alive) or the swap
        record. Iterative worklist — a 64k-token shared prefix is a
        >1000-deep linear chain, past Python's recursion limit. Returns
        how many device blocks actually RETURNED to the free pool
        (cache-only references)."""
        n = 0
        todo = [root]
        while todo:
            e = todo.pop()
            todo.extend(self._by_id[ceid]
                        for ceid in self._children.get(e.eid, ()))
            if e.block is not None:
                if self.kv.allocator.refcount(e.block) == 1:
                    n += 1
                self.kv.allocator.free([e.block])
                e.block = None
            elif self.swap is not None:
                self.swap.drop_block(self._bkey(e))
            self._by_key.pop((e.parent, e.tokens), None)
            self._by_id.pop(e.eid, None)
            self._children.pop(e.eid, None)
            self._children.get(e.parent, set()).discard(e.eid)
        return n

    def _subtree_sizes(self) -> Dict[int, int]:
        """Resident device blocks per entry's subtree (what a no-tier
        eviction of that entry would actually unpin), for EVERY entry in
        ONE iterative post-order pass over the forest — per-candidate
        subtree walks would make a pressure reclaim quadratic in resident
        entries on the common chain-shaped caches."""
        sizes: Dict[int, int] = {}
        roots = [e for e in self._by_id.values()
                 if e.parent not in self._by_id]
        stack = [(e, False) for e in roots]
        while stack:
            e, ready = stack.pop()
            kids = self._children.get(e.eid, ())
            if ready:
                sizes[e.eid] = (1 if e.block is not None else 0) + \
                    sum(sizes[c] for c in kids)
            else:
                stack.append((e, True))
                stack.extend((self._by_id[c], False) for c in kids)
        return sizes

    def _victim_order(self, cands: List[PrefixEntry]) -> List[PrefixEntry]:
        """Hit-frequency- and size-aware victim scoring: evict the
        least-hit entries first (a hot small prefix outlives a cold large
        one regardless of recency), break hit ties by LARGER subtree first
        (reclaiming more per eviction), and keep LRU as the final
        tie-break. Pure ordering — the caller applies the refcount /
        protect filters."""
        sizes = self._subtree_sizes() if cands else {}
        return sorted(cands, key=lambda e: (e.hits,
                                            -sizes.get(e.eid, 0),
                                            e.last_used))

    def reclaim(self, n_blocks: int, protect: Optional[Set[int]] = None
                ) -> int:
        """Free up to ``n_blocks`` device blocks from cold UNREFERENCED
        entries (allocator refcount 1 — the cache's own reference), in
        ``_victim_order`` (hit frequency, then subtree size, LRU as the
        tie-break). With a swap tier the pages spill to host RAM as ONE
        batch (one device gather over the whole cold set, queued async
        writes committed by a single wait, one index rewrite — a pressure
        event evicting N blocks used to pay that I/O sequence N times) and
        the entries stay matchable (restored on the next hit); without one
        the entry (and its now-unreachable subtree) is dropped. Returns
        the number of device blocks actually freed."""
        protect = protect or set()
        freed = 0
        cands = self._victim_order(
            [e for e in self._by_id.values()
             if e.block is not None and e.eid not in protect
             and self.kv.allocator.refcount(e.block) == 1])
        if self.swap is None:
            for e in cands:
                if freed >= n_blocks:
                    break
                if e.eid not in self._by_id or e.block is None:
                    continue   # dropped as part of an earlier subtree
                freed += self._drop_subtree(e)
                self.stats["evicted"] += 1
            return freed
        batch = [e for e in cands[:n_blocks]
                 if e.eid in self._by_id and e.block is not None]
        if not batch:
            return 0
        try:
            self.swap.put_blocks([self._bkey(e) for e in batch], self.kv,
                                 [e.block for e in batch],
                                 draft_kv=self.draft_kv)
        except Exception as err:   # noqa: BLE001 — drop instead
            # the swapper rolled every in-flight write back (atomic batch
            # commit); degrade to dropping the cold entries outright
            logger.warning(f"prefix cache: batched spill of "
                           f"{len(batch)} blocks failed ({err}); dropping")
            for e in batch:
                if e.eid in self._by_id and e.block is not None:
                    freed += self._drop_subtree(e)
                    self.stats["evicted"] += 1
            return freed
        for e in batch:
            self.kv.allocator.free([e.block])
            e.block = None
            freed += 1
            self.stats["swapped_out"] += 1
            self.stats["evicted"] += 1
        return freed

    def invalidate_uid(self, uid: int) -> int:
        """Drop every entry published by ``uid`` (and its subtrees) — the
        quarantine hook: a row whose logits went non-finite may have
        written non-finite KV, and a poisoned page must never be handed
        to a healthy request."""
        doomed = [e for e in self._by_id.values() if e.source_uid == uid]
        n0 = len(self._by_id)
        for e in doomed:
            if e.eid in self._by_id:       # not already dropped via a parent
                self._drop_subtree(e)
        return n0 - len(self._by_id)

    def clear(self) -> None:
        """Release every cache-held reference (tests / explicit flush)."""
        for e in [e for e in self._by_id.values() if e.parent == CHAIN_ROOT]:
            self._drop_subtree(e)


class KVSwapTier:
    """Host-RAM tier for committed KV pages, on the ``swap_tensor``
    machinery. Three record kinds share one ``AsyncTensorSwapper``
    (atomic, crash-safe `.swp` commits) plus a tiny JSON index persisted
    beside the pages (``kv_tier_index.json``), so a tier directory
    outlives the engine process — ``serve(resume_from=)`` on a fresh
    engine restores a preempted victim's pages instead of re-prefilling
    them:

    * **request records** (``kvreq_<uid>_s<k>_*``) — a preempted or
      crashed request's committed pages (target k/v and, under
      speculation, the draft pools' pages for the same block ids). A
      record is a LIST OF SEGMENTS: ``publish_request_segment`` appends
      each boundary's newly-committed full blocks, so a writer killed
      mid-prompt leaves a restorable partial-watermark record behind.
      (JAX's records may also carry a ``handoff`` dict for its
      disaggregated fleet; the port reads past it until roles are
      ported, ROADMAP §A item 12.)
    * **block records** (``kvblk_<tag><eid>_*``) — single cold
      prefix-cache pages spilled under KV pressure (per-engine, keyed by
      in-memory entry ids).
    * **prefix records** (``kvpfx_<fingerprint>_*``) — CONTENT-ADDRESSED
      pages covering a chunk-aligned prompt prefix, keyed by the token
      fingerprint: any engine sharing the tier can match a new prompt
      against them and admit at the watermark, so a hot shared prompt is
      prefilled once FLEET-WIDE (``put_prefix`` / ``match_prefix`` /
      ``restore_prefix``).

    ``shared=True`` marks a tier owned by a FLEET rather than one engine:
    ``prune_requests`` becomes a no-op (the router owns record lifecycle —
    one engine's serve() must not drop its peers' records) and
    per-engine prefix caches attached to it must use distinct ``tag``s.

    Record writes may be queued (``async_commit=True``): the page files
    ride the aio queue and the index entry lands only at the next
    ``drain()`` — the engine drains at the following frame boundary, so
    boundary swap-outs overlap with the next frame instead of committing
    synchronously. A lookup drains first (blocking) only when a record it
    may read is queued, so a queued record is never invisible to it, and
    a probe of another uid leaves the queue to the boundary's drain
    (JAX's ``request_record`` and ``match_prefix`` drain the whole queue
    on every call, so an admission probe at the boundary of the eviction
    makes every commit blocking). ``stats`` counts overlapped vs blocking
    commits.
    """

    def __init__(self, swap_dir: str, aio_handle=None, shared: bool = False,
                 prefix_max_records: Optional[int] = 256):
        self.swapper = AsyncTensorSwapper(swap_dir, aio_handle)
        self.shared = shared
        self._lock = threading.RLock()
        self.prefix_max_records = prefix_max_records
        self._index_path = os.path.join(swap_dir, "kv_tier_index.json")
        self._index = {"requests": {}, "blocks": {}, "prefixes": {}}
        if os.path.exists(self._index_path):
            try:
                with open(self._index_path) as f:
                    self._index = json.load(f)
            except (OSError, ValueError):
                logger.warning(f"KVSwapTier: unreadable index at "
                               f"{self._index_path}; starting empty")
        self._index.setdefault("prefixes", {})
        self.stats = dict(requests_out=0, requests_in=0, blocks_out=0,
                          blocks_in=0, commits_overlapped=0,
                          commits_blocking=0, commit_failures=0,
                          prefix_records=0, prefix_hits=0)
        # async-committed records not yet in the index: (section, key, rec)
        self._pending: List[Tuple[str, str, Dict]] = []
        self._prefix_clock = max(
            (r.get("stamp", 0) for r in self._index["prefixes"].values()),
            default=0)
        # spilled prefix-BLOCK records reference in-memory entry ids, so
        # anything left by a previous process is unreachable by
        # construction — drop it now or a tmpfs tier leaks host RAM on
        # every crash/restart cycle. (Request records stay: they are the
        # crash-recovery payload; serve() prunes the non-resumed ones.
        # Prefix records stay too: they are content-addressed, so a
        # restarted fleet keeps its fleet-wide prefix share.)
        # One tier directory belongs to one engine (or one fleet) at a
        # time.
        for key in list(self._index["blocks"]):
            self.drop_block(key)

    # ---------------- async commit queue (overlapped swap-out) ----------

    @_locked
    def pending_commits(self) -> int:
        return len(self._pending)

    @_locked
    def drain(self, blocking: bool = True) -> int:
        """Commit every queued async record write: ONE ``swapper.wait``
        finalizes the page files, then the records enter the index with a
        single rewrite. ``blocking=False`` marks a frame-boundary drain
        (the writes overlapped with the previous frame); ``blocking=True``
        marks a forced drain (a lookup/restore needed the records NOW, or
        a synchronous put). On an aio error the swapper rolled every
        in-flight write back — the queued records are discarded (callers
        fall back to re-prefill) and the error re-raised."""
        if not self._pending:
            return 0
        pend, self._pending = self._pending, []
        try:
            self.swapper.wait()
        except Exception:
            self.stats["commit_failures"] += len(pend)
            raise
        for section, key, rec in pend:
            self._index[section][key] = rec
        self._save_index()
        self.stats["commits_blocking" if blocking
                   else "commits_overlapped"] += len(pend)
        return len(pend)

    def _drain_for_read(self) -> None:
        """Read paths must see queued records; a failed drain degrades to
        a miss (the records were rolled back anyway) instead of failing
        the lookup."""
        if not self._pending:
            return
        try:
            self.drain(blocking=True)
        except Exception as e:       # noqa: BLE001 — degrade to a miss
            logger.warning(f"KVSwapTier: async commit failed at lookup "
                           f"({type(e).__name__}: {e}); queued records "
                           "dropped")

    def _drain_if_queued(self, section: str, key: Optional[str] = None
                         ) -> None:
        """Drain for a lookup of ``section`` (of its ``key``, or of any
        key): only a queued record the lookup may read forces the drain."""
        if any(s == section and (key is None or k == key)
               for s, k, _ in self._pending):
            self._drain_for_read()

    def _stage(self, section: str, key: str, rec: Dict,
               async_commit: bool) -> None:
        self._pending = [(s, k, r) for (s, k, r) in self._pending
                         if not (s == section and k == key)]
        self._pending.append((section, key, rec))
        if not async_commit:
            self.drain(blocking=True)

    def _record(self, section: str, key: str) -> Optional[Dict]:
        """Committed-or-pending view of one record."""
        for s, k, r in reversed(self._pending):
            if s == section and k == key:
                return r
        return self._index[section].get(key)

    def _save_index(self) -> None:
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._index, f)
        os.replace(tmp, self._index_path)

    @staticmethod
    def _page_shape(kv, n: int) -> Tuple[int, ...]:
        # kv.lanes is the pool row width: head_dim, or head_dim + packed
        # scale lanes for int8 pools — tier records ship the quantized
        # representation verbatim, so the on-disk geometry follows it
        return (kv.num_layers, kv.kv_heads, n, kv.block_size, kv.lanes)

    @staticmethod
    def _pool_layout(kv) -> str:
        """Versioned page-row layout tag stored in every tier record.
        ``raw`` = plain dtype rows; ``int8_scale_lanes_v1`` = absmax int8
        values + bitcast f32 scale in trailing lanes
        (``kv_cache.quantize_kv_lanes``). Restores refuse records whose
        layout differs from the pool's — same-byte-width pools with
        different row semantics (or an f32-era record meeting a quantized
        pool) must fail loudly, never silently reinterpret scale bytes."""
        return "int8_scale_lanes_v1" if getattr(kv, "quantized", False) \
            else "raw"

    def _adopt(self, key: str, kv, n: int) -> None:
        """Register swapper metadata for a key written by a previous tier
        instance (crash recovery: the files survive, the in-memory swapper
        state does not)."""
        self.swapper.adopt(key, self._page_shape(kv, n),
                           dtype_name(kv.k.dtype))

    def _queue_out(self, prefix: str, kv, kp, vp, draft_kv=None,
                   dkp=None, dvp=None) -> Dict:
        """Queue one record's page writes (async) and build its index
        record — the single definition of the on-disk schema ``_restore``
        reads, shared by the per-record and batched spill paths. The
        caller owns the commit (``swapper.wait``)."""
        n = kp.shape[2]
        self.swapper.swap_out(f"{prefix}_k", kp, async_op=True)
        self.swapper.swap_out(f"{prefix}_v", vp, async_op=True)
        if draft_kv is not None:
            self.swapper.swap_out(f"{prefix}_dk", dkp, async_op=True)
            self.swapper.swap_out(f"{prefix}_dv", dvp, async_op=True)
        rec = {"blocks": n, "draft": draft_kv is not None,
               "dtype": dtype_name(kv.k.dtype),
               "layout": self._pool_layout(kv),
               "page_shape": list(self._page_shape(kv, n))}
        if draft_kv is not None:
            rec["draft_shape"] = list(self._page_shape(draft_kv, n))
        return rec

    def _read(self, kv, blocks: List[int], draft_kv=None):
        """One device gather + D2H per pool — after this, the payload is
        host memory and the device blocks may be freed regardless of when
        the (possibly async) file writes commit."""
        kp, vp = kv.read_pages(blocks)
        dkp = dvp = None
        if draft_kv is not None:
            dkp, dvp = draft_kv.read_pages(blocks)
        return kp, vp, dkp, dvp

    def _put(self, prefix: str, kv, blocks: List[int], draft_kv=None
             ) -> Dict:
        # a foreign pending batch must not share this wait(): an error
        # would roll BOTH back while the pending records stayed queued
        self._drain_for_read()
        kp, vp, dkp, dvp = self._read(kv, blocks, draft_kv)
        rec = self._queue_out(prefix, kv, kp, vp, draft_kv, dkp, dvp)
        self.swapper.wait()      # atomic commit; raises (and rolls back)
        return rec

    def _restore(self, prefix: str, rec: Dict, kv, dst_blocks: List[int],
                 draft_kv=None) -> None:
        if rec["dtype"] != dtype_name(kv.k.dtype):
            raise IOError(f"{prefix}: pages were swapped as {rec['dtype']} "
                          f"but the pool is {dtype_name(kv.k.dtype)}")
        # records from before the layout field are pre-quantization "raw"
        if rec.get("layout", "raw") != self._pool_layout(kv):
            raise IOError(
                f"{prefix}: pages were swapped with row layout "
                f"{rec.get('layout', 'raw')!r} but the pool expects "
                f"{self._pool_layout(kv)!r} (engine kv_dtype changed since "
                "the record was written)")
        n = rec["blocks"]
        if len(dst_blocks) != n:
            raise IOError(f"{prefix}: {n} pages recorded, "
                          f"{len(dst_blocks)} destination blocks")
        # geometry must match too: a same-dtype engine with a different
        # block size / layer count would otherwise SHORT-READ the old
        # file without an aio error and scatter misaligned payloads —
        # silent KV corruption instead of the loud swap_failed fallback
        if tuple(rec.get("page_shape", ())) != self._page_shape(kv, n):
            raise IOError(
                f"{prefix}: pages were swapped with geometry "
                f"{rec.get('page_shape')} but the pool expects "
                f"{self._page_shape(kv, n)}")
        if rec.get("draft") and draft_kv is not None and \
                tuple(rec.get("draft_shape", ())) != \
                self._page_shape(draft_kv, n):
            raise IOError(f"{prefix}: draft page geometry mismatch")
        self._adopt(f"{prefix}_k", kv, n)
        self._adopt(f"{prefix}_v", kv, n)
        kp = self.swapper.swap_in(f"{prefix}_k")
        vp = self.swapper.swap_in(f"{prefix}_v")
        kv.k, kv.v = kv.scatter_pages(kv.k, kv.v, dst_blocks, kp, vp)
        if rec.get("draft") and draft_kv is not None:
            self._adopt(f"{prefix}_dk", draft_kv, n)
            self._adopt(f"{prefix}_dv", draft_kv, n)
            dkp = self.swapper.swap_in(f"{prefix}_dk")
            dvp = self.swapper.swap_in(f"{prefix}_dv")
            draft_kv.k, draft_kv.v = draft_kv.scatter_pages(
                draft_kv.k, draft_kv.v, dst_blocks, dkp, dvp)

    def _drop(self, prefix: str, rec: Dict) -> None:
        # commit-or-discard any queued async batch FIRST: release() drains
        # the shared aio queue internally, so a foreign batch's write
        # error would otherwise surface out of an ordinary retirement's
        # drop (crashing serve) while the rolled-back files' records
        # stayed queued for a later (clean) drain to index dangling.
        # _drain_for_read keeps both sides consistent — records commit or
        # are discarded together with their files.
        self._drain_for_read()
        for suffix in ("_k", "_v") + (("_dk", "_dv") if rec.get("draft")
                                      else ()):
            try:
                self.swapper.release(prefix + suffix)
            except Exception as e:   # noqa: BLE001 — drop is best-effort
                logger.warning(f"KVSwapTier: releasing {prefix}{suffix} "
                               f"failed ({type(e).__name__}: {e})")

    # ---------------- request records (preemption / crash recovery) ----

    @staticmethod
    def _seg_prefix(uid: int, i: int) -> str:
        return f"kvreq_{uid}_s{i}"

    @_locked
    def put_request(self, uid: int, tokens: int, kv, blocks: List[int],
                    draft_kv=None, fingerprint: Optional[str] = None,
                    async_commit: bool = False) -> None:
        """Swap a victim's committed pages out as a fresh single-segment
        record. ``tokens`` is the committed watermark the pages cover and
        ``fingerprint`` the ``token_fingerprint`` of exactly those tokens —
        restore validates both, so a stale record (or a reused uid) can
        never restore pages under different content. ``async_commit``
        queues the page writes on the aio swapper and defers the commit
        to the next ``drain()`` — the engine drains at the following frame
        boundary, overlapping the write with the next frame."""
        if self._record("requests", str(uid)) is not None:
            self.drop_request(uid)      # uid re-put: release old segments
        kp, vp, dkp, dvp = self._read(kv, blocks, draft_kv)
        seg = self._queue_out(self._seg_prefix(uid, 0), kv, kp, vp,
                              draft_kv, dkp, dvp)
        rec = {"tokens": int(tokens), "fingerprint": fingerprint,
               "blocks": len(blocks), "segments": [seg]}
        self._stage("requests", str(uid), rec, async_commit)
        self.stats["requests_out"] += 1

    @_locked
    def publish_request_segment(self, uid: int, tokens: int,
                                fingerprint: Optional[str], kv,
                                new_blocks: List[int], draft_kv=None,
                                async_commit: bool = True,
                                start_block: Optional[int] = None) -> bool:
        """Append one segment of NEWLY-committed pages to ``uid``'s record
        (creating it at the first call) and advance its watermark to
        ``tokens`` — a boundary-incremental publish. Content below the
        watermark is final, so earlier segments are never rewritten; a
        writer killed mid-prompt leaves the partial watermark restorable
        from the tier.

        ``start_block`` is the caller's publish cursor (the block index
        this segment starts at): when it disagrees with the record's
        actual coverage — a failed drain dropped a queued segment, on
        THIS engine or a peer sharing the tier — the stale record is
        dropped and False returned, and the caller must republish from
        block zero. This enforces the ``blocks == blocks_for(tokens)``
        restore invariant structurally: a record can never claim a
        watermark its segments don't contiguously cover."""
        prev = self._record("requests", str(uid))
        if prev is not None and "segments" not in prev:
            # a legacy single-record entry (pre-segment index) cannot be
            # appended to — replace it outright
            self.drop_request(uid)
            prev = None
        have = prev["blocks"] if prev else 0
        if start_block is not None and start_block != have:
            self.drop_request(uid)
            logger.warning(
                f"KVSwapTier: uid={uid} publish cursor at block "
                f"{start_block} but the record covers {have} — a dropped "
                "commit desynced them; record dropped, republish from "
                "zero")
            return False
        segs = list(prev["segments"]) if prev else []
        kp, vp, dkp, dvp = self._read(kv, new_blocks, draft_kv)
        seg = self._queue_out(self._seg_prefix(uid, len(segs)), kv, kp, vp,
                              draft_kv, dkp, dvp)
        segs.append(seg)
        rec = {"tokens": int(tokens), "fingerprint": fingerprint,
               "blocks": have + len(new_blocks), "segments": segs}
        self._stage("requests", str(uid), rec, async_commit)
        self.stats["requests_out"] += 1
        return True

    @_locked
    def request_record(self, uid: int) -> Optional[Dict]:
        self._drain_if_queued("requests", str(uid))
        return self._index["requests"].get(str(uid))

    @_locked
    def restore_request(self, uid: int, kv, dst_blocks: List[int],
                        draft_kv=None) -> None:
        self._drain_for_read()
        rec = self._index["requests"][str(uid)]
        segs = rec.get("segments")
        if segs is None:                # legacy single-record schema
            self._restore(f"kvreq_{uid}", rec, kv, dst_blocks, draft_kv)
        else:
            if len(dst_blocks) != rec["blocks"]:
                raise IOError(
                    f"kvreq_{uid}: {rec['blocks']} pages recorded across "
                    f"{len(segs)} segments, {len(dst_blocks)} destination "
                    "blocks")
            off = 0
            for i, seg in enumerate(segs):
                n = seg["blocks"]
                self._restore(self._seg_prefix(uid, i), seg, kv,
                              dst_blocks[off:off + n], draft_kv)
                off += n
        self.stats["requests_in"] += 1

    @_locked
    def drop_request(self, uid: int) -> None:
        key = str(uid)
        pend = [r for (s, k, r) in self._pending
                if s == "requests" and k == key]
        self._pending = [(s, k, r) for (s, k, r) in self._pending
                         if not (s == "requests" and k == key)]
        rec = self._index["requests"].pop(key, None)
        rec = pend[-1] if pend else rec
        if rec is None:
            return
        segs = rec.get("segments")
        if segs is None:
            self._drop(f"kvreq_{uid}", rec)
        else:
            for i, seg in enumerate(segs):
                self._drop(self._seg_prefix(uid, i), seg)
        self._save_index()

    @_locked
    def prune_requests(self, keep_uids) -> int:
        """Drop request records for uids NOT in ``keep_uids`` (serve()
        start: records exist solely for swap-in re-admission, so a new
        run that will not resume a uid has abandoned its pages — without
        this, every crashed-and-not-resumed request leaks its pages in
        the tier forever). A SHARED tier never prunes: peer replicas'
        in-flight records look abandoned to any one engine, and the
        router owns the fleet-level record lifecycle instead."""
        if self.shared:
            return 0
        doomed = [u for u in list(self._index["requests"])
                  if int(u) not in keep_uids]
        for u in doomed:
            self.drop_request(int(u))
        return len(doomed)

    # ---------------- prefix records (fleet-wide prefix share) ----------

    @_locked
    def put_prefix(self, tokens: Sequence[int], kv, blocks: List[int],
                   draft_kv=None, async_commit: bool = True) -> bool:
        """Publish a CONTENT-ADDRESSED prefix record: pages covering
        ``tokens`` (a chunk-aligned prompt prefix, exactly
        ``len(tokens)`` of them), keyed by the token fingerprint so ANY
        engine sharing the tier can admit a matching prompt at the
        watermark. First publisher wins (identical content — a second
        copy would waste tier RAM); beyond ``prefix_max_records`` the
        stalest committed record is dropped (LRU by hit stamp). Returns
        whether a record was actually published."""
        fp = token_fingerprint(tokens)
        key = f"kvpfx_{fp}"
        if self._record("prefixes", key) is not None:
            return False
        kp, vp, dkp, dvp = self._read(kv, blocks, draft_kv)
        rec = self._queue_out(key, kv, kp, vp, draft_kv, dkp, dvp)
        rec["tokens"] = len(tokens)
        rec["fingerprint"] = fp
        self._prefix_clock += 1
        rec["stamp"] = self._prefix_clock
        if self.prefix_max_records is not None:
            live = self._index["prefixes"]
            while len(live) >= self.prefix_max_records:
                victim = min(live, key=lambda k: live[k].get("stamp", 0))
                self.drop_prefix(victim)
        self._stage("prefixes", key, rec, async_commit)
        self.stats["prefix_records"] += 1
        return True

    @_locked
    def match_prefix(self, tokens: Sequence[int], chunk: int,
                     max_probes: int = 64
                     ) -> Optional[Tuple[str, Dict]]:
        """Longest published chunk-aligned prefix of ``tokens``: probes
        fingerprints at descending chunk multiples (a hot identical
        prompt hits on the first probe), bounded by ``max_probes``.
        Returns ``(key, record)`` or None; a hit refreshes the record's
        LRU stamp."""
        self._drain_if_queued("prefixes")
        if not self._index["prefixes"]:
            return None
        toks = [int(t) for t in tokens]
        w = (len(toks) // chunk) * chunk
        probes = 0
        while w >= chunk and probes < max_probes:
            key = f"kvpfx_{token_fingerprint(toks[:w])}"
            rec = self._index["prefixes"].get(key)
            if rec is not None:
                self._prefix_clock += 1
                rec["stamp"] = self._prefix_clock
                self.stats["prefix_hits"] += 1
                return key, rec
            w -= chunk
            probes += 1
        return None

    @_locked
    def restore_prefix(self, key: str, kv, dst_blocks: List[int],
                       draft_kv=None) -> None:
        """Restore the FIRST ``len(dst_blocks)`` pages of a prefix record
        into freshly-allocated private blocks. The record is KEPT — it is
        shared, content-addressed, and reusable by every later admission
        (unlike request records, which are consumed by their restore)."""
        self._drain_for_read()
        rec = self._index["prefixes"][key]
        n = len(dst_blocks)
        if not 0 < n <= rec["blocks"]:
            raise IOError(f"{key}: {n} destination blocks vs "
                          f"{rec['blocks']} recorded pages")
        if rec["dtype"] != dtype_name(kv.k.dtype):
            raise IOError(f"{key}: pages were swapped as {rec['dtype']} "
                          f"but the pool is {dtype_name(kv.k.dtype)}")
        if rec.get("layout", "raw") != self._pool_layout(kv):
            raise IOError(
                f"{key}: pages were swapped with row layout "
                f"{rec.get('layout', 'raw')!r} but the pool expects "
                f"{self._pool_layout(kv)!r} (engine kv_dtype changed since "
                "the record was written)")
        if tuple(rec.get("page_shape", ())) != \
                self._page_shape(kv, rec["blocks"]):
            raise IOError(
                f"{key}: pages were swapped with geometry "
                f"{rec.get('page_shape')} but the pool expects "
                f"{self._page_shape(kv, rec['blocks'])}")
        self._adopt(f"{key}_k", kv, rec["blocks"])
        self._adopt(f"{key}_v", kv, rec["blocks"])
        kp = self.swapper.swap_in(f"{key}_k")[:, :, :n]
        vp = self.swapper.swap_in(f"{key}_v")[:, :, :n]
        kv.k, kv.v = kv.scatter_pages(kv.k, kv.v, dst_blocks, kp, vp)
        if rec.get("draft") and draft_kv is not None:
            if tuple(rec.get("draft_shape", ())) != \
                    self._page_shape(draft_kv, rec["blocks"]):
                raise IOError(f"{key}: draft page geometry mismatch")
            self._adopt(f"{key}_dk", draft_kv, rec["blocks"])
            self._adopt(f"{key}_dv", draft_kv, rec["blocks"])
            dkp = self.swapper.swap_in(f"{key}_dk")[:, :, :n]
            dvp = self.swapper.swap_in(f"{key}_dv")[:, :, :n]
            draft_kv.k, draft_kv.v = draft_kv.scatter_pages(
                draft_kv.k, draft_kv.v, dst_blocks, dkp, dvp)
        self.stats["blocks_in"] += n

    @_locked
    def drop_prefix(self, key: str) -> None:
        self._pending = [(s, k, r) for (s, k, r) in self._pending
                         if not (s == "prefixes" and k == key)]
        rec = self._index["prefixes"].pop(key, None)
        if rec is None:
            return
        self._drop(key, rec)
        self._save_index()

    # ---------------- block records (prefix-cache spill) ----------------

    @_locked
    def put_block(self, key: str, kv, block: int, draft_kv=None) -> None:
        self._index["blocks"][key] = self._put(key, kv, [block],
                                               draft_kv=draft_kv)
        self._save_index()
        self.stats["blocks_out"] += 1

    @_locked
    def put_blocks(self, keys: List[str], kv, blocks: List[int],
                   draft_kv=None) -> None:
        """Batched prefix-block spill (``PrefixCache.reclaim`` under
        pressure): ONE device gather over the whole block list
        (``read_pages`` already takes lists — the per-block path paid a
        gather, a committed write pair, and a full index rewrite PER
        block), all page writes queued async and committed by a SINGLE
        ``wait``, and ONE index rewrite at the end. Failure semantics
        match ``put_block``: an aio error rolls every in-flight write back
        (atomic batch) and nothing enters the index."""
        assert len(keys) == len(blocks)
        if not keys:
            return
        # a foreign pending batch must not share this wait() (see _put)
        self._drain_for_read()
        kp, vp = kv.read_pages(blocks)       # one gather + D2H per pool
        dkp = dvp = None
        if draft_kv is not None:
            dkp, dvp = draft_kv.read_pages(blocks)
        recs: Dict[str, Dict] = {}
        for i, key in enumerate(keys):
            recs[key] = self._queue_out(
                key, kv, kp[:, :, i:i + 1], vp[:, :, i:i + 1], draft_kv,
                None if dkp is None else dkp[:, :, i:i + 1],
                None if dvp is None else dvp[:, :, i:i + 1])
        self.swapper.wait()                  # single atomic batch commit
        self._index["blocks"].update(recs)
        self._save_index()                   # one index rewrite
        self.stats["blocks_out"] += len(keys)

    @_locked
    def restore_block(self, key: str, kv, dst_block: int,
                      draft_kv=None) -> None:
        # pop the record only AFTER a successful restore: a failed read
        # must leave it in place so the caller's drop_block can still
        # release the page files (popping first would leak them)
        self._drain_for_read()
        rec = self._index["blocks"][str(key)]
        self._restore(key, rec, kv, [dst_block], draft_kv=draft_kv)
        self._index["blocks"].pop(str(key), None)
        self._drop(key, rec)
        self._save_index()
        self.stats["blocks_in"] += 1

    @_locked
    def drop_block(self, key: str) -> None:
        rec = self._index["blocks"].pop(str(key), None)
        if rec is None:
            return
        self._drop(key, rec)
        self._save_index()
