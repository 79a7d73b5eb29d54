"""Block accounting for the KV cache of the continuous-batching scheduler.

The port's own copy of ``dpu_operator_tpu/workloads/kv_pool.py``: a
request holds fixed-size blocks of ``block_size`` token slots from
admission to completion, and freed blocks are reusable at once. The free
list is kept sorted and hands out the lowest id first, so a seeded run
allocates the same blocks every time.

**Prefix sharing (copy-on-write).** With ``sharing=True`` the pool keeps a
content-addressed index over allocated blocks, each block of a prompt
keyed by the rolling hash of everything up to and including it
(:func:`chain_keys`), so requests with a common prompt prefix map the same
blocks, refcounted:

- blocks are published only once their content is real
  (:meth:`register_prefix`, after the owner's prefill);
- :meth:`map_prefix` hands a later request the longest indexed chain;
- a write into a block with refcount > 1 copies it first
  (:meth:`write_token`), once per divergence; a write inside the covered
  slots of a published block with refcount 1 unpublishes it;
- :meth:`rollback_tokens` moves the written frontier back past rejected
  speculation, accounting only: blocks and fired copies stay;
- :meth:`free` returns a block to the free list only at refcount zero.

Pure accounting: the executor's cache holds the data. The pool keeps the
reference's gauges (``tpu_serve_kv_blocks{state}``,
``tpu_kv_shared_blocks``, ``tpu_serve_kv_internal_fragmentation``) and
counters (``tpu_kv_cow_copies_total``, ``tpu_kv_prefix_block_hits_total``)
current on every mutation, and :meth:`KvBlockPool.snapshot` is the
``kv`` block of ``/debug/serve``. The gauges are kept by counters, shared
blocks and written slots, that each mutation updates for only the blocks
it touches (a decode token moves its owner's frontier through one block),
so no update walks the owners or the blocks. Each gauge update still runs
under a ``kv_pool.gauges`` profiler range and adds its seconds to
:attr:`KvBlockPool.gauge_s`, the running cost of that upkeep, which the
scheduler's ledger reads an iteration at a time.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from ..utils import metrics, tracing

#: 61-bit Mersenne prime, the rolling-hash modulus (no PYTHONHASHSEED
#: dependence)
_HASH_MOD = (1 << 61) - 1
_HASH_MUL = 1_000_003


def _fold(h: int, values: Sequence[int]) -> int:
    for v in values:
        h = (h * _HASH_MUL + int(v) + 1) % _HASH_MOD
    return h


def chain_keys(tokens: Sequence[int], block_size: int) -> list:
    """Content keys for the blocks of *tokens*: ``key[i]`` hashes every
    token through block *i*, so a block matches only when its whole
    prefix matches too. A final partial block's key also folds in its
    length, so it matches only a tail of the same content and length."""
    keys: list[int] = []
    h = 0
    n = len(tokens)
    for start in range(0, n, block_size):
        block = tokens[start:start + block_size]
        h = _fold(h, block)
        if len(block) < block_size:
            h = _fold(h, (-1, len(block)))
        keys.append(h)
    return keys


class KvPoolExhausted(Exception):
    """The pool cannot satisfy an allocation (schedulers normally probe
    with :meth:`KvBlockPool.can_alloc` and preempt instead)."""


class KvBlockPool:
    """*num_blocks* blocks of *block_size* token slots, with per-owner
    accounting and optional refcounted prefix sharing. Owners are request
    ids. Thread-safe."""

    def __init__(self, num_blocks: int, block_size: int,
                 sharing: bool = False) -> None:
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.sharing = sharing
        self._lock = threading.Lock()
        self._free: list[int] = list(range(num_blocks))
        self._owned: dict[str, list[int]] = {}
        #: token slots holding real KV rows, per owner
        self._used_tokens: dict[str, int] = {}
        #: block id -> refcount (allocated blocks only; shared >= 2)
        self._refs: dict[int, int] = {}
        #: prefix index: chain key -> block id, and block id -> (key,
        #: token slots the key covers)
        self._index: dict[int, int] = {}
        self._block_key: dict[int, tuple] = {}
        #: allocated blocks with refcount >= 2
        self._shared = 0
        #: block id -> {owner: slots of the block that owner has written},
        #: nonzero only; a block's written slots are its owners' largest
        #: (mappers' content is the same in the shared region)
        self._cover: dict[int, dict[str, int]] = {}
        #: written slots summed over blocks, a block counted once
        self._written = 0
        #: lifetime counters
        self.cow_copies = 0
        self.prefix_block_hits = 0
        self.spec_rollback_tokens = 0
        #: running seconds (perf_counter) of the gauge updates
        self.gauge_s = 0.0
        self._update_gauges_locked()

    def blocks_for_tokens(self, tokens: int) -> int:
        """Blocks needed to hold *tokens* token slots (ceil)."""
        return max(0, -(-int(tokens) // self.block_size))

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def used_blocks(self) -> int:
        with self._lock:
            return self.num_blocks - len(self._free)

    def occupancy(self) -> float:
        """Fraction of the pool physically allocated, a shared block
        counted once (0.0 once every request is done)."""
        with self._lock:
            return (self.num_blocks - len(self._free)) / self.num_blocks

    def logical_blocks(self) -> int:
        """Blocks summed over owners (a block mapped by three requests
        counts three times): the occupancy without sharing."""
        with self._lock:
            return sum(len(b) for b in self._owned.values())

    def shared_blocks(self) -> int:
        """Physical blocks referenced by two owners or more."""
        with self._lock:
            return self._shared

    def _cover_locked(self, block: int, owner: str, slots: int) -> None:
        """Set *owner*'s written slots in *block*, keeping ``_written``."""
        covers = self._cover.setdefault(block, {})
        self._written -= max(covers.values(), default=0)
        if slots > 0:
            covers[owner] = slots
        else:
            covers.pop(owner, None)
        self._written += max(covers.values(), default=0)
        if not covers:
            del self._cover[block]

    def _move_frontier_locked(self, owner: str, old: int, new: int) -> None:
        """Re-cover the blocks of *owner* between its written frontier
        *old* and *new*: the only blocks whose coverage the move changes."""
        blocks = self._owned[owner]
        bs = self.block_size
        lo, hi = max(0, min(old, new)), max(old, new)
        for i in range(lo // bs, -(-hi // bs)):
            self._cover_locked(blocks[i], owner, min(max(new - i * bs, 0), bs))

    def _fragmentation_locked(self) -> float:
        allocated = (self.num_blocks - len(self._free)) * self.block_size
        if allocated == 0:
            return 0.0
        return max(0.0, (allocated - self._written) / allocated)

    def internal_fragmentation(self) -> float:
        """Fraction of allocated token slots not yet written (0.0 when
        nothing is allocated)."""
        with self._lock:
            return self._fragmentation_locked()

    def prefix_index_keys(self) -> int:
        """Chain keys published in the prefix index: how much reusable
        prefix KV this replica holds (the headroom digest's affinity
        signal)."""
        with self._lock:
            return len(self._index)

    def owners(self) -> list[str]:
        with self._lock:
            return sorted(self._owned)

    def can_alloc(self, n_blocks: int) -> bool:
        with self._lock:
            return len(self._free) >= n_blocks

    def blocks_of(self, owner: str) -> list[int]:
        with self._lock:
            return list(self._owned.get(owner, ()))

    def alloc(self, owner: str, n_blocks: int) -> Optional[list[int]]:
        """Append *n_blocks* to *owner*'s allocation; None when the pool
        cannot satisfy it (nothing is taken then)."""
        if n_blocks < 0:
            raise ValueError("n_blocks must be >= 0")
        with self._lock:
            if len(self._free) < n_blocks:
                return None
            taken = self._free[:n_blocks]
            del self._free[:n_blocks]
            for b in taken:
                self._refs[b] = 1
            self._owned.setdefault(owner, []).extend(taken)
            self._used_tokens.setdefault(owner, 0)
            self._update_gauges_locked()
            return taken

    # -- prefix sharing -------------------------------------------------------
    def probe_prefix(self, keys: Sequence[int]) -> int:
        """How many leading blocks of *keys* the index could map now."""
        if not self.sharing:
            return 0
        with self._lock:
            return self._match_len_locked(keys)

    def _match_len_locked(self, keys: Sequence[int]) -> int:
        n = 0
        for key in keys:
            if key not in self._index:
                break
            n += 1
        return n

    def map_prefix(self, owner: str, keys: Sequence[int]) -> int:
        """Map the longest indexed chain of *keys* as *owner*'s first
        blocks (call before :meth:`alloc`), bumping each refcount; returns
        the number of blocks mapped."""
        if not self.sharing or not keys:
            return 0
        with self._lock:
            if self._owned.get(owner):
                raise ValueError(
                    f"map_prefix must precede alloc for {owner!r}")
            n = self._match_len_locked(keys)
            if n == 0:
                return 0
            blocks = [self._index[k] for k in keys[:n]]
            for b in blocks:
                self._refs[b] += 1
                if self._refs[b] == 2:
                    self._shared += 1
            self._owned.setdefault(owner, []).extend(blocks)
            self._used_tokens.setdefault(owner, 0)
            self.prefix_block_hits += n
            metrics.KV_PREFIX_BLOCK_HITS.inc(n)
            self._update_gauges_locked()
            return n

    def register_prefix(self, owner: str, keys: Sequence[int],
                        covered_tokens: int) -> int:
        """Publish *owner*'s leading blocks under *keys* (block i under
        key i) once its prefill has written them. *covered_tokens* (the
        prompt length) is how many slots the keys describe: writes past a
        key's coverage leave it valid. Keys already indexed, or blocks
        already published, are skipped; returns the number published."""
        if not self.sharing or not keys:
            return 0
        with self._lock:
            owned = self._owned.get(owner, ())
            published = 0
            for i, key in enumerate(keys):
                if i >= len(owned):
                    break
                block = owned[i]
                if key in self._index or block in self._block_key:
                    continue
                covered = min(self.block_size,
                              int(covered_tokens) - i * self.block_size)
                if covered <= 0:
                    break
                self._index[key] = block
                self._block_key[block] = (key, covered)
                published += 1
            self._update_gauges_locked()
            return published

    def write_token(self, owner: str, pos: int) -> Optional[bool]:
        """Account one token write at sequence position *pos*. Into a
        shared block (refcount > 1) it copies: a fresh block replaces it
        in the owner's map and True is returned (None when the pool has no
        block for the copy). Into an exclusive published block, inside
        the key's covered slots, it unpublishes the block. False on every
        write that does not copy."""
        with self._lock:
            owned = self._owned.get(owner)
            if owned is None:
                raise KeyError(f"unknown owner {owner!r}")
            b_idx = int(pos) // self.block_size
            if b_idx >= len(owned):
                raise IndexError(
                    f"{owner!r} writing pos {pos} past its "
                    f"{len(owned)}-block reservation")
            block = owned[b_idx]
            if self._refs[block] > 1:
                if not self._free:
                    return None
                fresh = self._free.pop(0)
                self._refs[fresh] = 1
                self._refs[block] -= 1
                if self._refs[block] == 1:
                    self._shared -= 1
                owned[b_idx] = fresh
                slots = self._cover.get(block, {}).get(owner, 0)
                if slots:
                    self._cover_locked(block, owner, 0)
                    self._cover_locked(fresh, owner, slots)
                self.cow_copies += 1
                metrics.KV_COW_COPIES.inc()
                self._update_gauges_locked()
                return True
            entry = self._block_key.get(block)
            if entry is not None and int(pos) % self.block_size \
                    < entry[1]:
                del self._block_key[block]
                self._index.pop(entry[0], None)
            return False

    def set_used_tokens(self, owner: str, tokens: int) -> None:
        """Record how many of *owner*'s slots hold real KV rows (capped at
        its allocation)."""
        with self._lock:
            if owner not in self._owned:
                raise KeyError(f"unknown owner {owner!r}")
            cap = len(self._owned[owner]) * self.block_size
            new = min(int(tokens), cap)
            self._move_frontier_locked(owner, self._used_tokens[owner], new)
            self._used_tokens[owner] = new
            self._update_gauges_locked()

    def rollback_tokens(self, owner: str, tokens: int) -> int:
        """Move *owner*'s written frontier back to *tokens* after rejected
        speculation. Accounting only: the blocks stay allocated (the next
        accepted tokens rewrite the same slots) and a copy-on-write that
        fired for a speculated write is not undone. A *tokens* at or above
        the frontier is a no-op. Returns the slots rolled back."""
        with self._lock:
            if owner not in self._owned:
                raise KeyError(f"unknown owner {owner!r}")
            if tokens < 0:
                raise ValueError("tokens must be >= 0")
            cur = self._used_tokens.get(owner, 0)
            new = min(cur, int(tokens))
            rolled = cur - new
            if rolled:
                self._move_frontier_locked(owner, cur, new)
                self._used_tokens[owner] = new
                self.spec_rollback_tokens += rolled
                self._update_gauges_locked()
            return rolled

    def free(self, owner: str) -> int:
        """Drop every block *owner* holds: each refcount falls by one and a
        block returns to the free list (and leaves the index) only at zero.
        Freeing an unknown owner is a no-op. Returns the blocks released."""
        with self._lock:
            blocks = self._owned.pop(owner, None)
            used = self._used_tokens.pop(owner, 0)
            if not blocks:
                self._update_gauges_locked()
                return 0
            for b in blocks[:self.blocks_for_tokens(used)]:
                self._cover_locked(b, owner, 0)
            released = []
            for b in blocks:
                refs = self._refs[b] - 1
                if refs < 0:
                    raise AssertionError(
                        f"block {b} refcount went negative")
                if refs == 1:
                    self._shared -= 1
                if refs == 0:
                    del self._refs[b]
                    entry = self._block_key.pop(b, None)
                    if entry is not None:
                        self._index.pop(entry[0], None)
                    released.append(b)
                else:
                    self._refs[b] = refs
            if released:
                self._free.extend(released)
                self._free.sort()
            self._update_gauges_locked()
            return len(released)

    def outstanding(self) -> int:
        """Blocks currently allocated (a block mapped N times counts
        once): 0 once every request is done."""
        with self._lock:
            return self.num_blocks - len(self._free)

    def _update_gauges_locked(self) -> None:
        t0 = time.perf_counter()
        with tracing.profiled("kv_pool.gauges"):
            used = self.num_blocks - len(self._free)
            metrics.SERVE_KV_BLOCKS.set(float(len(self._free)), state="free")
            metrics.SERVE_KV_BLOCKS.set(float(used), state="used")
            metrics.KV_SHARED_BLOCKS.set(float(self._shared))
            metrics.SERVE_KV_FRAGMENTATION.set(self._fragmentation_locked())
        self.gauge_s += time.perf_counter() - t0

    def snapshot(self) -> dict:
        """The ``kv`` block of ``/debug/serve``."""
        with self._lock:
            used = self.num_blocks - len(self._free)
            return {
                "numBlocks": self.num_blocks,
                "blockSize": self.block_size,
                "freeBlocks": len(self._free),
                "usedBlocks": used,
                "occupancy": round(used / self.num_blocks, 4),
                "internalFragmentation": round(
                    self._fragmentation_locked(), 4),
                "owners": len(self._owned),
                "sharing": self.sharing,
                "sharedBlocks": self._shared,
                "logicalBlocks": sum(len(b)
                                     for b in self._owned.values()),
                "cowCopies": self.cow_copies,
                "prefixBlockHits": self.prefix_block_hits,
                "prefixIndexKeys": len(self._index),
                "specRollbackTokens": self.spec_rollback_tokens,
            }
