"""Block accounting for the KV cache of the continuous-batching scheduler.

The port's own copy of the allocation accounting of
``dpu_operator_tpu/workloads/kv_pool.py::KvBlockPool``: a request holds
fixed-size blocks of ``block_size`` token slots from admission to
completion, and freed blocks are reusable at once. The free list is kept
sorted and hands out the lowest id first, so a seeded run allocates the
same blocks every time. Prefix sharing, copy-on-write, speculative
rollback and the metrics gauges are not ported yet. Pure accounting: the
slot executor's dense cache holds the data.
"""

from __future__ import annotations

import threading
from typing import Optional


class KvBlockPool:
    """*num_blocks* blocks of *block_size* token slots, with per-owner
    accounting. Owners are request ids. Thread-safe."""

    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._lock = threading.Lock()
        self._free: list[int] = list(range(num_blocks))
        self._owned: dict[str, list[int]] = {}
        #: token slots holding real KV rows, per owner
        self._used_tokens: dict[str, int] = {}

    def blocks_for_tokens(self, tokens: int) -> int:
        """Blocks needed to hold *tokens* token slots (ceil)."""
        return max(0, -(-int(tokens) // self.block_size))

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

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
            self._owned.setdefault(owner, []).extend(taken)
            self._used_tokens.setdefault(owner, 0)
            return taken

    def set_used_tokens(self, owner: str, tokens: int) -> None:
        """Record how many of *owner*'s slots hold real KV rows (capped at
        its allocation)."""
        with self._lock:
            if owner not in self._owned:
                raise KeyError(f"unknown owner {owner!r}")
            cap = len(self._owned[owner]) * self.block_size
            self._used_tokens[owner] = min(int(tokens), cap)

    def free(self, owner: str) -> int:
        """Return every block *owner* holds; freeing an unknown owner is a
        no-op. Returns the number of blocks freed."""
        with self._lock:
            blocks = self._owned.pop(owner, None)
            self._used_tokens.pop(owner, None)
            if not blocks:
                return 0
            self._free.extend(blocks)
            self._free.sort()
            return len(blocks)

    def outstanding(self) -> int:
        """Blocks currently allocated: 0 once every request is done."""
        with self._lock:
            return self.num_blocks - len(self._free)
