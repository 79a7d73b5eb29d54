"""Speculative decoding: drafter, exact greedy acceptance, adaptive k.

The port's own copy of ``dpu_operator_tpu/workloads/spec.py``, line for
line in its logic. A cheap drafter proposes k tokens per sequence, the
batched verify pass (:func:`~dpu_operator_tpu_torch.workloads.decode.verify_step`)
scores all k+1 positions in one iteration, and the exact greedy
acceptance rule keeps the emitted stream identical to running
``generate()`` token by token: speculation changes how many tokens an
iteration emits, never which tokens.

The default drafter is prompt lookup (n-gram): match the context's own
suffix against its history and propose what followed. Everything here is
pure Python over token ids, so seeded virtual-clock runs replay
bit-identically with speculation on.
"""

from __future__ import annotations

from typing import Protocol, Sequence


class Drafter(Protocol):
    """The drafter seam: propose up to *k* continuation tokens for a
    request whose context (prompt + generated tokens so far) is *ids*.
    Returning fewer than k, or none, shrinks that row's speculation."""

    def propose(self, ids: Sequence[int], k: int) -> list: ...


class NgramDrafter:
    """Prompt-lookup drafting: the most recent earlier occurrence of the
    context's trailing n-gram, longest n-gram first, and the tokens that
    followed it. Stateless, so one drafter serves every request."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1) -> None:
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, ids: Sequence[int], k: int) -> list:
        ids = list(ids)
        n = len(ids)
        if k <= 0 or n < self.min_ngram + 1:
            return []
        for ng in range(min(self.max_ngram, n - 1),
                        self.min_ngram - 1, -1):
            pattern = ids[n - ng:]
            # right to left over earlier occurrences: the most recent
            # match first (start < n - ng, so a continuation exists)
            for start in range(n - ng - 1, -1, -1):
                if ids[start:start + ng] == pattern:
                    cont = ids[start + ng:start + ng + k]
                    if cont:
                        return cont
                    break  # a suffix-adjacent match has no continuation
        return []


def greedy_accept(drafts: Sequence[int],
                  argmaxes: Sequence[int]) -> tuple:
    """The exact greedy acceptance rule. ``argmaxes[i]`` is the token
    greedy decoding would emit after position i's context, so
    ``len(argmaxes) == len(drafts) + 1``. Drafts are accepted left to
    right while ``drafts[i] == argmaxes[i]``; the first mismatch emits
    the model's own token (the correction), and when every draft
    survives ``argmaxes[k]`` is emitted (the bonus). Returns
    ``(accepted, emitted)`` with ``accepted + 1`` emitted tokens; with no
    drafts this is plain greedy decode."""
    if len(argmaxes) != len(drafts) + 1:
        raise ValueError(
            f"need {len(drafts) + 1} argmax positions for "
            f"{len(drafts)} drafts, got {len(argmaxes)}")
    accepted = 0
    emitted: list[int] = []
    for d, true_tok in zip(drafts, argmaxes):
        if int(d) != int(true_tok):
            break
        emitted.append(int(d))
        accepted += 1
    emitted.append(int(argmaxes[accepted]))
    return accepted, emitted


class AdaptiveK:
    """Per-iteration draft length: an EWMA of the per-draft acceptance
    rate a prices k drafts at ``1 + sum_{i=1..k} a^i`` expected tokens
    for ``cost.verify_s(batch, k)`` modelled seconds, against plain
    decode (k = 0) at ``cost.decode_s(batch)``; the k with the most
    expected tokens per second wins, ties to the smaller k."""

    def __init__(self, k_max: int, init_rate: float = 0.5,
                 ewma: float = 0.3) -> None:
        if k_max < 0:
            raise ValueError("k_max must be >= 0")
        self.k_max = k_max
        self.rate = min(max(init_rate, 0.0), 1.0)
        self.ewma = ewma
        #: lifetime accounting
        self.proposed_total = 0
        self.accepted_total = 0

    def observe(self, proposed: int, accepted: int) -> None:
        """Fold one row's draft outcome into the EWMA."""
        if proposed <= 0:
            return
        self.proposed_total += proposed
        self.accepted_total += accepted
        obs = accepted / proposed
        self.rate += self.ewma * (obs - self.rate)

    def acceptance_rate(self) -> float:
        """Lifetime accepted / proposed, 0.0 before any proposal."""
        if not self.proposed_total:
            return 0.0
        return self.accepted_total / self.proposed_total

    def expected_tokens(self, k: int) -> float:
        """Expected emitted tokens for k drafts at the current rate."""
        a = self.rate
        total, p = 1.0, 1.0
        for _ in range(k):
            p *= a
            total += p
        return total

    def choose(self, cost: object, batch: int) -> int:
        """The k in [0, k_max] maximizing expected tokens per second under
        *cost* (``decode_s`` and ``verify_s``); plain decode is the
        baseline a speculation must beat."""
        if self.k_max <= 0 or batch <= 0:
            return 0
        best_k = 0
        best = 1.0 / max(cost.decode_s(batch), 1e-12)
        for k in range(1, self.k_max + 1):
            rate = (self.expected_tokens(k)
                    / max(cost.verify_s(batch, k), 1e-12))
            if rate > best:
                best, best_k = rate, k
        return best_k
