"""Speculative-decoding primitives: the host half.

Host-pure copy of the server-side functions of
``deepspeed_tpu/inference/speculation.py``: prompt-lookup proposals
(:func:`lookup_proposals_host` :104, :class:`LookupIndex` :131) and greedy
acceptance (:func:`greedy_accept_host` :200). The paged server schedules on
the host, so acceptance is plain Python over the verify forward's argmaxes.
The in-graph versions belong to the one-shot engine's speculative loops and
``draft_propose`` to draft-model speculation, both later slices (ROADMAP.md
queue C).

Prompt-lookup proposals (draft-model-free speculation): the candidate
continuation is whatever followed the most recent earlier occurrence of
the current BIGRAM in the sequence's own prompt+generated history. Greedy
acceptance keeps the output exactly greedy — the proposals can only change
how many target forwards run, never what they commit.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple


def lookup_proposals_host(history: Sequence[int], k: int) -> List[int]:
    """Prompt-lookup proposals for ONE sequence (the JAX package's
    in-graph ``lookup_proposals`` rule) over a plain token list that ends
    with the pending token. Returns ``k`` proposed tokens, padded with the
    pending token where the lookup has nothing better."""
    n = len(history)
    cur = int(history[-1])
    out = [cur] * k
    if n < 2:
        return out
    b0, b1 = int(history[-2]), int(history[-1])
    jstar = -1
    for j in range(n - 3, -1, -1):      # latest j with j < n-2
        if history[j] == b0 and history[j + 1] == b1:
            jstar = j
            break
    if jstar < 0:
        return out
    for i in range(k):
        idx = jstar + 2 + i
        if idx < n:
            out[i] = int(history[idx])
    return out


class LookupIndex:
    """Incremental prompt-lookup state for ONE sequence: the same
    latest-bigram-match rule as :func:`lookup_proposals_host`, without
    rescanning the whole history every step. ``extend`` registers each
    new committed token in O(1) (the pair ending at the previous tail
    becomes matchable once a newer token arrives — exactly the
    ``j < n-2`` exclusion of the query bigram itself); ``proposals`` is
    a dict lookup plus a K-token slice. The serving hot path calls this
    once per active slot per verify step, so proposal cost stays flat
    as contexts grow instead of O(prompt+generated) per step.

    Equivalent to the rescan of :func:`lookup_proposals_host`."""

    __slots__ = ("hist", "_latest")

    def __init__(self, history: Sequence[int] = ()):
        self.hist: List[int] = []
        self._latest = {}          # (tok_j, tok_j+1) -> latest j <= n-3
        self.extend(history)

    def extend(self, tokens: Sequence[int]) -> None:
        hist = self.hist
        for t in tokens:
            n = len(hist)
            if n >= 2:
                # the pair ending at the old tail (j = n-2) is now
                # strictly before the new query bigram — index it;
                # later occurrences overwrite, keeping "latest j"
                self._latest[(hist[n - 2], hist[n - 1])] = n - 2
            hist.append(int(t))

    def proposals(self, k: int) -> List[int]:
        hist = self.hist
        cur = int(hist[-1])
        out = [cur] * k
        if len(hist) < 2:
            return out
        j = self._latest.get((hist[-2], hist[-1]))
        if j is None:
            return out
        for i in range(k):
            idx = j + 2 + i
            if idx < len(hist):
                out[i] = hist[idx]
        return out


def greedy_accept_host(t_row: Sequence[int], props: Sequence[int]
                       ) -> Tuple[int, List[int]]:
    """Greedy acceptance for ONE row (the JAX package's in-graph
    ``greedy_accept`` rule): ``t_row`` is the verify forward's K argmax
    tokens, ``props`` the K-1 proposals. Returns ``(m, committed)`` — the number of accepted proposals and
    the committed block ``[p_1..p_m, correction]`` (1..K tokens)."""
    m = 0
    while m < len(props) and int(props[m]) == int(t_row[m]):
        m += 1
    return m, [int(p) for p in props[:m]] + [int(t_row[m])]
