"""Speculative-decoding primitives.

Counterpart of ``deepspeed_tpu/inference/speculation.py``: one home for the
proposal and verify→commit bookkeeping of both speculative paths, the
one-shot engine's loops (``InferenceEngine.generate_speculative``) and the
paged server's per-slot rounds, so the two cannot drift.

* On tensors, for the engine's loops: :func:`greedy_accept` (:30),
  :func:`commit_speculative_block` (:50), :func:`lookup_proposals` (:75)
  and :func:`draft_propose` (:179). JAX runs them inside one
  ``lax.while_loop``; here they are torch ops on the device, and none of
  them reads a device value on the host.
* On the host, for the server, which schedules there: prompt-lookup
  proposals (:func:`lookup_proposals_host` :104, :class:`LookupIndex` :131)
  and greedy acceptance (:func:`greedy_accept_host` :200), plain Python
  over the verify forward's argmaxes.

Prompt-lookup proposals (draft-model-free speculation): the candidate
continuation is whatever followed the most recent earlier occurrence of
the current BIGRAM in the sequence's own prompt+generated history. Greedy
acceptance keeps the output exactly greedy — the proposals can only change
how many target forwards run, never what they commit.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def greedy_accept(t_toks: torch.Tensor, props: torch.Tensor, K: int):
    """Greedy acceptance: the longest prefix of ``props [B, K-1]`` that
    agrees with the target's argmax ``t_toks [B, K]``. Returns ``(m,
    correction, committed)``: ``m [B]`` the number of accepted proposals
    (the first mismatch), ``correction [B, 1]`` the target's token there,
    and ``committed [B, K]`` the block ``[p_1..p_m, correction, ...]``."""
    B = t_toks.shape[0]
    miss = torch.cat([props != t_toks[:, :K - 1],
                      torch.ones((B, 1), dtype=torch.bool,
                                 device=t_toks.device)], 1)
    m = torch.argmax(miss.int(), 1)        # first mismatch = #accepted
    correction = torch.gather(t_toks, 1, m[:, None])
    iota = torch.arange(K, device=t_toks.device)[None, :]
    props_pad = torch.cat([props, props[:, -1:]], 1)
    committed = torch.where(iota < m[:, None], props_pad, correction)
    return m, correction, committed


def commit_speculative_block(committed, m, done, n_gen, out, eos: int,
                             K: int, max_new_tokens: int):
    """The verify→commit bookkeeping of a speculative round: scatter the
    accepted block into the ``out`` buffer (tokens after an in-block EOS
    are not output), track EOS and budget, and compute each row's context
    advance. Returns ``(out, n_gen, done, adv, active)``; ``out`` is
    written in place, ``adv`` is how many tokens each row's caches and
    history gain this round."""
    B = committed.shape[0]
    dev = committed.device
    iota = torch.arange(K, device=dev)[None, :]
    active = ~done
    commit_mask = (iota <= m[:, None]) & active[:, None]
    is_eos = (committed == eos) & commit_mask
    after_eos = (torch.cumsum(is_eos.int(), 1) - is_eos.int()) > 0
    emit = commit_mask & ~after_eos
    rows = torch.arange(B, device=dev)[:, None]
    cols = (n_gen[:, None].long() + iota).clamp(0, max_new_tokens + K - 1)
    out[rows, cols] = torch.where(emit, committed.to(out.dtype),
                                  out[rows, cols])
    n_gen = n_gen + emit.int().sum(1).to(n_gen.dtype)
    done = done | is_eos.any(1) | (n_gen >= max_new_tokens)
    adv = torch.where(active, m + 1, torch.zeros_like(m))
    return out, n_gen, done, adv, active


def lookup_proposals(hist: torch.Tensor, hlen: torch.Tensor,
                     cur: torch.Tensor, K: int) -> torch.Tensor:
    """Prompt-lookup proposals on the device: for each row, the latest
    ``j < hlen-2`` with ``hist[j:j+2]`` equal to the current bigram (the
    two most recent history tokens, ``cur`` included), and the ``K-1``
    tokens that followed it. Rows with no match (or fewer than two tokens
    of history) propose ``cur`` repeated, a worst case the verify forward
    simply rejects.

    ``hist [B, S]`` is the padded history with ``hlen [B]`` live tokens;
    ``cur [B]`` is the pending token (``hist[b, hlen[b]-1]``). Returns
    ``props [B, K-1]``."""
    B, S = hist.shape
    dev = hist.device
    ar = torch.arange(B, device=dev)
    hlen = hlen.long()
    b0 = hist[ar, (hlen - 2).clamp_min(0)]
    b1 = hist[ar, hlen - 1]
    pos = torch.arange(S, device=dev)[None, :]
    nxt = torch.roll(hist, -1, dims=1)
    match = ((hist == b0[:, None]) & (nxt == b1[:, None])
             & (pos < (hlen - 2)[:, None]) & (hlen >= 2)[:, None])
    found = match.any(1)
    jstar = torch.where(match, pos, torch.full_like(pos, -1)).amax(1)
    iprop = torch.arange(K - 1, device=dev)[None, :]
    pcols = (jstar[:, None] + 2 + iprop).clamp(0, S - 1)
    valid = found[:, None] & (jstar[:, None] + 2 + iprop < hlen[:, None])
    return torch.where(valid, torch.gather(hist, 1, pcols),
                       cur[:, None].to(hist.dtype))


def draft_propose(step_fn, pending: torch.Tensor, k: int):
    """Draft-model proposals: ``k`` chained draft decode steps, each
    step's greedy token fed back as the next step's input. ``step_fn(tokens
    [S]) -> tokens [S]`` runs one draft step (advancing its cache); the
    ``k``-th step only writes the last proposal's k/v, so the draft cache
    covers every proposed token, and its output is never proposed.
    Returns ``props [S, k-1]``, on the device: nothing here waits for the
    device, so the whole chain is enqueued ahead of the verify that
    reads it."""
    toks = pending
    outs = []
    for _ in range(k):
        toks = step_fn(toks)
        outs.append(toks)
    return torch.stack(outs[:-1], dim=1)


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
