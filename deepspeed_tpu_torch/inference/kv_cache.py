"""KV caches — the inference workspace: dense and paged.

Counterpart of ``deepspeed_tpu/inference/kv_cache.py``:

* the dense cache (``KVCache`` through ``advance``, :28-151): keys and
  values ``[L, B, S_max, KH, D]`` plus per-sequence live ``lengths [B]``
  (int32, on the cache's device), with the prompt, token and speculative
  chunk writers (``write_prompt``, ``append_token``, ``write_chunk``);
* the paged pool (``PagedKVCache`` through ``paged_advance``, :154-460, and
  ``BlockAllocator`` :619): one global block pool ``[L, NB, BS, KH, D]``
  shared by every resident sequence, per-slot int32 block tables mapping
  logical positions to pool blocks, and the host-side refcounted free list
  with prefix caching. Block 0 is the reserved null block: idle slots keep
  an all-zero table row and write their masked, discarded tokens there.

JAX threads an immutable, donated cache through its jitted steps; here
every writer updates the buffers in place (one allocation, no copies), the
lengths included, and returns the cache it was given: a CUDA graph of a
step (``inference/cuda_graph.py``) bakes in the addresses of k/v,
``lengths``, ``block_tables`` and the scale tiles, so none of them may move
between steps. Where a JAX gather
clamps an index or a JAX scatter drops one, the port clamps or redirects
it explicitly: torch indexing would fault on the device instead.

int8 pools (``quantized=True``, JAX :180-253) store int8 payloads with
per-block-per-head f32 scale tiles ``[L, NB, KH, BS]``: the writers quantize
each written (position, head) row, the gathers dequantize to f32. The host
tier (``HostKVTier``, ``paged_read_block``, ``paged_swap_in``, JAX :463-616)
keeps demoted prefix blocks in host memory, and the allocator demotes and
swaps them in through its owner's callbacks. The allocator calls the KV-pool
accountant's hooks (JAX :784, :841, :880, :908) and honours fault
injection's famine reservations.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from deepspeed_tpu_torch.ops.quant_core import dequantize_int8, quantize_int8


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # [L, B, S, KH, D]
    v: torch.Tensor        # [L, B, S, KH, D]
    lengths: torch.Tensor  # [B] int32 — live tokens per sequence

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]


def auto_max_tokens(num_layers: int, batch: int, num_kv_heads: int,
                    head_dim: int, dtype=torch.bfloat16,
                    reserve_fraction: float = 0.1, shard_factor: int = 1,
                    device=None) -> Optional[int]:
    """Free-memory KV budget: how many cache tokens per sequence fit the
    device's currently free memory, minus a reserve for activations.
    Returns ``None`` for a device that reports no memory stats (the CPU) —
    callers fall back to the explicit default. Raises when stats exist but
    free memory cannot hold even a 128-token cache."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    from deepspeed_tpu_torch.accelerator import get_accelerator
    stats = get_accelerator().memory_stats(device.index)
    limit = int(stats.get("bytes_limit", 0))
    if limit <= 0:
        return None
    free = max(0, limit - int(stats.get("bytes_in_use", 0)))
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_token = (num_layers * 2 * num_kv_heads * head_dim * itemsize * batch
                 ) // max(int(shard_factor), 1)
    tokens = (int(free * (1.0 - reserve_fraction)) // max(per_token, 1)
              // 128) * 128
    if tokens < 128:
        raise RuntimeError(
            "max_out_tokens='auto': free accelerator memory "
            f"({free / 2**20:.0f} MiB of {limit / 2**20:.0f} MiB limit) "
            f"cannot hold even a 128-token KV cache at {per_token} "
            "bytes/token — reduce batch/model size, free memory, or set "
            "max_out_tokens explicitly")
    return tokens


def init_cache(num_layers: int, batch: int, max_seq: int, num_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (num_layers, batch, max_seq, num_kv_heads, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   lengths=torch.zeros((batch,), dtype=torch.int32,
                                       device=device))


def write_prompt(cache: KVCache, layer: int, k: torch.Tensor,
                 v: torch.Tensor, lengths: torch.Tensor,
                 offset: Optional[int] = None) -> KVCache:
    """Prefill: write ``[B, T, KH, D]`` keys/values at positions 0..T-1 of
    ``layer`` and copy ``lengths`` into ``cache.lengths``, IN PLACE.

    Right-padded positions hold garbage; they are either masked by decode
    (col >= lengths) or overwritten by later appends at ``lengths[b]``.
    Pad positions past the cache's end are dropped. ``offset``: the cache
    holds positions ``offset..offset+S-1`` (a rank's block of a cache
    split over ``seq``), so it takes the prompt's positions there.
    """
    offset = offset or 0
    T = max(min(k.shape[1] - offset, cache.max_seq), 0)
    cache.k[layer, :, :T] = k[:, offset:offset + T]
    cache.v[layer, :, :T] = v[:, offset:offset + T]
    cache.lengths.copy_(lengths)
    return cache


def append_token(cache: KVCache, layer: int, k: torch.Tensor,
                 v: torch.Tensor, offset: Optional[int] = None) -> KVCache:
    """Decode: write one token's ``[B, KH, D]`` k/v at ``lengths[b]`` of
    ``layer``, IN PLACE.

    Lengths are NOT advanced here (all layers append at the same position);
    call :func:`advance` once per step after the last layer. With an
    ``offset`` (the cache is a rank's block of positions ``offset..
    offset+S-1`` of a cache split over ``seq``) only the rows whose
    position falls in the block are written.
    """
    rows = torch.arange(k.shape[0], device=cache.k.device)
    pos = cache.lengths.long()
    k, v = k.to(cache.k.dtype), v.to(cache.v.dtype)
    if offset is not None:
        pos = pos - offset
        own = ((pos >= 0) & (pos < cache.max_seq))[:, None, None]
        pos = pos.clamp(0, cache.max_seq - 1)
        k = torch.where(own, k, cache.k[layer, rows, pos])
        v = torch.where(own, v, cache.v[layer, rows, pos])
    cache.k[layer, rows, pos] = k
    cache.v[layer, rows, pos] = v
    return cache


def write_chunk(cache: KVCache, layer: int, k: torch.Tensor,
                v: torch.Tensor) -> KVCache:
    """Speculative verify: write a K-token chunk's ``[B, K, KH, D]`` k/v at
    positions ``lengths[b] .. lengths[b]+K-1`` of ``layer``, IN PLACE.

    Lengths are NOT advanced: the caller commits only the accepted prefix,
    and rejected positions stay as garbage past ``lengths``, masked like
    right-padding. A chunk that would run past the cache's end starts
    earlier so that it fits, as JAX's ``dynamic_update_slice`` clamps
    its start."""
    B, K = k.shape[:2]
    dev = cache.k.device
    start = cache.lengths.long().clamp(0, max(cache.max_seq - K, 0))
    pos = start[:, None] + torch.arange(K, device=dev)[None, :]
    rows = torch.arange(B, device=dev)[:, None]
    cache.k[layer, rows, pos] = k.to(cache.k.dtype)
    cache.v[layer, rows, pos] = v.to(cache.v.dtype)
    return cache


def advance(cache: KVCache, n: int = 1) -> KVCache:
    """Lengths ``n`` further on, in place; returns ``cache``."""
    cache.lengths.add_(n)
    return cache


# ---------------------------------------------------------------- paged


@dataclasses.dataclass
class PagedKVCache:
    """Paged decode workspace over ``num_slots`` resident sequences.

    k/v: ``[L, num_blocks, block_size, KH, D]`` global pool.
    block_tables: ``[num_slots, max_blocks]`` int32 — pool block ids per
    slot, in logical order (entry j covers positions ``j*block_size ..
    (j+1)*block_size-1``); unallocated entries are 0 (the null block).
    lengths: ``[num_slots]`` int32 live context length per slot.

    int8 storage: k/v hold int8 payloads and ``k_scale``/``v_scale`` the
    scale tiles ``[L, NB, KH, BS]`` f32, one symmetric amax/127 scale per
    written (position, head) row, block_size last so a kernel reads a
    block's scales for one head contiguously. ``None`` scales: a
    full-precision pool."""
    k: torch.Tensor
    v: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None   # [L, NB, KH, BS] f32 | None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def num_slots(self) -> int:
        return self.block_tables.shape[0]

    @property
    def max_blocks(self) -> int:
        return self.block_tables.shape[1]

    @property
    def max_context(self) -> int:
        return self.max_blocks * self.block_size

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]


def init_paged_cache(num_layers: int, num_slots: int, num_blocks: int,
                     block_size: int, max_blocks_per_slot: int,
                     num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                     quantized: bool = False, device=None) -> PagedKVCache:
    """``num_blocks`` INCLUDES the reserved null block 0, so the usable
    pool is ``num_blocks - 1`` blocks. ``quantized=True`` builds the int8
    pool (payload int8 whatever ``dtype``) with two separate all-ones
    scale tensors: unwritten positions dequantize to exact zeros."""
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    pool_dtype = torch.int8 if quantized else dtype

    def scales():
        if not quantized:
            return None
        return torch.ones((num_layers, num_blocks, num_kv_heads, block_size),
                          dtype=torch.float32, device=device)

    return PagedKVCache(
        k=torch.zeros(shape, dtype=pool_dtype, device=device),
        v=torch.zeros(shape, dtype=pool_dtype, device=device),
        block_tables=torch.zeros((num_slots, max_blocks_per_slot),
                                 dtype=torch.int32, device=device),
        lengths=torch.zeros((num_slots,), dtype=torch.int32, device=device),
        k_scale=scales(), v_scale=scales())


def _quant_rows(cache: PagedKVCache, x: torch.Tensor):
    """The writers' one quantization seam: for an int8 pool, ``[..., KH,
    D]`` quantized per (position, head) row along D → (int8 payload,
    scales ``[..., KH]``); for an fp pool, cast, and no scales."""
    if cache.k_scale is None:
        return x.to(cache.k.dtype), None
    q, s = quantize_int8(x, -1)
    return q, s[..., 0]


def _scatter_blocks(cache: PagedKVCache, layer: int, idx: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor) -> PagedKVCache:
    """Whole-block scatter shared by the prompt and chunk writers:
    ``[nb*BS, KH, D]`` k/v into pool blocks ``idx [nb]``, in place. Entries
    pointing at the null block may repeat; which write lands there does
    not matter (block 0 is garbage by contract). An int8 pool takes the
    quantized rows and their ``[nb, KH, BS]`` scale tiles at the same
    indices."""
    nb, BS = idx.shape[0], cache.block_size
    idx = idx.long()
    qk, sk = _quant_rows(cache, k)
    qv, sv = _quant_rows(cache, v)
    cache.k[layer][idx] = qk.reshape(nb, BS, *k.shape[1:])
    cache.v[layer][idx] = qv.reshape(nb, BS, *v.shape[1:])
    if sk is not None:
        KH = k.shape[1]
        cache.k_scale[layer][idx] = sk.reshape(nb, BS, KH).transpose(1, 2)
        cache.v_scale[layer][idx] = sv.reshape(nb, BS, KH).transpose(1, 2)
    return cache


def paged_write_prompt(cache: PagedKVCache, layer: int, k: torch.Tensor,
                       v: torch.Tensor, slot: int) -> PagedKVCache:
    """Prefill: scatter one prompt's ``[T, KH, D]`` k/v into ``slot``'s
    blocks at logical positions ``0..T-1`` (T divisible by block_size).
    Positions beyond the live length hold right-pad garbage (masked by
    attention, overwritten by later appends). Lengths are NOT set here."""
    nb = k.shape[0] // cache.block_size
    return _scatter_blocks(cache, layer, cache.block_tables[slot, :nb], k, v)


def _scatter_positions(cache: PagedKVCache, layer: int, blk: torch.Tensor,
                       off: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> PagedKVCache:
    """Per-position scatter shared by the append and verify writers: k/v
    ``[..., KH, D]`` with leading dims matching ``blk``/``off``. The scale
    scatter ``k_scale[layer][blk, :, off]`` has its two index tensors apart,
    so (as in numpy and JAX) their dims come first: ``[..., KH]``, the
    shape :func:`_quant_rows` returns."""
    blk, off = blk.long(), off.long()
    qk, sk = _quant_rows(cache, k)
    qv, sv = _quant_rows(cache, v)
    cache.k[layer][blk, off] = qk
    cache.v[layer][blk, off] = qv
    if sk is not None:
        cache.k_scale[layer][blk, :, off] = sk
        cache.v_scale[layer][blk, :, off] = sv
    return cache


def paged_append_token(cache: PagedKVCache, layer: int, k: torch.Tensor,
                       v: torch.Tensor) -> PagedKVCache:
    """Decode: append one token's ``[S, KH, D]`` k/v at ``lengths[s]`` for
    every slot, in place. Idle slots (all-zero table, length 0) write into
    the null block, and so does a position past the table (a garbage row
    of the pipelined loop): JAX's ``take_along_axis`` gives an out-of-range
    block id there and its scatter drops the write. Lengths advance via
    :func:`paged_advance`."""
    return _scatter_positions(cache, layer,
                              *_table_lookup(cache, cache.lengths[:, None]),
                              k[:, None], v[:, None])


def _table_lookup(cache: PagedKVCache, pos: torch.Tensor):
    """(pool block, offset) of positions ``pos [S, n]`` through each slot's
    table row; a position past the table maps to the null block 0."""
    pos = pos.long()
    entry = pos // cache.block_size
    blk = cache.block_tables.gather(
        1, entry.clamp(0, cache.max_blocks - 1))
    blk = torch.where(entry < cache.max_blocks, blk, torch.zeros_like(blk))
    return blk, pos % cache.block_size


def paged_write_tokens(cache: PagedKVCache, layer: int, k: torch.Tensor,
                       v: torch.Tensor) -> PagedKVCache:
    """Speculative verify: write K tokens' ``[S, K, KH, D]`` k/v for EVERY
    slot at positions ``lengths[s]..lengths[s]+K-1`` through the block
    tables, in place, without advancing lengths. A position whose block
    index runs past the table redirects to the null block 0."""
    pos = cache.lengths[:, None] + torch.arange(
        k.shape[1], device=cache.lengths.device)[None, :]
    return _scatter_positions(cache, layer, *_table_lookup(cache, pos), k, v)


def paged_write_chunk(cache: PagedKVCache, layer: int, k: torch.Tensor,
                      v: torch.Tensor, slot: int, start: int
                      ) -> PagedKVCache:
    """Chunked prefill: scatter a C-token chunk's ``[C, KH, D]`` k/v into
    ``slot``'s blocks at positions ``start..start+C-1`` (both C and start
    block-aligned), in place. Table entries past the row's end are the
    null block, so a window running past the table spills into block 0
    (JAX pads the row with zeros for the same reason)."""
    BS = cache.block_size
    nb = k.shape[0] // BS
    row = cache.block_tables[slot]
    row = torch.cat([row, torch.zeros((nb,), dtype=row.dtype,
                                      device=row.device)])
    first = min(start // BS, cache.max_blocks)   # dynamic_slice's clamp
    return _scatter_blocks(cache, layer, row[first:first + nb], k, v)


def _dequant_blocks(x, scale):
    """Gathered int8 blocks ``[..., BS, KH, D]`` times their scale tiles
    ``[..., KH, BS]`` → f32."""
    return dequantize_int8(x, scale.transpose(-1, -2)[..., None])


def paged_gather_slot_kv(cache: PagedKVCache, layer: int, slot: int):
    """ONE slot's cache ``[1, max_context, KH, D]`` through its table (the
    chunked-prefill plain path); an int8 pool dequantizes to f32."""
    row = cache.block_tables[slot].long()
    k, v = cache.k[layer][row], cache.v[layer][row]
    if cache.quantized:
        k = _dequant_blocks(k, cache.k_scale[layer][row])
        v = _dequant_blocks(v, cache.v_scale[layer][row])
    return (k.reshape(1, cache.max_context, *k.shape[2:]),
            v.reshape(1, cache.max_context, *v.shape[2:]))


def paged_gather_kv(cache: PagedKVCache, layer: int):
    """Per-slot caches ``[S, max_context, KH, D]`` through the block tables
    — the plain path for ALiBi and windowed layers. Gathered position j is
    logical position j, so the dense masked attention applies unchanged.
    An int8 pool dequantizes to f32."""
    S = cache.num_slots
    bt = cache.block_tables.long()
    k, v = cache.k[layer][bt], cache.v[layer][bt]
    if cache.quantized:
        k = _dequant_blocks(k, cache.k_scale[layer][bt])
        v = _dequant_blocks(v, cache.v_scale[layer][bt])
    return (k.reshape(S, cache.max_context, *k.shape[3:]),
            v.reshape(S, cache.max_context, *v.shape[3:]))


def paged_advance(cache: PagedKVCache, active: torch.Tensor
                  ) -> PagedKVCache:
    """Advance live slots' lengths by one, in place; idle slots stay pinned
    at 0 so their appends keep landing in the null block. Returns
    ``cache``."""
    cache.lengths.add_(active.to(torch.int32))
    return cache


# ------------------------------------------------------------- host tier
# A demoted block's payload (k/v across all layers, plus the scale tiles of
# an int8 pool) moves to host memory keyed by its chain hash and the device
# block recycles; a later prefix hit on the hash swaps the payload back into
# a freshly allocated block. Both copies run only inside admission-time
# allocation, after the server has flushed every step in flight: the pool is
# written in place, so a swap-in under a running step would corrupt it.

_TIER_FIELDS = ("k", "v", "k_scale", "v_scale")


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A host copy that is complete on return: pinned for a CUDA source (a
    later swap-in copies it back without a sync), a plain clone on the
    CPU."""
    if x.device.type != "cuda":
        return x.clone()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)   # blocking: waits for the stream's earlier writes
    return out


def paged_read_block(cache: PagedKVCache, block: int) -> Dict[str, torch.Tensor]:
    """Device→host copy of one pool block across all layers: ``{"k": [L,
    BS, KH, D], "v": ..., ("k_scale"/"v_scale": [L, KH, BS])}`` as host
    tensors (the demotion copy; by return the content is host-durable and
    the device block may recycle)."""
    return {f: _to_host(getattr(cache, f)[:, block]) for f in _TIER_FIELDS
            if getattr(cache, f) is not None}


def paged_swap_in(cache: PagedKVCache, block: int,
                  payload: Dict[str, torch.Tensor]) -> PagedKVCache:
    """Host→device copy of a demoted payload into pool ``block``, in place.
    On CUDA the copies are stream-ordered and asynchronous: the next step
    reads the block behind them, and the pinned payload stays allocated
    until they complete (PyTorch's pinned-memory allocator records the
    copy's stream before it reuses the buffer)."""
    fields = [f for f in _TIER_FIELDS if getattr(cache, f) is not None]
    if sorted(payload) != sorted(fields):
        raise ValueError(f"swap-in payload holds {sorted(payload)}, the pool "
                         f"takes {sorted(fields)}")
    for f in fields:
        getattr(cache, f)[:, block].copy_(payload[f], non_blocking=True)
    return cache


class HostKVTier:
    """Host-memory residency for demoted KV blocks, keyed by chain hash
    (JAX ``HostKVTier`` :534).

    Host storage and bookkeeping only: the BlockAllocator decides when to
    demote and swap in (its ``on_demote``/``on_swap_in`` callbacks do the
    copies), this class holds payloads. Insertion order is the host LRU:
    past ``max_blocks`` the oldest payload drops for good. ``put`` on a
    hash already resident raises: two device blocks claimed one chain
    hash, which first-writer-wins registration rules out."""

    def __init__(self, max_blocks: Optional[int] = None):
        if max_blocks is not None and max_blocks < 1:
            raise ValueError(
                f"host tier max_blocks must be >= 1 (or None for "
                f"unbounded), got {max_blocks}")
        self.max_blocks = max_blocks
        self._store: "OrderedDict[bytes, Dict[str, torch.Tensor]]" = \
            OrderedDict()
        self._block_nbytes = 0    # payload size, learned at the first put
        self.swap_outs = 0        # payloads demoted into the tier
        self.swap_ins = 0         # payloads promoted back to the device
        self.dropped = 0          # host-LRU drops (content gone for good)
        self.superseded = 0       # payloads purged by re-registration

    def __len__(self) -> int:
        return len(self._store)

    @property
    def host_bytes(self) -> int:
        """Bytes parked in host memory (every payload is one pool block
        across all layers)."""
        return len(self._store) * self._block_nbytes

    @property
    def block_nbytes(self) -> int:
        """Payload bytes of ONE tiered block (0 until the first put): the
        cost ledger prices swap-in traffic with it."""
        return self._block_nbytes

    def has(self, h: bytes) -> bool:
        return h in self._store

    def put(self, h: bytes, payload: Dict[str, torch.Tensor]) -> None:
        if h in self._store:
            raise ValueError(
                "double demote: chain hash already host-resident — two "
                "device blocks claimed the same prefix hash")
        if not self._block_nbytes:
            self._block_nbytes = sum(int(a.nbytes) for a in payload.values())
        self._store[h] = payload
        self.swap_outs += 1
        while (self.max_blocks is not None
               and len(self._store) > self.max_blocks):
            self._store.popitem(last=False)
            self.dropped += 1

    def take(self, h: bytes) -> Dict[str, torch.Tensor]:
        """Pop one payload for swap-in (a host copy kept beside the device
        one could go stale against it)."""
        payload = self._store.pop(h)
        self.swap_ins += 1
        return payload

    def discard(self, h: bytes) -> bool:
        """Drop a host payload whose hash was just re-registered on the
        device (a bounded tier's capacity drop can strand a descendant
        hash on the host after its ancestor dropped). Returns True when a
        payload was dropped."""
        if self._store.pop(h, None) is None:
            return False
        self.superseded += 1
        return True


def prefix_block_hashes(prompt, block_size: int) -> List[bytes]:
    """Chain hashes for every FULL block of a prompt: block i's hash is
    ``sha256(hash_{i-1} || tokens[i*BS:(i+1)*BS])`` — a block matches only
    under its entire preceding prefix, which makes reuse position-safe."""
    n = len(prompt) // block_size
    out, prev = [], b""
    for i in range(n):
        span = prompt[i * block_size:(i + 1) * block_size]
        h = hashlib.sha256(
            prev + b"," + ",".join(map(str, span)).encode()).digest()
        out.append(h)
        prev = h
    return out


class BlockAllocator:
    """Host-side refcounted free list over pool blocks 1..num_blocks-1
    (block 0 is the reserved null block); an EOS'd sequence's blocks
    return here and are handed to a queued request without any device
    reallocation.

    Prefix caching: a FULL block covering an immutable block-aligned
    prompt prefix is registered under its chain hash
    (:meth:`register_prefix`); a later request sharing that exact prefix
    takes the block by refcount (:meth:`match_prefix`). Released cached
    blocks (refcount 0) park in an LRU of evictable blocks and are evicted
    only when an allocation outruns the free list. The free list is a
    stack (pop → low ids) with a set shadow for O(1) membership.

    Host offload (``host_tier``): an LRU pop DEMOTES the parked block's
    payload to the tier instead of destroying it, and a prefix walk that
    hits a demoted hash swaps it back in. The copies are the owner's
    callbacks: ``on_demote(block, hash)`` makes the payload host-durable
    before it returns, ``on_swap_in(block, payload)`` writes the already
    reserved payload into the freshly allocated block. Until both are
    bound an LRU pop is a plain eviction.

    Copy of JAX's allocator with its ``accountant`` hooks
    (``telemetry/memory.py`` ``KVPoolAccountant``: acquire, release,
    rollback, eviction, demotion, famine) and the famine reservations of
    fault injection (:meth:`set_reserved`). The handoff lookups
    (``lookup_prefix``) are ROADMAP.md A7b-ii."""

    def __init__(self, num_blocks: int, enable_prefix_caching: bool = False,
                 accountant=None, host_tier: Optional[HostKVTier] = None):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 pool blocks (1 usable + the null block), "
                f"got {num_blocks}")
        if host_tier is not None and not enable_prefix_caching:
            raise ValueError(
                "host offload tiers demoted PREFIX blocks — it needs "
                "enable_prefix_caching (a hashless block has no "
                "identity to swap back in under)")
        self.num_blocks = num_blocks
        self.enable_prefix_caching = enable_prefix_caching
        # host offload (docs/serving.md "KV quantization & host
        # tiering"): when set, an LRU pop DEMOTES the parked block's
        # payload to host RAM instead of destroying it, and a
        # match_prefix hit on a demoted hash swaps it back in. The
        # copies are the owner's (the server holds the device arrays):
        # on_demote(block, hash) must make the payload host-durable
        # before returning, on_swap_in(block, payload) must write the
        # already-reserved payload into the freshly allocated block.
        # Until both callbacks are bound, demotion falls back to plain
        # eviction — never silent data teleportation.
        self.host_tier = host_tier
        self.on_demote = None
        self.on_swap_in = None
        self.demotions = 0     # LRU pops that preserved content on host
        self.swap_ins = 0      # host hits promoted back to device
        # pool lifetime/fragmentation accounting (telemetry/memory.py
        # KVPoolAccountant) or None — every hook sits behind a None
        # check, so an unaccounted allocator costs nothing extra
        self.accountant = accountant
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() -> low ids
        self._free_set = set(self._free)
        self._refcount: Dict[int, int] = {}       # live blocks only
        # prefix cache index: chain hash <-> block id, plus the LRU of
        # evictable (refcount-0 but content-retained) cached blocks in
        # release order — eviction pops the oldest
        self._hash_to_block: Dict[bytes, int] = {}
        self._block_hash: Dict[int, bytes] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # blocks withheld from the free budget (fault injection / tests
        # simulating pool pressure — telemetry/faultinject.py); never
        # handed out while reserved
        self.reserved_blocks = 0
        # observer for LRU evictions (the scheduler counts them + drops
        # a ring event: the first rung of the degradation ladder must be
        # visible, not silent)
        self.on_evict = None
        self.evictions = 0

    def set_reserved(self, n: int) -> None:
        """Withhold ``n`` blocks from the free budget (famine
        injection). Already-live blocks are unaffected — the squeeze
        lands on future admissions, exactly like real pressure."""
        if n < 0 or n > self.usable_blocks:
            raise ValueError(
                f"reserved blocks must be in [0, {self.usable_blocks}], "
                f"got {n}")
        self.reserved_blocks = int(n)

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: immediately free + evictable cached,
        minus any fault-injected reservation."""
        return max(
            0, len(self._free) + len(self._lru) - self.reserved_blocks)

    @property
    def usable_blocks(self) -> int:
        """Total pool capacity (excludes the reserved null block)."""
        return self.num_blocks - 1

    @property
    def cached_blocks(self) -> int:
        """Blocks currently holding a reusable hashed prefix (resident
        shared + evictable LRU)."""
        return len(self._hash_to_block)

    @property
    def live_blocks(self) -> int:
        """DISTINCT blocks held by resident sequences — a shared prefix
        block counts once however many sequences hold it, so
        ``live + free == usable`` always."""
        return len(self._refcount)

    def _pop_free(self) -> int:
        if self._free:
            b = self._free.pop()
            self._free_set.discard(b)
            return b
        # free list dry: pop the least-recently-released cached block.
        # With a host tier armed this is a DEMOTION — the payload moves
        # to host RAM under its chain hash and a later match_prefix hit
        # swaps it back — and it runs during admission's allocation,
        # i.e. BEFORE the server's preemption rung ever fires: famine
        # demotes coldest-parked blocks first. Without a tier the
        # content is gone for good (the hash index forgets it), so a
        # later identical prefix re-prefills and re-registers.
        b, _ = self._lru.popitem(last=False)
        h = self._block_hash.get(b)
        if (h is not None and self.host_tier is not None
                and self.on_demote is not None):
            self._drop_hash(b)
            self.on_demote(b, h)   # device->host, durable on return
            self.demotions += 1
            if self.accountant is not None:
                self.accountant.on_demote(b)
        else:
            self._drop_hash(b)
            self.evictions += 1
            if self.accountant is not None:
                self.accountant.on_evict(b)
            if self.on_evict is not None:
                self.on_evict(b)
        return b

    def _drop_hash(self, b: int) -> None:
        h = self._block_hash.pop(b, None)
        if h is not None and self._hash_to_block.get(h) == b:
            del self._hash_to_block[h]

    def allocate(self, n: int):
        """``n`` fresh block ids (refcount 1 each), or None (caller
        queues) when even eviction cannot cover the span."""
        if n > self.free_blocks:
            if self.accountant is not None:
                # famine: freeze the allocator state into the event
                # ring (once per episode — re-armed by the next
                # successful allocation); fragmentation refreshed so
                # the frozen snapshot is current, not Nth-transition
                # stale
                self.accountant.update_fragmentation(self._free_set)
                self.accountant.on_famine(n, self.famine_state())
            return None
        out = [self._pop_free() for _ in range(n)]
        for b in out:
            self._refcount[b] = 1
        if self.accountant is not None:
            for b in out:
                self.accountant.on_acquire(b)
            self.accountant.on_alloc_ok()
        return out

    def famine_state(self) -> dict:
        """JSON-able allocator state for the famine ring event."""
        return {
            "free_list": len(self._free),
            "evictable_lru": len(self._lru),
            "live_blocks": len(self._refcount),
            "cached_blocks": len(self._hash_to_block),
            "reserved_blocks": self.reserved_blocks,
            "usable_blocks": self.usable_blocks,
            "host_blocks": (len(self.host_tier)
                            if self.host_tier is not None else 0),
        }

    @property
    def free_ids(self):
        """Immediately-free block ids (the free list proper, evictable
        LRU excluded) — the fragmentation gauge's input."""
        return tuple(self._free_set)

    def release(self, blocks) -> None:
        """Drop one reference per block. A block reaching refcount 0
        returns to the free list — unless it holds a registered prefix,
        in which case it parks in the evictable LRU (content retained
        for future :meth:`match_prefix` hits, memory reclaimable)."""
        self._drop_refs(blocks, rollback=False)

    def _drop_refs(self, blocks, rollback: bool) -> None:
        """The refcount-decrement / park-or-free invariant, in ONE
        place (release and rollback differ only in which accounting
        hook fires at refcount 0 — duplicating the loop would leave
        the free-list bookkeeping to drift apart by hand)."""
        for b in blocks:
            if b == 0:
                raise ValueError("block 0 is the reserved null block")
            if b in self._free_set or b in self._lru:
                raise ValueError(f"double free of block {b}")
            ref = self._refcount.get(b, 0)
            if ref <= 0:
                raise ValueError(f"double free of block {b}")
            if ref > 1:
                self._refcount[b] = ref - 1
                continue
            del self._refcount[b]
            parked = b in self._block_hash
            if parked:
                self._lru[b] = None
            else:
                self._free.append(b)
                self._free_set.add(b)
            if self.accountant is not None:
                if rollback:
                    self.accountant.on_rollback(b)
                else:
                    self.accountant.on_release(b, parked)

    def rollback_match(self, blocks) -> None:
        """Undo a :meth:`match_prefix` acquisition whose tail
        allocation failed (a blocked queue head retried every step):
        refcounts drop exactly like :meth:`release`, but the pool
        accounting is REWOUND, not observed — a rollback was never a
        residency, so no lifetime sample is recorded and a resurrected
        block re-parks under its ORIGINAL timestamp (flooding the
        lifetime histogram with ~0s samples and re-stamping LRU ages
        each retry would corrupt exactly the numbers the offload/
        eviction decision reads)."""
        self._drop_refs(blocks, rollback=True)

    # ------------------------------------------------------- prefix cache

    def match_prefix(self, hashes) -> list:
        """Walk a prompt's chain hashes in prefix order, acquiring every
        consecutive hit (refcount++ on resident blocks, resurrection out
        of the LRU for evictable ones, and — host tier armed — swap-in
        of demoted blocks through :meth:`_swap_in_hit`). Stops at the
        first miss — a deeper block is only valid under its full prefix
        chain. Returns the acquired block ids; the caller allocates the
        tail and, on tail-allocation failure, must ``release`` these
        (a rolled-back swap-in parks device-side, content intact)."""
        out = []
        for h in hashes:
            b = self._hash_to_block.get(h)
            if b is None:
                b = self._swap_in_hit(h)
                if b is None:
                    break
                out.append(b)
                continue
            if b in self._lru:
                del self._lru[b]
                self._refcount[b] = 1
                if self.accountant is not None:
                    # resurrection is a fresh residency (refcount 0->1)
                    self.accountant.on_acquire(b)
            else:
                self._refcount[b] = self._refcount[b] + 1
            out.append(b)
        return out

    def _swap_in_hit(self, h: bytes):
        """Promote one demoted (host-resident) block back to the device
        for a prefix hit: POP the payload first (the staging
        allocation below may itself demote a colder parked block, and
        on a bounded tier that demotion's capacity drop could evict
        exactly this hash — reserving the payload up front makes the
        swap-in immune to its own staging), then allocate a block off
        the free list, copy the payload in via the owner's callback,
        and re-register the hash. Returns the block id, or None when
        the hash is not host-resident (a true miss) or no block can
        stage the swap-in."""
        if (self.host_tier is None or self.on_swap_in is None
                or not self.host_tier.has(h) or self.free_blocks < 1):
            return None
        payload = self.host_tier.take(h)
        b = self._pop_free()
        self._refcount[b] = 1
        self.on_swap_in(b, payload)   # host->device into block b
        self._hash_to_block[h] = b
        self._block_hash[b] = h
        self.swap_ins += 1
        if self.accountant is not None:
            self.accountant.on_acquire(b)
        return b

    def register_prefix(self, block: int, h: bytes) -> bool:
        """Publish a live, fully-written prefix block under its chain
        hash. First writer wins: if the hash is already claimed (a
        concurrent identical prefill), this block stays private and
        recycles normally. Returns True when registered."""
        if not self.enable_prefix_caching:
            return False
        if self._refcount.get(block, 0) <= 0:
            raise ValueError(
                f"register_prefix on non-live block {block} — only a "
                "resident sequence's own blocks can be published")
        if h in self._hash_to_block or block in self._block_hash:
            return False
        self._hash_to_block[h] = block
        self._block_hash[block] = h
        if self.host_tier is not None:
            # invariant: a hash is never BOTH device-registered and
            # host-resident. A bounded tier's capacity drop can strand
            # a descendant hash on host after its chain ancestor
            # dropped; when the re-prefilled chain re-registers it
            # here, the stale host copy must go — otherwise this
            # block's next demotion reads as a double demote.
            self.host_tier.discard(h)
        return True
