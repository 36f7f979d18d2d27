"""One fused inference transformer, many architectures — in PyTorch.

Counterpart of ``deepspeed_tpu/model_implementations/transformer.py``:
the same configuration, the same parameter tree and the same functions
(``prefill``, ``decode_step``, ``decode_chunk``, ``causal_forward``,
``encoder_forward``, and the paged-pool functions ``paged_prefill``,
``paged_prefill_chunk``, ``paged_decode_step`` and ``paged_verify_step``
the server runs), written as plain functions on tensors over a parameter
dict. Prefill attention runs the flash kernel
(``ops/flash_attention.py``), a dense decode step the dense decode kernel
and the paged steps the paged decode, chunk and verify kernels
(``ops/decode_attention.py``; over an int8 pool their int8 variants, given
the layer's scale tiles) — on a CUDA tensor the CUDA kernels, on a CPU
tensor their plain versions. ALiBi, sliding windows and padded-key masks
(the encoder's too) have no kernel in either package and take the plain
einsum path here (over the pool gathered through the block tables, for the
paged steps), as they take the XLA path there; so does the dense
speculative verify ``decode_chunk``, whose attention JAX leaves to an XLA
einsum. The large products around attention (projections, MLP, LM head)
are ``torch`` matmuls, as the JAX package leaves them to XLA. A projection
weight may be an int8 node (``{"q", "scale"}`` or ``{"q", "oscale"}``,
``module_inject/quantize.py``): it is dequantized into the activation
dtype, or, with ``int8_compute`` (w8a8), multiplied as int8 x int8 with an
int32 accumulator (``ops/int8_gemm.py``). The paged functions take the
slot, the chunk start and the prompt length as host ints where JAX traces
scalars, and none of them reads a device value on the host.

Parameter schema (nested dict of tensors)::

    wte [V, E]   wpe [P, E]?   ln_f {scale, bias}   lm_head [E, V]?
    layers: list of
      ln1 {scale, bias}   ln2 {scale, bias}?
      attn {wq, wk, wv [E, H, D], bq, bk, bv [H, D], wo [H, D, E], bo [E]}
      mlp  {wi [E, F], bi [F], wo [F, E], bo [E]}

plus, by architecture, ``ln_emb`` (BLOOM, BERT), ``wtte`` (BERT's
token-type table), ``lm_head_bias``, and ``mlp.{wg, bg}`` (gated MLPs).
``pre_layer_norm=False`` is the post-LN order of BERT and DistilBERT.

**Several ranks.** Under a ``tensor`` mesh axis (``tensor_parallel.
tp_size``) each rank holds its heads of wq/wk/wv/wo and its columns of
the MLP (``parallel/tensor_parallel.py`` ``tp_param_specs``): q/k/v and
the cache have ``H / tp`` and ``KH / tp`` heads, every attention kernel
runs on them as it is, and the row-parallel products (``attn.wo``,
``mlp.wo``) are summed over the group before their bias is added, once.
The functions tell the split from the weights' head count, so a whole
tree runs as on one device. Under w8a8 the row-parallel activations are
quantized with the group's row amax and the int32 products summed before
the rescale, so the result is the one-device one. With ``seq_shard_kv``
(``sp_size``) the dense cache holds this rank's block of positions:
prefill writes the prompt's positions in it, decode appends a token on
the rank that owns its position, and decode attention is plain torch
(JAX's is an XLA einsum there): each rank's partial softmax over its
block, merged over ``seq`` (max, then sums); a rank whose positions are
all past ``live`` weighs 0. The paged steps and ``decode_chunk`` refuse
it, with JAX's messages.

Not in this slice (ROADMAP.md queue C): MoE layers and expert-parallel
meshes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.kv_cache import (
    KVCache, PagedKVCache, advance, append_token, paged_advance,
    paged_append_token, paged_gather_kv, paged_gather_slot_kv,
    paged_write_chunk, paged_write_prompt, paged_write_tokens, write_chunk,
    write_prompt)
from deepspeed_tpu_torch.ops.decode_attention import (
    decode_attention, paged_chunk_attention, paged_decode_attention,
    paged_verify_attention)
from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference)
from deepspeed_tpu_torch.ops.int8_gemm import (maybe_int8_einsum,
                                               maybe_int8_matmul)
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.parallel.tensor_parallel import (SEQ, TENSOR,
                                                          axis_rank)
from deepspeed_tpu_torch.utils.unported import not_ported

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class InferenceTransformerConfig:
    vocab_size: int
    n_positions: int
    n_embd: int
    n_layer: int
    n_head: int
    n_kv_head: Optional[int] = None          # != n_head → GQA/MQA
    intermediate_size: Optional[int] = None  # default 4*E
    pre_layer_norm: bool = True              # False → BERT-style post-LN
    positional: str = "learned"              # learned | rotary | alibi | none
    rotary_dim: int = 0                      # 0 → full head dim when rotary
    rotary_interleaved: bool = False         # True → GPT-J style pairs
    rotary_base: float = 10000.0
    parallel_attn_mlp: bool = False          # GPT-J / GPT-NeoX parallel block
    activation: str = "gelu_new"             # gelu | gelu_new | relu | silu
    norm_type: str = "layernorm"             # layernorm | rmsnorm (LLaMA)
    gated_mlp: bool = False                  # SwiGLU: wg gate projection
    seq_shard_kv: bool = False
    layer_norm_eps: float = 1e-5
    tied_lm_head: bool = True
    attn_scale: Optional[float] = None       # default 1/sqrt(head_dim)
    alibi_scale: float = 1.0
    # per-layer sliding-window size (None = global), length n_layer
    local_windows: Optional[tuple] = None
    int8_compute: bool = False
    num_experts: int = 0
    moe_layers: Optional[tuple] = None
    moe_top_k: int = 1
    moe_renormalize: bool = True
    moe_activation: Optional[str] = None
    # "lm" → project to vocab logits; "none" → return final hidden states
    head: str = "lm"
    explicit_head_dim: Optional[int] = None
    embed_scale: float = 1.0
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.explicit_head_dim or self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head

    @property
    def ffn(self) -> int:
        return self.intermediate_size or 4 * self.n_embd

    def is_moe_layer(self, idx: int) -> bool:
        if self.num_experts <= 0:
            return False
        return self.moe_layers is None or idx in self.moe_layers

    @property
    def scale(self) -> float:
        return self.attn_scale if self.attn_scale is not None else (
            1.0 / math.sqrt(self.head_dim))


# ---------------------------------------------------------------- params

def init_params(generator: torch.Generator, cfg: InferenceTransformerConfig,
                device=None) -> Dict:
    """Random init from ``generator`` (on ``device``, default the
    generator's): weights ``N(0, 1) / sqrt(fan_in)`` in ``cfg.dtype``, zero
    biases, unit norm scales — the JAX package's scheme, not its numbers."""
    if cfg.num_experts > 0:
        raise NotImplementedError(not_ported("MoE layers"))
    E, H, D, F_, KH = cfg.n_embd, cfg.n_head, cfg.head_dim, cfg.ffn, \
        cfg.kv_heads
    dev = torch.device(device) if device is not None else generator.device
    dt = cfg.dtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def norm():
        p = {"scale": torch.ones((E,), dtype=dt, device=dev)}
        if cfg.norm_type != "rmsnorm":
            p["bias"] = zeros(E)
        return p

    params: Dict[str, Any] = {"wte": dense((cfg.vocab_size, E), E),
                              "ln_f": norm(), "layers": []}
    if cfg.positional == "learned":
        params["wpe"] = dense((cfg.n_positions, E), E)
    if not cfg.tied_lm_head:
        params["lm_head"] = dense((E, cfg.vocab_size), E)
    for _ in range(cfg.n_layer):
        layer = {
            "ln1": norm(),
            "attn": {"wq": dense((E, H, D), E), "wk": dense((E, KH, D), E),
                     "wv": dense((E, KH, D), E), "bq": zeros(H, D),
                     "bk": zeros(KH, D), "bv": zeros(KH, D),
                     "wo": dense((H, D, E), E), "bo": zeros(E)},
            "mlp": {"wi": dense((E, F_), E), "bi": zeros(F_),
                    "wo": dense((F_, E), F_), "bo": zeros(E)},
        }
        if cfg.gated_mlp:
            layer["mlp"]["wg"] = dense((E, F_), E)
        if not (cfg.parallel_attn_mlp and cfg.pre_layer_norm
                and cfg.positional == "rotary" and cfg.rotary_interleaved):
            layer["ln2"] = norm()
        params["layers"].append(layer)
    return params


# ---------------------------------------------------------------- math

def _layer_norm(x, p, eps):
    """LayerNorm, or RMSNorm when the param dict carries no bias; f32
    statistics."""
    xf = x.float()
    if "bias" not in p:
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * p["scale"].float()).to(x.dtype)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _act(x, kind):
    if kind == "relu":
        return F.relu(x)
    if kind == "gelu":
        return F.gelu(x)
    if kind == "quick_gelu":                 # CLIP: x * sigmoid(1.702 x)
        return x * torch.sigmoid(1.702 * x)
    if kind in ("silu", "swish"):
        return F.silu(x)
    return F.gelu(x, approximate="tanh")     # gelu_new / gelu_fast


def _rotary_angles(positions, dim, base):
    """positions [...]; returns cos/sin [..., dim//2] in fp32."""
    inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=positions.device) / dim))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x, positions, rotary_dim, base, interleaved):
    """x [..., D] with leading position dims matching ``positions``;
    ``interleaved=True`` is the GPT-J pairing, False the NeoX half split."""
    D = x.shape[-1]
    rd = rotary_dim or D
    cos, sin = _rotary_angles(positions, rd, base)
    cos, sin = cos.unsqueeze(-2), sin.unsqueeze(-2)   # broadcast over heads
    rot, rest = x[..., :rd].float(), x[..., rd:]
    if interleaved:
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(rot.shape)
    else:
        half = rd // 2
        x1, x2 = rot[..., :half], rot[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([out.to(x.dtype), rest], -1)


def alibi_slopes(n_head: int, device=None) -> torch.Tensor:
    """BLOOM ALiBi head slopes (fp32 [H])."""
    def pow2slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]
    if math.log2(n_head).is_integer():
        s = pow2slopes(n_head)
    else:
        closest = 2 ** math.floor(math.log2(n_head))
        s = pow2slopes(closest) + pow2slopes(2 * closest)[0::2][
            : n_head - closest]
    return torch.tensor(s, dtype=torch.float32, device=device)


def _alibi(cfg, H: int, device) -> torch.Tensor:
    """The ALiBi slopes of this rank's ``H`` heads (of ``cfg.n_head``)."""
    s = alibi_slopes(cfg.n_head, device) * cfg.alibi_scale
    return s if H == cfg.n_head else s.narrow(0, axis_rank(TENSOR) * H, H)


def _row_reduce(split: bool):
    """The group a row-parallel product is summed over, or None."""
    return TENSOR if split else None


def _repeat_kv(k, n_rep):
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=-2)


def _prefill_attention(q, k, v, cfg: InferenceTransformerConfig,
                       causal: bool = True, key_mask=None, window=None,
                       reference: bool = False):
    """Attention over a full sequence. q [B, T, H, D], k/v [B, T, KH, D]
    → [B, T, H, D]. The causal, unbiased, unwindowed case is the flash
    kernel (its plain version when ``reference``); ``key_mask [B, T]``,
    ALiBi and ``window`` take the plain einsum path."""
    B, T, H, D = q.shape
    if causal and key_mask is None and window is None \
            and cfg.positional != "alibi":
        if reference:
            return flash_attention_reference(q, k, v, causal=True,
                                             scale=cfg.scale)[0]
        return flash_attention(q, k, v, causal=True, scale=cfg.scale)
    k = _repeat_kv(k, H // k.shape[2])
    v = _repeat_kv(v, H // v.shape[2])
    att = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * cfg.scale
    pos = torch.arange(T, device=q.device)
    if cfg.positional == "alibi":
        slopes = _alibi(cfg, H, q.device)
        rel = (pos[None, :] - pos[:, None])[None, None]
        att = att + slopes[None, :, None, None] * rel
    if causal:
        mask = pos[:, None] >= pos[None, :]
        if window is not None:   # query i sees keys in (i-w, i]
            mask &= pos[:, None] - pos[None, :] < window
        att = att.masked_fill(~mask[None, None], NEG_INF)
    if key_mask is not None:
        att = att.masked_fill(~key_mask[:, None, None, :].bool(), NEG_INF)
    p = torch.softmax(att, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _decode_attention(q, k_cache, v_cache, live,
                      cfg: InferenceTransformerConfig, window=None):
    """One-token attention against the cache. q [B, H, D], cache
    [B, S, KH, D], ``live [B]`` = valid cache positions *including* the
    just-appended token → [B, H, D]. The decode kernel, except for ALiBi
    and windowed layers, which take the plain path, and a seq-sharded
    cache (:func:`_decode_attention_seq`)."""
    if cfg.seq_shard_kv:
        return _decode_attention_seq(q, k_cache, v_cache, live, cfg, window)
    if cfg.positional != "alibi" and window is None:
        return decode_attention(q, k_cache, v_cache, live, scale=cfg.scale)
    B, H, D = q.shape
    KH, S = k_cache.shape[2], k_cache.shape[1]
    s = torch.einsum("bhd,bshd->bhs", q.float(),
                     _repeat_kv(k_cache, H // KH).float()) * cfg.scale
    pos = torch.arange(S, device=q.device)[None, None, :]
    if cfg.positional == "alibi":
        slopes = _alibi(cfg, H, q.device)
        s = s + slopes[None, :, None] * (pos - (live - 1)[:, None, None])
    s = s.masked_fill(pos >= live[:, None, None], NEG_INF)
    if window is not None:
        s = s.masked_fill(pos <= (live - 1 - window)[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p,
                        _repeat_kv(v_cache, H // KH).float()).to(q.dtype)


def _decode_attention_seq(q, k_cache, v_cache, live,
                          cfg: InferenceTransformerConfig, window=None):
    """One-token attention over a cache whose positions are split over
    ``seq``: this rank's block is ``[r * S, (r + 1) * S)``. Each rank's
    f32 scores over its block, then the softmax merged over the group: the
    global max by all-reduce, each block's ``exp(s - max)`` sum and
    weighted values summed. A masked score is ``NEG_INF``, so a block
    with no live position weighs exactly 0."""
    B, H, D = q.shape
    KH, S = k_cache.shape[2], k_cache.shape[1]
    s = torch.einsum("bhd,bshd->bhs", q.float(),
                     _repeat_kv(k_cache, H // KH).float()) * cfg.scale
    pos = (axis_rank(SEQ) * S
           + torch.arange(S, device=q.device))[None, None, :]
    if cfg.positional == "alibi":
        slopes = _alibi(cfg, H, q.device)
        s = s + slopes[None, :, None] * (pos - (live - 1)[:, None, None])
    s = s.masked_fill(pos >= live[:, None, None], NEG_INF)
    if window is not None:
        s = s.masked_fill(pos <= (live - 1 - window)[:, None, None], NEG_INF)
    m = comm.all_reduce(s.amax(-1), comm.MAX, SEQ)
    p = torch.exp(s - m[..., None])
    den = comm.all_reduce(p.sum(-1), comm.SUM, SEQ)
    o = comm.all_reduce(torch.einsum("bhs,bshd->bhd", p, _repeat_kv(
        v_cache, H // KH).float()), comm.SUM, SEQ)
    return (o / den[..., None]).to(q.dtype)


def _paged_kernel(cfg, window) -> bool:
    """Causal, non-ALiBi, unwindowed layers take the paged kernels; the
    rest gather through the block tables (dequantizing an int8 pool) onto
    the plain path."""
    return cfg.positional != "alibi" and window is None


def _pool_scales(cache: PagedKVCache, layer_idx: int) -> dict:
    """The layer's scale tiles an int8 pool adds to a paged-kernel call
    (empty for an fp pool)."""
    if not cache.quantized:
        return {}
    return {"k_scale": cache.k_scale[layer_idx],
            "v_scale": cache.v_scale[layer_idx]}


def _paged_decode_attention(q, cache: PagedKVCache, layer_idx: int,
                            cfg: InferenceTransformerConfig, live,
                            window=None):
    """One-token attention through the paged pool. q ``[S, H, D]``,
    ``live [S]`` = valid positions including the just-appended token."""
    if _paged_kernel(cfg, window):
        return paged_decode_attention(q, cache.k[layer_idx],
                                      cache.v[layer_idx],
                                      cache.block_tables, live,
                                      scale=cfg.scale,
                                      **_pool_scales(cache, layer_idx))
    k_cache, v_cache = paged_gather_kv(cache, layer_idx)
    return _decode_attention(q, k_cache, v_cache, live, cfg, window=window)


def _bmm_f32(a, b):
    """``torch.bmm`` with an f32 result: 16-bit operands enter the GEMM as
    they are and accumulate in f32 (JAX's ``preferred_element_type``), so
    on the card neither is copied to f32 first."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _chunk_attention(q, k_cache, v_cache, lengths,
                     cfg: InferenceTransformerConfig, window=None):
    """Attention of ``q [B, K, H, D]`` at positions
    ``lengths[b]..lengths[b]+K-1`` against a cache that already holds the
    chunk's own k/v: key position s is visible to chunk query i iff
    ``s < lengths[b] + i + 1`` (the plain path of verify and chunked
    prefill).

    The cache is read where it lies, never copied or cast: row b's heads
    are one strided batch of GEMMs, scores come out in f32, and the f32
    probabilities enter P.V as their rounding to the cache's dtype plus
    the remainder, stacked into one GEMM (16 bits of P)."""
    B, K, H, D = q.shape
    KH, S = k_cache.shape[2], k_cache.shape[1]
    G = H // KH
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    k_cache, v_cache = k_cache.to(dt), v_cache.to(dt)
    # [B, KH, G*K, D]: the query rows of each kv head (a small copy)
    qg = q.to(dt).permute(0, 2, 1, 3).reshape(B, KH, G * K, D)
    s = torch.stack([_bmm_f32(qg[b], k_cache[b].permute(1, 2, 0))
                     for b in range(B)]).view(B, H, K, S) * cfg.scale
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    qpos = lengths[:, None] + torch.arange(K, device=q.device)[None, :]
    if cfg.positional == "alibi":
        slopes = _alibi(cfg, H, q.device)
        s = s + slopes[None, :, None, None] * (pos - qpos[:, None, :, None])
    s = s.masked_fill(pos >= (qpos + 1)[:, None, :, None], NEG_INF)
    if window is not None:
        s = s.masked_fill(pos <= qpos[:, None, :, None] - window, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if dt != torch.float32:
        hi = p.to(dt)
        p = torch.cat([hi, (p - hi.float()).to(dt)], dim=2)
    terms = p.shape[2] // K
    pg = p.view(B, KH, G * terms * K, S)
    o = torch.stack([_bmm_f32(pg[b], v_cache[b].transpose(0, 1))
                     for b in range(B)])
    o = o.view(B, H, terms, K, D).sum(2)
    return o.transpose(1, 2).to(q.dtype)


def _paged_verify_attention(q, cache: PagedKVCache, layer_idx: int,
                            cfg: InferenceTransformerConfig, window=None):
    """Verify attention for ALL slots: ``q [S, K, H, D]``, each slot's K
    candidates at ``lengths[s]..lengths[s]+K-1``, through the tables."""
    if _paged_kernel(cfg, window):
        return paged_verify_attention(q, cache.k[layer_idx],
                                      cache.v[layer_idx],
                                      cache.block_tables, cache.lengths,
                                      scale=cfg.scale,
                                      **_pool_scales(cache, layer_idx))
    k_cache, v_cache = paged_gather_kv(cache, layer_idx)
    return _chunk_attention(q, k_cache, v_cache, cache.lengths, cfg,
                            window=window)


def _paged_chunk_attention(q, cache: PagedKVCache, layer_idx: int,
                           cfg: InferenceTransformerConfig, slot: int,
                           start: int, window=None):
    """Chunked-prefill attention: ``q [1, C, H, D]`` at positions
    ``start..start+C-1`` attends slot ``slot``'s resident prefix and the
    chunk itself through its table row."""
    if _paged_kernel(cfg, window):
        return paged_chunk_attention(q[0], cache.k[layer_idx],
                                     cache.v[layer_idx],
                                     cache.block_tables[slot], start,
                                     scale=cfg.scale,
                                     **_pool_scales(cache, layer_idx))[None]
    k_cache, v_cache = paged_gather_slot_kv(cache, layer_idx, slot)
    return _chunk_attention(q, k_cache, v_cache,
                            torch.full((1,), start, device=q.device), cfg,
                            window=window)


# ---------------------------------------------------------------- blocks

def _qkv(x, a, cfg, positions):
    """x [..., E] → q [..., H, D], k/v [..., KH, D] with rotary applied."""
    def proj(w):
        return maybe_int8_einsum("...e,ehd->...hd", x, w, x.dtype,
                                 cfg.int8_compute, 1, 2)
    q = proj(a["wq"]) + a["bq"]
    k = proj(a["wk"]) + a["bk"]
    v = proj(a["wv"]) + a["bv"]
    if cfg.positional == "rotary":
        q = apply_rotary(q, positions, cfg.rotary_dim, cfg.rotary_base,
                         cfg.rotary_interleaved)
        k = apply_rotary(k, positions, cfg.rotary_dim, cfg.rotary_base,
                         cfg.rotary_interleaved)
    return q, k, v


def _mlp(x, m, cfg):
    """The MLP; under ``tensor`` its columns are this rank's, and the down
    projection is summed over the group before ``bo``."""
    up = maybe_int8_matmul(x, m["wi"], x.dtype, cfg.int8_compute) + m["bi"]
    if "wg" in m:
        # gated MLP (LLaMA SwiGLU): down(act(gate(x)) * up(x))
        g = maybe_int8_matmul(x, m["wg"], x.dtype, cfg.int8_compute)
        if "bg" in m:
            g = g + m["bg"]
        h = _act(g.float(), cfg.activation) * up.float()
    else:
        h = _act(up.float(), cfg.activation)
    return maybe_int8_matmul(
        h.to(x.dtype), m["wo"], x.dtype, cfg.int8_compute,
        reduce=_row_reduce(h.shape[-1] < cfg.ffn)) + m["bo"]


def _attn_out(subscripts, attn, a, dtype, cfg):
    """The attention output projection ``[..., H, D] x wo [H, D, E]``
    (summed over ``tensor`` when the heads are this rank's), plus its
    bias."""
    return maybe_int8_einsum(
        subscripts, attn, a["wo"], dtype, cfg.int8_compute, 2, 1,
        reduce=_row_reduce(attn.shape[-2] < cfg.n_head)) + a["bo"]


def _ffn(x, layer, cfg):
    if "moe" in layer:
        raise NotImplementedError(not_ported("MoE layers (_moe_mlp)"))
    return _mlp(x, layer["mlp"], cfg)


def _post_attn(x, ln1_out, attn_out, layer, cfg):
    """Residual/LN after attention (parallel-attn-mlp / pre-LN / post-LN),
    one definition for the prefill and decode blocks."""
    if cfg.parallel_attn_mlp:
        ln2 = layer.get("ln2")
        mlp_in = (_layer_norm(x, ln2, cfg.layer_norm_eps)
                  if ln2 is not None else ln1_out)
        return x + attn_out + _ffn(mlp_in, layer, cfg)
    if cfg.pre_layer_norm:
        x = x + attn_out
        return x + _ffn(_layer_norm(x, layer["ln2"], cfg.layer_norm_eps),
                        layer, cfg)
    x = _layer_norm(x + attn_out, layer["ln1"], cfg.layer_norm_eps)
    return _layer_norm(x + _ffn(x, layer, cfg), layer["ln2"],
                       cfg.layer_norm_eps)


def _window(cfg, layer_idx):
    return cfg.local_windows[layer_idx] if cfg.local_windows else None


def _block_seq(x, layer, cfg, positions, lengths, cache, layer_idx,
               causal=True, key_mask=None, reference=False, slot=None):
    """Full-sequence block (prefill). x [B, T, E]; writes the prompt's k/v
    into ``cache`` when one is given — into pool slot ``slot``'s blocks for
    a :class:`PagedKVCache` (prompt-internal attention never needs the
    pool)."""
    a = layer["attn"]
    ln1_out = _layer_norm(x, layer["ln1"], cfg.layer_norm_eps)
    h = ln1_out if cfg.pre_layer_norm else x
    q, k, v = _qkv(h, a, cfg, positions)
    if isinstance(cache, PagedKVCache):
        cache = paged_write_prompt(cache, layer_idx, k[0], v[0], slot)
    elif cache is not None:
        cache = write_prompt(cache, layer_idx, k, v, lengths,
                             offset=_seq_offset(cfg, cache))
    attn = _prefill_attention(q, k, v, cfg, causal=causal, key_mask=key_mask,
                              window=_window(cfg, layer_idx),
                              reference=reference)
    attn_out = _attn_out("...hd,hde->...e", attn, a, x.dtype, cfg)
    return _post_attn(x, ln1_out, attn_out, layer, cfg), cache


def _block_decode(x, layer, cfg, cache, layer_idx, live):
    """Single-token block. x [B, E]; appends to cache in place."""
    a = layer["attn"]
    ln1_out = _layer_norm(x, layer["ln1"], cfg.layer_norm_eps)
    h = ln1_out if cfg.pre_layer_norm else x
    q, k, v = _qkv(h, a, cfg, cache.lengths)   # new token at lengths[b]
    cache = append_token(cache, layer_idx, k, v,
                         offset=_seq_offset(cfg, cache))
    attn = _decode_attention(q, cache.k[layer_idx], cache.v[layer_idx],
                             live, cfg, window=_window(cfg, layer_idx))
    attn_out = _attn_out("bhd,hde->be", attn, a, x.dtype, cfg)
    return _post_attn(x, ln1_out, attn_out, layer, cfg), cache


def _block_chunk(x, layer, cfg, cache, layer_idx):
    """K-token verify block (speculative decoding). x ``[B, K, E]``; writes
    the chunk's k/v at ``lengths[b]..lengths[b]+K-1`` in place without
    advancing lengths."""
    a = layer["attn"]
    ln1_out = _layer_norm(x, layer["ln1"], cfg.layer_norm_eps)
    h = ln1_out if cfg.pre_layer_norm else x
    positions = cache.lengths[:, None] + torch.arange(
        x.shape[1], device=x.device)[None, :]
    q, k, v = _qkv(h, a, cfg, positions)
    cache = write_chunk(cache, layer_idx, k, v)
    attn = _chunk_attention(q, cache.k[layer_idx], cache.v[layer_idx],
                            cache.lengths, cfg,
                            window=_window(cfg, layer_idx))
    attn_out = _attn_out("...hd,hde->...e", attn, a, x.dtype, cfg)
    return _post_attn(x, ln1_out, attn_out, layer, cfg), cache


# ---------------------------------------------------------------- model

def _embed(params, cfg, ids, positions, token_type_ids=None):
    x = params["wte"][ids].to(cfg.dtype)
    if cfg.embed_scale != 1.0:   # Gemma: x * sqrt(E), head reads raw wte
        x = x * torch.tensor(cfg.embed_scale, dtype=cfg.dtype)
    if cfg.positional == "learned":
        # a position past the table (a garbage row of the pipelined server
        # loop) reads its last row, as JAX's gather clamps
        wpe = params["wpe"]
        x = x + wpe[positions.clamp(max=wpe.shape[0] - 1)].to(cfg.dtype)
    if "wtte" in params:   # BERT token-type embeddings
        tt = (token_type_ids if token_type_ids is not None
              else torch.zeros_like(ids))
        x = x + params["wtte"][tt].to(cfg.dtype)
    if "ln_emb" in params:   # BLOOM word_embeddings_layernorm / BERT's
        x = _layer_norm(x, params["ln_emb"], cfg.layer_norm_eps)
    return x


def _logits(params, cfg, x):
    head = params["wte"].T if cfg.tied_lm_head else params["lm_head"]
    out = (x @ head.to(x.dtype)).float()
    if "lm_head_bias" in params:   # GPT-J ships a biased lm_head
        out = out + params["lm_head_bias"].float()
    return out


def _seq_offset(cfg, cache: KVCache) -> Optional[int]:
    """The first position of this rank's block of a seq-sharded cache
    (None: the cache holds every position)."""
    return axis_rank(SEQ) * cache.max_seq if cfg.seq_shard_kv else None


def _check_causal(cfg):
    if cfg.num_experts > 0:
        raise NotImplementedError(not_ported("MoE layers"))


def _refuse_paged_seq(cfg):
    if cfg.seq_shard_kv:
        raise NotImplementedError(
            "paged serving with a seq-sharded KV pool is unsupported — "
            "the block pool is already the long-context memory lever")


def _causal_trunk(params, cfg, input_ids, lengths, cache, key_mask=None,
                  reference=False, slot=None):
    """Shared causal trunk: embed → blocks → final LN. ``prefill`` and
    ``causal_forward`` both run through here."""
    _check_causal(cfg)
    B, T = input_ids.shape
    positions = torch.arange(T, device=input_ids.device)[None, :].expand(
        B, T)
    x = _embed(params, cfg, input_ids, positions)
    for i, layer in enumerate(params["layers"]):
        x, cache = _block_seq(x, layer, cfg, positions, lengths, cache, i,
                              causal=True, key_mask=key_mask,
                              reference=reference, slot=slot)
    return _layer_norm(x, params["ln_f"], cfg.layer_norm_eps), cache


def prefill(params, cfg: InferenceTransformerConfig, input_ids, lengths,
            cache: KVCache):
    """Run the right-padded prompt ``[B, T]`` through the model, filling
    the cache. Returns (next-token logits ``[B, V]``, cache)."""
    x, cache = _causal_trunk(params, cfg, input_ids, lengths, cache)
    rows = torch.arange(x.shape[0], device=x.device)
    return _logits(params, cfg, x[rows, lengths.long() - 1]), cache


def decode_step(params, cfg: InferenceTransformerConfig, tokens,
                cache: KVCache):
    """One generation step: ``tokens [B]`` → (logits ``[B, V]``, cache).
    Appends k/v for the new token (in place) and advances lengths."""
    _check_causal(cfg)
    x = _embed(params, cfg, tokens[:, None], cache.lengths[:, None])[:, 0]
    live = cache.lengths + 1
    for i, layer in enumerate(params["layers"]):
        x, cache = _block_decode(x, layer, cfg, cache, i, live)
    x = _layer_norm(x, params["ln_f"], cfg.layer_norm_eps)
    return _logits(params, cfg, x), advance(cache)


def decode_chunk(params, cfg: InferenceTransformerConfig, tokens,
                 cache: KVCache):
    """Speculative verify over the dense cache: score K candidate tokens
    ``[B, K]`` in ONE forward at positions ``lengths[b]..lengths[b]+K-1``
    → (logits ``[B, K, V]``, cache). The chunk's k/v are written into the
    cache in place; lengths are NOT advanced — the caller commits the
    accepted prefix by advancing per row (rejected positions remain
    masked garbage). Attention is plain torch (f32 scores), as JAX
    computes it outside any Pallas kernel."""
    _check_causal(cfg)
    if cfg.seq_shard_kv:
        raise NotImplementedError(
            "decode_chunk with seq-sharded KV is unsupported — run "
            "speculative decoding without seq_shard_kv")
    positions = cache.lengths[:, None] + torch.arange(
        tokens.shape[1], device=tokens.device)[None, :]
    x = _embed(params, cfg, tokens, positions)
    for i, layer in enumerate(params["layers"]):
        x, cache = _block_chunk(x, layer, cfg, cache, i)
    x = _layer_norm(x, params["ln_f"], cfg.layer_norm_eps)
    return _logits(params, cfg, x), cache


# ---------------------------------------------------------------- paged

def _block_decode_paged(x, layer, cfg, cache: PagedKVCache, layer_idx,
                        live):
    """Single-token block over the paged pool. x [S, E] (one token per
    slot); appends into each slot's current block."""
    a = layer["attn"]
    ln1_out = _layer_norm(x, layer["ln1"], cfg.layer_norm_eps)
    h = ln1_out if cfg.pre_layer_norm else x
    q, k, v = _qkv(h, a, cfg, cache.lengths)
    cache = paged_append_token(cache, layer_idx, k, v)
    attn = _paged_decode_attention(q, cache, layer_idx, cfg, live,
                                   window=_window(cfg, layer_idx))
    attn_out = _attn_out("bhd,hde->be", attn, a, x.dtype, cfg)
    return _post_attn(x, ln1_out, attn_out, layer, cfg), cache


def paged_prefill(params, cfg: InferenceTransformerConfig, input_ids,
                  length: int, cache: PagedKVCache, slot: int):
    """Admit one prompt into pool slot ``slot``: run the right-padded
    ``[1, T]`` prompt through the trunk (T a multiple of the block size),
    scattering each layer's k/v into the slot's blocks, and pin
    ``lengths[slot] = length``. Returns (next-token logits ``[1, V]``,
    cache)."""
    _check_causal(cfg)
    _refuse_paged_seq(cfg)
    x, cache = _causal_trunk(params, cfg, input_ids, None, cache, slot=slot)
    cache.lengths[slot] = length
    return _logits(params, cfg, x[:, length - 1]), cache


def _block_chunk_paged(x, layer, cfg, cache: PagedKVCache, layer_idx,
                       slot: int, start: int):
    """Chunked-prefill block over the paged pool. x ``[1, C, E]`` at
    positions ``start..start+C-1``; scatters the chunk's k/v into the
    slot's blocks, then attends resident prefix + chunk through the
    table."""
    a = layer["attn"]
    ln1_out = _layer_norm(x, layer["ln1"], cfg.layer_norm_eps)
    h = ln1_out if cfg.pre_layer_norm else x
    positions = start + torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _qkv(h, a, cfg, positions)
    cache = paged_write_chunk(cache, layer_idx, k[0], v[0], slot, start)
    attn = _paged_chunk_attention(q, cache, layer_idx, cfg, slot, start,
                                  window=_window(cfg, layer_idx))
    attn_out = _attn_out("...hd,hde->...e", attn, a, x.dtype, cfg)
    return _post_attn(x, ln1_out, attn_out, layer, cfg), cache


def paged_prefill_chunk(params, cfg: InferenceTransformerConfig, input_ids,
                        start: int, length: int, cache: PagedKVCache,
                        slot: int):
    """One chunk of an incremental prefill: the C-token chunk
    ``input_ids [1, C]`` at positions ``start..start+C-1`` (block-aligned)
    runs through the trunk, scattering each layer's k/v into slot
    ``slot``'s blocks and attending the already-resident prefix through
    the table. ``lengths[slot]`` advances to ``min(start + C, length)``.
    Returns (next-token logits ``[1, V]``, cache); the logits are the
    prompt's last token's on the final chunk, the chunk tail's (discarded
    by the caller) before it."""
    _check_causal(cfg)
    _refuse_paged_seq(cfg)
    C = input_ids.shape[1]
    positions = start + torch.arange(C, device=input_ids.device)[None, :]
    x = _embed(params, cfg, input_ids, positions)
    for i, layer in enumerate(params["layers"]):
        x, cache = _block_chunk_paged(x, layer, cfg, cache, i, slot, start)
    x = _layer_norm(x, params["ln_f"], cfg.layer_norm_eps)
    cache.lengths[slot].fill_(min(start + C, length))   # no host copy
    last = min(max(length - 1 - start, 0), C - 1)
    return _logits(params, cfg, x[:, last]), cache


def _block_verify_paged(x, layer, cfg, cache: PagedKVCache, layer_idx):
    """K-token speculative-verify block over the paged pool. x
    ``[S, K, E]``; writes each slot's chunk k/v at ``lengths[s]..
    lengths[s]+K-1`` through the tables without advancing lengths."""
    a = layer["attn"]
    ln1_out = _layer_norm(x, layer["ln1"], cfg.layer_norm_eps)
    h = ln1_out if cfg.pre_layer_norm else x
    positions = cache.lengths[:, None] + torch.arange(
        x.shape[1], device=x.device)[None, :]
    q, k, v = _qkv(h, a, cfg, positions)
    cache = paged_write_tokens(cache, layer_idx, k, v)
    attn = _paged_verify_attention(q, cache, layer_idx, cfg,
                                   window=_window(cfg, layer_idx))
    attn_out = _attn_out("...hd,hde->...e", attn, a, x.dtype, cfg)
    return _post_attn(x, ln1_out, attn_out, layer, cfg), cache


def paged_verify_step(params, cfg: InferenceTransformerConfig, tokens,
                      cache: PagedKVCache):
    """Speculative verify for ALL resident slots: score each slot's K
    candidates ``tokens [S, K]`` in one forward at positions
    ``lengths[s]..lengths[s]+K-1`` → (logits ``[S, K, V]``, cache). The
    chunk's k/v are written through the tables; lengths are NOT advanced —
    the caller commits the accepted prefix."""
    _check_causal(cfg)
    _refuse_paged_seq(cfg)
    positions = cache.lengths[:, None] + torch.arange(
        tokens.shape[1], device=tokens.device)[None, :]
    x = _embed(params, cfg, tokens, positions)
    for i, layer in enumerate(params["layers"]):
        x, cache = _block_verify_paged(x, layer, cfg, cache, i)
    x = _layer_norm(x, params["ln_f"], cfg.layer_norm_eps)
    return _logits(params, cfg, x), cache


def paged_decode_step(params, cfg: InferenceTransformerConfig, tokens,
                      cache: PagedKVCache, active):
    """One generation step for ALL resident slots: ``tokens [S]`` →
    (logits ``[S, V]``, cache). Appends each slot's token at
    ``lengths[s]`` and advances only ``active`` slots — idle slots stay at
    length 0, writing into the null block."""
    _check_causal(cfg)
    x = _embed(params, cfg, tokens[:, None], cache.lengths[:, None])[:, 0]
    live = cache.lengths + 1
    for i, layer in enumerate(params["layers"]):
        x, cache = _block_decode_paged(x, layer, cfg, cache, i, live)
    x = _layer_norm(x, params["ln_f"], cfg.layer_norm_eps)
    return _logits(params, cfg, x), paged_advance(cache, active)


def causal_forward(params, cfg: InferenceTransformerConfig, input_ids,
                   attention_mask=None, reference_attention: bool = False):
    """Full-sequence logits ``[B, T, V]`` (hidden states when
    ``cfg.head == "none"``). ``attention_mask [B, T]`` masks pad keys.
    ``reference_attention`` takes the flash kernel's plain version
    instead of the kernel, so a run on the card can hold the kernels'
    decode path against a forward that runs through no kernel."""
    x, _ = _causal_trunk(params, cfg, input_ids, None, None,
                         key_mask=attention_mask,
                         reference=reference_attention)
    if cfg.head == "none":
        return x
    return _logits(params, cfg, x)


def encoder_forward(params, cfg: InferenceTransformerConfig, input_ids,
                    attention_mask=None, token_type_ids=None):
    """Bidirectional encoder forward (the BERT and DistilBERT policies'
    post-LN trees): final hidden states ``[B, T, E]``. ``attention_mask
    [B, T]`` masks pad keys (default: none masked); with a key mask,
    attention takes the plain path, as in JAX."""
    B, T = input_ids.shape
    positions = torch.arange(T, device=input_ids.device)[None, :].expand(
        B, T)
    x = _embed(params, cfg, input_ids, positions, token_type_ids)
    mask = (attention_mask if attention_mask is not None
            else torch.ones((B, T), dtype=torch.int32,
                            device=input_ids.device))
    for i, layer in enumerate(params["layers"]):
        x, _ = _block_seq(x, layer, cfg, positions, None, None, i,
                          causal=False, key_mask=mask)
    if cfg.pre_layer_norm:
        x = _layer_norm(x, params["ln_f"], cfg.layer_norm_eps)
    return x
