"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False: a hand-written CUDA kernel has no
CPU mode. The file imports no JAX (nor the tests' conftest, which does), so
it runs on the GPU machine as it is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerances: bf16/fp16 outputs are compared at 2e-2 for flash attention and
the paged chunk kernel (the output is rounded to 16 bits and the kernel
rounds q.scale and P to the storage dtype before its products, so the two
may land one rounding step apart) and 1e-2 for the dense and paged decode
and verify kernels (f32 math on both sides, output rounded); f32 inputs at
1e-4 (only the order of the sums differs); the f32 LSE at 1e-3 for 16-bit
inputs. The int8 variants of the paged kernels are held to the same limits
against their plain versions over the same int8 pool (the plain versions
dequantize it up front; the kernels fold the scales into the score and P).
The flash backward kernels (B2 dq, B3 dk/dv) are held, as in
``chip_smoke.py``, element-wise to ``atol + rtol * |plain|`` (2e-2 and 1e-2
in bf16 and fp16: the outputs land one or two 16-bit rounding steps apart
where the two sides' exp or dot differ in the last bits) and to 1e-2
relative L2 over each tile of 64 positions along T (late rows and keys of
a causal sequence hold values ~20x smaller than the first, so a skipped or
mis-masked tile reads ~1 there; the sums in another order read ~1e-4); in
f32 to 1e-4 on all three.
The block-sparse kernel (B8) is held to 2e-2 in bf16/fp16 (as flash
attention) and 1e-4 in f32, and to 1e-2 (f32: 1e-4) relative L2 over each
tile of 64 rows (late rows of a long sparse sequence are small, so a wrong
block can hide inside the absolute limit); rows that see no key must be
exactly 0. The
LayerNorm kernels (B9, B10): o and dx element-wise within 2e-2 + 1e-2 *
|plain| in 16 bits (one or two rounding steps of outputs up to ~4) and 1e-4
in f32; mean and rstd 1e-5 relative (f32 on both sides); dw and db 1e-4
relative L2 (f32 sums over the rows in another order); B10 twice on the
same inputs gives the same bits, also on rows wider than 8192 (N 20000,
65544, 100000 at R 1, 3 and 8192: its wide kernel).
Head dims: every attention kernel also runs at D in {32, 40, 48, 80, 96,
112} (int8 pools: {32, 48, 80, 96}) on its 64- or 128-wide instantiation,
under the same limits, on inputs that are ``[..., :D]`` views of
``[..., DK + 16]`` buffers whose guard columns hold NaN (a load past D
poisons the result), every head of the packed output held to the plain
version, and the same bits on a second call; B8 also writes into a
NaN-guarded view, whose guard columns must stay NaN. D = 36 takes the
padded route. The serving kernels (B1, B4-B7 and B5i-B7i) also run at D
in {136, 160, 192, 256} on their 256-wide instantiation, and at 256 with 8
q heads on one kv head (Gemma-2B's layout), under the same limits and
guards; D = 132 takes their padded route. The flash backward (B2, B3)
and B8 run at D in {136, 160, 192, 256} the same way (B2/B3 also with one
and with four kv heads at 256, B8 at 256 over blocks of 16, 32, 64 and
128); every kernel raises above 256 (D1c).
"""
import pytest
import torch

from deepspeed_tpu_torch.ops import block_sparse_attention as port_bsa
from deepspeed_tpu_torch.ops import decode_attention as port_decode
from deepspeed_tpu_torch.ops import flash_attention as port_flash
from deepspeed_tpu_torch.ops import layer_norm as port_ln
from deepspeed_tpu_torch.ops import quant_core as port_quant
from deepspeed_tpu_torch.ops import sparse_attention as port_sparse
from deepspeed_tpu_torch.ops.head_dim import head_dim_route


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(g, shape, dtype):
    return torch.randn(shape, generator=g, device=g.device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,T,H,KH,D,dtype", [
    (True, 1024, 25, 25, 64, torch.bfloat16),    # GPT-2 XL prefill
    (True, 1000, 32, 8, 128, torch.bfloat16),    # GQA, ragged T
    (False, 300, 4, 4, 64, torch.bfloat16),      # full attention
    (True, 77, 8, 2, 64, torch.float16),
    (True, 1, 4, 4, 128, torch.bfloat16),        # one token
    # around the 128-row q tile and 128-key K/V tile
    (True, 127, 4, 4, 64, torch.bfloat16),
    (True, 128, 4, 4, 128, torch.bfloat16),
    (True, 129, 4, 4, 64, torch.bfloat16),
    (False, 257, 4, 4, 128, torch.bfloat16),
    (True, 1024, 16, 16, 128, torch.bfloat16),   # GPT-2 1.3B training
    (True, 300, 8, 8, 128, torch.float16),       # fp16 at D=128
    (True, 512, 8, 2, 64, torch.bfloat16),       # GQA, KH=2
])
def test_flash_kernel_matches_plain_on_card(cuda_device, causal, T, H, KH, D,
                                            dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = _randn(g, (2, T, H, D), dtype)
    k = _randn(g, (2, T, KH, D), dtype)
    v = _randn(g, (2, T, KH, D), dtype)
    n = port_flash.flash_attention_fwd.launches
    o, lse = port_flash.flash_attention_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = port_flash.flash_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert port_flash.flash_attention_fwd.launches == n + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    o32, lse32 = port_flash.flash_attention_fwd(q.float(), k.float(),
                                                v.float(), causal=causal)
    r32, l32 = port_flash.flash_attention_reference(q.float(), k.float(),
                                                    v.float(), causal)
    assert (o32 - r32).abs().max().item() <= 1e-4
    assert (lse32 - l32).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_flash_kernel_reads_strided_qkv(cuda_device):
    """q/k/v as views into one fused projection output, as a model may
    hand them over: the kernel reads them through their strides."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = _randn(g, (2, 200, 3, 8, 64), torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o = port_flash.flash_attention(q, k, v)
    ref, _ = port_flash.flash_attention_reference(q.contiguous(),
                                                  k.contiguous(),
                                                  v.contiguous())
    assert (o.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_flash_kernel_reads_fused_projection_views(cuda_device):
    """q/k/v as ``split`` views of one [B, T, 3 H D] projection at D=128,
    as ``models/gpt2.py`` makes them (strides (T 3C, 3C, D, 1))."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    B, T, H, D = 2, 1024, 16, 128
    qkv = _randn(g, (B, T, 3 * H * D), torch.bfloat16)
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    assert q.stride() == (T * 3 * H * D, 3 * H * D, D, 1)
    o, lse = port_flash.flash_attention_fwd(q, k, v)
    ref, lse_ref = port_flash.flash_attention_reference(
        q.contiguous(), k.contiguous(), v.contiguous())
    assert (o.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("H,KH,D,dtype", [(25, 25, 64, torch.bfloat16),
                                          (32, 8, 128, torch.bfloat16),
                                          (8, 4, 64, torch.float16),
                                          (8, 1, 128, torch.float32)])
def test_decode_kernel_matches_plain_on_card(cuda_device, H, KH, D, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    B, S = 4, 1024
    # the layer view of a 2-layer cache, as the model passes it
    kc = _randn(g, (2, B, S, KH, D), dtype)[1]
    vc = _randn(g, (2, B, S, KH, D), dtype)[1]
    q = _randn(g, (B, H, D), dtype)
    lens = torch.tensor([0, 1, 517, S], dtype=torch.int32,
                        device=cuda_device)
    n = port_decode.decode_attention.launches
    out = port_decode.decode_attention(q, kc, vc, lens)
    ref = port_decode.decode_attention_reference(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert port_decode.decode_attention.launches == n + 1
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 7, 8, 12, 16])
def test_decode_kernel_takes_any_group_on_card(cuda_device, R, D, dtype):
    """B4 at any R = H / KH (units of up to 8 query rows: R = 12 and 16
    take two), over the layer view of a 5-D cache, with lengths 0, 1, 63,
    64, 65, S - 1 and S in one batch (splits empty, partial and full), and
    the same bits on a second call."""
    g = torch.Generator(device=cuda_device).manual_seed(R * 10 + D)
    KH, S = 2, 1000
    lens = torch.tensor([0, 1, 63, 64, 65, S - 1, S], dtype=torch.int32,
                        device=cuda_device)
    B = lens.numel()
    kc = _randn(g, (2, B, S, KH, D), dtype)[1]
    vc = _randn(g, (2, B, S, KH, D), dtype)[1]
    q = _randn(g, (B, KH * R, D), dtype)
    n = port_decode.decode_attention.launches
    out = port_decode.decode_attention(q, kc, vc, lens)
    again = port_decode.decode_attention(q, kc, vc, lens)
    ref = port_decode.decode_attention_reference(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert port_decode.decode_attention.launches == n + 2
    assert torch.equal(out, again)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q = _randn(g, (1, 16, 2, 48), torch.bfloat16)     # head dim 48: taken
    out = port_flash.flash_attention(q, q, q)
    ref, _ = port_flash.flash_attention_reference(q, q, q)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    q = _randn(g, (1, 16, 2, 256), torch.bfloat16)    # head dim 256: taken
    out = port_flash.flash_attention(q, q, q)
    ref, lse = port_flash.flash_attention_reference(q, q, q)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    dq, _ = port_flash.flash_attention_bwd_dq(q, q, q, ref, lse, q)
    rq, _ = port_flash._bwd_dq_reference(q, q, q, ref, lse, q, True,
                                         256 ** -0.5)   # and by B2
    assert (dq.float() - rq.float()).abs().max().item() <= 2e-2 + 1e-2 * (
        rq.float().abs().max().item())
    q = _randn(g, (1, 16, 2, 320), torch.bfloat16)    # head dim 320: D1c
    with pytest.raises(ValueError, match="D1c"):
        port_flash.flash_attention(q, q, q)
    q = _randn(g, (2, 12, 64), torch.bfloat16)
    kc = _randn(g, (2, 32, 1, 64), torch.bfloat16)    # a group of 12: taken
    lens = torch.tensor([5, 32], dtype=torch.int32, device=cuda_device)
    out = port_decode.decode_attention(q, kc, kc, lens)
    ref = port_decode.decode_attention_reference(q, kc, kc, lens)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    kc = _randn(g, (2, 32, 12, 64), torch.bfloat16)
    with pytest.raises(TypeError, match="int32"):
        port_decode.decode_attention(
            q, kc, kc, torch.ones(2, dtype=torch.int64, device=cuda_device))


@pytest.mark.cuda
def test_generate_on_card_runs_through_the_kernels(cuda_device):
    """A small bf16 model through init_inference -> generate: one flash
    launch per layer for the prefill, one decode launch per layer and
    step."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.model_implementations.transformer import (
        InferenceTransformerConfig, init_params)
    cfg = InferenceTransformerConfig(vocab_size=512, n_positions=256,
                                     n_embd=256, n_layer=2, n_head=4)
    params = init_params(torch.Generator(device=cuda_device).manual_seed(0),
                         cfg)
    eng = deepspeed_tpu_torch.init_inference((cfg, params), dtype="bf16")
    prompts = [[1, 2, 3], list(range(100)), [7] * 40]
    port_flash.flash_attention_fwd.launches = 0
    port_decode.decode_attention.launches = 0
    out = eng.generate(prompts, max_new_tokens=6)
    assert port_flash.flash_attention_fwd.launches == cfg.n_layer
    assert port_decode.decode_attention.launches == cfg.n_layer * 5
    for row, p in zip(out, prompts):
        assert row[:len(p)] == p and len(row) == len(p) + 6
        assert all(0 <= t < cfg.vocab_size for t in row)


@pytest.mark.cuda
def test_generate_decode_steps_add_no_host_sync_on_card(cuda_device):
    """``generate``'s decode steps under set_sync_debug_mode("error"): the
    dense decode wrapper, its split plan and its scratch read nothing back
    from the device."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.model_implementations.transformer import (
        InferenceTransformerConfig, decode_step, init_params, prefill)
    cfg = InferenceTransformerConfig(vocab_size=512, n_positions=256,
                                     n_embd=256, n_layer=2, n_head=4)
    params = init_params(torch.Generator(device=cuda_device).manual_seed(0),
                         cfg)
    eng = deepspeed_tpu_torch.init_inference((cfg, params), dtype="bf16")
    ids = torch.zeros((2, 128), dtype=torch.long, device=cuda_device)
    ids[0, :3] = torch.tensor([1, 2, 3])
    ids[1, :100] = torch.arange(100)
    lens = torch.tensor([3, 100], device=cuda_device)
    cache = eng._make_cache(2, 256)
    with torch.inference_mode():
        lg, cache = prefill(eng.params, eng.model_config, ids, lens, cache)
        tok = lg.argmax(-1)
        lg, cache = decode_step(eng.params, eng.model_config, tok, cache)
        torch.cuda.synchronize()
        n = port_decode.decode_attention.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                lg, cache = decode_step(eng.params, eng.model_config,
                                        lg.argmax(-1), cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert port_decode.decode_attention.launches == n + 3 * cfg.n_layer
    assert bool(torch.isfinite(lg.float()).all())


# --------------------------------------------------------- flash backward

def _bwd_case(g, B, T, H, KH, D, dtype, causal, strided=False):
    """q/k/v (views of one fused projection when ``strided``), the
    forward's o and lse, and a seeded output gradient."""
    if strided:
        assert H == KH
        qkv = _randn(g, (B, T, 3 * H * D), dtype)
        q, k, v = (x.reshape(B, T, H, D) for x in qkv.split(H * D, -1))
    else:
        q, k, v = (_randn(g, (B, T, h, D), dtype) for h in (H, KH, KH))
    o, lse = port_flash.flash_attention_fwd(q, k, v, causal=causal)
    do = _randn(g, (B, T, H, D), dtype)
    return q, k, v, o, lse, do


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _bwd_errors(a, r, atol, rtol, tile=64):
    """``(worst element's share of atol + rtol*|r|, worst relative L2
    over tiles of ``tile`` positions along T)``; a tile whose plain rms is
    below ``atol / 10`` is measured against that floor."""
    a, r = a.float(), r.float()
    d = a - r
    d2, r2 = d.square().sum((0, 2, 3)), r.square().sum((0, 2, 3))
    pad = -d2.numel() % tile
    d2, r2 = (torch.nn.functional.pad(x, (0, pad)).view(-1, tile).sum(1)
              for x in (d2, r2))
    floor = (atol / 10) ** 2 * r.numel() / r.shape[1] * tile
    return ((d.abs() / (atol + rtol * r.abs())).max().item(),
            (d2 / r2.clamp_min(floor)).sqrt().max().item())


BWD_CASES = [
    (2, 1024, 16, 16, 128, torch.bfloat16, True, True),    # 1.3B, strided
    (2, 1024, 25, 25, 64, torch.bfloat16, True, False),    # GPT-2 XL
    (1, 1024, 32, 8, 128, torch.bfloat16, True, False),    # GQA
    (2, 1000, 16, 16, 128, torch.bfloat16, True, False),   # ragged T
    (2, 300, 8, 8, 64, torch.bfloat16, False, False),      # full attention
    (2, 77, 8, 2, 64, torch.float16, True, False),
    (1, 130, 4, 4, 128, torch.float32, True, False),
    (1, 1, 4, 4, 64, torch.bfloat16, True, False),         # one token
    # around the Hopper kernels' tiles: 64-row boxes, 128-row blocks
    (1, 63, 4, 4, 128, torch.bfloat16, True, False),
    (1, 64, 4, 4, 128, torch.bfloat16, True, False),
    (1, 65, 4, 4, 128, torch.bfloat16, True, False),
    (1, 127, 4, 4, 128, torch.bfloat16, True, False),
    (1, 128, 4, 4, 128, torch.bfloat16, True, False),
    (1, 129, 4, 4, 128, torch.bfloat16, True, False),
    (2, 257, 4, 4, 128, torch.bfloat16, True, False),
    (1, 129, 4, 2, 128, torch.bfloat16, False, False),    # ragged, full
    (2, 256, 8, 8, 128, torch.float16, True, True),       # fp16, strided
    (1, 512, 16, 4, 128, torch.bfloat16, True, False),    # GQA, rep 4
    (2, 256, 8, 1, 64, torch.bfloat16, True, False),      # MQA
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KH,D,dtype,causal,strided", BWD_CASES)
def test_flash_bwd_kernels_match_plain_on_card(cuda_device, B, T, H, KH, D,
                                               dtype, causal, strided):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, o, lse, do = _bwd_case(g, B, T, H, KH, D, dtype, causal,
                                    strided)
    n_dq = port_flash.flash_attention_bwd_dq.launches
    n_dkv = port_flash.flash_attention_bwd_dkv.launches
    dq, dk, dv = port_flash.flash_attention_bwd(q, k, v, o, lse, do, causal)
    rq, rk, rv = port_flash.flash_attention_bwd_reference(q, k, v, o, lse,
                                                          do, causal)
    torch.cuda.synchronize()
    assert port_flash.flash_attention_bwd_dq.launches == n_dq + 1
    assert port_flash.flash_attention_bwd_dkv.launches == n_dkv + 1
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    atol, rtol, l2 = ((1e-4, 1e-4, 1e-4) if dtype == torch.float32
                      else (2e-2, 1e-2, 1e-2))
    for name, a, r in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert a.dtype == dtype and bool(torch.isfinite(a).all()), name
        elem, tile_l2 = _bwd_errors(a, r, atol, rtol)
        assert elem <= 1.0 and tile_l2 <= l2, (name, elem, tile_l2,
                                               _rel(a, r))


@pytest.mark.cuda
@pytest.mark.parametrize("H,KH,D", [(16, 16, 128), (16, 4, 128), (8, 8, 64)])
def test_flash_bwd_kernels_are_bit_stable_on_card(cuda_device, H, KH, D):
    """B2 and B3 take no atomics across blocks (the GQA group sum stays in
    the block that owns the key tile): two runs on the same inputs give the
    same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, o, lse, do = _bwd_case(g, 2, 1000, H, KH, D, torch.bfloat16,
                                    True, H == KH)
    runs = []
    for _ in range(2):
        dq, delta = port_flash.flash_attention_bwd_dq(q, k, v, o, lse, do)
        dk, dv = port_flash.flash_attention_bwd_dkv(q, k, v, lse, delta, do)
        runs.append((dq, delta, dk, dv))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "delta", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_autograd_function_on_card(cuda_device):
    """FlashAttentionFunction: the forward kernel, then B2 and B3, against
    autograd through the plain forward."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v, _, _, do = _bwd_case(g, 2, 256, 8, 4, 64, torch.bfloat16, True)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = port_flash.FlashAttentionFunction.apply(*leaves, True, 0.125)
    grads = torch.autograd.grad(out, leaves, do)
    ref = [x.detach().float().requires_grad_() for x in (q, k, v)]
    o_ref, _ = port_flash.flash_attention_reference(*ref, True, 0.125)
    rgrads = torch.autograd.grad(o_ref, ref, do.float())
    for a, r in zip(grads, rgrads):
        assert _rel(a, r) <= 2e-2


@pytest.mark.cuda
def test_train_batch_on_card_runs_through_the_kernels(cuda_device):
    """A small bf16 GPT-2 through initialize -> train_batch: per micro-batch
    one forward launch per layer and one more under remat, one dq and one
    dk/dv launch per layer; the loss falls on a repeated batch."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMModel
    from deepspeed_tpu_torch.ops import decode_attention as da
    cfg = GPT2Config(vocab_size=500, n_positions=256, n_embd=256, n_layer=2,
                     n_head=2)
    model = GPT2LMModel(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, config={
            "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
            "bf16": {"enabled": True},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})
    ids = np.random.default_rng(0).integers(0, 500, (4, 256), np.int32)
    fns = (port_flash.flash_attention_fwd, port_flash.flash_attention_bwd_dq,
           port_flash.flash_attention_bwd_dkv, da.decode_attention)
    for f in fns:
        f.launches = 0
    metrics = [engine.train_batch({"input_ids": ids}) for _ in range(2)]
    # a bf16 step reads nothing back from the device
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics.append(engine.train_batch({"input_ids": ids}))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    losses = [float(m["loss"]) for m in metrics]
    fwd, dq, dkv, dec = (f.launches for f in fns)
    assert fwd == 2 * 2 * 2 * 3 and dq == dkv == 2 * 2 * 3 and dec == 0
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ------------------------------------------------------------------ paged

def _paged_case(g, dtype, H, KH, D, NB=40, BS=32, MB=8, S=4):
    """Pools as the layer view of a 2-layer pool; shuffled tables with a
    shared first block (slots 0 and 1) and dead entries at block 0."""
    kp = _randn(g, (2, NB, BS, KH, D), dtype)[1]
    vp = _randn(g, (2, NB, BS, KH, D), dtype)[1]
    perm = torch.randperm(NB - 1, generator=torch.Generator().manual_seed(0))
    ids = (perm + 1).tolist()
    lens = [1, 77, BS * MB - 5, 0][:S]
    tables = torch.zeros((S, MB), dtype=torch.int32)
    for s_, n in enumerate(lens):
        for j in range(-(-(n + 4) // BS)):
            tables[s_, j] = tables[0, j] if s_ == 1 and j == 0 else ids.pop()
    dev = g.device
    return (kp, vp, tables.to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


PAGED_CASES = [(torch.bfloat16, 25, 25, 64, 128), (torch.bfloat16, 32, 8,
                                                   128, 32),
               (torch.float16, 8, 2, 64, 32), (torch.float32, 8, 1, 128, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,KH,D,BS", PAGED_CASES)
def test_paged_decode_and_verify_kernels_match_plain_on_card(
        cuda_device, dtype, H, KH, D, BS):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    kp, vp, tables, lens = _paged_case(g, dtype, H, KH, D, BS=BS,
                                       MB=256 // BS)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    q = _randn(g, (4, H, D), dtype)
    n = port_decode.paged_decode_attention.launches
    out = port_decode.paged_decode_attention(q, kp, vp, tables, lens)
    ref = port_decode.paged_decode_attention_reference(q, kp, vp, tables,
                                                       lens)
    torch.cuda.synchronize()
    assert port_decode.paged_decode_attention.launches == n + 1
    assert torch.equal(out[3], torch.zeros_like(out[3]))   # length 0
    assert (out.float() - ref.float()).abs().max().item() <= tol
    for K in (1, 4, 5):
        qv = _randn(g, (4, K, H, D), dtype)
        out = port_decode.paged_verify_attention(qv, kp, vp, tables, lens)
        ref = port_decode.paged_verify_attention_reference(qv, kp, vp,
                                                           tables, lens)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,KH,D,BS", PAGED_CASES)
def test_paged_chunk_kernel_matches_plain_on_card(cuda_device, dtype, H, KH,
                                                  D, BS):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    kp, vp, tables, _ = _paged_case(g, dtype, H, KH, D, BS=BS, MB=256 // BS)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    row = tables[2]
    for start, C in ((0, 64), (BS, 96), (256 - BS, 64)):   # last: past row
        qc = _randn(g, (C, H, D), dtype)
        n = port_decode.paged_chunk_attention.launches
        out = port_decode.paged_chunk_attention(qc, kp, vp, row, start)
        ref = port_decode.paged_chunk_attention_reference(qc, kp, vp, row,
                                                          start)
        torch.cuda.synchronize()
        assert port_decode.paged_chunk_attention.launches == n + 1
        assert (out.float() - ref.float()).abs().max().item() <= tol


def _int8_pool(p):
    """An int8 pool [NB, BS, KH, D] quantized per (position, head) row from
    ``p``, and its scale tiles [NB, KH, BS] (block dim contiguous)."""
    q, s = port_quant.quantize_int8(p, -1)
    return q, s[..., 0].transpose(1, 2).contiguous()


PAGED_INT8_CASES = PAGED_CASES + [(torch.float16, 25, 25, 64, 128),
                                  (torch.float32, 8, 2, 64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,KH,D,BS", PAGED_INT8_CASES)
def test_paged_int8_decode_and_verify_kernels_match_plain_on_card(
        cuda_device, dtype, H, KH, D, BS):
    g = torch.Generator(device=cuda_device).manual_seed(13)
    kp, vp, tables, lens = _paged_case(g, dtype, H, KH, D, BS=BS,
                                       MB=256 // BS)
    (kq, ks), (vq, vs) = _int8_pool(kp), _int8_pool(vp)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    q = _randn(g, (4, H, D), dtype)
    n = port_decode.paged_decode_attention_int8.launches
    n_fp = port_decode.paged_decode_attention.launches
    out = port_decode.paged_decode_attention(q, kq, vq, tables, lens,
                                             k_scale=ks, v_scale=vs)
    ref = port_decode.paged_decode_attention_reference(
        q, kq, vq, tables, lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert port_decode.paged_decode_attention_int8.launches == n + 1
    assert port_decode.paged_decode_attention.launches == n_fp
    assert torch.equal(out[3], torch.zeros_like(out[3]))   # length 0
    assert (out.float() - ref.float()).abs().max().item() <= tol
    for K in (1, 4, 5):
        qv = _randn(g, (4, K, H, D), dtype)
        out = port_decode.paged_verify_attention_int8(qv, kq, vq, tables,
                                                      lens, ks, vs)
        ref = port_decode.paged_verify_attention_reference(
            qv, kq, vq, tables, lens, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,KH,D,BS", PAGED_INT8_CASES)
def test_paged_int8_chunk_kernel_matches_plain_on_card(cuda_device, dtype, H,
                                                       KH, D, BS):
    g = torch.Generator(device=cuda_device).manual_seed(14)
    kp, vp, tables, _ = _paged_case(g, dtype, H, KH, D, BS=BS, MB=256 // BS)
    (kq, ks), (vq, vs) = _int8_pool(kp), _int8_pool(vp)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    row = tables[2]
    for start, C in ((0, 64), (BS, 96), (256 - BS, 64)):   # last: past row
        qc = _randn(g, (C, H, D), dtype)
        n = port_decode.paged_chunk_attention_int8.launches
        out = port_decode.paged_chunk_attention(qc, kq, vq, row, start,
                                                k_scale=ks, v_scale=vs)
        ref = port_decode.paged_chunk_attention_reference(
            qc, kq, vq, row, start, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert port_decode.paged_chunk_attention_int8.launches == n + 1
        assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_paged_int8_wrappers_refuse_what_the_kernels_do_not_take(
        cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(15)
    kp, vp, tables, lens = _paged_case(g, torch.bfloat16, 4, 4, 64)
    kq, ks = _int8_pool(kp)
    q = _randn(g, (4, 4, 64), torch.bfloat16)
    with pytest.raises(TypeError, match="float32 scale"):
        port_decode.paged_decode_attention(q, kq, kq, tables, lens,
                                           k_scale=ks.half(),
                                           v_scale=ks.half())
    with pytest.raises(TypeError, match="float32 scale"):
        port_decode.paged_decode_attention(
            q, kq, kq, tables, lens, k_scale=ks.transpose(1, 2).contiguous()
            .transpose(1, 2), v_scale=ks)
    with pytest.raises(ValueError, match="require k_scale"):
        port_decode.paged_decode_attention(q, kq, kq, tables, lens)


@pytest.mark.cuda
def test_paged_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    kp, vp, tables, lens = _paged_case(g, torch.bfloat16, 4, 4, 64)
    with pytest.raises(TypeError, match="int32"):
        port_decode.paged_decode_attention(
            _randn(g, (4, 4, 64), torch.bfloat16), kp, vp, tables.long(),
            lens)
    kp48 = _randn(g, (40, 32, 4, 48), torch.bfloat16)   # head dim 48: taken
    q48 = _randn(g, (4, 2, 4, 48), torch.bfloat16)
    out = port_decode.paged_verify_attention(q48, kp48, kp48, tables, lens)
    ref = port_decode.paged_verify_attention_reference(q48, kp48, kp48,
                                                       tables, lens)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    kp320 = _randn(g, (40, 32, 4, 320), torch.bfloat16)
    with pytest.raises(ValueError, match="D1c"):
        port_decode.paged_verify_attention(
            _randn(g, (4, 2, 4, 320), torch.bfloat16), kp320, kp320, tables,
            lens)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [{}, {"enable_prefix_caching": True,
                                        "prefill_chunk_tokens": 64},
                                   {"speculation_tokens": 4}])
def test_server_on_card_runs_through_the_paged_kernels(cuda_device, knobs):
    """A small bf16 model through ContinuousBatchingServer: one kernel
    launch per layer and program, never the dense decode kernel."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import ContinuousBatchingServer
    from deepspeed_tpu_torch.model_implementations.transformer import (
        InferenceTransformerConfig, init_params)
    cfg = InferenceTransformerConfig(vocab_size=512, n_positions=256,
                                     n_embd=256, n_layer=2, n_head=4)
    params = init_params(torch.Generator(device=cuda_device).manual_seed(0),
                         cfg)
    eng = deepspeed_tpu_torch.init_inference(
        (cfg, params), dtype="bf16", max_out_tokens=256, block_size=32,
        num_slots=2, **knobs)
    prompts = [[1, 2, 3], list(range(100)), [7] * 40, list(range(70))]
    fns = (port_flash.flash_attention_fwd, port_decode.decode_attention,
           port_decode.paged_decode_attention,
           port_decode.paged_chunk_attention,
           port_decode.paged_verify_attention)
    for f in fns:
        f.launches = 0
    srv = ContinuousBatchingServer(eng)
    ids = [srv.submit(p, max_new_tokens=6) for p in prompts]
    out = srv.drain()
    flash, dense, dec, chunk, ver = (f.launches for f in fns)
    st = srv.stats
    srv.close()
    steps = st["decode_steps"] + st["async_loop"]["garbage_steps"]
    assert dense == 0
    assert chunk == cfg.n_layer * st["prefill_chunks"]
    if knobs.get("prefill_chunk_tokens"):
        assert flash == 0 and chunk > 0
    else:
        assert flash == cfg.n_layer * st["prefills"] > 0
    if knobs.get("speculation_tokens"):
        assert ver == cfg.n_layer * steps > 0 and dec == 0
    else:
        assert dec == cfg.n_layer * steps > 0 and ver == 0
    for rid, p in zip(ids, prompts):
        assert out[rid][:len(p)] == p and len(out[rid]) == len(p) + 6
        assert all(0 <= t < cfg.vocab_size for t in out[rid])


@pytest.mark.cuda
def test_int8_offload_server_on_card_runs_through_the_int8_kernels(
        cuda_device):
    """A small bf16 model through an int8 server with prefix caching,
    64-token chunks and the host tier, under pool pressure: the int8
    kernels run (one launch per layer and program), the fp paged kernels
    never, blocks demote and swap back in."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import ContinuousBatchingServer
    from deepspeed_tpu_torch.model_implementations.transformer import (
        InferenceTransformerConfig, init_params)
    cfg = InferenceTransformerConfig(vocab_size=512, n_positions=256,
                                     n_embd=256, n_layer=2, n_head=4)
    params = init_params(torch.Generator(device=cuda_device).manual_seed(0),
                         cfg)
    eng = deepspeed_tpu_torch.init_inference(
        (cfg, params), dtype="bf16", max_out_tokens=128, block_size=32,
        num_slots=2, kv_cache_dtype="int8", enable_prefix_caching=True,
        prefill_chunk_tokens=64, kv_host_offload=True)
    fns = (port_decode.paged_decode_attention,
           port_decode.paged_chunk_attention,
           port_decode.paged_decode_attention_int8,
           port_decode.paged_chunk_attention_int8)
    for f in fns:
        f.launches = 0
    srv = ContinuousBatchingServer(eng)
    prefixes = [[1 + (s * 7 + i) % 500 for i in range(96)] for s in range(3)]
    outs = []
    for i in range(6):
        p = prefixes[i % 3] + [7 + i, 9]
        rid = srv.submit(p, max_new_tokens=4)
        out = srv.drain()[rid]
        assert out[:len(p)] == p and len(out) == len(p) + 4
        outs.append(out)
    dec, chunk, dec8, chunk8 = (f.launches for f in fns)
    st = srv.stats
    srv.close()
    steps = st["decode_steps"] + st["async_loop"]["garbage_steps"]
    assert dec == chunk == 0
    assert chunk8 == cfg.n_layer * st["prefill_chunks"] > 0
    assert dec8 == cfg.n_layer * steps > 0
    assert st["kv_tier"]["demotions"] > 0 and st["kv_tier"]["swap_ins"] > 0
    assert st["prefix_cache_evictions"] == st["preempted"] == 0


def _split_edge_case(g, dtype, H, KH, D, BS, span=1024):
    """Lengths 0, 1, BS-1, BS, BS+1 and MB*BS in one batch over ``span``
    keys a slot, so the paged decode kernel's splits are empty, partial
    and full; shuffled tables into the layer view of a 2-layer pool."""
    MB = span // BS
    lens = [0, 1, BS - 1, BS, BS + 1, MB * BS]
    NB = len(lens) * MB + 1
    kp = _randn(g, (2, NB, BS, KH, D), dtype)[1]
    vp = _randn(g, (2, NB, BS, KH, D), dtype)[1]
    perm = torch.randperm(NB - 1, generator=torch.Generator().manual_seed(1))
    tables = (perm[:len(lens) * MB] + 1).reshape(len(lens), MB)
    return (kp, vp, tables.to(torch.int32).to(g.device),
            torch.tensor(lens, dtype=torch.int32, device=g.device))


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("dtype,H,KH,D,BS", PAGED_INT8_CASES)
def test_paged_decode_splits_on_card(cuda_device, dtype, H, KH, D, BS, pool):
    """B5 / B5i over split key ranges: against the plain version, exact
    zeros for a length-0 slot, and the same bits on a second call."""
    g = torch.Generator(device=cuda_device).manual_seed(16)
    kp, vp, tables, lens = _split_edge_case(g, dtype, H, KH, D, BS)
    sc = {}
    if pool == "int8":
        (kp, ks), (vp, vs) = _int8_pool(kp), _int8_pool(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    S, MB = tables.shape
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert port_decode.paged_split_plan(MB * BS, S * KH, sms)[0] > 1
    q = _randn(g, (S, H, D), dtype)
    out = port_decode.paged_decode_attention(q, kp, vp, tables, lens, **sc)
    again = port_decode.paged_decode_attention(q, kp, vp, tables, lens, **sc)
    ref = port_decode.paged_decode_attention_reference(q, kp, vp, tables,
                                                       lens, **sc)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert torch.equal(out, again)
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # length 0
    assert (out.float() - ref.float()).abs().max().item() <= tol


# B6/B6i and B7/B7i over every cp.async geometry: BS 16, 32 and 128
VERIFY_CHUNK_CASES = PAGED_INT8_CASES + [(torch.bfloat16, 8, 2, 64, 16),
                                         (torch.float16, 32, 8, 128, 16)]


def _pool_case(g, dtype, H, KH, D, BS, pool):
    """:func:`_split_edge_case`'s pools, tables and lengths, the pools int8
    (with their scale tiles in ``sc``) for ``pool == "int8"``."""
    kp, vp, tables, lens = _split_edge_case(g, dtype, H, KH, D, BS)
    sc = {}
    if pool == "int8":
        (kp, ks), (vp, vs) = _int8_pool(kp), _int8_pool(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    return kp, vp, tables, lens, sc


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 4, 8])
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("dtype,H,KH,D,BS", VERIFY_CHUNK_CASES)
def test_paged_verify_splits_on_card(cuda_device, dtype, H, KH, D, BS, pool,
                                     K):
    """B7 / B7i over split key ranges with lengths 0, 1, BS-1, BS, BS+1 and
    MB*BS-K in one batch (K*R up to 32 rows: two tensor-core row groups):
    against the plain version, and the same bits on a second call."""
    g = torch.Generator(device=cuda_device).manual_seed(19)
    kp, vp, tables, lens, sc = _pool_case(g, dtype, H, KH, D, BS, pool)
    S, MB = tables.shape
    lens[-1] = MB * BS - K
    q = _randn(g, (S, K, H, D), dtype)
    fn = (port_decode.paged_verify_attention_int8 if sc
          else port_decode.paged_verify_attention)
    n = fn.launches
    out = port_decode.paged_verify_attention(q, kp, vp, tables, lens, **sc)
    again = port_decode.paged_verify_attention(q, kp, vp, tables, lens, **sc)
    ref = port_decode.paged_verify_attention_reference(q, kp, vp, tables,
                                                       lens, **sc)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert fn.launches == n + 2
    assert torch.equal(out, again)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("dtype,H,KH,D,BS", VERIFY_CHUNK_CASES)
def test_paged_chunk_splits_on_card(cuda_device, dtype, H, KH, D, BS, pool):
    """B6 / B6i with C in {1, 17, 64, 256} at start {0, 1, 255, 256, 512}
    through a full table row (1024 keys): q tiles of 1 to 12 64-key stages
    split between the two warp groups (one group idle at 1), against the
    plain version, and the same bits on a second call."""
    g = torch.Generator(device=cuda_device).manual_seed(20)
    kp, vp, tables, _, sc = _pool_case(g, dtype, H, KH, D, BS, pool)
    row = tables[-1]
    fn = (port_decode.paged_chunk_attention_int8 if sc
          else port_decode.paged_chunk_attention)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for C in (1, 17, 64, 256):
        for start in (0, 1, 255, 256, 512):
            qc = _randn(g, (C, H, D), dtype)
            n = fn.launches
            out = port_decode.paged_chunk_attention(qc, kp, vp, row, start,
                                                    **sc)
            again = port_decode.paged_chunk_attention(qc, kp, vp, row,
                                                      start, **sc)
            ref = port_decode.paged_chunk_attention_reference(
                qc, kp, vp, row, start, **sc)
            torch.cuda.synchronize()
            assert fn.launches == n + 2
            assert torch.equal(out, again), (C, start)
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= tol, (C, start, err)


@pytest.mark.cuda
def test_server_decode_steps_add_no_host_sync_on_card(cuda_device):
    """Steady-state ContinuousBatchingServer decode steps (the async loop)
    under set_sync_debug_mode("error"): the paged decode wrapper, its
    split plan and its scratch read nothing back from the device."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import ContinuousBatchingServer
    from deepspeed_tpu_torch.model_implementations.transformer import (
        InferenceTransformerConfig, init_params)
    cfg = InferenceTransformerConfig(vocab_size=512, n_positions=256,
                                     n_embd=256, n_layer=2, n_head=4)
    params = init_params(torch.Generator(device=cuda_device).manual_seed(0),
                         cfg)
    eng = deepspeed_tpu_torch.init_inference(
        (cfg, params), dtype="bf16", max_out_tokens=256, block_size=32,
        num_slots=2)
    srv = ContinuousBatchingServer(eng)
    ids = [srv.submit(p, max_new_tokens=24)
           for p in ([1, 2, 3], list(range(100)))]
    for _ in range(4):   # admission and prefill read tokens back by design
        srv.step()
    n = port_decode.paged_decode_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            srv.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert port_decode.paged_decode_attention.launches == n + 4 * cfg.n_layer
    out = srv.drain()
    srv.close()
    assert all(len(out[r]) == n_p + 24 for r, n_p in zip(ids, (3, 100)))


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["verify", "chunk"])
def test_server_verify_and_chunk_steps_add_no_host_sync_on_card(
        cuda_device, program):
    """As the decode test above: steady-state speculative verify steps
    (K=4, the async loop) and a non-final chunk step of a 64-token chunked
    prefill under set_sync_debug_mode("error"). The verify and chunk
    wrappers, their plans and their scratch read nothing back from the
    device."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import ContinuousBatchingServer
    from deepspeed_tpu_torch.model_implementations.transformer import (
        InferenceTransformerConfig, init_params)
    cfg = InferenceTransformerConfig(vocab_size=512, n_positions=256,
                                     n_embd=256, n_layer=2, n_head=4)
    params = init_params(torch.Generator(device=cuda_device).manual_seed(0),
                         cfg)
    knobs = ({"speculation_tokens": 4} if program == "verify" else
             {"enable_prefix_caching": True, "prefill_chunk_tokens": 64})
    eng = deepspeed_tpu_torch.init_inference(
        (cfg, params), dtype="bf16", max_out_tokens=256, block_size=32,
        num_slots=2, **knobs)
    srv = ContinuousBatchingServer(eng)
    if program == "verify":
        fn, steps, warm = port_decode.paged_verify_attention, 4, 4
        prompts = [[1, 2, 3], list(range(100))]
    else:   # one 200-token prompt: four chunks, one a step
        fn, steps, warm = port_decode.paged_chunk_attention, 1, 1
        prompts = [list(range(1, 201))]
    ids = [srv.submit(p, max_new_tokens=24) for p in prompts]
    for _ in range(warm):   # admission and prefill read tokens back by design
        srv.step()
    n = fn.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(steps):
            srv.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fn.launches == n + steps * cfg.n_layer
    out = srv.drain()
    srv.close()
    assert all(len(out[r]) == len(p) + 24 for r, p in zip(ids, prompts))


# ------------------------------------------------------------ block sparse

SPARSE_CASES = [   # block, head dim, dtype, layout, causal, strided
    (16, 64, torch.bfloat16, "fixed", True, False),
    (32, 128, torch.bfloat16, "bigbird", False, False),
    (64, 128, torch.bfloat16, "fixed", True, True),
    (128, 64, torch.float16, "longformer", False, False),
    (128, 128, torch.bfloat16, "variable", True, True),
    (64, 64, torch.float32, "fixed", True, False),
    (16, 128, torch.float32, "bigbird", False, False),
]
# B8's tensor-core kernel (blocks of 64 and 128) over every layout that
# chip_smoke.py's phase sparse uses, q/k/v as strided views
WGMMA_CASES = [(block, D, dtype, layout, causal)
               for block, D in ((64, 128), (128, 64), (64, 64), (128, 128))
               for dtype in (torch.bfloat16, torch.float16)
               for layout, causal in (("fixed", True), ("bigbird", False),
                                      ("longformer", False),
                                      ("fixed_per_head", False),
                                      ("variable", False),
                                      ("sliding", True))]


def _sparse_layout(name, H, block, T):
    cfg = {"fixed": lambda: port_sparse.FixedSparsityConfig(
               num_heads=H, block=block, num_local_blocks=4,
               attention="unidirectional"),
           "bigbird": lambda: port_sparse.BigBirdSparsityConfig(
               num_heads=H, block=block, different_layout_per_head=True),
           "longformer": lambda: port_sparse.BSLongformerSparsityConfig(
               num_heads=H, block=block, global_block_indices=[1]),
           "variable": lambda: port_sparse.VariableSparsityConfig(
               num_heads=H, block=block, num_random_blocks=1,
               local_window_blocks=[2], global_block_indices=[0]),
           "fixed_per_head": lambda: port_sparse.FixedSparsityConfig(
               num_heads=H, block=block, num_local_blocks=4,
               different_layout_per_head=True,
               num_different_global_patterns=4),
           "sliding": lambda: port_sparse.LocalSlidingWindowSparsityConfig(
               num_heads=H, block=block, num_sliding_window_blocks=5)
           }[name]()
    return cfg.make_layout(T)


def _assert_sparse_close(out, ref, dtype):
    """B8's gates on ``[B, H, T, D]`` outputs: max |out - ref| <= atol, and
    relative L2 over every tile of 64 rows along T."""
    atol, l2 = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-2)
    elem, tile_l2 = _bwd_errors(out.transpose(1, 2), ref.transpose(1, 2),
                                atol, 0.0)
    assert elem <= 1.0 and tile_l2 <= l2, (elem, tile_l2, _rel(out, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("block,D,dtype,layout,causal,strided",
                         SPARSE_CASES)
def test_block_sparse_kernel_matches_plain_on_card(cuda_device, block, D,
                                                   dtype, layout, causal,
                                                   strided):
    g = torch.Generator(device=cuda_device).manual_seed(10)
    B, H, T = 2, 4, 1024
    lut, counts = (torch.as_tensor(x, device=cuda_device) for x in
                   port_bsa.build_lut(_sparse_layout(layout, H, block, T)))
    if strided:   # [B, H, T, D] views of a fused [B, T, 3, H, D] projection
        q, k, v = (x.transpose(1, 2) for x in
                   _randn(g, (B, T, 3, H, D), dtype).unbind(2))
    else:
        q, k, v = (_randn(g, (B, H, T, D), dtype) for _ in range(3))
    n = port_bsa.block_sparse_attention.launches
    out = port_bsa.block_sparse_attention(q, k, v, lut, counts, block, causal)
    ref = port_bsa.block_sparse_attention_reference(q, k, v, lut, counts,
                                                    block, causal)
    torch.cuda.synchronize()
    assert port_bsa.block_sparse_attention.launches == n + 1
    assert out.dtype == dtype and out.shape == (B, H, T, D)
    _assert_sparse_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("block,D,dtype,layout,causal", WGMMA_CASES)
def test_block_sparse_wgmma_kernel_matches_plain_on_card(
        cuda_device, block, D, dtype, layout, causal):
    """B8 at blocks of 64 and 128 on strided views of a fused projection,
    with and without the host's tile order (the same bits either way and
    on a second call), a LUT row with padding and an out-of-range entry,
    and a query block whose only entry lies above the diagonal (causal)
    or that lists nothing: exactly 0."""
    import numpy as np
    g = torch.Generator(device=cuda_device).manual_seed(block + D)
    B, H, T = 2, 4, 1024
    nb = T // block
    lay = _sparse_layout(layout, H, block, T)
    lay[:, 0] = 0
    lay[:, 0, 1] = 1
    lay[:, -1] = 0
    lut_np, counts_np = port_bsa.build_lut(lay)
    clean = [torch.as_tensor(x, device=cuda_device)
             for x in (lut_np, counts_np)]
    # padding past the counts out of range, and row 1 listing nb and -1
    # too: the kernel must load none of them (the plain version, which
    # gathers every entry, takes the clean LUT)
    lut_np = np.concatenate([lut_np, np.full((H, nb, 2), nb + 7, np.int32)],
                            -1)
    for h in range(H):
        c = counts_np[h, 1]
        lut_np[h, 1, c:c + 2] = nb, -1
        counts_np[h, 1] = c + 2
    lut_np[lut_np == 0] = np.where(
        np.arange(lut_np.shape[-1]) >= counts_np[..., None], nb + 7, 0)[
            lut_np == 0]
    lut, counts = (torch.as_tensor(np.ascontiguousarray(x),
                                   device=cuda_device)
                   for x in (lut_np, counts_np))
    order = torch.as_tensor(port_bsa.tile_order(lut_np, counts_np, causal),
                            device=cuda_device)
    q, k, v = (x.transpose(1, 2) for x in
               _randn(g, (B, T, 3, H, D), dtype).unbind(2))
    out = port_bsa.block_sparse_attention(q, k, v, lut, counts, block,
                                          causal)
    again = port_bsa.block_sparse_attention(q, k, v, lut, counts, block,
                                            causal, order=order)
    ref = port_bsa.block_sparse_attention_reference(q, k, v, *clean, block,
                                                    causal)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out[:, :, -block:], torch.zeros_like(out[:, :, -block:]))
    if causal:
        assert torch.equal(out[:, :, :block],
                           torch.zeros_like(out[:, :, :block]))
    _assert_sparse_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_sparse_dead_rows_are_zero_on_card(cuda_device, dtype):
    """Row block 0 lists only a block above the diagonal (causal) and the
    last row block lists nothing: both give exactly 0."""
    import numpy as np
    g = torch.Generator(device=cuda_device).manual_seed(11)
    H, block, T, D = 2, 64, 512, 64
    nb = T // block
    lay = np.zeros((H, nb, nb), np.int64)
    lay[:, 0, 1] = 1
    for i in range(1, nb - 1):
        lay[:, i, :i + 1] = 1
    lut, counts = (torch.as_tensor(x, device=cuda_device)
                   for x in port_bsa.build_lut(lay))
    q, k, v = (_randn(g, (2, H, T, D), dtype) for _ in range(3))
    out = port_bsa.block_sparse_attention(q, k, v, lut, counts, block, True)
    ref = port_bsa.block_sparse_attention_reference(q, k, v, lut, counts,
                                                    block, True)
    torch.cuda.synchronize()
    assert torch.equal(out[:, :, :block], torch.zeros_like(out[:, :, :block]))
    assert torch.equal(out[:, :, -block:],
                       torch.zeros_like(out[:, :, -block:]))
    _assert_sparse_close(out, ref, dtype)


@pytest.mark.cuda
def test_sparse_self_attention_on_card(cuda_device):
    """The front-end on CUDA tensors: one kernel launch per call, the LUT
    built once per length, the output [B, T, H, D]."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    cfg = port_sparse.FixedSparsityConfig(num_heads=4, block=64,
                                          num_local_blocks=4,
                                          attention="unidirectional")
    op = port_sparse.SparseSelfAttention(cfg)
    n = port_bsa.block_sparse_attention.launches
    for T in (512, 512, 256):
        q, k, v = (_randn(g, (2, T, 4, 64), torch.bfloat16) for _ in range(3))
        out = op(q, k, v)
        ref = port_sparse.sparse_attention_reference(q, k, v, op.layout(T),
                                                     64, True)
        torch.cuda.synchronize()
        assert out.shape == (2, T, 4, 64)
        _assert_sparse_close(out.transpose(1, 2), ref.transpose(1, 2),
                             torch.bfloat16)
    assert port_bsa.block_sparse_attention.launches == n + 3
    assert sorted(op._cache) == [256, 512]


@pytest.mark.cuda
def test_block_sparse_refuses_what_the_kernel_does_not_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(13)
    lut = torch.zeros((2, 8, 1), dtype=torch.int32, device=cuda_device)
    counts = torch.ones((2, 8), dtype=torch.int32, device=cuda_device)
    q = _randn(g, (1, 2, 64, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="blocks"):
        port_bsa.block_sparse_attention(q, q, q, lut, counts, 8)
    q = _randn(g, (1, 2, 128, 96), torch.bfloat16)    # head dim 96: taken
    out = port_bsa.block_sparse_attention(q, q, q, lut, counts, 16)
    ref = port_bsa.block_sparse_attention_reference(q, q, q, lut, counts, 16)
    _assert_sparse_close(out, ref, torch.bfloat16)
    q = _randn(g, (1, 2, 128, 256), torch.bfloat16)   # head dim 256: taken
    out = port_bsa.block_sparse_attention(q, q, q, lut, counts, 16)
    ref = port_bsa.block_sparse_attention_reference(q, q, q, lut, counts, 16)
    _assert_sparse_close(out, ref, torch.bfloat16)
    q = _randn(g, (1, 2, 128, 320), torch.bfloat16)
    with pytest.raises(ValueError, match="D1c"):
        port_bsa.block_sparse_attention(q, q, q, lut, counts, 16)
    q = _randn(g, (1, 2, 128, 64), torch.bfloat16)
    with pytest.raises(TypeError, match="int32"):
        port_bsa.block_sparse_attention(q, q, q, lut.long(), counts, 16)


# ------------------------------------------------------------- layer norm

LN_CASES = [   # R, N, dtype
    (2048, 2048, torch.bfloat16),   # GPT-2 1.3B width
    (1000, 1600, torch.bfloat16),   # GPT-2 XL width, ragged R
    (1000, 768, torch.float16),
    (333, 2048, torch.float32),
    (64, 37, torch.bfloat16),       # scalar path: rows not 16-byte sized
    (17, 20000, torch.bfloat16),    # B10's wide kernel
    (4, 30000, torch.float32),      # rows too wide to cache in B9
]


def _ln_gates(a, r, dtype):
    a, r = a.float(), r.float()
    if dtype == torch.float32:
        return (a - r).abs().max().item() <= 1e-4
    return bool(((a - r).abs() <= 2e-2 + 1e-2 * r.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,dtype", LN_CASES)
def test_layer_norm_kernels_match_plain_on_card(cuda_device, R, N, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(14)
    x = _randn(g, (R, N), dtype) * 2 + 0.5
    w = _randn(g, (N,), torch.float32) + 1
    b = _randn(g, (N,), torch.float32)
    go = _randn(g, (R, N), dtype)
    nf, nb_ = port_ln.layer_norm_fwd.launches, port_ln.layer_norm_bwd.launches
    o, mean, rstd = port_ln.layer_norm_fwd(x, w, b)
    ro, rmean, rrstd = port_ln.layer_norm_fwd_reference(x, w, b, 1e-5)
    dx, dw, db = port_ln.layer_norm_bwd(x, w, mean, rstd, go)
    dx2, dw2, db2 = port_ln.layer_norm_bwd(x, w, mean, rstd, go)
    rdx, rdw, rdb = port_ln.layer_norm_bwd_reference(x, w, mean, rstd, go)
    torch.cuda.synchronize()
    assert (port_ln.layer_norm_fwd.launches,
            port_ln.layer_norm_bwd.launches) == (nf + 1, nb_ + 2)
    assert o.dtype == dx.dtype == dtype and dw.dtype == torch.float32
    assert _ln_gates(o, ro, dtype) and _ln_gates(dx, rdx, dtype)
    for a, r in ((mean, rmean), (rstd, rrstd)):
        assert ((a - r).abs() <= 1e-5 * r.abs() + 1e-7).all()
    for a, r in ((dw, rdw), (db, rdb)):
        assert ((a - r).norm() / r.norm()).item() <= 1e-4
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2) \
        and torch.equal(db, db2)


def _ln_bwd_gates(x, go, dtype):
    """B10 against its plain version from B9's statistics: dx element-wise,
    dw and db 1e-4 relative L2, the same bits on a second call."""
    N = x.shape[1]
    g = torch.Generator(device=x.device).manual_seed(N)
    w = _randn(g, (N,), torch.float32) + 1
    _, mean, rstd = port_ln.layer_norm_fwd(x, w, torch.zeros_like(w))
    runs = [port_ln.layer_norm_bwd(x, w, mean, rstd, go) for _ in range(2)]
    rdx, rdw, rdb = port_ln.layer_norm_bwd_reference(x, w, mean, rstd, go)
    torch.cuda.synchronize()
    dx, dw, db = runs[0]
    assert dx.dtype == dtype and _ln_gates(dx, rdx, dtype)
    for a, r in ((dw, rdw), (db, rdb)):
        assert ((a - r).norm() / r.norm()).item() <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# B10's wide kernel: rows wider than its ring kernel takes (4 x 256
# chunks), from one row to 8192, aligned and not
@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 3, 8192])
@pytest.mark.parametrize("N", [20000, 65544, 100000])
def test_layer_norm_bwd_wide_rows_on_card(cuda_device, R, N):
    g = torch.Generator(device=cuda_device).manual_seed(19)
    for dtype in ((torch.bfloat16, torch.float32) if R < 8192
                  else (torch.bfloat16,)):
        x = _randn(g, (R, N), dtype) * 2 + 0.5
        _ln_bwd_gates(x, _randn(g, (R, N), dtype), dtype)
        del x
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [3, 1000])
@pytest.mark.parametrize("N", [8, 64, 256, 520, 1024])
def test_layer_norm_bwd_narrow_rows_on_card(cuda_device, R, N, dtype):
    """Rows of at most 128 chunks: B10's ring kernel in groups of 8 rows;
    at f32 N = 256 its 48 KB of ring beside the static shared memory
    pass the default limit, which the launch raises."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    x = _randn(g, (R, N), dtype) * 2 + 0.5
    _ln_bwd_gates(x, _randn(g, (R, N), dtype), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", [(8, 10001), (2048, 10001), (1000, 2048)])
def test_layer_norm_bwd_unaligned_rows_on_card(cuda_device, R, N):
    """Rows of an odd width, or that start 2 bytes past a 16-byte
    boundary, take B10's wide kernel with scalar loads."""
    g = torch.Generator(device=cuda_device).manual_seed(20)
    x = (_randn(g, (R * N + 1,), torch.bfloat16) * 2 + 0.5)[1:].view(R, N)
    _ln_bwd_gates(x, _randn(g, (R, N), torch.bfloat16), torch.bfloat16)


# B9 around its register and template thresholds: chunks a lane of 1, 2,
# 4, 8 and 16 and the rows past them (the shared-memory path), R below,
# at and above one row a warp of the persistent grid
LN_FWD_CASES = ([(R, N, torch.bfloat16)
                 for R in (1, 3, 1000, 8192)
                 for N in (1, 37, 768, 1600, 2048, 4096, 8192, 20000)]
                + [(1000, N, torch.float16) for N in (768, 4096, 8192)]
                + [(1000, N, torch.float32) for N in (1024, 2048, 4096)])


def _ln_fwd_gates(x, w, b, dtype):
    o, mean, rstd = port_ln.layer_norm_fwd(x, w, b)
    o2, mean2, rstd2 = port_ln.layer_norm_fwd(x, w, b)
    ro, rmean, rrstd = port_ln.layer_norm_fwd_reference(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert o.dtype == dtype and mean.shape == rstd.shape == (x.shape[0], 1)
    assert _ln_gates(o, ro, dtype)
    for a, r in ((mean, rmean), (rstd, rrstd)):
        assert ((a - r).abs() <= 1e-5 * r.abs() + 1e-7).all()
    assert torch.equal(o, o2) and torch.equal(mean, mean2) \
        and torch.equal(rstd, rstd2)


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,dtype", LN_FWD_CASES)
def test_layer_norm_fwd_widths_on_card(cuda_device, R, N, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(17)
    x = _randn(g, (R, N), dtype) * 2 + 0.5
    w = _randn(g, (N,), torch.float32) + 1
    b = _randn(g, (N,), torch.float32)
    _ln_fwd_gates(x, w, b, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [768, 2048])
def test_layer_norm_fwd_unaligned_rows_on_card(cuda_device, N):
    """Rows that start 2 bytes past a 16-byte boundary take the scalar
    path."""
    g = torch.Generator(device=cuda_device).manual_seed(18)
    x = (_randn(g, (1000 * N + 1,), torch.bfloat16) * 2 + 0.5)[1:]
    x = x.view(1000, N)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = _randn(g, (N,), torch.float32) + 1
    b = _randn(g, (N,), torch.float32)
    _ln_fwd_gates(x, w, b, torch.bfloat16)


@pytest.mark.cuda
def test_fused_layer_norm_autograd_on_card(cuda_device):
    """FusedLayerNormFunction (B9 forward, B10 backward) and the residual
    variant against autograd through layer_norm_reference."""
    g = torch.Generator(device=cuda_device).manual_seed(15)
    x = _randn(g, (4, 256, 1024), torch.bfloat16)
    r = _randn(g, (4, 256, 1024), torch.bfloat16)
    w = (_randn(g, (1024,), torch.float32) + 1).requires_grad_()
    b = _randn(g, (1024,), torch.float32).requires_grad_()
    go = _randn(g, (4, 256, 1024), torch.bfloat16)
    leaves = [x.clone().requires_grad_(), r.clone().requires_grad_(), w, b]
    o, s = port_ln.fused_residual_layer_norm(*leaves)
    grads = torch.autograd.grad(o, leaves, go)
    ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    ro = port_ln.layer_norm_reference(ref_leaves[0] + ref_leaves[1],
                                      *ref_leaves[2:])
    rgrads = torch.autograd.grad(ro, ref_leaves, go)
    assert torch.equal(s, x + r) and _ln_gates(o, ro, torch.bfloat16)
    for a, rg in zip(grads, rgrads):
        assert a.dtype == rg.dtype
        assert ((a.float() - rg.float()).norm()
                / rg.float().norm()).item() <= 1e-2


@pytest.mark.cuda
def test_layer_norm_refuses_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros((4, 64), dtype=torch.float64, device=cuda_device)
    w = torch.ones(64, device=cuda_device)
    with pytest.raises(TypeError, match="float32, float16 or bfloat16"):
        port_ln.layer_norm_fwd(x, w, w)
    x = torch.zeros((64, 8), dtype=torch.bfloat16, device=cuda_device).t()
    with pytest.raises(ValueError, match="contiguous"):
        port_ln.layer_norm_fwd(x, w[:8].repeat(8), w[:8].repeat(8))


# --------------------------------------------------- head dims up to 128

# head dims that run natively on the 64- and 128-wide instantiations (rows
# of whole 16-byte chunks), in every dtype; int8 pools need D % 16 == 0
HEAD_DIMS = [32, 40, 48, 80, 96, 112]
INT8_HEAD_DIMS = [32, 48, 80, 96]
HEAD_DTYPES = [torch.float16, torch.bfloat16, torch.float32]


def _guarded(x, fill=float("nan")):
    """``x`` as the ``[..., :D]`` view of a ``[..., DK + 16]`` buffer whose
    guard columns past D hold ``fill`` (NaN; int8 has none, so 127): a
    kernel that loads past D takes NaN into its result, and its strides
    are those of a wider tensor."""
    D = x.shape[-1]
    DK, _ = head_dim_route(D, x.element_size())
    buf = torch.full((*x.shape[:-1], DK + 16), fill, dtype=x.dtype,
                     device=x.device)
    buf[..., :D] = x
    return buf[..., :D]


def _fused(g, lead, H, D, dtype):
    """q, k and v as views of one fused ``[*lead, 3, H, D]`` projection
    with NaN guard columns past D."""
    return _guarded(_randn(g, (*lead, 3, H, D), dtype)).unbind(len(lead))


def _head_err(o, ref):
    """The worst |o - ref| of each head (dim -2): a store past D lands in
    the next head of the kernel's packed output."""
    d = (o.float() - ref.float()).abs()
    return d.amax(dim=tuple(i for i in range(d.dim()) if i != d.dim() - 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_fwd_takes_head_dims_to_128_on_card(cuda_device, D, dtype):
    """B1 on the 64- or 128-wide instantiation at a true head dim D, q/k/v
    views of a fused projection with NaN guard columns: every head of the
    packed output against the plain version, the same bits on a second
    call."""
    g = torch.Generator(device=cuda_device).manual_seed(D)
    q, k, v = _fused(g, (2, 200), 4, D, dtype)
    n = port_flash.flash_attention_fwd.launches
    o, lse = port_flash.flash_attention_fwd(q, k, v)
    o2, lse2 = port_flash.flash_attention_fwd(q, k, v)
    ref, lse_ref = port_flash.flash_attention_reference(
        q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert port_flash.flash_attention_fwd.launches == n + 2
    assert o.shape == (2, 200, 4, D) and o.is_contiguous()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (_head_err(o, ref) <= tol).all()
    assert (lse - lse_ref).abs().max().item() <= (
        1e-4 if dtype == torch.float32 else 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_bwd_takes_head_dims_to_128_on_card(cuda_device, D, dtype):
    """B2 and B3 at a true head dim D (GQA: 4 q heads over 2 kv heads), q,
    k and v views of a fused projection, o and dO views, all with NaN
    guard columns: the backward gates on every head of dq, dk and dv, the
    same bits on a second call."""
    g = torch.Generator(device=cuda_device).manual_seed(100 + D)
    B, T, H, KH = 2, 300, 4, 2
    qkv = _guarded(_randn(g, (B, T, H + 2 * KH, D), dtype))
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KH], qkv[:, :, H + KH:]
    o, lse = port_flash.flash_attention_fwd(q, k, v)
    o = _guarded(o)
    do = _guarded(_randn(g, (B, T, H, D), dtype))
    runs = []
    for _ in range(2):
        dq, delta = port_flash.flash_attention_bwd_dq(q, k, v, o, lse, do)
        dk, dv = port_flash.flash_attention_bwd_dkv(q, k, v, lse, delta, do)
        runs.append((dq, dk, dv, delta))
    rq, rk, rv = port_flash.flash_attention_bwd_reference(q, k, v, o, lse,
                                                          do)
    torch.cuda.synchronize()
    atol, rtol, l2 = ((1e-4, 1e-4, 1e-4) if dtype == torch.float32
                      else (2e-2, 1e-2, 1e-2))
    for name, a, r in zip(("dq", "dk", "dv"), runs[0], (rq, rk, rv)):
        assert a.shape == r.shape and a.is_contiguous(), name
        for h in range(a.shape[2]):
            elem, tile_l2 = _bwd_errors(a[:, :, h:h + 1], r[:, :, h:h + 1],
                                        atol, rtol)
            assert elem <= 1.0 and tile_l2 <= l2, (name, h, elem, tile_l2)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_decode_takes_head_dims_to_128_on_card(cuda_device, D, dtype):
    """B4 at a true head dim D (R = 4) over the layer view of a 5-D cache,
    q a view of a fused projection, cache and q with NaN guard columns:
    every head against the plain version, the same bits twice."""
    g = torch.Generator(device=cuda_device).manual_seed(200 + D)
    B, S, KH, R = 4, 700, 2, 4
    kc = _guarded(_randn(g, (2, B, S, KH, D), dtype))[1]
    vc = _guarded(_randn(g, (2, B, S, KH, D), dtype))[1]
    q = _guarded(_randn(g, (B, 3, KH * R, D), dtype))[:, 0]
    lens = torch.tensor([0, 1, 400, S], dtype=torch.int32,
                        device=cuda_device)
    o = port_decode.decode_attention(q, kc, vc, lens)
    o2 = port_decode.decode_attention(q, kc, vc, lens)
    ref = port_decode.decode_attention_reference(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert o.shape == (B, KH * R, D) and o.is_contiguous()
    assert torch.equal(o, o2)
    assert torch.equal(o[0], torch.zeros_like(o[0]))
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (_head_err(o, ref) <= tol).all()


def _paged_head_dim_runs(g, q_dtype, D, kp, vp, tables, lens, scales):
    """B5, B7 (K = 4) and B6 over one pool, q with NaN guard columns, each
    twice: ``[(name, output, plain, second output)]``."""
    H = 8
    sc = {} if scales is None else dict(k_scale=scales[0],
                                        v_scale=scales[1])
    runs = []
    cases = (
        ("decode", (4, H, D), port_decode.paged_decode_attention,
         port_decode.paged_decode_attention_reference, (tables, lens)),
        ("verify", (4, 4, H, D), port_decode.paged_verify_attention,
         port_decode.paged_verify_attention_reference, (tables, lens)),
        ("chunk", (96, H, D), port_decode.paged_chunk_attention,
         port_decode.paged_chunk_attention_reference, (tables[2], 32)))
    for name, shape, fn, plain, rest in cases:
        q = _guarded(_randn(g, shape, q_dtype))
        o = fn(q, kp, vp, *rest, **sc)
        o2 = fn(q, kp, vp, *rest, **sc)
        runs.append((name, o, plain(q, kp, vp, *rest, **sc), o2))
    return runs


def _check_paged_runs(runs, dtype, D):
    for name, o, ref, o2 in runs:
        tol = (1e-4 if dtype == torch.float32
               else 2e-2 if name == "chunk" else 1e-2)
        assert o.shape[-1] == D and o.is_contiguous(), name
        assert torch.equal(o, o2), name
        assert (_head_err(o, ref) <= tol).all(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_paged_kernels_take_head_dims_to_128_on_card(cuda_device, D, dtype):
    """B5, B6 and B7 at a true head dim D (8 q heads over 2 kv heads) over
    the layer view of a pool with shuffled tables, pools and q with NaN
    guard columns: every head against the plain versions, the same bits on
    a second call."""
    g = torch.Generator(device=cuda_device).manual_seed(300 + D)
    kp, vp, tables, lens = _paged_case(g, dtype, 8, 2, D, BS=32, MB=8)
    kp, vp = _guarded(kp), _guarded(vp)
    fp = (port_decode.paged_decode_attention,
          port_decode.paged_chunk_attention,
          port_decode.paged_verify_attention)
    n = [f.launches for f in fp]
    runs = _paged_head_dim_runs(g, dtype, D, kp, vp, tables, lens, None)
    torch.cuda.synchronize()
    assert [f.launches for f in fp] == [x + 2 for x in n]
    _check_paged_runs(runs, dtype, D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("D", INT8_HEAD_DIMS)
def test_paged_int8_kernels_take_head_dims_to_128_on_card(cuda_device, D,
                                                          dtype):
    """B5i, B6i and B7i at a true head dim D over int8 pools quantized per
    row (guard columns of 127): as the fp test, and no fp paged launch."""
    g = torch.Generator(device=cuda_device).manual_seed(400 + D)
    kp, vp, tables, lens = _paged_case(g, dtype, 8, 2, D, BS=32, MB=8)
    (kq, ks), (vq, vs) = _int8_pool(kp), _int8_pool(vp)
    kq, vq = _guarded(kq, 127), _guarded(vq, 127)
    i8 = (port_decode.paged_decode_attention_int8,
          port_decode.paged_chunk_attention_int8,
          port_decode.paged_verify_attention_int8)
    n, n_fp = [f.launches for f in i8], port_decode.paged_decode_attention \
        .launches
    runs = _paged_head_dim_runs(g, dtype, D, kq, vq, tables, lens, (ks, vs))
    torch.cuda.synchronize()
    assert [f.launches for f in i8] == [x + 2 for x in n]
    assert port_decode.paged_decode_attention.launches == n_fp
    _check_paged_runs(runs, dtype, D)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 64])
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_block_sparse_takes_head_dims_to_128_on_card(cuda_device, D, dtype,
                                                     block):
    """B8 at a true head dim D, blocks of 16 (mma.sync) and 64 (wgmma),
    q/k/v strided views of a fused projection with NaN guard columns, the
    output a view of a NaN-filled buffer (B8 takes ``out``, for
    SparseSelfAttention): the sparse gates, the output's guard columns
    untouched, the same bits twice."""
    g = torch.Generator(device=cuda_device).manual_seed(500 + D + block)
    B, H, T = 2, 4, 512
    lut, counts = (torch.as_tensor(x, device=cuda_device) for x in
                   port_bsa.build_lut(_sparse_layout("fixed", H, block, T)))
    q, k, v = (x.transpose(1, 2) for x in _fused(g, (B, T), H, D, dtype))
    o = _guarded(torch.full((B, T, H, D), float("nan"), dtype=dtype,
                            device=cuda_device))
    buf = o._base
    out = o.transpose(1, 2)
    port_bsa.block_sparse_attention(q, k, v, lut, counts, block, True,
                                    out=out)
    first = buf.clone()
    port_bsa.block_sparse_attention(q, k, v, lut, counts, block, True,
                                    out=out)
    ref = port_bsa.block_sparse_attention_reference(q, k, v, lut, counts,
                                                    block, True)
    torch.cuda.synchronize()
    assert bool(torch.isnan(buf[..., D:]).all())
    assert torch.equal(buf[..., :D], first[..., :D])
    _assert_sparse_close(out, ref, dtype)


@pytest.mark.cuda
def test_padded_route_runs_odd_head_dims_on_card(cuda_device):
    """D = 36 is no whole number of 16-byte chunks in 16 bits: the wrappers
    zero-pad to 64 and slice back. B1 + B2/B3 under autograd against
    autograd through the plain forward, and B5 against its plain version,
    each one launch."""
    g = torch.Generator(device=cuda_device).manual_seed(36)
    q, k, v = (_randn(g, (2, 256, 4, 36), torch.bfloat16) for _ in range(3))
    do = _randn(g, (2, 256, 4, 36), torch.bfloat16)
    fns = (port_flash.flash_attention_fwd, port_flash.flash_attention_bwd_dq,
           port_flash.flash_attention_bwd_dkv,
           port_decode.paged_decode_attention)
    n = [f.launches for f in fns]
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = port_flash.FlashAttentionFunction.apply(*leaves, True, 1 / 6)
    grads = torch.autograd.grad(out, leaves, do)
    ref = [x.detach().float().requires_grad_() for x in (q, k, v)]
    o_ref, _ = port_flash.flash_attention_reference(*ref, True, 1 / 6)
    rgrads = torch.autograd.grad(o_ref, ref, do.float())
    assert out.shape == q.shape
    assert (out.float() - o_ref).abs().max().item() <= 2e-2
    for a, r in zip(grads, rgrads):
        assert a.shape == r.shape and _rel(a, r) <= 2e-2
    kp, vp, tables, lens = _paged_case(g, torch.bfloat16, 4, 4, 36)
    qd = _randn(g, (4, 4, 36), torch.bfloat16)
    o = port_decode.paged_decode_attention(qd, kp, vp, tables, lens)
    r = port_decode.paged_decode_attention_reference(qd, kp, vp, tables,
                                                     lens)
    torch.cuda.synchronize()
    assert o.shape == qd.shape
    assert (o.float() - r.float()).abs().max().item() <= 1e-2
    assert [f.launches for f in fns] == [x + 1 for x in n]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [160, 256])
def test_head_dims_past_128_run_and_d1c_holds_on_card(cuda_device, D):
    """B2, B3 and B8 run at D (one launch each, against their plain
    versions); every kernel raises at 264 (fault D1c)."""
    g = torch.Generator(device=cuda_device).manual_seed(D)
    q = _randn(g, (1, 64, 2, D), torch.bfloat16)
    o, lse = port_flash.flash_attention_fwd(q, q, q)
    fns = (port_flash.flash_attention_bwd_dq,
           port_flash.flash_attention_bwd_dkv, port_bsa.block_sparse_attention)
    n = [f.launches for f in fns]
    dq, delta = port_flash.flash_attention_bwd_dq(q, q, q, o, lse, q)
    dk, dv = port_flash.flash_attention_bwd_dkv(q, q, q, lse, delta, q)
    lut = torch.zeros((2, 4, 1), dtype=torch.int32, device=cuda_device)
    counts = torch.ones((2, 4), dtype=torch.int32, device=cuda_device)
    qb = q.transpose(1, 2)
    out = port_bsa.block_sparse_attention(qb, qb, qb, lut, counts, 16)
    refs = (port_flash.flash_attention_bwd_reference(q, q, q, o, lse, q),
            port_bsa.block_sparse_attention_reference(qb, qb, qb, lut,
                                                      counts, 16))
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [x + 1 for x in n]
    for a, r in zip((dq, dk, dv), refs[0]):
        elem, tile_l2 = _bwd_errors(a, r, 2e-2, 1e-2)
        assert elem <= 1.0 and tile_l2 <= 1e-2
    _assert_sparse_close(out, refs[1], torch.bfloat16)
    q = _randn(g, (1, 64, 2, 264), torch.bfloat16)
    with pytest.raises(ValueError, match="D1c"):
        port_flash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="D1c"):
        port_decode.decode_attention(
            q[:, 0], q, q, torch.tensor([5], dtype=torch.int32,
                                        device=cuda_device))
    kp, vp, tables, lens = _paged_case(g, torch.bfloat16, 2, 2, 264)
    with pytest.raises(ValueError, match="D1c"):
        port_decode.paged_decode_attention(q[0, :4], kp, vp, tables, lens)
    with pytest.raises(ValueError, match="D1c"):
        qb = q.transpose(1, 2)
        port_bsa.block_sparse_attention(qb, qb, qb, lut, counts, 16)
    with pytest.raises(ValueError, match="D1c"):
        port_flash.flash_attention_bwd_dq(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="D1c"):
        port_flash.flash_attention_bwd_dkv(q, q, q, lse, lse, q)


# ------------------------------------------ serving head dims up to 256

# head dims on the serving kernels' 256-wide instantiation (int8 pools of
# 136 take the padded route: 136 bytes are no whole 16-byte chunks)
WIDE_HEAD_DIMS = [136, 160, 192, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("D", WIDE_HEAD_DIMS)
def test_flash_fwd_takes_head_dims_to_256_on_card(cuda_device, D, dtype):
    """B1 on the 256-wide instantiation at a true head dim D (GQA: 4 q
    heads over 2 kv heads, a ragged T), q/k/v views of one guarded
    projection: every head against the plain version, the LSE, the same
    bits on a second call."""
    g = torch.Generator(device=cuda_device).manual_seed(600 + D)
    B, T, H, KH = 2, 333, 4, 2
    qkv = _guarded(_randn(g, (B, T, H + 2 * KH, D), dtype))
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KH], qkv[:, :, H + KH:]
    for causal in (True, False):
        n = port_flash.flash_attention_fwd.launches
        o, lse = port_flash.flash_attention_fwd(q, k, v, causal)
        o2, lse2 = port_flash.flash_attention_fwd(q, k, v, causal)
        ref, lse_ref = port_flash.flash_attention_reference(
            q.contiguous(), k.contiguous(), v.contiguous(), causal)
        torch.cuda.synchronize()
        assert port_flash.flash_attention_fwd.launches == n + 2
        assert o.shape == (B, T, H, D) and o.is_contiguous()
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert (_head_err(o, ref) <= tol).all(), causal
        assert (lse - lse_ref).abs().max().item() <= (
            1e-4 if dtype == torch.float32 else 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("D", WIDE_HEAD_DIMS)
def test_decode_takes_head_dims_to_256_on_card(cuda_device, D, dtype):
    """B4 at a true head dim D on the 256-wide instantiation, R = 4 and
    R = 8 over one kv head (Gemma-2B), guarded views: every head against
    the plain version, the same bits twice, a length-0 row exactly 0."""
    g = torch.Generator(device=cuda_device).manual_seed(700 + D)
    B, S = 4, 700
    lens = torch.tensor([0, 1, 400, S], dtype=torch.int32,
                        device=cuda_device)
    for KH, R in ((2, 4), (1, 8)):
        kc = _guarded(_randn(g, (2, B, S, KH, D), dtype))[1]
        vc = _guarded(_randn(g, (2, B, S, KH, D), dtype))[1]
        q = _guarded(_randn(g, (B, 3, KH * R, D), dtype))[:, 0]
        o = port_decode.decode_attention(q, kc, vc, lens)
        o2 = port_decode.decode_attention(q, kc, vc, lens)
        ref = port_decode.decode_attention_reference(q, kc, vc, lens)
        torch.cuda.synchronize()
        assert o.shape == (B, KH * R, D) and o.is_contiguous()
        assert torch.equal(o, o2)
        assert torch.equal(o[0], torch.zeros_like(o[0]))
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        assert (_head_err(o, ref) <= tol).all(), R


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("D", WIDE_HEAD_DIMS)
def test_paged_kernels_take_head_dims_to_256_on_card(cuda_device, D, dtype):
    """B5, B6 and B7 at a true head dim D on the 256-wide instantiation, 8
    q heads over 2 kv heads and (D = 256) over one, guarded pools and q:
    every head against the plain versions, the same bits twice."""
    g = torch.Generator(device=cuda_device).manual_seed(800 + D)
    fp = (port_decode.paged_decode_attention,
          port_decode.paged_chunk_attention,
          port_decode.paged_verify_attention)
    for KH in ((2, 1) if D == 256 else (2,)):
        kp, vp, tables, lens = _paged_case(g, dtype, 8, KH, D, BS=32, MB=8)
        kp, vp = _guarded(kp), _guarded(vp)
        n = [f.launches for f in fp]
        runs = _paged_head_dim_runs(g, dtype, D, kp, vp, tables, lens, None)
        torch.cuda.synchronize()
        assert [f.launches for f in fp] == [x + 2 for x in n]
        _check_paged_runs(runs, dtype, D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("D", WIDE_HEAD_DIMS)
def test_paged_int8_kernels_take_head_dims_to_256_on_card(cuda_device, D,
                                                          dtype):
    """B5i, B6i and B7i at a true head dim D over int8 pools quantized per
    row (guard columns of 127), 8 q heads over 2 kv heads and (D = 256)
    over one: as the fp test, and no fp paged launch."""
    g = torch.Generator(device=cuda_device).manual_seed(900 + D)
    i8 = (port_decode.paged_decode_attention_int8,
          port_decode.paged_chunk_attention_int8,
          port_decode.paged_verify_attention_int8)
    for KH in ((2, 1) if D == 256 else (2,)):
        kp, vp, tables, lens = _paged_case(g, dtype, 8, KH, D, BS=32, MB=8)
        (kq, ks), (vq, vs) = _int8_pool(kp), _int8_pool(vp)
        kq, vq = _guarded(kq, 127), _guarded(vq, 127)
        n = [f.launches for f in i8]
        n_fp = port_decode.paged_decode_attention.launches
        runs = _paged_head_dim_runs(g, dtype, D, kq, vq, tables, lens,
                                    (ks, vs))
        torch.cuda.synchronize()
        assert [f.launches for f in i8] == [x + 2 for x in n]
        assert port_decode.paged_decode_attention.launches == n_fp
        _check_paged_runs(runs, dtype, D)


@pytest.mark.cuda
def test_padded_route_runs_head_dim_132_on_card(cuda_device):
    """D = 132 is no whole number of 16-byte chunks in 16 bits: B1, B4 and
    B5-B7 zero-pad to 256 and slice back, one launch each, against their
    plain versions."""
    g = torch.Generator(device=cuda_device).manual_seed(132)
    D, dt = 132, torch.bfloat16
    q, k, v = (_randn(g, (2, 200, 4, D), dt) for _ in range(3))
    n = port_flash.flash_attention_fwd.launches
    o = port_flash.flash_attention(q, k, v)
    ref, _ = port_flash.flash_attention_reference(q, k, v)
    assert o.shape == q.shape
    assert (o.float() - ref.float()).abs().max().item() <= 2e-2
    assert port_flash.flash_attention_fwd.launches == n + 1
    kc, vc = (_randn(g, (2, 300, 2, D), dt) for _ in range(2))
    qd = _randn(g, (2, 4, D), dt)
    lens = torch.tensor([7, 300], dtype=torch.int32, device=cuda_device)
    o = port_decode.decode_attention(qd, kc, vc, lens)
    ref = port_decode.decode_attention_reference(qd, kc, vc, lens)
    assert (o.float() - ref.float()).abs().max().item() <= 1e-2
    kp, vp, tables, lens = _paged_case(g, dt, 8, 2, D, BS=32, MB=8)
    fp = (port_decode.paged_decode_attention,
          port_decode.paged_chunk_attention,
          port_decode.paged_verify_attention)
    n = [f.launches for f in fp]
    runs = _paged_head_dim_runs(g, dt, D, kp, vp, tables, lens, None)
    torch.cuda.synchronize()
    assert [f.launches for f in fp] == [x + 2 for x in n]
    _check_paged_runs(runs, dt, D)


# ------------------------------------ training head dims up to 256 (D1b-ii)

def _flash_bwd_guarded(g, B, T, H, KH, D, dtype, causal=True):
    """B2 and B3 twice at a true head dim D, q/k/v views of one guarded
    projection, o and dO guarded views: every head of dq, dk and dv held
    to the backward gates, the same bits on the second call."""
    qkv = _guarded(_randn(g, (B, T, H + 2 * KH, D), dtype))
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KH], qkv[:, :, H + KH:]
    o, lse = port_flash.flash_attention_fwd(q, k, v, causal)
    o = _guarded(o)
    do = _guarded(_randn(g, (B, T, H, D), dtype))
    runs = []
    for _ in range(2):
        dq, delta = port_flash.flash_attention_bwd_dq(q, k, v, o, lse, do,
                                                      causal)
        dk, dv = port_flash.flash_attention_bwd_dkv(q, k, v, lse, delta, do,
                                                    causal)
        runs.append((dq, dk, dv, delta))
    rq, rk, rv = port_flash.flash_attention_bwd_reference(q, k, v, o, lse,
                                                          do, causal)
    torch.cuda.synchronize()
    atol, rtol, l2 = ((1e-4, 1e-4, 1e-4) if dtype == torch.float32
                      else (2e-2, 1e-2, 1e-2))
    for name, a, r in zip(("dq", "dk", "dv"), runs[0], (rq, rk, rv)):
        assert a.shape == r.shape and a.is_contiguous(), name
        for h in range(a.shape[2]):
            elem, tile_l2 = _bwd_errors(a[:, :, h:h + 1], r[:, :, h:h + 1],
                                        atol, rtol)
            assert elem <= 1.0 and tile_l2 <= l2, (name, h, elem, tile_l2)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("D", WIDE_HEAD_DIMS)
def test_flash_bwd_takes_head_dims_to_256_on_card(cuda_device, D, dtype):
    """B2 and B3 on the 256-wide instantiation (B3 as its role split) at a
    true head dim D, GQA (4 q heads over 2 kv heads), a ragged T, causal
    and not."""
    g = torch.Generator(device=cuda_device).manual_seed(700 + D)
    for causal in (True, False):
        _flash_bwd_guarded(g, 2, 333, 4, 2, D, dtype, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("KH", [1, 4])
def test_flash_bwd_head_dim_256_kv_groups_on_card(cuda_device, KH):
    """B2 and B3 at 256 with 8 q heads on one kv head (MQA) and on four:
    B3 sums each group in a fixed order."""
    g = torch.Generator(device=cuda_device).manual_seed(800 + KH)
    _flash_bwd_guarded(g, 2, 512, 8, KH, 256, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HEAD_DTYPES)
@pytest.mark.parametrize("D,block", [
    (D, block) for D in WIDE_HEAD_DIMS
    for block in ((16, 32, 64, 128) if D == 256 else (16, 64))])
def test_block_sparse_takes_head_dims_to_256_on_card(cuda_device, D, block,
                                                     dtype):
    """B8 on the 256-wide instantiation at a true head dim D (at 256 over
    every block size: half-block ring tiles at 64 and 128), q/k/v strided
    views of a guarded projection, the output a guarded view: the sparse
    gates, the guard columns untouched, the same bits twice."""
    g = torch.Generator(device=cuda_device).manual_seed(900 + D + block)
    B, H, T = 2, 4, 512
    lut, counts = (torch.as_tensor(x, device=cuda_device) for x in
                   port_bsa.build_lut(_sparse_layout("fixed", H, block, T)))
    q, k, v = (x.transpose(1, 2) for x in _fused(g, (B, T), H, D, dtype))
    o = _guarded(torch.full((B, T, H, D), float("nan"), dtype=dtype,
                            device=cuda_device))
    buf = o._base
    out = o.transpose(1, 2)
    port_bsa.block_sparse_attention(q, k, v, lut, counts, block, True,
                                    out=out)
    first = buf.clone()
    port_bsa.block_sparse_attention(q, k, v, lut, counts, block, True,
                                    out=out)
    ref = port_bsa.block_sparse_attention_reference(q, k, v, lut, counts,
                                                    block, True)
    torch.cuda.synchronize()
    assert bool(torch.isnan(buf[..., D:]).all())
    assert torch.equal(buf[..., :D], first[..., :D])
    _assert_sparse_close(out, ref, dtype)
