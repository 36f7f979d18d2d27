"""LLaMA and BERT training paths on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False. The file imports no JAX (nor the
tests' conftest, which imports JAX), so it runs on the GPU machine as it
is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train_models.py -q

* ``FlashAttentionFunction`` non-causal at BERT-large's attention shape
  ([4, 512, 16, 64], bf16): the forward (B1) and the backward (B2, B3)
  against the kernels' plain versions, element-wise within 2e-2 + 1e-2
  |plain| and within 1e-2 relative L2 (``chip_smoke.py``'s flash
  backward gate for 16-bit inputs).
* The BERT layer's flash route under autograd against its einsum route
  (the same layer given an all-ones key mask) at BERT-large's width: the
  output and the gradients of x and of every weight within 2e-2 relative
  L2. The two routes round P and the attention output to bf16 at other
  places; a flash route that stopped the gradient, or one without B2/B3,
  reads 1 here. The launch counters show which route ran.
* A 2-layer LLaMA at llama-7b-gqa's width (4096 wide, 32 heads of 128 over
  8 KV heads, FFN 14336), bf16: the loss within 1e-2 relative and the
  gradient of every weight within 5e-2 relative L2 of the same model with
  ``use_flash_attention=False`` (``chip_smoke.py``'s training oracle); B3
  runs its group sum at 4 query heads a KV head.
"""
import math

import pytest
import torch

from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import transformer as port_tf


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _counts():
    return {f.__name__: f.launches for f in (
        fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
        fa.flash_attention_bwd_dkv)}


@pytest.mark.cuda
def test_non_causal_flash_function_at_bert_shape(cuda_device):
    g = torch.Generator(device="cuda").manual_seed(0)
    B, T, H, D = 4, 512, 16, 64
    q, k, v, do = (torch.randn((B, T, H, D), generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    before = _counts()
    o = fa.FlashAttentionFunction.apply(qa, ka, va, False,
                                        1.0 / math.sqrt(D))
    grads = torch.autograd.grad(o, (qa, ka, va), do)
    after = _counts()
    assert {n: after[n] - before[n] for n in after} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1}
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=False)
    refs = fa.flash_attention_bwd_reference(q, k, v, ro, rlse, do,
                                            causal=False)
    for name, a, r in zip(("o", "dq", "dk", "dv"), (o, *grads),
                          (ro, *refs)):
        err = (a.float() - r.float()).abs()
        assert bool((err <= 2e-2 + 1e-2 * r.float().abs()).all()), name
        assert _rel_l2(a, r) <= 1e-2, (name, _rel_l2(a, r))


@pytest.mark.cuda
@pytest.mark.parametrize("pre_ln", [True, False], ids=["pre-ln", "post-ln"])
def test_bert_layer_flash_gradients_equal_the_einsum_route(cuda_device,
                                                           pre_ln):
    cfg = port_tf.DeepSpeedTransformerConfig(
        hidden_size=1024, heads=16, intermediate_size=4096, fp16=True,
        attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
        num_hidden_layers=24, pre_layer_norm=pre_ln)
    layer = port_tf.DeepSpeedTransformerLayer(cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    params = layer.init(g)
    # biases and LayerNorms off their init values, so their gradients and
    # placement show
    for k in params:
        if params[k].dim() == 1:
            params[k] = params[k] + 0.1 * torch.randn(
                params[k].shape, generator=g, device="cuda").to(
                    params[k].dtype)
    x = torch.randn((2, 512, 1024), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    dy = torch.randn_like(x)
    mask = torch.ones((2, 512), dtype=torch.int32, device="cuda")
    out = {}
    for route, m in (("flash", None), ("einsum", mask)):
        leaves = [x.clone().requires_grad_()] + [
            p.clone().requires_grad_() for p in params.values()]
        before = _counts()
        y = layer(dict(zip(params, leaves[1:])), leaves[0],
                  attention_mask=m)
        grads = torch.autograd.grad(y, leaves, dy)
        after = _counts()
        out[route] = (y, grads, {n: after[n] - before[n] for n in after})
    assert set(out["flash"][2].values()) == {1}
    assert set(out["einsum"][2].values()) == {0}
    assert _rel_l2(out["flash"][0], out["einsum"][0]) <= 2e-2
    for name, a, b in zip(["x", *params], out["flash"][1],
                          out["einsum"][1]):
        assert torch.isfinite(a).all(), name
        assert _rel_l2(a, b) <= 2e-2, (name, _rel_l2(a, b))


@pytest.mark.cuda
def test_llama_7b_gqa_width_matches_plain_attention(cuda_device):
    cfg = port_llama.config_for("llama-7b-gqa", n_layer=2)
    model = port_llama.LlamaLMModel(cfg)
    params = {k: v.to(torch.bfloat16) for k, v in model.init(
        torch.Generator(device="cuda").manual_seed(2)).items()}
    ids = torch.randint(0, cfg.vocab_size, (1, 1024),
                        generator=torch.Generator().manual_seed(3)
                        ).to(cuda_device)
    out = {}
    for flash in (True, False):
        m = port_llama.LlamaLMModel(
            port_llama.config_for("llama-7b-gqa", n_layer=2,
                                  use_flash_attention=flash))
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        before = _counts()
        loss = m.loss_fn(leaves, {"input_ids": ids})
        grads = torch.autograd.grad(loss, list(leaves.values()))
        after = _counts()
        out[flash] = (loss.item(), grads,
                      {n: after[n] - before[n] for n in after})
    # two layers, each forward twice under remat; one backward each
    assert out[True][2] == {"flash_attention_fwd": 4,
                            "flash_attention_bwd_dq": 2,
                            "flash_attention_bwd_dkv": 2}
    assert set(out[False][2].values()) == {0}
    assert math.isfinite(out[True][0])
    assert abs(out[True][0] - out[False][0]) <= 1e-2 * abs(out[False][0])
    for name, a, b in zip(params, out[True][1], out[False][1]):
        assert torch.isfinite(a).all(), name
        assert _rel_l2(a, b) <= 5e-2, (name, _rel_l2(a, b))
