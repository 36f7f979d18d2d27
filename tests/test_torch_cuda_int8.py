"""The int8 GEMMs (w8a8 inference, SwitchBack training) on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False: ``torch._int_mm``'s CUDA path and
its shape rules exist only there. The file imports no JAX (nor the tests'
conftest, which does), so it runs on the GPU machine as it is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_int8.py -q

* ``int8_mm`` at M in {1, 8, 16, 17, 64} (``_int_mm`` refuses M <= 16:
  the rows are zero-padded to 17), with the weight row- or column-major:
  the int32 result equals the exact integer product, eagerly and replayed
  from a captured CUDA graph.
* ``int8_einsum`` (q/k/v, attention out, 2-D) and ``int8_matmul`` at the
  same M: the card's result equals the CPU's (the same f32 quantization
  arithmetic, an exact int32 product, the same f32 rescale; 1e-6
  relative), eager and graphed.
* A shape ``_int_mm`` refuses (a width off a multiple of 8) raises,
  through the seam too: nothing falls back to the dequantizing path.
* SwitchBack's forward and dx equal the CPU's to 1e-6 relative; its dw
  (bf16 operands, f32 accumulation on the tensor cores) is within one
  bf16 step of the largest element.
* A w8a8 engine stores every int8 GEMM weight column-major, and its
  graphed ``generate`` gives the eager tokens.
"""
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.cuda_graph import GraphedStep
from deepspeed_tpu_torch.model_implementations.transformer import (
    InferenceTransformerConfig, init_params)
from deepspeed_tpu_torch.module_inject.quantize import (quantize_weight,
                                                        quantize_weight_out)
from deepspeed_tpu_torch.ops.int8_gemm import (int8_einsum, int8_matmul,
                                               int8_mm, is_quantized,
                                               maybe_int8_matmul)
from deepspeed_tpu_torch.ops.int8_training import switchback_matmul

ROWS = (1, 8, 16, 17, 64)
RTOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch._int_mm's CUDA path has no "
                    "CPU mode")
    return torch.device("cuda")


def _graphed(fn, *args):
    """``fn(*args)`` through the port's graph runner: warmed up, captured
    and replayed once; the replay's output."""
    step = GraphedStep("int8 check", fn, args, lambda: ())
    step()
    out = step()
    assert step.captures == 1 and step.replays == 1
    return out


def _i8(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("layout", ["row", "col"])
def test_int8_mm_is_exact(cuda_device, M, layout):
    a, b = _i8(M, 1600), _i8(1600, 4800, seed=1)
    want = (a.double() @ b.double()).long()
    ga, gb = a.to(cuda_device), b.to(cuda_device)
    if layout == "col":
        gb = gb.t().contiguous().t()
    for out in (int8_mm(ga, gb), _graphed(int8_mm, ga, gb)):
        assert out.dtype == torch.int32 and out.shape == (M, 4800)
        assert torch.equal(out.cpu().long(), want)


def _rand(*shape, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g)


FORMS = {
    # (subscripts, x's trailing shape, weight shape, contract, x_c, w_out)
    "qkv": ("...e,ehd->...hd", (64,), (64, 4, 16), (0,), 1, 2),
    "attn_out": ("...hd,hde->...e", (4, 16), (4, 16, 64), (0, 1), 2, 1),
    "2d": ("...k,kn->...n", (64,), (64, 96), (0,), 1, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("form", sorted(FORMS))
def test_int8_einsum_on_the_card_matches_the_cpu(cuda_device, M, form):
    sub, xt, wshape, contract, xc, wo = FORMS[form]
    x = _rand(M, *xt)
    node = quantize_weight_out(_rand(*wshape, seed=3), contract)
    want = int8_einsum(sub, x, node, xc, wo, torch.float32)
    gnode = {k: v.to(cuda_device) for k, v in node.items()}
    gx = x.to(cuda_device)

    def run(t):
        return int8_einsum(sub, t, gnode, xc, wo, torch.float32)
    for out in (run(gx), _graphed(run, gx)):
        torch.testing.assert_close(out.cpu(), want, rtol=RTOL,
                                   atol=RTOL * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("M", ROWS)
def test_int8_matmul_on_the_card_matches_the_cpu(cuda_device, M):
    x = _rand(M, 64)
    node = quantize_weight(_rand(64, 96, seed=4), 16)
    want = int8_matmul(x, node)
    gnode = {k: v.to(cuda_device) for k, v in node.items()}
    gx = x.to(cuda_device)
    for out in (int8_matmul(gx, gnode), _graphed(int8_matmul, gx, gnode)):
        torch.testing.assert_close(out.cpu(), want, rtol=RTOL,
                                   atol=RTOL * float(want.abs().max()))


@pytest.mark.cuda
def test_refused_shape_raises(cuda_device):
    a = _i8(32, 12).to(cuda_device)
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_mm(a, _i8(12, 16).to(cuda_device))
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_mm(_i8(32, 16).to(cuda_device), _i8(16, 12).to(cuda_device))
    node = {k: v.to(cuda_device) for k, v in
            quantize_weight_out(_rand(12, 16), (0,)).items()}
    with pytest.raises(ValueError, match="multiples of 8"):
        maybe_int8_matmul(_rand(4, 12).to(cuda_device), node, torch.float32,
                          True)


@pytest.mark.cuda
def test_switchback_on_the_card_matches_the_cpu(cuda_device):
    x, w, dy = _rand(4, 24, 64), _rand(64, 96, seed=5) * 0.1, \
        _rand(4, 24, 96, seed=6)
    res = []
    for dev, dt in (("cpu", torch.float32), (cuda_device, torch.float32),
                    (cuda_device, torch.bfloat16)):
        tx = x.to(dev, dt).requires_grad_()
        tw = w.to(dev, dt).requires_grad_()
        y = switchback_matmul(tx, tw)
        dx, dw = torch.autograd.grad(y, [tx, tw], dy.to(dev, dt))
        res.append([t.detach().float().cpu() for t in (y, dx, dw)])
    (y0, dx0, dw0), (y1, dx1, dw1), (_, _, dw2) = res
    for a, b in ((y1, y0), (dx1, dx0)):
        torch.testing.assert_close(a, b, rtol=RTOL,
                                   atol=RTOL * float(b.abs().max()))
    torch.testing.assert_close(dw1, dw0, rtol=0,
                               atol=1e-5 * float(dw0.abs().max()))
    top = float(dw0.abs().max())
    step = 2.0 ** (torch.tensor(top).log2().floor().item() - 7)
    # bf16 x and dy are rounded copies: dw moves by their rounding too
    ref = (x.to(torch.bfloat16).float().reshape(-1, 64).t()
           @ dy.to(torch.bfloat16).float().reshape(-1, 96))
    torch.testing.assert_close(dw2, ref.to(torch.bfloat16).float(), rtol=0,
                               atol=step)


@pytest.mark.cuda
def test_w8a8_engine_graph_matches_eager(cuda_device):
    cfg = InferenceTransformerConfig(vocab_size=512, n_positions=512,
                                     n_embd=256, n_layer=2, n_head=4)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = deepspeed_tpu_torch.init_inference(
        (cfg, params), dtype="bfloat16", max_out_tokens=256,
        quant={"enabled": True, "activation": {"enabled": True}})
    assert eng.model_config.int8_compute
    attn, mlp = eng.params["layers"][0]["attn"], eng.params["layers"][0][
        "mlp"]
    for node, c in ((attn["wq"], 1), (attn["wo"], 2), (mlp["wi"], 1)):
        assert is_quantized(node) and "oscale" in node
        q = node["q"]
        assert q.reshape(q.shape[:c].numel(), -1).stride(0) == 1
    prompts = [[1, 2, 3, 4, 5], list(range(10, 60)), [7] * 20]
    out = eng.generate(prompts, max_new_tokens=12)
    assert eng._kept[2] is not None and eng._kept[2].replays > 0
    eng._cuda_graphs = False
    assert eng.generate(prompts, max_new_tokens=12) == out
