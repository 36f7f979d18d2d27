#!/usr/bin/env python3
"""Where a launch of the paged verify (B7, B7i) and chunk (B6, B6i) kernels
spends its time, on one NVIDIA GPU: per-block ``%globaltimer`` stamps.

    python3 scripts/stamp_paged_kernels.py [OTHER_CHECKOUT]

Copies this checkout's ``deepspeed_tpu_torch`` to ``build/stamps/this``
(and OTHER_CHECKOUT's, e.g. ``git archive <commit> deepspeed_tpu_torch |
tar -x -C build/parent``, to ``build/stamps/other``) and turns on the
kernels' ``DSTT_STAMP`` hooks (``ops/csrc/attention_common.cuh``) in the copy: a
stamp by thread 0 of every block at its entry (0), its first stage of K/V
landed (1), the end of its key loop (2), its arrival ticket taken (3), its
exit (4) and the exit of a split with no key (5). Loads the copies beside
each other with ``other_checkout.load_wrapper``.
Each kernel runs at chip_smoke.py's phase paged shapes (S=8, BS=128, MB=8,
NB=65, verify K=4, chunks of C=256; GPT-2 XL heads and H=32/KH=8/D=128)
after an L2 flush and a device spin, as ``cuda_ms`` times it. Prints one
JSON line per kernel and case: the 0/50/90/100th percentiles of each stamp
over the blocks, in µs after the first block's entry, then the card's name
and power limit. Exits 1 when this checkout's sources have no hooks; an
other checkout's source without them takes the text edits of LEGACY (the
chunk kernel of fd62579) or is skipped with a note.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import (SPIN_CYCLES, _int8_layer_pool,  # noqa: E402
                        _paged_tables)
from other_checkout import card, load_wrapper  # noqa: E402

S, BS, MB, NB, K, C = 8, 128, 8, 65, 4, 256
NAMES = ["entry", "stage0", "loopend", "ticket", "exit", "dead"]
MAX_BLOCKS = 1 << 17

HEADER = f"""
__device__ unsigned long long dstt_stamps[{MAX_BLOCKS}][6];
__device__ __forceinline__ void dstt_stamp(int k) {{
  if (threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const long long b = (long long)blockIdx.z * gridDim.y + blockIdx.y;
    dstt_stamps[b * gridDim.x + blockIdx.x][k] = t;
  }}
}}
"""
READER = """
extern "C" int dstt_read_stamps(void* dst, int nblocks) {
  return (int)cudaMemcpyFromSymbol(dst, dstt_stamps,
                                   (size_t)nblocks * 6 * 8);
}
extern "C" int dstt_clear_stamps() {
  void* p;
  cudaGetSymbolAddress(&p, dstt_stamps);
  return (int)cudaMemset(p, 0, sizeof(dstt_stamps));
}
"""
SOURCES = ("paged_attention", "paged_chunk_attention")
# A checkout from before the hooks (the one-block-a-q-head chunk kernel of
# fd62579): its stamp points as text edits after the kernel's name
LEGACY = {
    "paged_chunk_attention": ("paged_chunk_mma_kernel(const T*", [
        ("  const int span = a.MB * a.BS;\n",
         "  const int span = a.MB * a.BS;\n  dstt_stamp(0);\n"),
        ("    __syncthreads();\n    if constexpr (Q8) {\n",
         "    __syncthreads();\n    if (j == 0) dstt_stamp(1);\n"
         "    if constexpr (Q8) {\n"),
        ("#pragma unroll\n  for (int i = 0; i < 2; ++i) {\n"
         "    l_r[i] +=",
         "  dstt_stamp(2);\n#pragma unroll\n  for (int i = 0; i < 2; "
         "++i) {\n    l_r[i] +="),
        ("  }\n}\n\n// float32: one warp per query row",
         "  }\n  dstt_stamp(4);\n}\n\n// float32: one warp per query "
         "row")]),
}


def _patch(src: str, kernel: str, edits) -> str:
    """``src`` with ``edits`` applied after ``kernel``'s definition; raises
    KeyError when a stamp point is not there."""
    lo = src.index(kernel)
    head, body = src[:lo], src[lo:]
    for old, new in edits:
        if old not in body:
            raise KeyError(old)
        body = body.replace(old, new, 1)
    return head + body


def instrument(checkout: Path, dst: Path) -> dict:
    """Copy ``checkout``'s package to ``dst`` with stamps in its paged
    sources: a source with ``DSTT_STAMP`` hooks (attention_common.cuh) gets
    ``DSTT_STAMPS`` and the stamp function ahead of its includes; one
    without takes LEGACY's text edits. Returns ``{source name: "hooks" or
    "legacy"}`` of the sources instrumented."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(checkout / "deepspeed_tpu_torch",
                    dst / "deepspeed_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = {}
    for name in SOURCES:
        path = dst / "deepspeed_tpu_torch" / "ops" / "csrc" / f"{name}.cu"
        src = path.read_text()
        done[name] = "hooks" if "DSTT_STAMP(" in src else "legacy"
        if done[name] == "hooks":
            out = "#define DSTT_STAMPS 1\n" + HEADER + src
        elif name in LEGACY:
            try:
                out = _patch(src, *LEGACY[name])
            except (KeyError, ValueError):
                del done[name]
                continue
            out = out.replace("namespace {\n", HEADER + "namespace {\n", 1)
        else:
            del done[name]
            continue
        path.write_text(out + READER)
    return done


def stamps(lib, fn, nblocks, flush):
    """Stamps of one launch of ``fn`` after a flush and a device spin (a
    first launch builds and warms): percentiles in µs over the blocks."""
    lib.dstt_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn()
    torch.cuda.synchronize()
    lib.dstt_clear_stamps()
    flush.zero_()
    torch.cuda._sleep(SPIN_CYCLES)
    fn()
    torch.cuda.synchronize()
    buf = np.zeros((nblocks, 6), np.uint64)
    lib.dstt_read_stamps(buf.ctypes.data, nblocks)
    buf = buf.astype(np.int64)
    t0 = buf[:, 0][buf[:, 0] > 0].min()
    out = {"blocks": nblocks, "entered": int((buf[:, 0] > 0).sum()),
           "dead": int((buf[:, 5] > 0).sum())}
    for k, name in enumerate(NAMES):
        v = buf[:, k][buf[:, k] > 0] - t0
        if len(v):
            out[name] = [round(float(np.percentile(v, p)) / 1e3, 2)
                         for p in (0, 50, 90, 100)]
    return out


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    checkouts = {"this": ROOT}
    if len(sys.argv) == 2:
        checkouts["other"] = Path(sys.argv[1]).resolve()
    mods = {}
    for tag, path in checkouts.items():
        done = instrument(path, ROOT / "build" / "stamps" / tag)
        if tag == "this" and done != dict.fromkeys(SOURCES, "hooks"):
            print(f"this checkout: no DSTT_STAMP hooks in "
                  f"{[n for n in SOURCES if done.get(n) != 'hooks']}",
                  file=sys.stderr)
            return 1
        for name in sorted(set(SOURCES) - set(done)):
            print(f"{tag}: no stamp points found in {name}.cu; skipped",
                  flush=True)
        builders = [b for b, n in (("PAGED_BUILDER", "paged_attention"),
                                   ("CHUNK_BUILDER", "paged_chunk_attention"))
                    if n in done]
        mod = load_wrapper(str(ROOT / "build" / "stamps" / tag),
                           "decode_attention", builders)
        for b in builders:
            getattr(mod, b).name = f"stamps_{tag}_{getattr(mod, b).name}"
        mods[tag] = (mod, done)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    rng = np.random.default_rng(3)
    span = MB * BS
    for shape, H, KH, D in (("gpt2-xl", 25, 25, 64),
                            ("gqa H=32 KH=8 D=128", 32, 8, 128)):
        def rnd(*s):
            return torch.randn(s, generator=g, device="cuda",
                               dtype=torch.bfloat16)
        kp, vp = rnd(2, NB, BS, KH, D)[1], rnd(2, NB, BS, KH, D)[1]
        kq, ks = _int8_layer_pool(rnd(2, NB, BS, KH, D))
        vq, vs = _int8_layer_pool(rnd(2, NB, BS, KH, D))
        lens_np = rng.integers(1, span - K + 1, S).astype(np.int32)
        tables = torch.as_tensor(_paged_tables(
            rng, -(-(lens_np + K) // BS), NB, MB), device="cuda")
        lens = torch.as_tensor(lens_np, device="cuda")
        row = torch.as_tensor(_paged_tables(rng, [MB], NB, MB)[0],
                              device="cuda")
        qv = rnd(S, K, H, D)
        qcs = {start: rnd(C, H, D) for start in (0, 256)}
        pools = {"": (kp, vp, {}),
                 "_int8": (kq, vq, dict(k_scale=ks, v_scale=vs))}
        for tag, (m, done) in mods.items():
            for suffix, (kpool, vpool, sc) in pools.items():
                if "paged_attention" in done:
                    units, splits, _ = m.paged_verify_plan(
                        span, S, KH, K * (H // KH))
                    r = stamps(m.PAGED_BUILDER.load(),
                               lambda: m.paged_verify_attention(
                                   qv, kpool, vpool, tables, lens, **sc),
                               units * splits, flush)
                    print(json.dumps({"checkout": tag, "kernel":
                                      "paged_verify_attention" + suffix,
                                      "shape": shape, **r}), flush=True)
                if "paged_chunk_attention" not in done:
                    continue
                for start, qc in qcs.items():
                    if done["paged_chunk_attention"] == "hooks":
                        # one block a (64-row q tile, kv head)
                        nblocks = -(-C * (H // KH) // 64) * KH
                    else:   # one block a (64-row q tile, q head)
                        nblocks = -(-C // 64) * H
                    r = stamps(m.CHUNK_BUILDER.load(),
                               lambda: m.paged_chunk_attention(
                                   qc, kpool, vpool, row, start, **sc),
                               nblocks, flush)
                    print(json.dumps({"checkout": tag, "kernel":
                                      "paged_chunk_attention" + suffix,
                                      "shape": f"{shape} start={start}",
                                      **r}), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
