#!/usr/bin/env python3
"""Where a launch of the dense decode (B4) and block-sparse (B8) kernels
spends its time, on one NVIDIA GPU: per-block ``%globaltimer`` stamps, and
the launch floor of a kernel that does nothing.

    python3 scripts/stamp_decode_sparse.py [OTHER_CHECKOUT] [--out DIR]

Copies this checkout's ``deepspeed_tpu_torch`` to ``build/stamps/this``
(and OTHER_CHECKOUT's to ``build/stamps/other``) and turns on the
``DSTT_STAMP`` hooks (``ops/csrc/attention_common.cuh``) of the sources
that hold B4 and B8 in the copy, as ``stamp_paged_kernels.py`` does: a
stamp by thread 0 of every block at its entry (0), its first K/V landed
(1), the end of its key loop (2), its arrival ticket taken (3), its exit
(4) and the exit of a split with no key (5). A source without hooks is
skipped with a note; this checkout must have them (exit 1 otherwise).

Cases: chip_smoke.py's phase decode (B=8, S=1024, bf16, seeded lengths in
[1, 1024]; GPT-2 XL heads H=KH=25, D=64, and H=32, KH=8, D=128, layer views
of a 2-layer cache) and phase sparse case (i) (B=2, T=4096, 16 heads of
128, Fixed layout of blocks of 64, causal, bf16, strided views), each
launch after an L2 flush and a device spin, as ``cuda_ms`` times it. Prints
one JSON line per kernel and case: the 0/50/90/100th percentiles of each
stamp over the blocks that entered, in µs after the first block's entry;
for B4 also the lengths and the last exit. Then the floor:
``cuda_ms`` of a kernel with an empty body on B4's and B8's grids, of a
kernel that only reads the live K/V bytes of B4's GPT-2 XL case once
(plain and streaming loads), and of each checkout's B4 at both cases, each
with and without the flush.
With ``--out``, the raw stamps of the blocks that entered (and their
indices) go to DIR/stamps_<checkout>_<kernel>_<case>.npz.
Last, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import SPIN_CYCLES, _fixed_1p3b, cuda_ms  # noqa: E402
from other_checkout import card, load_wrapper  # noqa: E402
from stamp_paged_kernels import HEADER, MAX_BLOCKS, NAMES, READER  # noqa: E402

SOURCES = ("decode_attention", "paged_attention", "block_sparse_attention")
DECODE_CASES = [("gpt2-xl", 8, 1024, 25, 25, 64),
                ("gqa H=32 KH=8 D=128", 8, 1024, 32, 8, 128)]
NOOP = r"""
__global__ void dstt_noop_kernel() {}
extern "C" int dstt_noop(int gx, int gy, int gz, int threads, void* stream) {
  dstt_noop_kernel<<<dim3(gx, gy, gz), threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
// n 16-byte words read once, plainly or as streaming loads (evict first)
template <bool CS>
__global__ void dstt_stream_kernel(const uint4* src, long long n, unsigned* out) {
  unsigned x = 0;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n; i += gridDim.x * 256ll)
    x ^= CS ? __ldcs(src + i).x : src[i].x;
  if (x == 0x9e3779b9u) *out = x;
}
extern "C" int dstt_stream(const void* src, long long n, void* out, int cs, int blocks,
                           void* stream) {
  if (cs) dstt_stream_kernel<true><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, n, (unsigned*)out);
  else dstt_stream_kernel<false><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, n, (unsigned*)out);
  return (int)cudaGetLastError();
}
extern "C" const char* dstt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def instrument(checkout: Path, dst: Path) -> list:
    """Copy ``checkout``'s package to ``dst`` with ``DSTT_STAMPS`` and the
    stamp function ahead of each of SOURCES that has hooks; returns the
    names of those sources."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(checkout / "deepspeed_tpu_torch",
                    dst / "deepspeed_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = []
    for name in SOURCES:
        path = dst / "deepspeed_tpu_torch" / "ops" / "csrc" / f"{name}.cu"
        if path.is_file() and "DSTT_STAMP(" in path.read_text():
            path.write_text("#define DSTT_STAMPS 1\n" + HEADER
                            + path.read_text() + READER)
            done.append(name)
    return done


def read_stamps(builders, fn, flush):
    """Raw stamps [blocks, 6] (ns, 0 where unset) of one launch of ``fn``
    after a flush and a device spin (a first launch builds and warms), from
    whichever library of ``builders`` the launch loaded and wrote."""
    fn()
    torch.cuda.synchronize()
    libs = [b._lib for b in builders
            if b._lib is not None and hasattr(b._lib, "dstt_read_stamps")]
    for lib in libs:
        lib.dstt_clear_stamps()
    flush.zero_()
    torch.cuda._sleep(SPIN_CYCLES)
    fn()
    torch.cuda.synchronize()
    for lib in libs:
        lib.dstt_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        buf = np.zeros((MAX_BLOCKS, 6), np.uint64)
        lib.dstt_read_stamps(buf.ctypes.data, MAX_BLOCKS)
        buf = buf.astype(np.int64)
        if (buf[:, 0] > 0).any():
            return buf
    raise RuntimeError("no block stamped")


def summary(buf):
    """Percentiles (0/50/90/100) of each stamp in µs after the first entry,
    over the blocks that entered."""
    t0 = buf[:, 0][buf[:, 0] > 0].min()
    out = {"entered": int((buf[:, 0] > 0).sum()),
           "dead": int((buf[:, 5] > 0).sum())}
    for k, name in enumerate(NAMES):
        v = buf[:, k][buf[:, k] > 0] - t0
        if len(v):
            out[name] = [round(float(np.percentile(v, p)) / 1e3, 2)
                         for p in (0, 50, 90, 100)]
    return out


def load(tag, path):
    """The two wrapper modules of an instrumented copy, their libraries'
    builders renamed so each copy has its own cached ``.so``."""
    da = load_wrapper(str(path), "decode_attention", _decode_builders(path))
    bsa = load_wrapper(str(path), "block_sparse_attention", ["BUILDER"])
    for b in (*_builders_of(da), bsa.BUILDER):
        b.name = f"stamps_{tag}_{b.name}"
    return da, bsa


def _decode_builders(path):
    """B4's library: ``decode_attention.cu`` (the parent's) or the paged
    one, whichever the checkout's ``decode_attention.py`` builds."""
    src = (Path(path) / "deepspeed_tpu_torch" / "ops" /
           "decode_attention.py").read_text()
    return [b for b in ("BUILDER", "PAGED_BUILDER") if f"\n{b} = " in src]


def _builders_of(da):
    return [getattr(da, b) for b in ("BUILDER", "PAGED_BUILDER")
            if hasattr(da, b)]


def noop_builder():
    from deepspeed_tpu_torch.ops.op_builder import CUDAOpBuilder
    src = ROOT / "build" / "stamps" / "noop.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(NOOP)

    def bind(lib):
        lib.dstt_noop.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.dstt_stream.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
    b = CUDAOpBuilder("stamps_noop", bind)
    b.source = src
    return b.load()


def floors(flush, tiny, lens):
    """``cuda_ms`` with and without the flush of an empty kernel on B4's
    grids (the parent's (25, 8) x 256, the split (25, 8, 2) x 256) and B8's
    persistent grid (132 x 384), and of reading the live K/V bytes of B4's
    GPT-2 XL case at ``lens`` (2 x 2 x sum x 25 x 64 bytes) once, plainly
    and as streaming loads (4 blocks of 256 an SM)."""
    lib = noop_builder()
    stream = torch.cuda.current_stream().cuda_stream
    grids = {"B4 parent grid (25, 8) x 256": (25, 8, 1, 256),
             "B4 grid (25, 8, 2) x 256": (25, 8, 2, 256),
             "B8 persistent grid 132 x 384": (132, 1, 1, 384)}
    out = []
    for name, (gx, gy, gz, th) in grids.items():
        rec = {"floor": name}
        for f, fl in (("flush", flush), ("no_flush", tiny)):
            rec[f"{f}_ms"] = cuda_ms(lambda: lib.dstt_noop(gx, gy, gz, th,
                                                           stream), 100, fl)
        out.append(rec)
    nbytes = 2 * 2 * int(lens.sum()) * 25 * 64
    src = torch.zeros(nbytes // 4, dtype=torch.int32, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    for cs in (0, 1):
        rec = {"floor": f"stream {nbytes} bytes, "
                        f"{'streaming' if cs else 'plain'} loads"}
        for f, fl in (("flush", flush), ("no_flush", tiny)):
            rec[f"{f}_ms"] = cuda_ms(lambda: lib.dstt_stream(
                src.data_ptr(), nbytes // 16, sink.data_ptr(), cs, blocks,
                stream), 100, fl)
        out.append(rec)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    checkouts = {"this": ROOT}
    if args.other:
        checkouts["other"] = Path(args.other).resolve()
    mods = {}
    for tag, path in checkouts.items():
        dst = ROOT / "build" / "stamps" / tag
        done = instrument(path, dst)
        if tag == "this" and not {"block_sparse_attention"} <= set(done):
            print("this checkout: no DSTT_STAMP hooks in B8's source",
                  file=sys.stderr)
            return 1
        print(f"{tag}: hooks in {done}", flush=True)
        mods[tag] = (*load(tag, dst), done)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    tiny = torch.empty(1, dtype=torch.int32, device="cuda")

    def emit(kernel, case, tag, buf, extra=None):
        rec = {"checkout": tag, "kernel": kernel, "case": case,
               **summary(buf), **(extra or {})}
        print(json.dumps(rec), flush=True)
        if args.out:
            idx = np.nonzero(buf[:, 0])[0]
            np.savez(Path(args.out) / f"stamps_{tag}_{kernel}_"
                     f"{case.split()[0]}.npz", block=idx, stamps=buf[idx])

    # ---- B4 at phase decode's cases (chip_smoke.py's seeds and order)
    g = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)
    decode_in = {}
    for name, B, S, H, KH, D in DECODE_CASES:
        kc = torch.randn((2, B, S, KH, D), generator=g, device="cuda",
                         dtype=torch.bfloat16)[1]
        vc = torch.randn((2, B, S, KH, D), generator=g, device="cuda",
                         dtype=torch.bfloat16)[1]
        q = torch.randn((B, H, D), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        lens_np = rng.integers(1, S + 1, B).astype(np.int32)
        lens = torch.as_tensor(lens_np, device="cuda")
        decode_in[name] = (q, kc, vc, lens)
        for tag, (da, _, done) in mods.items():
            # B4's source: decode_attention.cu where the checkout has one
            # (the dense decode in a source of its own), else
            # paged_attention.cu
            b4 = ("decode_attention" if (checkouts[tag] / "deepspeed_tpu_torch"
                  / "ops" / "csrc" / "decode_attention.cu").is_file()
                  else "paged_attention")
            if b4 not in done:
                print(f"{tag}: B4's source has no hooks; skipped", flush=True)
                continue
            buf = read_stamps(_builders_of(da), lambda: da.decode_attention(q, kc, vc,
                                                                lens), flush)
            t0 = buf[:, 0][buf[:, 0] > 0].min()
            emit("decode_attention", name, tag, buf,
                 {"lengths": lens_np.tolist(),
                  "last_exit_us": round(float(buf[:, 4].max() - t0) / 1e3,
                                        2)})

    # ---- B8 at phase sparse case (i)
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa_this
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    g = torch.Generator(device="cuda").manual_seed(11)
    lay = _fixed_1p3b(sa).make_layout(4096)
    lut_np, counts_np = bsa_this.build_lut(lay)
    lut, counts = (torch.as_tensor(x, device="cuda")
                   for x in (lut_np, counts_np))
    q, k, v = (x.transpose(1, 2) for x in torch.randn(
        (2, 4096, 3, 16, 128), generator=g, device="cuda",
        dtype=torch.bfloat16).unbind(2))
    order = torch.as_tensor(bsa_this.tile_order(lut_np, counts_np, True),
                            device="cuda")
    for tag, (_, bsa, done) in mods.items():
        if "block_sparse_attention" not in done:
            print(f"{tag}: B8's source has no hooks; skipped", flush=True)
            continue
        # with the tile order SparseSelfAttention caches, where taken
        kw = ({"order": order} if "order" in inspect.signature(
            bsa.block_sparse_attention).parameters else {})
        buf = read_stamps([bsa.BUILDER], lambda: bsa.block_sparse_attention(
            q, k, v, lut, counts, 64, True, **kw), flush)
        emit("block_sparse_attention", "(i) gpt2-1.3b fixed", tag, buf)

    # ---- the floor: an empty kernel on B4's and B8's grids, the live K/V
    # bytes of B4's GPT-2 XL case streamed by a kernel that does nothing
    # else, and B4 itself, with and without the flush
    from deepspeed_tpu_torch.ops import decode_attention as da_this
    for rec in floors(flush, tiny, decode_in["gpt2-xl"][3]):
        print(json.dumps(rec), flush=True)
    calls = {"this_unstamped": da_this}
    if "other" in checkouts:
        calls["other_unstamped"] = load_wrapper(
            str(checkouts["other"]), "decode_attention",
            _decode_builders(checkouts["other"]))
    for name, ins in decode_in.items():
        for tag, m in calls.items():
            rec = {"kernel": "decode_attention", "case": name,
                   "checkout": tag}
            for f, fl in (("flush", flush), ("no_flush", tiny)):
                rec[f"{f}_ms"] = cuda_ms(lambda: m.decode_attention(*ins),
                                         100, fl)
            print(json.dumps(rec), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
