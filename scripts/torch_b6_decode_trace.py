#!/usr/bin/env python3
"""Where the time of the mixed GEMM's decode rows goes, on one GPU:

    python3 scripts/torch_b6_decode_trace.py [--out FILE]

It builds ``csrc/mixed_gemm.cu`` a second time with ``-DDS_DECODE_TRACE``
into its own library under ``build/`` (the port's own library is never
built so), in which thread 0 of every ``mixed_gemm_decode_kernel`` block
stamps ``%globaltimer`` at its start, its first step's products, the end
of its warps' steps, its stores, its split-K ticket and a shared tile's
sum, and notes its SM.  Then, at llama3-8b's four projection shapes (K,
N), M = 8 rows, bits 8, 4 and 6, group 256, seeded random weights, it
times one call as ``chip_smoke.py`` times B6 (L2 flushed by a 256 MB
memset, CUDA events) and prints the blocks' timeline relative to the
first block's start (min / median / max over blocks), the span from the
first start to the last stamp, and how many SMs ran 1, 2, ... blocks.
The event time less the span is what lies outside the kernel: the launch
and the events.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

STAMPS = ("start", "first_step", "steps_done", "stored", "ticket", "tile_sum")


def build_traced(build) -> ctypes.CDLL:
    out = os.path.join(ROOT, "build", "decode_trace", "libds_decode_trace.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    flags = [f for f in build.COMPILE_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run(
        [build.nvcc_path(), *flags, "-DDS_DECODE_TRACE", "-shared", "-o", out,
         str(build.CSRC / "mixed_gemm.cu"),
         str(build.CSRC / "paged_attention.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        cs.fail("traced build failed:\n" + proc.stdout[-4000:]
                + proc.stderr[-4000:])
    lib = ctypes.CDLL(out)
    lib.ds_mixed_gemm.argtypes = build._ENTRIES["ds_mixed_gemm"]
    lib.ds_mixed_gemm.restype = ctypes.c_int
    lib.ds_error_string.argtypes = [ctypes.c_int]
    lib.ds_error_string.restype = ctypes.c_char_p
    lib.ds_decode_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ds_decode_trace.restype = ctypes.c_int
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    from deepspeed_tpu_torch.ops.hopper import build
    from deepspeed_tpu_torch.ops.hopper import mixed_gemm as mg

    card = cs.card_line()
    print(card)
    lib = build_traced(build)
    build._LIB = lib  # the wrappers launch the traced kernels
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
    rows = []
    for shape, (K, N) in cs.GEMM_SHAPES.items():
        w = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
        for bits in (8, 4, 6):
            qw = mg.quantize_gemm_weight(w, bits=bits, group=cs.QUANT_GROUP)
            x = torch.randn((8, K), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            for _ in range(3):
                mg.mixed_gemm(x, qw)
            torch.cuda.synchronize()
            lib.ds_decode_trace(None, 1)
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            mg.mixed_gemm(x, qw)
            end.record()
            end.synchronize()
            event_us = start.elapsed_time(end) * 1e3
            buf = np.zeros(4096 * 8, np.uint64)
            build.check(lib, lib.ds_decode_trace(buf.ctypes.data, 0),
                        "decode trace read")
            blocks = mg.decode_blocks(8, N, K, cs.QUANT_GROUP,
                                      mg._sm_count(torch.device("cuda")))
            t = buf.reshape(4096, 8)[:blocks].astype(np.int64)
            t0 = t[:, 0].min()
            row = {"shape": shape, "K": K, "N": N, "bits": bits, "M": 8,
                   "blocks": blocks, "event_us": event_us,
                   "span_us": (t[:, :6].max() - t0) / 1e3}
            for i, name in enumerate(STAMPS):
                v = (t[:, i][t[:, i] > 0] - t0) / 1e3
                if v.size:
                    row[name] = [float(v.min()), float(np.median(v)),
                                 float(v.max())]
            per_sm = np.bincount(t[:, 7], minlength=mg._sm_count(
                torch.device("cuda")))
            row["sms_with_blocks"] = np.bincount(per_sm).tolist()
            rows.append(row)
            print(f"{shape} bits={bits} M=8 blocks={blocks}: event "
                  f"{event_us:.2f} us, span {row['span_us']:.2f} us ({card})")
            for name in STAMPS:
                if name in row:
                    lo, med, hi = row[name]
                    print(f"   {name:10s} min {lo:7.2f} median {med:7.2f} "
                          f"max {hi:7.2f} us")
            print(f"   SMs with 0, 1, 2, ... blocks: {row['sms_with_blocks']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
