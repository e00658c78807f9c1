#!/usr/bin/env python3
"""The mixed GEMM's times with f16 x above 16 rows, beside bf16 x, on one
GPU:

    python3 scripts/torch_b6_f16_times.py [--root DIR] [--build-only]
        [--out FILE]

At llama3-8b's four projection shapes (K, N), M = 256 (a mixed step) and
4096 (v1's prefill), bits 8, 4 and 6, group 256, seeded random weights, it
times ``mixed_gemm`` on f16 x and on the same values in bf16 as
``chip_smoke.py`` times B6 (L2 flushed by a 256 MB memset, CUDA events,
median of 30), and holds the f16 output against ``mixed_gemm_plain``
within ``chip_smoke.py``'s f16 limit.  Only ``csrc/mixed_gemm.cu`` (and
``paged_attention.cu``, which holds the error strings) is built, into its
own library under ``build/b6_f16_times/``.  ``--root`` takes the package,
its sources and ``chip_smoke.py`` from another checkout (say, a parent
commit unpacked with ``git archive`` into ``build/``), so that two
versions of the kernel can be timed in one call on one card;
``--build-only`` builds and exits, so that both builds can run at once.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M_ROWS = (256, 4096)


def build_gemm_only(build, root: str) -> ctypes.CDLL:
    """Compile mixed_gemm.cu and paged_attention.cu of ``build.CSRC`` into
    one library (named by a digest of its sources) and install it as the
    package's kernel library."""
    srcs = [build.CSRC / "mixed_gemm.cu", build.CSRC / "paged_attention.cu"]
    h = hashlib.sha256()
    for src in srcs + list(build.HEADERS):
        h.update(src.read_bytes())
    out_dir = os.path.join(root, "build", "b6_f16_times")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"lib-{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        objs = [os.path.join(out_dir, f"{src.stem}.{os.getpid()}.o")
                for src in srcs]
        procs = [subprocess.Popen([build.nvcc_path(), *build.COMPILE_FLAGS,
                                   "-c", "-o", obj, str(src)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            sys.exit("build failed:\n" + "\n".join(logs)[-8000:])
        link = subprocess.run([build.nvcc_path(), "-shared", "-o", lib_path,
                               *objs], capture_output=True, text=True)
        for obj in objs:
            os.unlink(obj)
        if link.returncode:
            sys.exit("link failed:\n" + link.stdout + link.stderr)
    lib = ctypes.CDLL(lib_path)
    for fn in ("ds_mixed_gemm", "ds_int8_gemm"):
        getattr(lib, fn).argtypes = build._ENTRIES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.ds_error_string.argtypes = [ctypes.c_int]
    lib.ds_error_string.restype = ctypes.c_char_p
    build._LIB = lib
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke as cs
    from deepspeed_tpu_torch.ops.hopper import build
    from deepspeed_tpu_torch.ops.hopper import mixed_gemm as mg

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    build_gemm_only(build, root)
    if args.build_only:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
    rows = []
    for shape, (K, N) in cs.GEMM_SHAPES.items():
        w = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
        for bits in (8, 4, 6):
            qw = mg.quantize_gemm_weight(w, bits=bits, group=cs.QUANT_GROUP)
            for M in M_ROWS:
                xh = torch.randn((M, K), generator=gen, device="cuda",
                                 dtype=torch.float16)
                xb = xh.to(torch.bfloat16)
                what = f"bits={bits} {shape} M={M}"
                err = cs.compare_f16(mg.mixed_gemm(xh, qw),
                                     mg.mixed_gemm_plain(xh, qw), what,
                                     rel=cs.GEMM_F32_REL)
                row = {"shape": shape, "K": K, "N": N, "bits": bits, "M": M,
                       "splits": mg.mixed_gemm_splits(M, N, K // qw.group,
                                                      sms),
                       "max_abs_err": err,
                       "f16_ms": cs.time_ms(lambda: mg.mixed_gemm(xh, qw),
                                            torch, flush),
                       "bf16_ms": cs.time_ms(lambda: mg.mixed_gemm(xb, qw),
                                             torch, flush)}
                row["f16_over_bf16"] = row["f16_ms"] / row["bf16_ms"]
                print(json.dumps(row), flush=True)
                rows.append(row)
            del qw
        del w
    out = {"card": card, "root": root, "rows": rows}
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
