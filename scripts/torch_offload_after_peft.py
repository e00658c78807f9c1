#!/usr/bin/env python3
"""``chip_smoke.py``'s peft phase and then its offload phase, round after
round in one process on one GPU, with every host registration of the
offload tiers checked:

    python3 scripts/torch_offload_after_peft.py [--rounds N]
        [--ckpt-layers L] [--out FILE]

Each round runs ``checkpoint_roundtrips`` at ``--ckpt-layers`` layers (0
skips it; the smoke's 2-layer parts of the peft phase take the same
depth), ``run_peft_phase`` and ``run_offload_phase``: the order in which
the smoke runs them.  ``HostArena`` registrations (``cudaHostRegister``)
and unregistrations are wrapped: a range that overlaps one still
registered, or a call that returns an error, ends the run with both
ranges named.  One line a round (seconds, registrations, the most bytes
registered at once), then a JSON line with the rounds.  It builds the
kernels into ``build/torch_kernels/`` as ``chip_smoke.py`` does (a build
already there is reused).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def watch_registrations(torch, po, log: dict) -> None:
    """Wrap ``HostArena._register`` and the arenas' unregistration so that
    every range is checked against the live ones and every CUDA return
    code is read."""
    live = log["live"]  # ptr -> span
    register = po.HostArena._register

    def checked_register(self, owner, ptr, span):
        for p, n in live.items():
            if ptr < p + n and p < ptr + span:
                sys.exit(f"host range [{ptr:#x}, +{span}) overlaps the "
                         f"registered [{p:#x}, +{n})")
        register(self, owner, ptr, span)
        live[ptr] = span
        log["registered"] += 1
        log["most_bytes"] = max(log["most_bytes"], sum(live.values()))

    def checked_unregister(ptrs, keep):
        cudart = torch.cuda.cudart()
        for p in ptrs:
            rc = int(cudart.cudaHostUnregister(p))
            if rc != 0:
                sys.exit(f"cudaHostUnregister({p:#x}, span "
                         f"{live.get(p)}) returned {rc}")
            live.pop(p, None)
        keep.clear()

    po.HostArena._register = checked_register
    po._unregister = checked_unregister


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ckpt-layers", type=int, default=1)
    ap.add_argument("--out", help="also write the rounds as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs an NVIDIA "
                 "GPU")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import cpu_adam
    from deepspeed_tpu_torch.ops.hopper import build
    from deepspeed_tpu_torch.ops.hopper import flash_attention as fa
    from deepspeed_tpu_torch.ops.hopper import mixed_gemm as mg
    from deepspeed_tpu_torch.runtime.zero import param_offload as po

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    host_build = threading.Thread(target=cpu_adam.build)
    host_build.start()
    secs, _ = build.build()
    host_build.join()
    print(f"build: {secs:.2f} s", flush=True)
    log = {"live": {}, "registered": 0, "most_bytes": 0}
    watch_registrations(torch, po, log)
    cs.CKPT_LAYERS = args.ckpt_layers or cs.CKPT_LAYERS
    rounds = []
    for r in range(args.rounds):
        t0 = time.perf_counter()
        before, log["most_bytes"] = log["registered"], 0
        if args.ckpt_layers:
            ck = cs.checkpoint_roundtrips(torch)
            del ck["params"]
            cs.free_cache(torch)
        peft = cs.run_peft_phase(torch, fa, mg)
        off = cs.run_offload_phase(torch, fa, card)
        rounds.append({
            "round": r + 1, "seconds": time.perf_counter() - t0,
            "peft_s": peft["seconds"], "offload_s": off["seconds"],
            "offload_part_s": off["part_seconds"],
            "registrations": log["registered"] - before,
            "most_registered_gb": log["most_bytes"] / 1e9,
            "left_registered": len(log["live"])})
        print(f"round {r + 1} ({card}): {rounds[-1]['seconds']:.1f} s, "
              f"peft {peft['seconds']:.1f} s, offload {off['seconds']:.1f} "
              f"s, {rounds[-1]['registrations']} registrations, at most "
              f"{rounds[-1]['most_registered_gb']:.2f} GB registered, "
              f"{len(log['live'])} left registered", flush=True)
    result = {"card": card, "ckpt_layers": args.ckpt_layers,
              "rounds": rounds}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
