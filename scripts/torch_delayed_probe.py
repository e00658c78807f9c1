"""Where a delayed offloaded step's time goes on the card: llama3-8b at
full width (``chip_smoke``'s zero-phase engines, seeded random weights),
``offload_optimizer: {device: cpu, delayed_update: true}``, at stage 0
(the one-device step) and at stage 1 (the data-parallel step on an NCCL
world of one).  For each step it prints the host's timeline in ms from the
step's start — the end of the dispatch of forward, backward and the
reduction (where the host update begins), the host AdamW's start and end,
the end of the updated parameters' push to the card, the end of the
gradients' staging, the step's end on the card — beside the device ms of
the dispatched work (CUDA events) and whether the card was still busy when
the host update began (the update hides behind the card only then).
Prints every step's line and writes the numbers to
``build/delayed_probe.json``.

Run on a machine with one card, from the repository's root::

    python3 scripts/torch_delayed_probe.py [--layers 4] [--steps 4]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def probe(torch, engine, placed, steps: int) -> list:
    """``steps`` delayed steps of ``engine``, each one's host timeline."""
    from deepspeed_tpu_torch.ops import cpu_adam

    opt = engine.offloaded_optimizer
    marks: dict = {}
    stream = torch.cuda.current_stream()

    def now():
        return (time.perf_counter() - marks["t0"]) * 1e3

    def wrap(obj, name, before=None, after=None):
        fn = getattr(obj, name)

        def wrapped(*a, **kw):
            if before:
                before()
            out = fn(*a, **kw)
            if after:
                after()
            return out

        setattr(obj, name, wrapped)
        return fn

    def at_update():
        marks["dispatched_ms"] = now()
        marks["card_busy"] = not stream.query()
        ev = marks["ev_dispatched"] = torch.cuda.Event(enable_timing=True)
        ev.record(stream)

    adam = wrap(cpu_adam, "adam_step",
                before=lambda: marks.setdefault("adam_start_ms", now()),
                after=lambda: marks.setdefault("adam_end_ms", now()))
    wrap(engine, "_offloaded_update", before=at_update)
    wrap(opt, "_push", after=lambda: marks.setdefault("push_end_ms", now()))
    wrap(opt, "stage_grads",
         after=lambda: marks.setdefault("staged_ms", now()))
    rows = []
    try:
        for _ in range(steps):
            torch.cuda.synchronize()
            marks.clear()
            start = torch.cuda.Event(enable_timing=True)
            marks["t0"] = time.perf_counter()
            start.record(stream)
            engine.train_batch(placed)
            torch.cuda.synchronize()
            row = {k: v for k, v in marks.items()
                   if k.endswith("_ms") or k == "card_busy"}
            row["step_ms"] = now()
            row["device_dispatched_ms"] = start.elapsed_time(
                marks["ev_dispatched"])
            rows.append(row)
    finally:
        cpu_adam.adam_step = adam
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops import cpu_adam
    from deepspeed_tpu_torch.ops.hopper import build

    if not torch.cuda.is_available():
        sys.exit("the probe runs on a CUDA card")
    build.build()
    cpu_adam.build()
    comm.init_distributed(verbose=False)  # NCCL, a world of one
    card = chip_smoke.card_line()
    print(card)
    out = {"card": card, "layers": args.layers}
    zero = {"offload_optimizer": {"device": "cpu", "delayed_update": True}}
    for stage in (0, 1):
        engine, cfg = chip_smoke._zero_engine(torch, args.layers, stage,
                                              zero=zero)
        placed = engine.place_batch(chip_smoke._zero_batch(cfg))
        rows = probe(torch, engine, placed, args.steps)
        out[f"stage{stage}"] = rows
        for k, r in enumerate(rows):
            print(f"stage {stage} step {k}: " + ", ".join(
                f"{key} {v:.2f}" if isinstance(v, float) else f"{key} {v}"
                for key, v in r.items()))
        chip_smoke.close_engine(torch, engine)
        del engine, placed
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "delayed_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("card", "layers")}))


if __name__ == "__main__":
    main()
