"""``python -m deepspeed_tpu_torch.observability`` — render a flight-recorder
dump as a human-readable timeline summary, or inspect a workload trace (the
port of ``deepspeed_tpu/observability/__main__.py``; host only, it touches
no device).

    python -m deepspeed_tpu_torch.observability /path/flight_1234_fault.json
    python -m deepspeed_tpu_torch.observability --latest /path/to/flight_dir
    python -m deepspeed_tpu_torch.observability dump.json --requests 5
    python -m deepspeed_tpu_torch.observability workload /path/workload.jsonl

Flight dumps show per-request phase timelines (queue → prefill → decode)
with duration bars, an engine-step summary grouped by step kind, and the
infra-event log.  The ``workload`` subcommand summarizes a captured or
synthesized workload-trace JSONL (``observability/replay.py`` schema):
arrival process, prompt/budget distributions, prefix sharing, cancels.
For interactive digging, load the server's ``GET /debug/trace`` output in
Perfetto (https://ui.perfetto.dev) instead.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Any, Dict, List, Optional

from .recorder import load_dump

_BAR_W = 36


def _bar(frac: float, width: int = _BAR_W) -> str:
    n = max(0, min(width, int(round(frac * width))))
    return "#" * n + "." * (width - n)


def _fmt_ms(seconds: float) -> str:
    return f"{seconds * 1e3:9.2f}ms"


def render_request(tl: Dict[str, Any], out: List[str]) -> None:
    rid = tl.get("rid", "?")
    spans = tl.get("spans", [])
    t0 = tl.get("submit_ts")
    t1 = tl.get("finish_ts")
    total = (t1 - t0) if (t0 is not None and t1 is not None) else None
    head = (f"request {rid}  replica={tl.get('replica', '?')} "
            f"uid={tl.get('uid', '?')}  reason={tl.get('finish_reason', '?')} "
            f"tokens={tl.get('tokens_out', '?')}")
    if tl.get("ttft_ms") is not None:
        head += f"  ttft={tl['ttft_ms']:.2f}ms"
    if total is not None:
        head += f"  total={total * 1e3:.2f}ms"
    out.append(head)
    for sp in spans:
        dur = sp["t_end"] - sp["t_start"]
        frac = dur / total if total else 0.0
        off = sp["t_start"] - t0 if t0 is not None else 0.0
        out.append(f"  {sp['name']:<18} +{_fmt_ms(off)} {_fmt_ms(dur)} "
                   f"|{_bar(frac)}|")
    out.append("")


def render_steps(steps: List[Dict[str, Any]], out: List[str]) -> None:
    if not steps:
        return
    by_kind: Dict[str, List[float]] = {}
    for s in steps:
        by_kind.setdefault(s.get("kind", "?"), []).append(
            s["t_end"] - s["t_start"])
    out.append(f"engine steps ({len(steps)} recorded):")
    for kind in sorted(by_kind):
        durs = by_kind[kind]
        mean = sum(durs) / len(durs)
        out.append(f"  {kind:<12} n={len(durs):<6} mean={_fmt_ms(mean)} "
                   f"max={_fmt_ms(max(durs))}")
    out.append("")


def render_events(events: List[Dict[str, Any]], out: List[str]) -> None:
    if not events:
        return
    out.append(f"infra events ({len(events)} recorded):")
    for ev in events:
        extra = {k: v for k, v in ev.items()
                 if k not in ("name", "t", "wall")}
        out.append(f"  t={ev.get('t', 0.0):.3f}  {ev.get('name', '?'):<28} "
                   f"{extra if extra else ''}")
    out.append("")


def render(dump: Dict[str, Any], max_requests: Optional[int] = None) -> str:
    out: List[str] = []
    meta = dump.get("meta", {})
    out.append(f"flight dump  pid={meta.get('pid', '?')} "
               f"reason={meta.get('reason', '?')}")
    out.append("")
    requests = dump.get("requests", [])
    shown = requests[-max_requests:] if max_requests else requests
    if len(shown) < len(requests):
        out.append(f"({len(requests) - len(shown)} older request timelines "
                   "elided — pass --requests 0 for all)")
        out.append("")
    for tl in shown:
        render_request(tl, out)
    render_steps(dump.get("steps", []), out)
    render_events(dump.get("events", []), out)
    return "\n".join(out)


def _workload_main(argv: List[str]) -> int:
    """``workload`` subcommand: summarize a workload-trace JSONL."""
    from .replay import load_workload

    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.observability workload",
        description="summarize a workload trace "
                    "(observability/replay.py JSONL schema)")
    ap.add_argument("trace", help="workload-trace JSONL")
    ap.add_argument("--prefix_len", type=int, default=8,
                    help="prefix length for the sharing histogram")
    args = ap.parse_args(argv)

    meta, reqs = load_workload(args.trace)
    out: List[str] = []
    out.append(f"workload {args.trace}")
    out.append("  meta: " + ", ".join(f"{k}={v}"
                                      for k, v in sorted(meta.items())))
    n = len(reqs)
    dur = reqs[-1].offset_s if n else 0.0
    out.append(f"  requests: {n}  span: {dur:.3f}s  mean rate: "
               f"{(n / dur if dur else float('inf')):.2f} req/s")
    if n:
        gaps = sorted(reqs[i + 1].offset_s - reqs[i].offset_s
                      for i in range(n - 1)) or [0.0]
        out.append(f"  interarrival: min={gaps[0] * 1e3:.1f}ms "
                   f"p50={gaps[len(gaps) // 2] * 1e3:.1f}ms "
                   f"max={gaps[-1] * 1e3:.1f}ms")
        plens = sorted(len(r.prompt) for r in reqs)
        out.append(f"  prompt tokens: min={plens[0]} "
                   f"p50={plens[len(plens) // 2]} max={plens[-1]}")
        budgets = sorted(r.max_new_tokens or 0 for r in reqs)
        out.append(f"  gen budget: min={budgets[0]} "
                   f"p50={budgets[len(budgets) // 2]} max={budgets[-1]}")
        # prefix sharing: how many requests share each distinct k-token
        # prompt prefix (what a prefix cache would key on)
        shared: dict = {}
        for r in reqs:
            shared.setdefault(tuple(r.prompt[:args.prefix_len]), []
                              ).append(r)
        reused = {k: v for k, v in shared.items() if len(v) > 1}
        out.append(f"  prefix sharing ({args.prefix_len}-token prefixes): "
                   f"{len(shared)} distinct, {len(reused)} shared by >1 "
                   f"request, {sum(len(v) for v in reused.values())} "
                   "requests on shared prefixes")
        cancels = sum(1 for r in reqs if r.cancel_after_s is not None)
        deadlines = sum(1 for r in reqs if r.deadline_s is not None)
        out.append(f"  cancels: {cancels}  deadlines: {deadlines}")
    print("\n".join(out))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "workload":
        return _workload_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.observability", description=__doc__)
    ap.add_argument("dump", nargs="?", default=None,
                    help="flight-recorder dump (JSON)")
    ap.add_argument("--latest", default=None, metavar="DIR",
                    help="render the newest flight_*.json under DIR "
                         "(default dir: $DSTPU_FLIGHT_DIR)")
    ap.add_argument("--requests", type=int, default=10,
                    help="show at most this many recent request timelines "
                         "(0 = all; default 10)")
    args = ap.parse_args(argv)

    path = args.dump
    if path is None:
        d = args.latest or os.environ.get("DSTPU_FLIGHT_DIR")
        if not d:
            ap.error("give a dump path, --latest DIR, or set "
                     "$DSTPU_FLIGHT_DIR")
        candidates = sorted(glob.glob(os.path.join(d, "flight_*.json")),
                            key=os.path.getmtime)
        if not candidates:
            print(f"no flight_*.json under {d}", file=sys.stderr)
            return 1
        path = candidates[-1]
    print(render(load_dump(path), max_requests=args.requests or None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
