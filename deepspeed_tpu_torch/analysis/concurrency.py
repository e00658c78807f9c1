"""Frame-protocol exhaustiveness for the fleet wire protocol (the
frame-protocol half of ``deepspeed_tpu/analysis/concurrency.py``).

A static AST pass over the port's ``serving/transport.py`` /
``worker.py`` / ``remote.py`` extracts every frame-type literal
*produced* (``{"op": ...}`` / ``{"ev": ...}`` dict literals) and every
literal *handled* (``op == "submit"``, ``ev in ("swap_ok",
"swap_err")``, ``frame.get("ev") != "hello_ok"`` comparisons) and errors
on a send with no handler (a frame the peer drops on the floor) or a dead
handler (a branch no sender can reach — usually a renamed frame type).
A second pass holds the submit and heartbeat frames' fields to the same
rule.  It reads no TOML: the lockdep waiver half (``waivers.toml``) is
ROADMAP.md A14's.

CLI::

    python -m deepspeed_tpu_torch.analysis.concurrency
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Set

__all__ = [
    "ConcurrencyError",
    "check_frame_fields",
    "check_frame_protocol",
    "default_protocol_paths",
    "extract_protocol",
]


class ConcurrencyError(ValueError):
    """A failed protocol-exhaustiveness check."""


# -- frame-protocol exhaustiveness ----------------------------------------

#: the fleet wire protocol lives in exactly these three files
_PROTOCOL_FILES = ("transport.py", "worker.py", "remote.py")
#: frame discriminator keys: pool->worker ops, worker->pool events
_CHANNELS = ("op", "ev")


def default_protocol_paths() -> List[str]:
    serving = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "serving")
    return [os.path.join(serving, f) for f in _PROTOCOL_FILES]


def _channel_of(node: ast.AST) -> Optional[str]:
    """If ``node`` reads a frame discriminator, return its channel:
    the name ``op``/``ev``, ``<x>.get("op"/"ev")``, or
    ``<x>["op"/"ev"]``."""
    if isinstance(node, ast.Name) and node.id in _CHANNELS:
        return node.id
    if isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) and \
            node.func.attr == "get" and node.args and \
            isinstance(node.args[0], ast.Constant) and \
            node.args[0].value in _CHANNELS:
        return node.args[0].value
    if isinstance(node, ast.Subscript):
        sl = node.slice
        if isinstance(sl, ast.Constant) and sl.value in _CHANNELS:
            return sl.value
    return None


def _str_consts(node: ast.AST) -> Optional[List[str]]:
    """String literal(s) on the other side of a comparison: a constant
    or a tuple/list/set of constants; None if anything is non-literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.append(el.value)
            else:
                return None
        return out
    return None


def extract_protocol(source: str, path: str = "<memory>") -> Dict[str, Any]:
    """Extract frame-type literals from one protocol file.

    Returns ``{"sent": {channel: {literal: [lines]}}, "handled": ...}``.
    *Sent* is any dict literal with an ``"op"``/``"ev"`` key mapping to
    a string constant (whether passed to ``send_frame`` directly, built
    in a variable, or injected into a local ack/ctrl queue — a produced
    frame needs a handler wherever it surfaces).  *Handled* is any
    comparison of a discriminator read against string literal(s)."""
    tree = ast.parse(source, filename=path)
    sent: Dict[str, Dict[str, List[int]]] = {c: {} for c in _CHANNELS}
    handled: Dict[str, Dict[str, List[int]]] = {c: {} for c in _CHANNELS}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value in _CHANNELS \
                        and isinstance(v, ast.Constant) \
                        and isinstance(v.value, str):
                    sent[k.value].setdefault(v.value, []).append(
                        node.lineno)
        elif isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            chan = None
            lits: List[str] = []
            for side in sides:
                c = _channel_of(side)
                if c is not None:
                    chan = c
                    continue
                s = _str_consts(side)
                if s is not None:
                    lits.extend(s)
            if chan is not None and lits:
                for lit in lits:
                    handled[chan].setdefault(lit, []).append(node.lineno)
    return {"sent": sent, "handled": handled}


def check_frame_protocol(
        paths: Optional[Sequence[str]] = None) -> List[str]:
    """Cross-file exhaustiveness: every sent frame type must have a
    handler somewhere in the protocol files, and every handled literal
    must be sent by someone.  Returns a list of problem strings."""
    paths = list(paths) if paths is not None else default_protocol_paths()
    sent: Dict[str, Dict[str, List[str]]] = {c: {} for c in _CHANNELS}
    handled: Dict[str, Dict[str, List[str]]] = {c: {} for c in _CHANNELS}
    for p in paths:
        with open(p, "r") as f:
            ex = extract_protocol(f.read(), p)
        base = os.path.basename(p)
        for chan in _CHANNELS:
            for lit, lns in ex["sent"][chan].items():
                sent[chan].setdefault(lit, []).extend(
                    f"{base}:{ln}" for ln in lns)
            for lit, lns in ex["handled"][chan].items():
                handled[chan].setdefault(lit, []).extend(
                    f"{base}:{ln}" for ln in lns)
    problems: List[str] = []
    for chan in _CHANNELS:
        for lit in sorted(set(sent[chan]) - set(handled[chan])):
            problems.append(
                f"frame {chan}={lit!r} is sent ({', '.join(sent[chan][lit])}) "
                f"but no handler compares against it — the peer drops it "
                f"on the floor")
        for lit in sorted(set(handled[chan]) - set(sent[chan])):
            problems.append(
                f"frame {chan}={lit!r} is handled "
                f"({', '.join(handled[chan][lit])}) but never sent — dead "
                f"handler (renamed or removed frame type?)")
    return problems


# -- frame-field exhaustiveness (submit + heartbeat payloads) -------------
#
# Op/ev literals cover frame TYPES; these checks cover frame FIELDS — the
# drift that bites when a new per-request knob (tenant, seed, adapter)
# rides the submit frame: the transport serializes it from a literal key
# tuple, the worker reads it with ``frame.get(...)``, and a key present
# on only one side is silently dropped (the request runs without its
# knob).  Same shape for heartbeats: every stats key the pool-side
# transport reads must be produced by the worker's ``_stats`` builder.

#: submit-frame keys that are structural, not optional per-request knobs
_SUBMIT_STRUCTURAL = {"op", "rid", "prompt", "trace"}


def _find_func(tree: ast.AST, name: str) -> Optional[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _submit_keys_sent(transport_src: str, path: str) -> Set[str]:
    """The optional-key tuple FramedReplica.submit serializes: the
    ``for key in (<literals>)`` loop containing 'max_new_tokens'."""
    tree = ast.parse(transport_src, filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.For):
            lits = _str_consts(node.iter)
            if lits and "max_new_tokens" in lits:
                return set(lits)
    return set()


def _frame_get_keys(worker_src: str, path: str) -> Set[str]:
    """Every ``frame.get("<key>")`` / ``frame["<key>"]`` read in the
    worker's op loop."""
    tree = ast.parse(worker_src, filename=path)
    keys: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "get" and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "frame" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            keys.add(node.args[0].value)
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "frame" and \
                isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str):
            keys.add(node.slice.value)
    return keys


def _hb_keys_produced(worker_src: str, path: str) -> Set[str]:
    """Stats keys the worker's ``_stats`` builder emits: the returned
    dict literal's keys plus ``stats["<key>"] = ...`` augmentations."""
    tree = ast.parse(worker_src, filename=path)
    fn = _find_func(tree, "_stats")
    keys: Set[str] = set()
    if fn is None:
        return keys
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.add(k.value)
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and \
                        isinstance(tgt.slice, ast.Constant) and \
                        isinstance(tgt.slice.value, str):
                    keys.add(tgt.slice.value)
    return keys


def _hb_keys_consumed(transport_src: str, path: str) -> Set[str]:
    """Stats keys the pool-side transport reads off heartbeats:
    ``self._stat("<key>")`` and ``self._stats.get("<key>")``."""
    tree = ast.parse(transport_src, filename=path)
    keys: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and node.args and
                isinstance(node.args[0], ast.Constant) and
                isinstance(node.args[0].value, str)):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "_stat":
            keys.add(node.args[0].value)
        elif isinstance(f, ast.Attribute) and f.attr == "get" and \
                isinstance(f.value, ast.Attribute) and \
                f.value.attr == "_stats":
            keys.add(node.args[0].value)
    return keys


def check_frame_fields(paths: Optional[Sequence[str]] = None) -> List[str]:
    """Field-level exhaustiveness across the submit and heartbeat frames:

    * every optional submit key the transport serializes must be read by
      the worker (``frame.get``), or the knob silently no-ops remotely;
    * every heartbeat stats key the pool-side transport reads must be
      produced by the worker's ``_stats`` builder, or the gauge silently
      reads its default forever.
    """
    paths = list(paths) if paths is not None else default_protocol_paths()
    by_name = {os.path.basename(p): p for p in paths}
    problems: List[str] = []
    tp, wp = by_name.get("transport.py"), by_name.get("worker.py")
    if tp is None or wp is None:
        return ["frame-field check needs transport.py and worker.py"]
    with open(tp) as f:
        transport_src = f.read()
    with open(wp) as f:
        worker_src = f.read()
    sent = _submit_keys_sent(transport_src, tp)
    if not sent:
        problems.append("transport.py: submit optional-key tuple not found "
                        "(the serializer loop moved?)")
    read = _frame_get_keys(worker_src, wp) | _SUBMIT_STRUCTURAL
    for key in sorted(sent - read):
        problems.append(
            f"submit field {key!r} is serialized by transport.py but never "
            f"read by worker.py — the knob silently no-ops out-of-process")
    produced = _hb_keys_produced(worker_src, wp)
    if not produced:
        problems.append("worker.py: _stats() heartbeat builder not found")
    consumed = _hb_keys_consumed(transport_src, tp)
    for key in sorted(consumed - produced):
        problems.append(
            f"heartbeat stats key {key!r} is read by transport.py but "
            f"never produced by worker.py _stats() — the gauge reads its "
            f"default forever")
    return problems


# -- CLI ------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    rc = 0
    problems = check_frame_protocol()
    if problems:
        for p in problems:
            print(f"concurrency: PROTOCOL: {p}", file=sys.stderr)
        rc = 1
    else:
        print("concurrency: frame protocol exhaustive "
              f"({', '.join(_PROTOCOL_FILES)})")
    field_problems = check_frame_fields()
    if field_problems:
        for p in field_problems:
            print(f"concurrency: FIELDS: {p}", file=sys.stderr)
        rc = 1
    else:
        print("concurrency: submit/heartbeat frame fields exhaustive")
    return rc


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
