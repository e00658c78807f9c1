"""Rolling weight swaps: new checkpoints into a live fleet, zero drops (the
port of ``deepspeed_tpu/serving/rollout.py``).

The serving-side continuous-deployment loop: training publishes a
committed checkpoint (``publish_params`` — same staging → manifest →
atomic-rename protocol as ``runtime/checkpoint/engine.py``, so a swap
source is *always* either fully valid or invisible), and
``rolling_swap`` walks the fleet one replica at a time:

    verify manifest (refuse up front — never touch a replica for a
    checkpoint that can't fully load)
      └─ per replica: quiesce (routing excludes it; in-flight streams
         keep running on the OLD weights) → drain → ``swap`` (pointer
         move between engine steps; quantized deployments re-quantize)
         → greedy health probe on the NEW weights → resume

Zero-drop: at most one replica is ever out of rotation, and it re-enters
only after its probe passes.  Streams in flight when their replica
quiesces finish on the old weights — a swap NEVER splices weight
generations into one stream.  (A single-replica pool has nothing to
route to mid-swap: fresh submits get fast 503 backpressure for the
drain+swap window; nothing in flight is dropped.)

Halt-and-rollback: any failure — drain timeout, swap error, probe
timeout, probe output mismatch — halts the rollout, rolls the
already-swapped replicas back to the retained old weights (best
effort), resumes routing everywhere, and raises :class:`RolloutHalted`:
the fleet is left serving the OLD weights.  A replica that *crashes*
mid-swap respawns from its launch argv, which also carries the old
weights.

Probe identity: with ``probe_expected`` the caller pins the exact greedy
tokens the new weights must produce; without it the first swapped
replica's probe output becomes the expectation for the rest, so a fleet
can never finish a rollout with replicas that disagree under greedy
decode.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

from ..observability.recorder import recorder
from ..observability.trace import tracer
from ..utils.logging import logger


class RolloutError(RuntimeError):
    """Rollout could not start (bad checkpoint, no replicas)."""


class RolloutHalted(RolloutError):
    """Rollout failed mid-fleet and was rolled back; old weights serve."""


def publish_params(params: Any, save_dir: str, tag: str) -> str:
    """Publish a parameter tree (tensors on any device, or numpy arrays) as
    a committed swap source, byte for byte the reference's directory for
    the same tree.  Stages into
    ``<tag>.tmp``, writes the sha256 manifest, atomically renames — the
    same commit protocol as training checkpoints, so ``rolling_swap``'s
    pre-check accepts exactly the set of directories that can fully
    load.  Returns the committed directory."""
    from ..runtime.checkpoint.engine import (_commit_dir, _save_tree,
                                             _write_manifest)
    os.makedirs(save_dir, exist_ok=True)
    final_dir = os.path.join(save_dir, tag)
    tmp_dir = final_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    _save_tree(params, os.path.join(tmp_dir, "model.safetensors"))
    _write_manifest(tmp_dir, {"kind": "rollout_params", "tag": tag},
                    algorithm="sha256")
    _commit_dir(tmp_dir, final_dir)
    logger.info(f"rollout: published swap source {final_dir}")
    return final_dir


def load_swap_params(ckpt_dir: str, engine) -> Any:
    """Load a published param tree shaped for ``engine``: CPU tensors in
    the model's nesting, each checked against the model's shape.  Returns
    the UNQUANTIZED tree — ``engine.swap_params`` re-applies the
    deployment's own quantization config and moves it to the engine's
    device."""
    import torch

    from ..models import transformer as tfm
    from ..runtime.checkpoint.engine import (_load_tree_flat,
                                             _unflatten_like,
                                             flatten_with_paths)

    # shape-only template (meta tensors: no storage anywhere): the
    # checkpoint's flat "a/b/c" keys are matched against the model's
    # param paths
    template = tfm.init_params(engine.model_cfg, torch.Generator(),
                               device="meta")
    flat = _load_tree_flat(os.path.join(ckpt_dir, "model.safetensors"))
    tree = _unflatten_like(template, flat)
    want = flatten_with_paths(template)
    for key, leaf in flatten_with_paths(tree).items():
        if tuple(leaf.shape) != tuple(want[key].shape):
            raise ValueError(f"checkpoint tensor {key!r} has shape "
                             f"{tuple(leaf.shape)}, the model wants "
                             f"{tuple(want[key].shape)}")
    return tree


def _event(name: str, **attrs) -> None:
    tracer.add_event(name, attrs=attrs)
    recorder.record_event(name, **attrs)


def _rollback(pool, swapped: List[str]) -> None:
    """Best-effort: return already-swapped replicas to the old weights
    (drain first — rollback must not splice generations either)."""
    for name in swapped:
        t = pool._by_name(name)
        if t is None or not t.healthy():
            continue  # crashed: its respawn argv carries the old weights
        try:
            pool.quiesce(name)
            pool.wait_drained(name, pool.cfg.rollout_drain_timeout_s)
            t.swap_rollback(timeout=pool.cfg.rollout_probe_timeout_s)
            _event("rollout/rollback", replica=name)
        except Exception as e:  # noqa: BLE001 — keep rolling the rest back
            logger.error(f"rollout: rollback of {name} failed: {e!r}")
        finally:
            pool.resume_replica(name)


def rolling_swap(pool, ckpt_dir: str, probe_prompt: Sequence[int],
                 probe_expected: Optional[Sequence[int]] = None) -> dict:
    """Swap every healthy replica in ``pool`` to the weights published at
    ``ckpt_dir``, one at a time (see module docstring).  Returns a
    summary dict; raises :class:`RolloutError` before touching anything
    if the checkpoint fails verification, :class:`RolloutHalted` after
    rolling back if any replica fails mid-fleet."""
    from ..runtime.checkpoint.engine import verify_checkpoint

    cfg = pool.cfg
    problems = verify_checkpoint(ckpt_dir)
    if problems:
        raise RolloutError(f"refusing rollout from {ckpt_dir}: "
                           + "; ".join(problems))
    targets = [t.name for t in list(pool.replicas) if t.healthy()]
    if not targets:
        raise RolloutError("no healthy replicas to roll")
    _event("rollout/start", ckpt_dir=ckpt_dir, targets=len(targets))
    expected = list(probe_expected) if probe_expected is not None else None
    swapped: List[str] = []
    for name in targets:
        t = pool._by_name(name)
        if t is None or not t.healthy():
            _halt(pool, swapped, name, "replica lost before its swap")
        pool.quiesce(name)
        try:
            _event("rollout/drain", replica=name)
            if not pool.wait_drained(name, cfg.rollout_drain_timeout_s):
                _halt(pool, swapped, name,
                      f"drain timed out after {cfg.rollout_drain_timeout_s}s")
            try:
                t.swap(ckpt_dir, timeout=cfg.rollout_probe_timeout_s)
            except Exception as e:  # noqa: BLE001
                _halt(pool, swapped, name, f"swap failed: {e!r}")
            swapped.append(name)
            _event("rollout/swap", replica=name, ckpt_dir=ckpt_dir)
            try:
                toks = _probe(t, probe_prompt, cfg)
            except Exception as e:  # noqa: BLE001
                _halt(pool, swapped, name, f"post-swap probe failed: {e!r}")
            if expected is None:
                expected = toks  # first replica pins the fleet's answer
            elif toks != expected:
                _halt(pool, swapped, name,
                      f"probe mismatch: {toks} != {expected}")
            _event("rollout/probe_ok", replica=name, tokens=len(toks))
        finally:
            pool.resume_replica(name)
    _event("rollout/done", ckpt_dir=ckpt_dir, swapped=len(swapped))
    logger.info(f"rollout: swapped {len(swapped)} replica(s) to {ckpt_dir}")
    return {"swapped": swapped, "ckpt_dir": ckpt_dir,
            "probe_tokens": expected}


def _probe(t, probe_prompt: Sequence[int], cfg) -> List[int]:
    """Greedy decode on ONE replica's new weights (bypasses routing)."""
    handle = t.submit(prompt=list(probe_prompt),
                      max_new_tokens=cfg.rollout_probe_tokens)
    return list(handle.result(timeout=cfg.rollout_probe_timeout_s))


def _halt(pool, swapped: List[str], name: str, why: str) -> None:
    logger.error(f"rollout: HALT at {name}: {why} — rolling back "
                 f"{len(swapped)} swapped replica(s)")
    _event("rollout/halt", replica=name, why=why, swapped=len(swapped))
    pool.resume_replica(name)
    _rollback(pool, swapped)
    raise RolloutHalted(f"halted at {name}: {why} (old weights serving)")
