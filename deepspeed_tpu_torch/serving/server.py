"""OpenAI-compatible HTTP front over the replica pool (the port of
``deepspeed_tpu/serving/server.py``).

Capability analogue of DeepSpeed-MII's RESTful API (``mii/grpc_related/
restful_gateway.py``) — stdlib ``ThreadingHTTPServer`` (one thread per
connection; every engine call stays on the replicas' engine threads, so HTTP
concurrency costs nothing on the accelerator side).

Endpoints:

* ``POST /v1/completions`` — OpenAI completions shape. ``prompt`` is a token
  id list (the OpenAI API's array-of-tokens form) or a string through the
  deployment's tokenizer (default: whitespace-separated integers, so the
  tiny-model demo is curl-able without a tokenizer).  ``"stream": true``
  streams SSE ``data:`` chunks over chunked transfer encoding; each chunk
  carries the token id (``choices[0].token``) next to the text.
* ``POST /v1/cancel`` — ``{"id": "..."}`` aborts an in-flight request (the
  other cancel path is simply closing the streaming connection).
* ``GET /healthz`` — replica health + pool state (503 when no replica).
* ``GET /metrics`` — Prometheus text exposition of the serving metrics
  (HELP/TYPE, TTFT/TPOT/queue-wait histograms, per-replica labels).
* ``GET /debug/requests`` — flight-recorder snapshot: recent request
  timelines, engine steps, and infra events.
* ``GET /debug/trace`` — tracer ring as Chrome/Perfetto trace-event JSON
  (load at https://ui.perfetto.dev).
* ``GET /debug/profile?seconds=N`` — on-demand ``torch.profiler`` capture
  (CPU and, on the card, CUDA activity); responds with the directory
  holding the Chrome trace.
* ``POST /v1/adapters`` — fleet adapter ops: ``register`` hot-loads a
  committed adapter checkpoint into every healthy replica, ``retire``
  retires it fleet-wide (``adapters.fleet_register`` / ``fleet_retire``).

Every replica's engine runs on the card unless ``--device cpu`` is passed
(the CLI raises at once when CUDA is absent and the CPU was not asked for).

Backpressure: when every healthy replica's bounded admission queue is full,
``/v1/completions`` returns **429** with ``Retry-After`` instead of queueing
unboundedly — queue depth is the tail-latency SLO knob (`ServingConfig.
max_queue`); deadline-shed requests return 504.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlsplit

from ..observability.recorder import recorder
from ..observability.trace import tracer
from ..utils.locks import named_lock
from ..utils.logging import logger
from ..utils.proc import terminate_procs
from .balancer import BalancedHandle, NoReplicaError, ReplicaPool
from .broker import InvalidRequestError, QueueFullError, RequestFailedError
from .config import (ServingConfig, format_slo_classes, parse_class_bounds,
                     parse_replica_classes, parse_slo_classes)
from .metrics import ServingMetrics


def _default_encode(text: str) -> List[int]:
    try:
        return [int(t) for t in text.split()]
    except ValueError:
        raise InvalidRequestError(
            "no tokenizer configured: string prompts must be "
            "whitespace-separated token ids (or pass a token id array)")


def _default_decode(tokens: Sequence[int]) -> str:
    return "".join(f" {t}" for t in tokens)


class ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # conservative: finish the TCP handshake fast even under thread churn
    request_queue_size = 64

    def __init__(self, addr, pool: ReplicaPool, metrics: ServingMetrics,
                 config: ServingConfig,
                 model_name: str = "deepspeed_tpu_torch",
                 encode: Optional[Callable[[str], List[int]]] = None,
                 decode: Optional[Callable[[Sequence[int]], str]] = None):
        super().__init__(addr, _Handler)
        self.pool = pool
        self.metrics = metrics
        self.cfg = config
        self.model_name = model_name
        self.encode = encode or _default_encode
        self.decode = decode or _default_decode
        self._handles = {}  # rid -> BalancedHandle (live requests)
        self._handles_lock = named_lock("server.handles")
        # /debug/profile serialization: one profiler session per process,
        # not reentrant — a second overlapping capture must get a clean
        # 409, not a mid-capture crash
        self.profile_lock = named_lock("server.profile")

    def handle_error(self, request, client_address):  # noqa: N802
        import sys as _sys

        exc = _sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            return  # clients abandoning connections is normal in serving
        super().handle_error(request, client_address)

    def register(self, handle: BalancedHandle) -> None:
        with self._handles_lock:
            self._handles[handle.rid] = handle

    def unregister(self, rid: str) -> None:
        with self._handles_lock:
            self._handles.pop(rid, None)

    def cancel_rid(self, rid: str) -> bool:
        with self._handles_lock:
            handle = self._handles.get(rid)
        if handle is None:
            return False
        handle.cancel()
        return True


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: ServingHTTPServer  # type: ignore[assignment]

    def log_message(self, fmt, *args):  # quiet: route to framework logger
        logger.debug("serving http: " + fmt % args)

    # -- helpers ---------------------------------------------------------

    def _json(self, code: int, obj: dict,
              headers: Sequence[Tuple[str, str]] = ()) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str, etype: str,
               headers: Sequence[Tuple[str, str]] = ()) -> None:
        self._json(code, {"error": {"message": message, "type": etype,
                                    "code": code}}, headers)

    def _read_body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) if n else b"{}"
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            raise InvalidRequestError(f"invalid JSON body: {e}")
        if not isinstance(body, dict):
            raise InvalidRequestError("body must be a JSON object")
        return body

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    # -- routes ----------------------------------------------------------

    def do_GET(self):  # noqa: N802 (stdlib casing)
        parts = urlsplit(self.path)
        path, query = parts.path, parse_qs(parts.query)
        if path == "/healthz":
            health = self.server.pool.health()
            health["metrics"] = self.server.metrics.snapshot()
            self._json(200 if health["status"] == "ok" else 503, health)
        elif path == "/metrics":
            body = self.server.metrics.to_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/v1/adapters":
            # per-replica resident/registered adapter census
            self._json(200, {"replicas": [
                {"name": t.name, **t.adapter_summary()}
                for t in self.server.pool.replicas]})
        elif path == "/debug/requests":
            self._json(200, recorder.snapshot())
        elif path == "/debug/trace":
            self._json(200, tracer.to_chrome_trace())
        elif path == "/debug/profile":
            self._debug_profile(query)
        else:
            self._error(404, f"no route {self.path}", "not_found")

    def _debug_profile(self, query: dict) -> None:
        """On-demand ``torch.profiler`` capture: blocks this HTTP thread
        for ``seconds`` (engine threads keep serving) and returns the
        directory holding the Chrome trace (``trace.json``)."""
        import tempfile

        import torch

        try:
            seconds = float(query.get("seconds", ["1.0"])[0])
        except ValueError:
            self._error(400, "seconds must be a number",
                        "invalid_request_error")
            return
        if not 0.0 < seconds <= 60.0:
            self._error(400, "seconds must be in (0, 60]",
                        "invalid_request_error")
            return
        if not self.server.profile_lock.acquire(blocking=False):
            # the profiler is process-wide: an overlapping second capture
            # would die inside it with an opaque 503
            self._error(409, "profiler busy: a capture is already running",
                        "profiler_busy")
            return
        try:
            out_dir = tempfile.mkdtemp(prefix="dstpu_profile_")
            try:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                with tracer.span("debug/profile", seconds=seconds):
                    with torch.profiler.profile(activities=acts) as prof:
                        time.sleep(seconds)
                    prof.export_chrome_trace(
                        os.path.join(out_dir, "trace.json"))
            except Exception as e:  # profiler unavailable on this backend
                self._error(503, f"profiler failed: {e!r}", "profiler_error")
                return
        finally:
            self.server.profile_lock.release()
        self._json(200, {"profile_dir": out_dir, "seconds": seconds})

    def do_POST(self):  # noqa: N802
        try:
            if self.path == "/v1/completions":
                self._completions()
            elif self.path == "/v1/adapters":
                self._adapters_admin()
            elif self.path == "/v1/cancel":
                body = self._read_body()
                ok = self.server.cancel_rid(str(body.get("id", "")))
                self._json(200 if ok else 404,
                           {"id": body.get("id"), "cancelled": ok})
            else:
                self._error(404, f"no route {self.path}", "not_found")
        except InvalidRequestError as e:
            self._error(400, str(e), "invalid_request_error")
        except QueueFullError as e:
            self.server.metrics.record_reject()
            self._error(429, str(e), "overloaded",
                        headers=[("Retry-After", "1")])
        except NoReplicaError as e:
            self._error(503, str(e), "service_unavailable")

    def _adapters_admin(self) -> None:
        """Fleet adapter ops: ``{"op": "register", "adapter", "ckpt_dir"
        [, "scaling"]}`` hot-loads a committed adapter checkpoint into
        every healthy replica; ``{"op": "retire", "adapter"}`` retires it
        fleet-wide (in-flight requests drain first)."""
        from .adapters import fleet_register, fleet_retire

        body = self._read_body()
        op = body.get("op")
        adapter = body.get("adapter")
        if not isinstance(adapter, str) or not adapter:
            raise InvalidRequestError("adapter must be a string adapter id")
        if op == "register":
            ckpt_dir = body.get("ckpt_dir")
            if not isinstance(ckpt_dir, str) or not ckpt_dir:
                raise InvalidRequestError("register needs a ckpt_dir")
            try:
                result = fleet_register(self.server.pool, adapter, ckpt_dir,
                                        scaling=body.get("scaling"))
            except (ValueError, OSError) as e:
                raise InvalidRequestError(str(e))
            self._json(200, result)
        elif op == "retire":
            self._json(200, fleet_retire(self.server.pool, adapter))
        else:
            raise InvalidRequestError(
                f"unknown adapter op {op!r} (want register/retire)")

    def _parse_prompt(self, body: dict) -> List[int]:
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            return self.server.encode(prompt)
        if isinstance(prompt, list) and all(
                isinstance(t, int) and not isinstance(t, bool)
                for t in prompt):
            return list(prompt)
        raise InvalidRequestError(
            "prompt must be a string or a token id array")

    def _completions(self) -> None:
        body = self._read_body()
        if body.get("n", 1) != 1:
            raise InvalidRequestError("only n=1 is supported")
        prompt = self._parse_prompt(body)
        seed = body.get("seed")
        if seed is not None and (isinstance(seed, bool)
                                 or not isinstance(seed, int)):
            raise InvalidRequestError("seed must be an integer")
        adapter = body.get("adapter")
        if adapter is not None and not isinstance(adapter, str):
            raise InvalidRequestError("adapter must be a string adapter id")
        kwargs = dict(
            max_new_tokens=body.get("max_tokens"),
            temperature=body.get("temperature"),
            deadline_s=body.get("deadline_s"),
            stop_token_ids=body.get("stop_token_ids", ()),
            seed=seed,
            tenant=body.get("tenant"),
            slo_class=body.get("slo_class"),
            adapter=adapter,
        )
        handle = self.server.pool.submit(prompt, **kwargs)
        self.server.register(handle)
        try:
            if body.get("stream"):
                self._stream_response(handle)
            else:
                self._unary_response(handle)
        finally:
            self.server.unregister(handle.rid)

    def _completion_obj(self, handle: BalancedHandle, text: str,
                        finish_reason, *, chunk: bool, token=None) -> dict:
        choice = {"index": 0, "text": text, "logprobs": None,
                  "finish_reason": finish_reason}
        if token is not None:
            choice["token"] = token
        return {"id": f"cmpl-{handle.rid}",
                "object": "text_completion" + (".chunk" if chunk else ""),
                "created": int(time.time()),
                "model": self.server.model_name,
                "choices": [choice]}

    def _unary_response(self, handle: BalancedHandle) -> None:
        try:
            tokens = handle.result()
        except RequestFailedError as e:
            if e.reason == "deadline":
                self._error(504, str(e), "deadline_exceeded")
            else:
                self._error(503, f"request failed: {e}", "service_unavailable")
            return
        obj = self._completion_obj(handle, self.server.decode(tokens),
                                   handle.finish_reason, chunk=False)
        obj["choices"][0]["tokens"] = tokens
        obj["usage"] = {"prompt_tokens": len(handle.prompt),
                        "completion_tokens": len(tokens),
                        "total_tokens": len(handle.prompt) + len(tokens)}
        self._json(200, obj)

    def _stream_response(self, handle: BalancedHandle) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def sse(obj) -> bytes:
            return b"data: " + json.dumps(obj).encode() + b"\n\n"

        try:
            try:
                for tok in handle.tokens():
                    self._chunk(sse(self._completion_obj(
                        handle, self.server.decode([tok]), None,
                        chunk=True, token=tok)))
                final = self._completion_obj(handle, "",
                                             handle.finish_reason or "length",
                                             chunk=True)
            except RequestFailedError as e:
                final = self._completion_obj(handle, "", "error", chunk=True)
                final["error"] = {"message": str(e), "type": e.reason}
            self._chunk(sse(final))
            self._chunk(b"data: [DONE]\n\n")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # client went away mid-stream: the disconnect IS the cancel
            handle.cancel()
            self.close_connection = True


def create_server(pool: ReplicaPool, metrics: ServingMetrics,
                  config: ServingConfig, host: str = "127.0.0.1",
                  port: int = 0, **kwargs) -> ServingHTTPServer:
    return ServingHTTPServer((host, port), pool, metrics, config, **kwargs)


# -- deployment entrypoint -------------------------------------------------


def replica_state_subdir(root: str, name: str) -> str:
    """Per-replica namespace for durable on-disk state (cold store, spill
    files): ``<root>/<base name>`` with any ``.g<N>`` respawn-generation
    suffix stripped, so a respawned worker (``replica0.g2``) lands on the
    SAME directory its crashed predecessor (``replica0.g1``) wrote — that
    is what makes restart rehydration find the warm set — while distinct
    replicas never share (no cross-replica handle aliasing or sweeps)."""
    base, dot, gen = name.rpartition(".")
    if base and gen.startswith("g") and gen[1:].isdigit():
        name = base
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", name) or "replica"
    return os.path.join(root, safe)


def build_engine_factory(args) -> Callable[[], "object"]:
    """Engine factory from parsed engine CLI args (``add_engine_cli_args``).
    Shared by the HTTP front's in-process pool and the out-of-process
    replica worker (``serving/worker.py``) so both transports build
    bit-identical engines from the same flag set.

    The parameters are drawn once, from ``--seed``, straight onto the
    engine's device (``--device``, the card by default) in its compute
    dtype: every engine the factory builds then holds the same tensors
    (the engine casts a leaf only when its device or dtype differs), so N
    in-process replicas share one copy of the weights, as the reference's
    share one immutable pytree."""
    import torch

    from ..accelerator import resolve_device
    from ..inference.v2.engine import InferenceEngineV2, V2Config
    from ..models import transformer as tfm

    device = resolve_device(getattr(args, "device", "cuda"))

    def seeded(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    model_cfg = tfm.get_config(args.model, dtype=args.dtype)
    params = tfm.init_params(model_cfg, seeded(args.seed), device=device)
    v2 = V2Config(max_tokens_per_step=args.max_tokens_per_step,
                  max_seqs=args.max_seqs, block_size=args.block_size,
                  num_blocks=args.num_blocks,
                  max_blocks_per_seq=args.max_blocks_per_seq,
                  dtype=args.dtype,
                  enable_prefix_cache=args.enable_prefix_cache,
                  prefix_cache_min_tokens=args.prefix_cache_min_tokens,
                  prefix_eviction=args.prefix_eviction,
                  kv_host_pool_mb=args.kv_host_pool_mb,
                  kv_host_pool_bytes=getattr(args, "kv_host_pool_bytes", 0),
                  kv_spill_dir=args.kv_spill_dir,
                  kv_promote_ahead=args.kv_promote_ahead,
                  kv_coldstore_dir=getattr(args, "kv_coldstore_dir", ""),
                  spec_mode=args.spec_mode, spec_k=args.spec_k,
                  quantize_bits=args.quantize_bits,
                  quantize_group=args.quantize_group,
                  adapter_slots=args.adapter_slots,
                  adapter_rank=args.adapter_rank)
    draft_params, draft_cfg, spec_heads = None, None, None
    if args.spec_mode == "draft":
        draft_cfg = tfm.get_config(args.spec_draft_model or args.model,
                                   dtype=args.dtype)
        draft_seed = (args.spec_draft_seed if args.spec_draft_seed is not None
                      else args.seed)
        draft_params = tfm.init_params(draft_cfg, seeded(draft_seed),
                                       device=device)
    elif args.spec_mode == "self_draft" and args.spec_train_steps > 0:
        # distill the speculation heads on the base model's own greedy
        # rollouts before serving starts (frozen-base PEFT — only head
        # params ever reach the optimizer); replicas share the result
        import numpy as np

        from ..linear.spec_heads import (greedy_rollouts, init_spec_heads,
                                         train_spec_heads)

        spec_heads = init_spec_heads(seeded(1), model_cfg, args.spec_k,
                                     base_params=params)
        rs = np.random.RandomState(args.seed)
        prompts = rs.randint(1, model_cfg.vocab_size, size=(32, 4)).tolist()
        data = greedy_rollouts(params, model_cfg, prompts, args.spec_k + 10)
        spec_heads, _ = train_spec_heads(params, spec_heads, model_cfg, data,
                                         steps=args.spec_train_steps)
    return lambda: InferenceEngineV2(model_cfg, params, v2,
                                     draft_params=draft_params,
                                     draft_config=draft_cfg,
                                     spec_heads=spec_heads, device=device)


def build_adapter_factory(args) -> Optional[Callable]:
    """Per-replica :class:`~deepspeed_tpu_torch.serving.adapters.AdapterRegistry`
    factory from parsed engine CLI args; None when the deployment serves
    no adapters (``--adapter_slots 0``).  ``--adapter_preload`` entries
    are hot-loaded into every replica's registry at build time."""
    if not getattr(args, "adapter_slots", 0):
        return None
    preload: List[Tuple[str, str]] = []
    for item in (getattr(args, "adapter_preload", None) or "").split(","):
        item = item.strip()
        if not item:
            continue
        aid, _, path = item.partition("=")
        if not aid or not path:
            raise ValueError(
                f"--adapter_preload entry {item!r} must be ID=CKPT_DIR")
        preload.append((aid, path))
    host_mb = getattr(args, "adapter_host_pool_mb", 256)
    spill_dir = getattr(args, "adapter_spill_dir", "") or ""
    cold_root = getattr(args, "adapter_coldstore_dir", "") or ""

    def factory(engine, name: str):
        from .adapters import AdapterRegistry

        # durable adapter state is namespaced per replica (generation
        # suffix stripped) so a respawned worker rehydrates its own
        # predecessor's cold packs and nobody else's
        cold = replica_state_subdir(cold_root, name) if cold_root else ""
        reg = AdapterRegistry(engine, host_bytes=host_mb << 20,
                              spill_dir=spill_dir, name=name,
                              coldstore_dir=cold)
        for aid, path in preload:
            if reg.known(aid):
                continue  # already rehydrated from the cold store
            reg.register(aid, ckpt_dir=path)
        return reg

    return factory


def engine_argv_from_args(args) -> List[str]:
    """Re-serialize the engine flag set for a worker subprocess: the worker
    re-initializes the same params from the same seed, so every replica
    process is token-identical to an in-process one under greedy decode."""
    argv = ["--model", args.model, "--dtype", args.dtype,
            "--device", args.device, "--seed", str(args.seed),
            "--max_tokens_per_step", str(args.max_tokens_per_step),
            "--max_seqs", str(args.max_seqs),
            "--block_size", str(args.block_size),
            "--num_blocks", str(args.num_blocks),
            "--max_blocks_per_seq", str(args.max_blocks_per_seq),
            "--prefix_eviction", args.prefix_eviction,
            "--prefix_cache_min_tokens", str(args.prefix_cache_min_tokens),
            "--spec_mode", args.spec_mode, "--spec_k", str(args.spec_k),
            "--spec_train_steps", str(args.spec_train_steps),
            "--quantize_bits", str(args.quantize_bits),
            "--quantize_group", str(args.quantize_group)]
    if args.enable_prefix_cache:
        argv.append("--enable_prefix_cache")
    if args.kv_host_pool_mb:
        argv += ["--kv_host_pool_mb", str(args.kv_host_pool_mb)]
    if getattr(args, "kv_host_pool_bytes", 0):
        argv += ["--kv_host_pool_bytes", str(args.kv_host_pool_bytes)]
    if args.kv_spill_dir:
        argv += ["--kv_spill_dir", args.kv_spill_dir]
    if args.kv_promote_ahead:
        argv.append("--kv_promote_ahead")
    if getattr(args, "kv_coldstore_dir", ""):
        # the ROOT rides respawn argv unchanged; each worker derives its
        # per-replica subdir from its own --name (replica_state_subdir)
        argv += ["--kv_coldstore_dir", args.kv_coldstore_dir]
    if args.spec_draft_model:
        argv += ["--spec_draft_model", args.spec_draft_model]
    if args.spec_draft_seed is not None:
        argv += ["--spec_draft_seed", str(args.spec_draft_seed)]
    if args.adapter_slots:
        argv += ["--adapter_slots", str(args.adapter_slots),
                 "--adapter_rank", str(args.adapter_rank),
                 "--adapter_host_pool_mb", str(args.adapter_host_pool_mb)]
        if args.adapter_spill_dir:
            argv += ["--adapter_spill_dir", args.adapter_spill_dir]
        if getattr(args, "adapter_coldstore_dir", ""):
            argv += ["--adapter_coldstore_dir", args.adapter_coldstore_dir]
        if args.adapter_preload:
            argv += ["--adapter_preload", args.adapter_preload]
    return argv


def serving_argv_from_config(cfg: ServingConfig) -> List[str]:
    """Worker-side serving knobs (queue cap, sampling, SLO) as CLI flags."""
    argv = ["--max_queue", str(cfg.max_queue),
            "--default_max_tokens", str(cfg.default_max_tokens),
            "--temperature", str(cfg.temperature),
            "--idle_wait_s", str(cfg.idle_wait_s)]
    if cfg.deadline_s is not None:
        argv += ["--deadline_s", str(cfg.deadline_s)]
    if cfg.stop_token_ids:
        argv += ["--stop_token_ids",
                 ",".join(str(t) for t in cfg.stop_token_ids)]
    if cfg.slo_classes:
        # the broker lives in the worker for out-of-process transports —
        # tenant admission ordering needs the table there, not just here
        argv += ["--slo_classes", format_slo_classes(cfg.slo_classes),
                 "--default_slo_class", cfg.default_slo_class]
    return argv


def _build_pool_from_args(args) -> Tuple[ReplicaPool, ServingMetrics,
                                         ServingConfig]:
    stop_ids = tuple(int(t) for t in args.stop_token_ids.split(",")) \
        if args.stop_token_ids else ()
    cfg = ServingConfig(max_queue=args.max_queue,
                        default_max_tokens=args.default_max_tokens,
                        temperature=args.temperature,
                        deadline_s=args.deadline_s,
                        stop_token_ids=stop_ids,
                        idle_wait_s=args.idle_wait_s,
                        num_replicas=args.replicas,
                        replica_transport=args.replica_transport,
                        # token comes from the environment, never argv
                        # (argv is world-readable in ps)
                        fleet_token=os.environ.get("DSTPU_FLEET_TOKEN"),
                        registry_host=getattr(args, "registry_host",
                                              "127.0.0.1"),
                        registry_port=getattr(args, "registry_port", 0),
                        autoscale_min=getattr(args, "autoscale_min", 1),
                        autoscale_max=getattr(args, "autoscale_max", 0),
                        replica_classes=parse_replica_classes(
                            getattr(args, "replica_classes", None)),
                        phase_prefill_ratio=getattr(
                            args, "phase_prefill_ratio", 4.0),
                        cache_aware_routing=not getattr(
                            args, "no_cache_aware_routing", False),
                        autoscale_class_bounds=parse_class_bounds(
                            getattr(args, "autoscale_class_bounds", None)),
                        slo_classes=parse_slo_classes(
                            getattr(args, "slo_classes", None)),
                        default_slo_class=getattr(args, "default_slo_class",
                                                  "standard"))
    monitor = None
    if args.csv_dir:
        from ..monitor.monitor import CSVMonitor

        monitor = CSVMonitor(args.csv_dir, job_name="serving")
    metrics = ServingMetrics()
    if args.replica_transport == "subprocess":
        worker_argv = (engine_argv_from_args(args)
                       + serving_argv_from_config(cfg))
        pool = ReplicaPool.build_subprocess(worker_argv, cfg,
                                            metrics=metrics, monitor=monitor)
    elif args.replica_transport == "remote":
        worker_argv = (engine_argv_from_args(args)
                       + serving_argv_from_config(cfg))
        pool = ReplicaPool.build_remote(
            worker_argv, cfg, metrics=metrics, monitor=monitor,
            launch_workers=not getattr(args, "external_workers", False))
    else:
        pool = ReplicaPool.build(build_engine_factory(args), cfg,
                                 metrics=metrics, monitor=monitor,
                                 adapter_factory=build_adapter_factory(args))
    return pool, metrics, cfg


def add_engine_cli_args(p) -> None:
    """Engine flags shared by the HTTP front (``dstpu-serve``) and the
    out-of-process replica worker (``python -m deepspeed_tpu_torch.serving.
    worker``) — one flag set, one ``build_engine_factory``, so a worker
    process builds the same engine the front would have built in-process."""
    p.add_argument("--model", default="tiny")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where each replica's engine runs: the card by "
                        "default (an error without CUDA), or the CPU")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_tokens_per_step", type=int, default=64)
    p.add_argument("--max_seqs", type=int, default=8)
    p.add_argument("--block_size", type=int, default=16)
    p.add_argument("--num_blocks", type=int, default=256)
    p.add_argument("--max_blocks_per_seq", type=int, default=16)
    p.add_argument("--enable_prefix_cache", action="store_true",
                   help="cross-request KV prefix cache (radix tree with "
                        "copy-on-write block sharing)")
    p.add_argument("--prefix_cache_min_tokens", type=int, default=0,
                   help="minimum shareable prefix length to take a cache hit")
    p.add_argument("--prefix_eviction", choices=["lru", "none"],
                   default="lru")
    p.add_argument("--kv_host_pool_mb", type=int, default=0,
                   help="serving memory hierarchy: demote cold prefix-cache "
                        "blocks into a host-DRAM pool of this many MiB "
                        "instead of evicting them, so a returning session "
                        "promotes KV back instead of recomputing prefill "
                        "(0 = off; needs --enable_prefix_cache)")
    p.add_argument("--kv_host_pool_bytes", type=int, default=0,
                   help="exact-bytes override of --kv_host_pool_mb "
                        "(tests/benches sizing the host pool below one MiB "
                        "to force bottom-tier overflow; 0 = use the MiB "
                        "knob)")
    p.add_argument("--kv_spill_dir", default="",
                   help="third memory tier: when the host pool overflows, "
                        "spill its oldest blocks to safetensors files in "
                        "this directory (FastPersist O_DIRECT writer)")
    p.add_argument("--kv_promote_ahead", action="store_true",
                   help="background thread prefetches spilled blocks into "
                        "host DRAM as soon as a request referencing them is "
                        "queued, overlapping disk reads with earlier steps")
    p.add_argument("--kv_coldstore_dir", default="",
                   help="crash-durable cold tier: host-pool overflow lands "
                        "as manifest-verified committed entries under this "
                        "root (replacing bare spill files), and a respawned "
                        "worker rehydrates surviving entries into its radix "
                        "tree at boot; worker transports derive a "
                        "per-replica subdir from the worker name")
    p.add_argument("--quantize_bits", type=int, default=0,
                   choices=[0, 4, 6, 8],
                   help="weight-only quantization of the served base: "
                        "projections become int4/fp6/int8 codes the CUDA "
                        "mixed GEMM dequantizes in-kernel (0 = bf16 base)")
    p.add_argument("--quantize_group", type=int, default=256,
                   help="per-group scale granularity along K for "
                        "--quantize_bits (shrinks to a divisor of K per "
                        "projection when K is not a multiple)")
    p.add_argument("--spec_mode", choices=["off", "draft", "self_draft"],
                   default="off",
                   help="speculative decoding: 'draft' proposes with a small "
                        "second model, 'self_draft' with Medusa-style heads "
                        "over the frozen base")
    p.add_argument("--spec_k", type=int, default=4,
                   help="speculative tokens proposed (and verified in one "
                        "forward) per decode step")
    p.add_argument("--spec_draft_model", default=None,
                   help="model preset for the draft model (draft mode); "
                        "defaults to --model")
    p.add_argument("--spec_draft_seed", type=int, default=None,
                   help="init seed for the draft model; defaults to --seed "
                        "(same preset + same seed → draft == target, the "
                        "acceptance-rate upper bound)")
    p.add_argument("--spec_train_steps", type=int, default=0,
                   help="self_draft: distill the speculation heads for this "
                        "many steps on the base model's greedy rollouts "
                        "before serving starts (0 = lm-head-seeded init)")
    p.add_argument("--adapter_slots", type=int, default=0,
                   help="multi-tenant LoRA serving: device adapter slots "
                        "per replica INCLUDING the null base slot 0, so N "
                        "slots hold N-1 resident adapters (0 = no adapter "
                        "serving)")
    p.add_argument("--adapter_rank", type=int, default=0,
                   help="stacked adapter rank r; registered adapters of "
                        "smaller rank are zero-padded to it (required with "
                        "--adapter_slots)")
    p.add_argument("--adapter_host_pool_mb", type=int, default=256,
                   help="host-DRAM pool for paged-out adapters, MiB: "
                        "registered adapters beyond the device slots stay "
                        "host-resident and promote on demand")
    p.add_argument("--adapter_spill_dir", default="",
                   help="spill tier for the adapter host pool: overflow "
                        "adapters land in safetensors files here")
    p.add_argument("--adapter_coldstore_dir", default="",
                   help="crash-durable cold tier for adapter factor packs "
                        "(per-replica subdirs, manifest-verified); a "
                        "respawned worker re-registers surviving packs "
                        "without re-loading their checkpoints")
    p.add_argument("--adapter_preload", default=None,
                   help="comma-separated ID=CKPT_DIR adapter checkpoints "
                        "registered into every replica at startup (later "
                        "adapters hot-register via the fleet ops)")


def add_serving_cli_args(p) -> None:
    """Admission / sampling knobs shared by the front and the worker."""
    p.add_argument("--max_queue", type=int, default=64)
    p.add_argument("--default_max_tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--deadline_s", type=float, default=None)
    p.add_argument("--idle_wait_s", type=float, default=0.005)
    p.add_argument("--stop_token_ids", default=None,
                   help="comma-separated token ids that end generation")
    p.add_argument("--slo_classes", default=None,
                   help="per-tenant SLO class table as "
                        "NAME:PRIORITY:DEADLINE_S[,...] — lower priority "
                        "admits first under pressure; deadline 0 inherits "
                        "--deadline_s")
    p.add_argument("--default_slo_class", default="standard",
                   help="SLO class applied when a request names none")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="dstpu-serve",
                                description="deepspeed_tpu_torch serving "
                                            "front")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--replica_transport",
                   choices=["inprocess", "subprocess", "remote"],
                   default="inprocess",
                   help="'subprocess' isolates each replica in its own "
                        "process (own CUDA context) behind the supervised "
                        "transport — a replica crash/hang costs one worker, "
                        "never the front; 'remote' runs a TCP registry that "
                        "workers dial into with fenced epochs (multi-host "
                        "fleet; local workers are spawned unless "
                        "--external_workers)")
    p.add_argument("--registry_host", default="127.0.0.1",
                   help="remote transport: registry bind address (bind a "
                        "routable interface for multi-host fleets)")
    p.add_argument("--registry_port", type=int, default=0,
                   help="remote transport: registry port (0 = ephemeral)")
    p.add_argument("--external_workers", action="store_true",
                   help="remote transport: do not spawn local workers — "
                        "slots wait for workers launched elsewhere to dial "
                        "in (auth via $DSTPU_FLEET_TOKEN)")
    p.add_argument("--autoscale_min", type=int, default=1,
                   help="remote transport: replica-count floor the "
                        "autoscaler restores immediately")
    p.add_argument("--autoscale_max", type=int, default=0,
                   help="remote transport: autoscaler ceiling "
                        "(0 disables autoscaling)")
    p.add_argument("--replica_classes", default=None,
                   help="per-slot replica classes for disaggregated "
                        "prefill/decode serving, comma-separated and "
                        "index-aligned with --replicas (e.g. "
                        "'prefill,decode,decode'); slots beyond the list "
                        "are 'mixed'")
    p.add_argument("--phase_prefill_ratio", type=float, default=4.0,
                   help="a request with prompt_len >= ratio * max_tokens "
                        "is prefill-heavy and routes to prefill-class "
                        "replicas")
    p.add_argument("--no_cache_aware_routing", action="store_true",
                   help="disable routing on heartbeated prefix-cache "
                        "digest summaries (fall back to pure "
                        "least-outstanding-tokens)")
    p.add_argument("--autoscale_class_bounds", default=None,
                   help="per-class autoscale bounds as CLASS=MIN:MAX[,...] "
                        "(e.g. 'decode=1:4'); unlisted classes share the "
                        "global --autoscale_min/--autoscale_max")
    add_engine_cli_args(p)
    add_serving_cli_args(p)
    p.add_argument("--csv_dir", default=None,
                   help="emit serving metrics to a CSVMonitor at this path")
    args = p.parse_args(argv)
    from ..accelerator import resolve_device

    resolve_device(args.device)  # the card unless --device cpu, at once

    pool, metrics, cfg = _build_pool_from_args(args)
    pool.start()
    pool.wait_ready(timeout=cfg.spawn_timeout_s)
    if args.replica_transport == "remote" and cfg.autoscale_max:
        from .autoscaler import Autoscaler

        Autoscaler(pool, cfg, metrics).start()
    server = create_server(pool, metrics, cfg, host=args.host, port=args.port,
                           model_name=args.model)
    stop = threading.Event()

    def _graceful(signum, frame):
        logger.info("serving: signal %s — draining" % signum)
        stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    # the subprocess launcher greps for this line to learn the bound port
    print(f"dstpu-serving listening on http://{args.host}:"
          f"{server.server_port}", flush=True)
    stop.wait()
    pool.drain(cfg.drain_timeout_s)
    server.shutdown()
    return 0


def launch_server_subprocess(argv: Sequence[str], timeout_s: float = 120.0,
                             env: Optional[dict] = None
                             ) -> Tuple[subprocess.Popen, str]:
    """Spawn ``python -m deepspeed_tpu_torch.serving.server <argv>`` and wait for
    its ready line; returns (proc, base_url).  Pair with ``stop_server``."""
    import os

    full_env = dict(os.environ)
    full_env.update(env or {})
    # the child must import deepspeed_tpu regardless of the caller's cwd
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    prev = full_env.get("PYTHONPATH")
    full_env["PYTHONPATH"] = (pkg_root + os.pathsep + prev) if prev \
        else pkg_root
    # new session: the front (and the replica workers it forks under
    # --replica_transport subprocess) form one process group, so teardown
    # can kill the whole tree with os.killpg — no orphaned workers
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepspeed_tpu_torch.serving.server", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=full_env, start_new_session=True)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"serving subprocess exited rc={proc.returncode}")
            continue
        if "dstpu-serving listening on " in line:
            return proc, line.split("listening on ", 1)[1].strip()
    terminate_procs([proc], term_timeout_s=5.0, process_group=True)
    raise TimeoutError("serving subprocess never became ready")


def stop_server(proc: subprocess.Popen, term_timeout_s: float = 15.0) -> int:
    """Graceful stop: SIGTERM triggers the drain path; SIGKILL after the
    grace period (shared ``terminate_procs`` policy with the elastic
    agent).  Group-wide, so replica worker processes can't outlive the
    front."""
    return terminate_procs([proc], term_timeout_s=term_timeout_s,
                           process_group=True)[0]


if __name__ == "__main__":
    sys.exit(main())
