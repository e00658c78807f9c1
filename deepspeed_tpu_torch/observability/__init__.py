"""deepspeed_tpu_torch.observability — the port of
``deepspeed_tpu/observability/``.

* :mod:`.trace` — always-on span tracer (thread-safe ring buffer, host-side
  only, Chrome/Perfetto export); ``InferenceEngineV2.step`` records one
  ``engine/step`` span per call, and the memory hierarchy its
  ``paging/demote``, ``paging/promote`` and ``coldstore/rehydrate_kv``
  spans;
* :mod:`.recorder` — flight recorder: bounded rings of the last N request
  timelines / M engine steps / K infra events, dumped to
  ``$DSTPU_FLIGHT_DIR`` on crash or injected fault;
* :mod:`.prometheus` — the Prometheus text exposition (builder and strict
  parser) behind the serving ``/metrics`` endpoint;
* :mod:`.replay` — workload capture (the broker's ``note_submit`` /
  ``note_cancel`` seam), seeded synthesis, open-loop replay against a
  replica pool, and the SLO gate over the packaged ``slo.toml`` (read
  with stdlib ``tomllib``).

``python -m deepspeed_tpu_torch.observability`` renders a flight dump (or
the newest under ``--latest DIR``) and summarizes a workload JSONL
(``workload``).  Tracing never touches the device, so the engine's
kernels and tokens are the same with it on or off
(``tests/test_torch_observability.py``).
"""

from .recorder import FlightRecorder, load_dump, recorder
from .trace import Span, Tracer, add_event, add_span, span, tracer

__all__ = ["FlightRecorder", "Span", "Tracer", "add_event", "add_span",
           "load_dump", "recorder", "span", "tracer"]
