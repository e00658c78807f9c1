"""``deepspeed_tpu_torch.serving`` — the port of ``deepspeed_tpu/serving/``:
the persistent serving layer over the port's ``InferenceEngineV2``.

Layers, bottom-up:

* :mod:`.broker` — request lifecycle over one continuous-batching
  :class:`~deepspeed_tpu_torch.inference.v2.engine.InferenceEngineV2`
  (bounded admission queue, deadlines, cancellation, streaming delivery);
* :mod:`.transport` — the replica seam: in-process engine threads or
  out-of-process worker processes behind one interface;
* :mod:`.worker` — the replica worker process (own engine, own CUDA
  context) for ``--replica_transport subprocess``;
* :mod:`.supervisor` — heartbeat health-checking, hung-replica detection,
  respawn with backoff, crash-loop circuit breaker;
* :mod:`.balancer` — replica pool with least-outstanding-tokens routing,
  health checks, and transparent retry on replica death;
* :mod:`.server` — OpenAI-compatible HTTP front (``/v1/completions``
  streaming + unary, ``/healthz``, ``/metrics``) with 429 backpressure;
* :mod:`.metrics` — TTFT/TPOT/queue-depth/KV-utilization/goodput counters
  emitted as ``monitor`` Events;
* :mod:`.adapters` — the multi-tenant adapter registry.

The multi-host fleet (``remote.py``), the autoscaler, rolling weight swaps
(``rollout.py``), the bench and the fleet adapter ops arrive with the
second half of ROADMAP.md A9; their options refuse naming it.

Quick start (tiny model on the CPU; drop ``--device cpu`` for the card)::

    python -m deepspeed_tpu_torch.serving.server --model tiny --device cpu
    curl -s localhost:8000/v1/completions -d \\
        '{"prompt": [5, 6, 7], "max_tokens": 8}'
"""

from .balancer import BalancedHandle, NoReplicaError, ReplicaPool
from .broker import (BrokerStoppedError, InvalidRequestError, QueueFullError,
                     RequestBroker, RequestFailedError, RequestHandle,
                     RequestState)
from .config import ServingConfig
from .metrics import ServingMetrics
from .server import (ServingHTTPServer, create_server,
                     launch_server_subprocess, stop_server)
from .supervisor import ReplicaSupervisor
from .transport import (FramedReplica, InProcessReplica, ProtocolError,
                        ReplicaTransport, SubprocessReplica)

__all__ = [
    "BalancedHandle", "BrokerStoppedError", "FramedReplica",
    "InProcessReplica", "InvalidRequestError", "NoReplicaError",
    "ProtocolError", "QueueFullError", "ReplicaPool", "ReplicaSupervisor",
    "ReplicaTransport", "RequestBroker", "RequestFailedError",
    "RequestHandle", "RequestState", "ServingConfig", "ServingHTTPServer",
    "ServingMetrics", "SubprocessReplica", "create_server",
    "launch_server_subprocess", "stop_server",
]
