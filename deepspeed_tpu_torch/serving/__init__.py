"""``deepspeed_tpu_torch.serving`` — the port of ``deepspeed_tpu/serving/``:
the persistent serving layer over the port's ``InferenceEngineV2``.

Layers, bottom-up:

* :mod:`.broker` — request lifecycle over one continuous-batching
  :class:`~deepspeed_tpu_torch.inference.v2.engine.InferenceEngineV2`
  (bounded admission queue, deadlines, cancellation, streaming delivery);
* :mod:`.transport` — the replica seam: in-process engine threads or
  out-of-process worker processes behind one interface;
* :mod:`.worker` — the replica worker process (own engine, own CUDA
  context) for ``--replica_transport subprocess``, or dialing into a
  remote registry (``--connect``) for the multi-host fleet;
* :mod:`.remote` — network transport: TCP worker registry with fenced
  (epoch-numbered) dial-in registration and lease-based liveness;
* :mod:`.supervisor` — heartbeat health-checking, hung-replica detection,
  respawn with backoff, crash-loop circuit breaker;
* :mod:`.balancer` — replica pool with least-outstanding-tokens routing,
  health checks, and transparent retry on replica death;
* :mod:`.autoscaler` — goodput-driven fleet sizing between
  ``autoscale_min`` and ``autoscale_max``;
* :mod:`.rollout` — zero-drop rolling weight swaps from committed
  checkpoints, with halt-and-rollback;
* :mod:`.server` — OpenAI-compatible HTTP front (``/v1/completions``
  streaming + unary, ``/healthz``, ``/metrics``) with 429 backpressure;
* :mod:`.metrics` — TTFT/TPOT/queue-depth/KV-utilization/goodput counters
  emitted as ``monitor`` Events;
* :mod:`.adapters` — the multi-tenant adapter registry and the fleet
  adapter ops (``fleet_register`` / ``fleet_retire``);
* :mod:`.bench` — offered-load sweeps, replays and the mixed-GEMM
  microbench against the serving front.

Quick start (tiny model on the CPU; drop ``--device cpu`` for the card)::

    python -m deepspeed_tpu_torch.serving.server --model tiny --device cpu
    curl -s localhost:8000/v1/completions -d \\
        '{"prompt": [5, 6, 7], "max_tokens": 8}'
"""

from .adapters import fleet_register, fleet_retire
from .autoscaler import Autoscaler
from .balancer import BalancedHandle, NoReplicaError, ReplicaPool
from .broker import (BrokerStoppedError, InvalidRequestError, QueueFullError,
                     RequestBroker, RequestFailedError, RequestHandle,
                     RequestState)
from .config import ServingConfig
from .metrics import ServingMetrics
from .remote import LocalWorkerLauncher, RemoteReplica, WorkerRegistry
from .rollout import (RolloutError, RolloutHalted, publish_params,
                      rolling_swap)
from .server import (ServingHTTPServer, create_server,
                     launch_server_subprocess, stop_server)
from .supervisor import ReplicaSupervisor
from .transport import (FramedReplica, InProcessReplica, ProtocolError,
                        ReplicaTransport, SubprocessReplica)

__all__ = [
    "Autoscaler", "BalancedHandle", "BrokerStoppedError", "FramedReplica",
    "InProcessReplica", "InvalidRequestError", "LocalWorkerLauncher",
    "NoReplicaError", "ProtocolError", "QueueFullError", "RemoteReplica",
    "ReplicaPool", "ReplicaSupervisor", "ReplicaTransport", "RequestBroker",
    "RequestFailedError", "RequestHandle", "RequestState", "RolloutError",
    "RolloutHalted", "ServingConfig", "ServingHTTPServer", "ServingMetrics",
    "SubprocessReplica", "WorkerRegistry", "create_server", "fleet_register",
    "fleet_retire", "launch_server_subprocess", "publish_params",
    "rolling_swap", "stop_server",
]
