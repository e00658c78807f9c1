"""``deepspeed_tpu_torch.serving`` — the port of ``deepspeed_tpu/serving/``.

Only ``adapters.py`` (the adapter registry and its checkpoint seam) is
ported; the broker, balancer, transport, workers and the rest of the
fleet arrive with ROADMAP.md queue A item A9."""
