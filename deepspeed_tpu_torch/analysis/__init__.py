"""``deepspeed_tpu_torch.analysis`` — the port's static checks.

:mod:`.concurrency` holds the fleet wire protocol's exhaustiveness check
(the frame-protocol half of ``deepspeed_tpu/analysis/concurrency.py``).
The reference's compiled-program passes and budgets, and the lockdep
waiver file, are ROADMAP.md A14's.
"""
