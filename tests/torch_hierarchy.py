"""Shared helpers of the serving memory hierarchy's parity tests
(``tests/test_torch_{prefix_cache,paging,coldstore,observability}.py``):
the ``tiny`` model in f32 for the JAX package and the port (the port's
weights converted by ``params_from_jax``), engine pairs built from one
``V2Config``, and the tier-accounting checks both packages' tests make."""

import threading

import jax
import numpy as np

from deepspeed_tpu.inference.v2 import engine as je
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.inference.v2 import engine as te
from deepspeed_tpu_torch.models import transformer as tt

# the V2Config of the reference's prefix-cache, paging and rehydrate tests
V2 = dict(max_tokens_per_step=32, max_seqs=4, block_size=8, num_blocks=64,
          max_blocks_per_seq=8, dtype="float32")

# counters that time a host operation: they differ run to run
TIMED = ("promote_wait_ms",)


def tiny_model():
    """(JAX config, JAX params, port config, port params) of ``tiny``."""
    jcfg = jt.get_config("tiny", dtype="float32")
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tt.get_config("tiny", dtype="float32")
    tparams = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


def jax_engine(model, cache=True, **over):
    jcfg, params, _, _ = model
    return je.InferenceEngineV2(jcfg, params, je.V2Config(
        **{**V2, "enable_prefix_cache": cache, **over}))


def port_engine(model, cache=True, **over):
    _, _, tcfg, tparams = model
    return te.InferenceEngineV2(tcfg, tparams, te.V2Config(
        **{**V2, "enable_prefix_cache": cache, **over}), device="cpu")


def serve(eng, prompt, n, **gen_kw):
    """Queue ``prompt`` alone, run to completion, return its new tokens."""
    uid = eng.put(list(prompt), max_new_tokens=n)
    return [int(t) for t in eng.generate_all(**gen_kw)[uid][len(prompt):]]


class _QueueMarker:
    """A promote-ahead queue entry that is no handle: the pager's thread
    hashes it when it looks it up, after it has finished every entry
    queued before it (one thread, first in first out)."""

    def __init__(self):
        self.reached = threading.Event()

    def __hash__(self):
        self.reached.set()
        return 0


def drain_prefetch(pager, timeout: float = 10.0) -> None:
    """Wait until the pager's promote-ahead thread has handled everything
    queued so far (either package's pager)."""
    marker = _QueueMarker()
    pager._queue.put(marker)
    assert marker.reached.wait(timeout), "promote-ahead thread stuck"


def untimed(stats):
    return {k: v for k, v in stats.items() if k not in TIMED}


def assert_consistent(eng, idle=True):
    """The tier identity: device_free + evictable + pinned + demoted ==
    total + demoted (demoted agreed on by allocator, pager and tree), and
    free + evictable + pinned == total with pinned from refcounts."""
    eng.prefix_cache.check_consistency()
    free, ev, pin, tot = (eng.free_blocks, eng.evictable_blocks,
                          eng.pinned_blocks, eng.total_blocks)
    assert free + ev + pin == tot, (free, ev, pin, tot)
    if idle:
        assert pin == 0, f"{pin} blocks pinned with no live sequence"


def assert_same_state(jeng, teng):
    """Both engines hold the same pool and tree: free lists, refcounts,
    and every prefix-cache counter and gauge."""
    ja, ta = jeng.kv.allocator, teng.kv.allocator
    assert ta._free == ja._free
    assert ta._refs == ja._refs and ta.demoted == ja.demoted
    assert untimed(teng.prefix_stats()) == untimed(jeng.prefix_stats())
