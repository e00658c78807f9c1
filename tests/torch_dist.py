"""Rank body of the port's data-parallel CPU tests
(``tests/test_torch_comm.py``, ``tests/test_torch_zero.py``,
``tests/test_torch_zero_offload.py``).

A test writes a job (a pickle of named scenarios: numpy weights, batches,
configs) and :func:`launch` starts one process per rank running this file
— a gloo world over a ``FileStore`` under the test's ``tmp_path`` (no TCP
port: xdist runs several workers at once), one torch thread each.  Each
rank runs every scenario in order and pickles its results.  This file
imports torch, numpy and the port only, so a rank never imports JAX or the
JAX package; each rank reports the modules it loaded, and the tests check
that list.  :func:`shared` runs such a job (or a reference run) once for
a whole pytest run, whichever xdist worker needs it first.
"""

import os
import pickle
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(world: int, scenarios, tmp_path, timeout: float = 240.0,
           device: str = "cpu"):
    """Run ``scenarios`` ([(name, dict)]) on a world of ``world`` ranks
    (gloo on the CPU; ``device="cuda"``: NCCL, the engines on the card);
    returns each rank's {name: result} (a scenario that raised holds
    {"error": traceback})."""
    tmp = str(tmp_path)
    job = os.path.join(tmp, f"job{world}.pkl")
    with open(job, "wb") as f:
        pickle.dump(list(scenarios), f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    store = os.path.join(tmp, f"store{world}")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         store, job, tmp, device], env=env, cwd=tmp, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{logs[r]}")
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}_{world}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def shared(tmp_path_factory, key: str, fn):
    """``fn()``, computed once for the whole pytest run: the first process
    to ask for ``key`` (an xdist worker, under ``-n``) computes it and
    pickles it beside the run's temporary directories; one that asks
    meanwhile waits for it (a file lock), and later ones read it.  A
    result that raised is not kept: the next asker computes it again."""
    import fcntl

    base = tmp_path_factory.getbasetemp()
    # the workers' temporary directories share the run's as their parent
    root = (base.parent if os.environ.get("PYTEST_XDIST_WORKER")
            else base) / "shared"
    root.mkdir(exist_ok=True)
    path = root / f"{key}.pkl"
    with open(root / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            value = fn()
            tmp = root / f"{key}.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(value, f)
            os.replace(tmp, path)
            return value
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# scenarios (run on every rank)
# ---------------------------------------------------------------------------


def _np(t):
    import torch

    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def collectives(sc, rank):
    """Every collective of the facade on integer-valued f32 inputs (exact
    under any summation order), and the comms logger's counts."""
    import torch

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.topology import MeshTopology, set_topology
    from deepspeed_tpu_torch.runtime.config import MeshConfig

    topo = MeshTopology.from_config(MeshConfig(**sc["mesh"]),
                                    device_type="cpu")
    set_topology(topo)
    comm.configure(enabled=True)
    comm.get_comms_logger().reset()
    x = torch.from_numpy(sc["inputs"][rank])
    out = {}
    for name, fn, axis, kw in sc["ops"]:
        f = getattr(comm, fn)
        if fn == "all_reduce":
            kw = dict(kw)
            kw["op"] = getattr(comm.ReduceOp, kw["op"])
            y = f(x.clone(), axis, **kw)
        else:
            y = f(x, axis, **kw)
        out[name] = _np(y)
    out["_index"] = {str(a): comm.axis_index(a) for a in sc["index_axes"]}
    out["_counts"] = comm.get_comms_logger().counts()
    out["_bytes"] = {k: r.total_bytes for k, r in
                     comm.get_comms_logger().stats.items()}
    return out


def wire(sc, rank):
    """The compressed reductions: two rounds of ``onebit_all_reduce``
    (residuals carried) and one ``compressed_all_reduce`` of this rank's
    input."""
    import torch

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops.onebit import onebit_all_reduce
    from deepspeed_tpu_torch.ops.quantizer import compressed_all_reduce
    from deepspeed_tpu_torch.parallel.topology import MeshTopology, set_topology
    from deepspeed_tpu_torch.runtime.config import MeshConfig

    topo = MeshTopology.from_config(MeshConfig(**sc["mesh"]),
                                    device_type="cpu")
    set_topology(topo)
    axes, world, block = sc["axes"], topo.axis_size(sc["axes"]), sc["block"]
    w = torch.from_numpy(sc["wres"])
    s_ = torch.from_numpy(sc["sres"])
    rounds = []
    for x in sc["onebit_inputs"]:
        out, w, s_ = onebit_all_reduce(torch.from_numpy(x[rank]), w, s_,
                                       axes, world, block)
        rounds.append((_np(out), _np(w), _np(s_)))
    q = compressed_all_reduce(torch.from_numpy(sc["qgz_input"][rank]), axes)
    return {"onebit": rounds, "qgz": _np(q)}


def _engine(sc, params_np, config):
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tt
    from deepspeed_tpu_torch.runtime.engine import ModelSpec
    from deepspeed_tpu_torch.sequence import tiled_compute as ttc

    from deepspeed_tpu_torch.linear.optimized_linear import has_lora

    cfg = tt.get_config(sc["preset"], **sc["model"])
    params = tt.params_from_jax(params_np, cfg, device="cpu",
                                dtype=torch.float32)
    # a tree with LoRA nodes takes their expanded axes
    axes = tt.param_axes(cfg, params=params) if has_lora(params) else \
        tt.param_axes(cfg)
    spec = ModelSpec(loss_fn=lambda p, b, r: ttc.tiled_loss_fn(
        p, b, cfg, tile_size=16), params=params, param_axes=axes)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=spec, config=config, device=sc.get("device", "cpu"))
    return eng


def engine(sc, rank):
    """Build an engine from the reference's numpy weights, train on the
    batches; report each step's metrics, the whole parameters after, the
    comms counts, the bytes this rank holds, and an eval."""
    from deepspeed_tpu_torch import comm

    comm.configure(enabled=True)
    eng = _engine(sc, sc["params"], sc["config"])
    comm.get_comms_logger().reset()
    steps = [dict(eng.train_batch(b)) for b in sc["batches"]]
    counts = comm.get_comms_logger().counts()
    nbytes = {k: r.total_bytes for k, r in
              comm.get_comms_logger().stats.items()}
    import torch.distributed as dist

    out = {"steps": steps, "counts": counts, "bytes": nbytes,
           "backend": dist.get_backend(),
           "resident": sum(t.numel() * t.element_size()
                           for t in eng._all_leaves),
           "report": eng.shard_report(),
           "params": {k: _np(v) for k, v in
                      eng.checkpoint_params().items()},
           "eval": eng.eval_batch(sc["batches"][0])}
    g = getattr(eng, "_gatherer", None)
    if g is not None:
        out["peak_live"] = g.peak_live_bytes
    return out


def checkpoint(sc, rank):
    """Train at one stage, save, load into an engine of another stage;
    report both engines' eval and one more step of each.  With
    ``export``, rank 0 also runs the fp32 export of the checkpoint; with
    ``merged`` (a LoRA tree), the saving engine exports its merged weights
    right after the save and rank 0 reports them and the files saved."""
    from deepspeed_tpu_torch import comm

    save_dir = os.path.join(sc["dir"], "ckpt")
    a = _engine(sc, sc["params"], sc["save_config"])
    for b in sc["batches"][:2]:
        a.train_batch(b)
    a.save_checkpoint(save_dir)
    merged = None
    if sc.get("merged"):  # every rank gathers, rank 0 writes
        merged = a.export_merged_weights(os.path.join(sc["dir"], "merged"))
    b_eng = _engine(sc, sc["params"], sc["load_config"])
    path, _ = b_eng.load_checkpoint(save_dir)
    out = {"path": path, "onebit_file": os.path.exists(os.path.join(
        path, "onebit_residuals.safetensors")),
           "eval_saved": a.eval_batch(sc["batches"][2]),
           "eval_loaded": b_eng.eval_batch(sc["batches"][2]),
           "step_saved": dict(a.train_batch(sc["batches"][2])),
           "step_loaded": dict(b_eng.train_batch(sc["batches"][2]))}
    if merged is not None and rank == 0:
        from safetensors.numpy import load_file

        out["merged"] = load_file(os.path.join(merged, "model.safetensors"))
        out["files"] = sorted(os.listdir(path))
    if sc.get("export") and rank == 0:
        from deepspeed_tpu_torch.checkpoint_utils import main as ck_main

        dest = os.path.join(sc["dir"], "fp32.safetensors")
        ck_main(["fp32", path, dest])
        from safetensors.numpy import load_file

        out["fp32"] = load_file(dest)
    comm.barrier()
    return out


def _arena_ranges():
    """Record every host buffer an engine's ``HostArena`` hands out (or
    adopts) while it is built and runs: {"ranges": [(ptr, bytes, tensor)]}
    and a function that restores the arena."""
    from deepspeed_tpu_torch.runtime.zero import param_offload as po

    log = {"ranges": []}
    empty, adopt = po.HostArena.empty, po.HostArena.adopt

    def rec(t):
        if t.numel():
            log["ranges"].append((t.data_ptr(), t.numel() * t.element_size(),
                                  t))
        return t

    po.HostArena.empty = lambda self, shape, dtype: rec(
        empty(self, shape, dtype))
    # a page-locking arena adopts through ``empty``; another keeps the
    # tensor it is given
    po.HostArena.adopt = lambda self, t: adopt(self, t) if self.pin \
        else rec(adopt(self, t))

    def restore():
        po.HostArena.empty, po.HostArena.adopt = empty, adopt

    return log, restore


def _overlaps(ranges) -> int:
    """How many pairs of (ptr, bytes) ranges overlap."""
    spans = sorted((p, p + n) for p, n, _ in ranges)
    return sum(1 for (_, e), (b, _) in zip(spans, spans[1:]) if b < e)


def offload(sc, rank):
    """An offloaded engine on this world: each step's metrics and ZenFlow
    hot columns (the whole leaves'), the parameters after (a pending
    delayed update flushed first when ``flush``), the host bytes this
    rank's arena holds, overlapping arena buffers (none may), the comms
    counts, the stream-ins and an eval; with ``states``, the parameters
    and optimizer state evicted and reloaded after the first step."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.zero import param_offload as po

    comm.configure(enabled=True)
    log, restore = _arena_ranges()
    try:
        eng = _engine(sc, sc["params"], sc["config"])
        comm.get_comms_logger().reset()
        po.reset_counts()
        steps, hot = [], []
        for k, b in enumerate(sc["batches"]):
            steps.append(dict(eng.train_batch(b)))
            z = eng.zenflow_optimizer
            if z is not None:
                hot.append({p: _np(h) for p, h in zip(eng._paths,
                                                       z.hot_columns)})
            if sc.get("states") and k == 0:
                eng.offload_states(include=("optim_states", "lp_params"))
                steps[-1]["_evicted"] = eng.states_offloaded
                eng.reload_states()
        counts = comm.get_comms_logger().counts()
        stream_in = po.COUNTS["stream_in"]
        if sc.get("flush"):
            eng.flush_delayed_update()
        z = eng.zenflow_optimizer
        out = {"steps": steps, "hot": hot, "counts": counts,
               "stream_in": stream_in,
               # where ZenFlow's cold sums and hot columns live
               "zenflow_on": sorted({t.device.type for t in
                                     z._cold_acc + z._hot_master})
               if z is not None else [],
               "host_bytes": eng._host.tensor_bytes if eng._host else 0,
               "overlaps": _overlaps(log["ranges"]),
               "params": {k: _np(v) for k, v in
                          eng.checkpoint_params().items()},
               "eval": eng.eval_batch(sc["batches"][0]),
               "files": sorted(os.listdir(sc["nvme"])) if sc.get("nvme")
               else []}
    finally:
        restore()
    return out


def qwz_gather(sc, rank):
    """qwZ's quantized gather (``runtime/zero/qwz.quantized_gather``) of
    this rank's fsdp shard of each of ``whole`` (split on ``dims``) beside
    the plain all-gather of the same shards: the gathered tensors and the
    bytes each gather sent."""
    import torch

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.topology import MeshTopology
    from deepspeed_tpu_torch.runtime.config import MeshConfig
    from deepspeed_tpu_torch.runtime.zero.qwz import quantized_gather

    dev = sc.get("device", "cpu")
    topo = MeshTopology.from_config(MeshConfig(fsdp_size="auto",
                                               data_parallel_size=1),
                                    device_type=dev)
    n, k = topo.size("fsdp"), comm.axis_index("fsdp", topo=topo)
    shards = [torch.from_numpy(w).to(dev, torch.bfloat16).chunk(n, d)[k]
              .contiguous() for w, d in zip(sc["whole"], sc["dims"])]
    comm.configure(enabled=True)
    log = comm.get_comms_logger()
    log.reset()
    fulls = quantized_gather(shards, sc["dims"], "fsdp", topo=topo)
    qbytes = log.stats["all_gather@fsdp"].total_bytes
    log.reset()
    comm.all_gather(torch.cat([s.reshape(-1) for s in shards]), "fsdp",
                    topo=topo)
    return {"gathered": [_np(f) for f in fulls], "bytes": qbytes,
            "plain_bytes": log.stats["all_gather@fsdp"].total_bytes}


SCENARIOS = {"collectives": collectives, "wire": wire, "engine": engine,
             "checkpoint": checkpoint, "offload": offload,
             "qwz_gather": qwz_gather}


def main(argv):
    rank, world, store, job, tmp, device = (int(argv[0]), int(argv[1]),
                                            argv[2], argv[3], argv[4],
                                            argv[5])
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm

    comm.init_distributed(init_method=f"file://{store}", world_size=world,
                          rank=rank, device=device, verbose=False)
    with open(job, "rb") as f:
        scenarios = pickle.load(f)
    results = {}
    for name, sc in scenarios:
        try:
            results[name] = SCENARIOS[sc["kind"]](sc, rank)
        except Exception:  # noqa: BLE001 — reported to the test
            results[name] = {"error": traceback.format_exc()}
    results["_modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "deepspeed_tpu"))
    with open(os.path.join(tmp, f"rank{rank}_{world}.pkl"), "wb") as f:
        pickle.dump(results, f)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
