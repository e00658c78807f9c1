"""Rank body of the port's data-parallel CPU tests
(``tests/test_torch_comm.py``, ``tests/test_torch_zero.py``).

A test writes a job (a pickle of named scenarios: numpy weights, batches,
configs) and :func:`launch` starts one process per rank running this file
— a gloo world over a ``FileStore`` under the test's ``tmp_path`` (no TCP
port: xdist runs several workers at once), one torch thread each.  Each
rank runs every scenario in order and pickles its results.  This file
imports torch, numpy and the port only, so a rank never imports JAX or the
JAX package; each rank reports the modules it loaded, and the tests check
that list.
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

    cfg = tt.get_config(sc["preset"], **sc["model"])
    params = tt.params_from_jax(params_np, cfg, device="cpu",
                                dtype=torch.float32)
    spec = ModelSpec(loss_fn=lambda p, b, r: ttc.tiled_loss_fn(
        p, b, cfg, tile_size=16), params=params,
        param_axes=tt.param_axes(cfg))
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
    ``export``, rank 0 also runs the fp32 export of the checkpoint."""
    from deepspeed_tpu_torch import comm

    save_dir = os.path.join(sc["dir"], "ckpt")
    a = _engine(sc, sc["params"], sc["save_config"])
    for b in sc["batches"][:2]:
        a.train_batch(b)
    a.save_checkpoint(save_dir)
    b_eng = _engine(sc, sc["params"], sc["load_config"])
    path, _ = b_eng.load_checkpoint(save_dir)
    out = {"path": path, "onebit_file": os.path.exists(os.path.join(
        path, "onebit_residuals.safetensors")),
           "eval_saved": a.eval_batch(sc["batches"][2]),
           "eval_loaded": b_eng.eval_batch(sc["batches"][2]),
           "step_saved": dict(a.train_batch(sc["batches"][2])),
           "step_loaded": dict(b_eng.train_batch(sc["batches"][2]))}
    if sc.get("export") and rank == 0:
        from deepspeed_tpu_torch.checkpoint_utils import main as ck_main

        dest = os.path.join(sc["dir"], "fp32.safetensors")
        ck_main(["fp32", path, dest])
        from safetensors.numpy import load_file

        out["fp32"] = load_file(dest)
    comm.barrier()
    return out


SCENARIOS = {"collectives": collectives, "wire": wire, "engine": engine,
             "checkpoint": checkpoint}


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
