"""The port's topology, collectives and comms logger against the JAX
package's (ROADMAP.md A13, part 1).

The port runs one process per rank: each world here is a gloo world on the
CPU (``tests/torch_dist.py``, spawned once per world size for the whole
module), held against the reference's ``shard_map`` over the matching
``jax.devices()[:n]`` sub-mesh of the virtual 8-device CPU mesh.  Inputs
are integer-valued f32, so every collective agrees exactly whatever order
gloo and XLA:CPU add in; the compressed reductions (1-bit, qgZ) divide, so
they agree to 1e-6.  Topology sizes, coordinates and errors are host logic
and agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from deepspeed_tpu import comm as jcomm
from deepspeed_tpu.compat import shard_map
from deepspeed_tpu.ops import onebit as jonebit
from deepspeed_tpu.ops.quantizer import compressed_all_reduce as j_qgz
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.config_utils import ConfigError as JConfigError
from deepspeed_tpu_torch.ops import onebit as tonebit
from deepspeed_tpu_torch.parallel import topology as ttopo
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.config_utils import ConfigError

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.torch_dist import launch

AXES = jtopo.MESH_AXES

#: (name, facade function, axis, keyword arguments)
OPS = [
    ("ar_sum", "all_reduce", ("dp", "fsdp"), {"op": "SUM"}),
    ("ar_avg", "all_reduce", ("dp", "fsdp"), {"op": "AVG"}),
    ("ar_max", "all_reduce", ("dp", "fsdp"), {"op": "MAX"}),
    ("ar_min", "all_reduce", ("dp", "fsdp"), {"op": "MIN"}),
    ("ar_prod", "all_reduce", ("dp", "fsdp"), {"op": "PROD"}),
    ("ar_dp", "all_reduce", "dp", {"op": "SUM"}),
    ("ar_fsdp", "all_reduce", "fsdp", {"op": "SUM"}),
    ("ag0", "all_gather", ("dp", "fsdp"), {"axis": 0}),
    ("ag1", "all_gather", "dp", {"axis": 1}),
    ("ag_stack0", "all_gather", ("dp", "fsdp"), {"axis": 0, "tiled": False}),
    ("ag_stack2", "all_gather", "fsdp", {"axis": 2, "tiled": False}),
    ("rs0", "reduce_scatter", ("dp", "fsdp"), {"scatter_axis": 0}),
    ("rs1", "reduce_scatter", "dp", {"scatter_axis": 1}),
    ("a2a01", "all_to_all", ("dp", "fsdp"),
     {"split_axis": 0, "concat_axis": 1}),
    ("a2a10", "all_to_all", "dp", {"split_axis": 1, "concat_axis": 0}),
]
MESHES = {2: {}, 4: {"data_parallel_size": 2, "fsdp_size": 2}}


def _inputs(n):
    base = (np.arange(24).reshape(4, 6) % 7 - 3).astype(np.float32)
    return [base + r for r in range(n)]


def _perms(n):
    return [("pp_ring", ("dp", "fsdp"), [(i, (i + 1) % n) for i in range(n)]),
            ("pp_one", "dp", [(0, 1)])]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's per-rank results: the collectives, then the wire
    compressions (one process set per world size)."""
    out = {}
    rng = np.random.default_rng(7)
    for n, mesh in MESHES.items():
        ops = [(name, fn, ax, kw) for name, fn, ax, kw in OPS]
        ops += [(name, "ppermute", ax, {"perm": perm})
                for name, ax, perm in _perms(n)]
        block = 16
        size = 100
        wlen, slen = tonebit.residual_shapes(size, n, block)
        wire = dict(kind="wire", mesh=mesh, axes=("dp", "fsdp"), block=block,
                    wres=np.zeros(wlen, np.float32),
                    sres=np.zeros(slen, np.float32),
                    onebit_inputs=[rng.standard_normal((n, size)).astype(
                        np.float32) for _ in range(2)],
                    qgz_input=rng.standard_normal((n, 3, 200)).astype(
                        np.float32))
        scenarios = [("coll", dict(kind="collectives", mesh=mesh,
                                   inputs=_inputs(n), ops=ops,
                                   index_axes=[("dp", "fsdp"), "dp",
                                               "fsdp"])),
                     ("wire", wire)]
        res = launch(n, scenarios, tmp_path_factory.mktemp(f"world{n}"))
        for r in res:
            for name, v in r.items():
                assert not (isinstance(v, dict) and "error" in v), v["error"]
        out[n] = (scenarios, res)
    return out


def _jax_topology(n, mesh):
    return jtopo.MeshTopology.from_config(jconfig.MeshConfig(**mesh),
                                          devices=jax.devices()[:n])


def _jax_per_device(topo, fn, stacked):
    """``fn`` on each device's slice of ``stacked`` (leading dim = device)
    inside shard_map over every mesh axis → its outputs, stacked."""
    def body(x):
        return fn(x[0])[None]

    f = shard_map(body, mesh=topo.mesh, in_specs=P(AXES), out_specs=P(AXES),
                  check_vma=False)
    return np.asarray(jax.jit(f)(stacked))


def _jax_op(fn, ax, kw):
    f = getattr(jcomm, fn)
    if fn == "all_reduce":
        op = getattr(jcomm.ReduceOp, kw["op"])
        return lambda x: f(x, ax, op=op)
    return lambda x: f(x, ax, **kw)


@pytest.mark.parametrize("n", sorted(MESHES))
def test_collectives_match_reference_exactly(worlds, n):
    scenarios, res = worlds[n]
    topo = _jax_topology(n, MESHES[n])
    stacked = jnp.asarray(np.stack(_inputs(n)))
    logger = jcomm.get_comms_logger()
    jcomm.configure(enabled=True)
    logger.reset()
    try:
        ops = dict(scenarios)["coll"]["ops"]
        for name, fn, ax, kw in ops:
            want = _jax_per_device(topo, _jax_op(fn, ax, kw), stacked)
            for r in range(n):
                got = res[r]["coll"][name]
                assert got.shape == want[r].shape, (name, r)
                np.testing.assert_array_equal(got, want[r],
                                              err_msg=f"{name} rank {r}")
        stats = {k: (v.count, v.total_bytes) for k, v in logger.stats.items()}
    finally:
        jcomm.configure(enabled=False)
        logger.reset()
    for r in range(n):
        got = {k: (c, res[r]["coll"]["_bytes"][k])
               for k, c in res[r]["coll"]["_counts"].items()}
        assert got == stats
    for ax in (("dp", "fsdp"), "dp", "fsdp"):
        want = _jax_per_device(topo, lambda x: jax.lax.axis_index(ax)
                               + 0 * x[0, 0].astype(jnp.int32), stacked)
        assert [res[r]["coll"]["_index"][str(ax)] for r in range(n)] == \
            [int(v) for v in want]


@pytest.mark.parametrize("n", sorted(MESHES))
def test_wire_compression_matches_reference(worlds, n):
    scenarios, res = worlds[n]
    sc = dict(scenarios)["wire"]
    topo = _jax_topology(n, MESHES[n])
    axes, block = ("dp", "fsdp"), sc["block"]
    w = jnp.zeros((n,) + sc["wres"].shape, jnp.float32)
    s = jnp.zeros((n,) + sc["sres"].shape, jnp.float32)
    for k, x in enumerate(sc["onebit_inputs"]):
        def body(xx, ww, ss):
            out, nw, ns = jonebit.onebit_all_reduce(xx[0], ww[0], ss[0], axes,
                                                    n, block)
            return out[None], nw[None], ns[None]

        f = shard_map(body, mesh=topo.mesh, in_specs=(P(AXES),) * 3,
                      out_specs=(P(AXES),) * 3, check_vma=False)
        out, w, s = jax.jit(f)(jnp.asarray(x), w, s)
        for r in range(n):
            for got, want in zip(res[r]["wire"]["onebit"][k],
                                 (out[r], w[r], s[r])):
                np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                           atol=1e-6)
    want = _jax_per_device(topo, lambda x: j_qgz(x, axes),
                           jnp.asarray(sc["qgz_input"]))
    for r in range(n):
        np.testing.assert_allclose(res[r]["wire"]["qgz"], want[r], rtol=1e-6,
                                   atol=1e-6)


def test_ranks_import_no_jax(worlds):
    for n, (_, res) in worlds.items():
        for r in res:
            assert r["_modules"] == [], (n, r["_modules"])


TOPO_CASES = [
    (8, {}), (8, {"fsdp_size": "auto", "data_parallel_size": 1}),
    (8, {"fsdp_size": 4}), (8, {"data_parallel_size": 2, "fsdp_size": 4}),
    (4, {"data_parallel_size": 2, "fsdp_size": 2}), (2, {}), (1, {}),
    (8, {"data_parallel_size": 3}), (8, {"fsdp_size": 3}),
    (8, {"data_parallel_size": 2, "fsdp_size": 2}),
    (8, {"tensor_parallel_size": 3}),
    (6, {"data_parallel_size": 4, "fsdp_size": "auto"}),
]


@pytest.mark.parametrize("n,mesh", TOPO_CASES)
def test_topology_matches_reference(n, mesh):
    try:
        jt = _jax_topology(n, mesh)
    except JConfigError as e:
        with pytest.raises(ConfigError) as got:
            ttopo.MeshTopology.from_config(tconfig.MeshConfig(**mesh),
                                           devices=list(range(n)))
        assert str(got.value) == str(e)
        return
    tt = ttopo.MeshTopology.from_config(tconfig.MeshConfig(**mesh),
                                        devices=list(range(n)))
    assert tt.axis_sizes == jt.axis_sizes
    assert (tt.world_size, tt.dp_world_size, tt.model_parallel_size,
            tt.active_axes(), repr(tt)) == \
        (jt.world_size, jt.dp_world_size, jt.model_parallel_size,
         jt.active_axes(), repr(jt))
    for k in range(n):
        assert tt.coord_of(k) == jt.coord_of(k)
    for bad in (n, -1):
        with pytest.raises(ValueError) as e_j:
            jt.coord_of(bad)
        with pytest.raises(ValueError) as e_t:
            tt.coord_of(bad)
        assert str(e_t.value) == str(e_j.value)


def test_topology_refusals_and_registry():
    # the reference builds these; the port refuses them, naming A13
    for mesh in ({"tensor_parallel_size": 2}, {"pipeline_parallel_size": 2},
                 {"sequence_parallel_size": 2}, {"expert_parallel_size": 2}):
        _jax_topology(8, mesh)
        with pytest.raises(NotImplementedError, match="A13"):
            ttopo.MeshTopology.from_config(tconfig.MeshConfig(**mesh),
                                           devices=list(range(8)))
    with pytest.raises(ConfigError) as got:
        ttopo.MeshTopology({"dp": 2, "zz": 1}, devices=[0, 1])
    with pytest.raises(JConfigError) as want:
        jtopo.MeshTopology({"dp": 2, "zz": 1}, devices=jax.devices()[:2])
    assert str(got.value) == str(want.value)
    with pytest.raises(ConfigError) as got:
        ttopo.MeshTopology({"dp": 3}, devices=[0, 1])
    with pytest.raises(JConfigError) as want:
        jtopo.MeshTopology({"dp": 3}, devices=jax.devices()[:2])
    assert str(got.value) == str(want.value)
    ttopo.reset_topology()
    with pytest.raises(RuntimeError, match="not initialized"):
        ttopo.get_data_parallel_world_size()
    t = ttopo.MeshTopology({"dp": 2, "fsdp": 4}, devices=list(range(8)))
    ttopo.set_topology(t)
    try:
        assert (ttopo.get_data_parallel_world_size(),
                ttopo.get_model_parallel_world_size(),
                ttopo.get_pipeline_parallel_world_size()) == (8, 1, 1)
        assert t.group_ranks(("dp", "fsdp"), 5) == list(range(8))
        assert t.group_ranks("fsdp", 5) == [4, 5, 6, 7]
        assert t.group_ranks("dp", 5) == [1, 5]
        assert t.axis_index(("dp", "fsdp"), 5) == 5
        with pytest.raises(ValueError, match="mesh order"):
            t.group_ranks(("fsdp", "dp"), 0)
    finally:
        ttopo.reset_topology()


@pytest.mark.parametrize("n,world,block", [
    (1, 1, 8), (100, 2, 16), (2048, 4, 2048), (5000, 3, 64), (7, 8, 8)])
def test_onebit_host_logic_matches_reference(n, world, block):
    assert tonebit.chunk_len(n, world, block) == \
        jonebit.chunk_len(n, world, block)
    assert tonebit.residual_shapes(n, world, block) == \
        jonebit.residual_shapes(n, world, block)
    assert tonebit.payload_bytes(n, world, block) == \
        jonebit.payload_bytes(n, world, block)
    import torch

    x = np.random.default_rng(n).standard_normal((3, 8 * block)).astype(
        np.float32)
    x[0, :5] = 0.0  # zero counts as non-negative in both
    packed = tonebit.pack_signs(torch.from_numpy(x))
    want = np.asarray(jonebit.pack_signs(jnp.asarray(x)))
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(
        tonebit.unpack_signs(packed, 8 * block).numpy(),
        np.asarray(jonebit.unpack_signs(jnp.asarray(want), 8 * block)))


def test_init_distributed_never_falls_back_to_gloo():
    """The default device is the card, whose backend is NCCL: without CUDA
    the call raises instead of starting a gloo world (the CPU world is
    asked for with ``device="cpu"``, as the ranks above do)."""
    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch import comm

    assert not dist.is_initialized() and not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        comm.init_distributed()
    assert not dist.is_initialized()
