"""The port's multi-device path (``lycoris_tpu_torch.parallel``, the
trainer's ``mesh``/``shard_base``, ``graft_entry``) on the CPU: worlds of
spawned processes on gloo, each with a ``file://`` rendezvous under
``tmp_path`` and a hard timeout, held to the JAX package's sharded trainer
and to the port's trainer in one process.
"""

import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lycoris_tpu.parallel.sharding as jshd
import torch_parallel_ranks as ranks
import torch_parity as tp
from lycoris_tpu.models import unet as junet
from lycoris_tpu.trainer import DiffusionTrainer as JaxTrainer
from lycoris_tpu_torch import parallel
from lycoris_tpu_torch.graft_entry import dryrun_multichip
from lycoris_tpu_torch.models import unet as tunet
from lycoris_tpu_torch.parallel import sharding as shd

WORLD_TIMEOUT = 110  # seconds a spawned world may take, start-up included
BATCH = 8
STEPS = 3


class StubMesh:
    """The shape of a ``(data, model)`` mesh and this rank's coordinate on
    each axis, with no process group."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data, model, index=0):
        self.shape, self.index = (data, model), index

    def get_local_rank(self, axis):
        return self.index


@pytest.fixture(autouse=True)
def reset_preset():
    yield
    tp.jl.LycorisNetwork.reset_preset()
    tp.tl.LycorisNetwork.reset_preset()


# -- the sharding rule ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1024, 512), (16, 16), (514, 512), (513, 7, 129)])
def test_base_param_spec_matches_jax(shape):
    """The four cases of ``test_parallel.py::test_base_param_specs``: the
    same dim sharded (both packages see the same shape) or none."""
    jspec = jshd.base_param_spec(jnp.zeros(shape), jshd.make_mesh(data=4, model=2))
    want = next((i for i, a in enumerate(jspec) if a == "model"), None)
    assert shd.base_param_spec(torch.empty(shape, device="meta"), StubMesh(4, 2)) == want


def _sdxl_leaves():
    cfg = junet.sdxl_config()
    sds = jax.ShapeDtypeStruct
    args = (sds((1, 4, 8, 8), jnp.float32), sds((1,), jnp.int32), sds((1, 6, 2048), jnp.float32),
            sds((1, 2816), jnp.float32))
    jleaves = jax.tree_util.tree_leaves(
        jax.eval_shape(junet.UNet2DConditionModel(cfg).init, jax.random.key(0), *args)["params"])
    tmodel = tunet.UNet2DConditionModel(tunet.sdxl_config(), device="meta")
    return jleaves, list(tmodel.parameters())


@pytest.fixture(scope="module")
def sdxl_leaves():
    return _sdxl_leaves()


@pytest.mark.parametrize("model", [2, 8])
def test_sdxl_sharded_bytes_match_jax(sdxl_leaves, model):
    """Every base leaf of the SDXL config: as many sharded, and the same
    bytes a rank, as the JAX rule gives on the flax shapes (flax stores
    linears (in, out) and convs (kh, kw, in, out), so the dim may differ)."""
    jleaves, tleaves = sdxl_leaves
    assert len(jleaves) == len(tleaves)
    jmesh = StubMesh(8 // model, model)

    def per_rank(shape, dim):
        n = math.prod(shape)
        return n // model if dim is not None else n

    jdims = [jshd.base_param_spec(x, jshd.make_mesh(data=8 // model, model=model))
             for x in jleaves]
    jdims = [next((i for i, a in enumerate(s) if a == "model"), None) for s in jdims]
    tdims = [shd.base_param_spec(p, jmesh) for p in tleaves]
    assert sum(d is not None for d in tdims) == sum(d is not None for d in jdims)
    jbytes = sum(per_rank(x.shape, d) for x, d in zip(jleaves, jdims))
    tbytes = sum(per_rank(p.shape, d) for p, d in zip(tleaves, tdims))
    assert tbytes == jbytes
    assert tbytes < 0.55 * sum(p.numel() for p in tleaves)


# -- worlds against the JAX sharded trainer and one process ------------------------------


def _jax_draws(rng, b):
    """The noise and timesteps the JAX step draws from ``rng``
    (``lycoris_tpu/trainer.py``: ``jax.random.split(rng, 3)``)."""
    noise_rng, t_rng, _ = jax.random.split(rng, 3)
    noise = jax.random.normal(noise_rng, (b, 4, 8, 8), dtype=jnp.float32)
    t = jax.random.randint(t_rng, (b,), 0, 1000)
    return np.asarray(noise), np.asarray(t)


def _jax_tiny(batch):
    """The JAX tiny UNet with seeded numpy params in the tree its init would
    make (found by ``jax.eval_shape``, with no init to compile): kernels
    N(0, 1/fan_in), biases N(0, 0.05^2), norm scales 1 + N(0, 0.05^2); a
    LoKr network on its attn-mlp layers, the trainable factors moved by
    N(0, 0.05^2) as in ``torch_parity.setup``; numpy latents and context."""
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((batch, 4, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((batch, 6, 32)).astype(np.float32)
    model = junet.UNet2DConditionModel(junet.tiny_unet_config())
    args = (jnp.asarray(lat), jnp.zeros((batch,), jnp.int32), jnp.asarray(ctx))
    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)["params"]

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim >= 2:
            return jnp.asarray(z / np.sqrt(math.prod(leaf.shape[:-1])))
        return jnp.asarray(z * 0.05 if path[-1].key == "bias" else 1 + z * 0.05)

    variables = {"params": jax.tree_util.tree_map_with_path(draw, shapes)}
    graph = tp.jl.ModelGraph.from_linen(model, variables, *args)
    tp.jl.LycorisNetwork.apply_preset(tp.ATTN_MLP)
    try:
        net = tp.jl.create_lycoris(graph, 1.0, 4, 2.0, algo="lokr", factor=4,
                                   rng=jax.random.key(1))
    finally:
        tp.jl.LycorisNetwork.reset_preset()
    tree = net.params_tree()
    for ln, p in tree.items():
        for k in sorted(p):
            if k in net.lora_map[ln].trainable:
                p[k] = p[k] + jnp.asarray(rng.standard_normal(p[k].shape).astype(np.float32)
                                          * 0.05)
    net.set_params_tree(tree)
    return model, variables, net, lat, ctx


RUN_2X2 = {"name": "2x2", "data": 2, "model": 2, "shard_base": True, "steps": STEPS,
           "fed": True}
PAIR_RUNS = [
    {"name": "dp", "data": 2, "model": 1, "steps": STEPS},
    {"name": "mp", "data": 1, "model": 2, "steps": STEPS, "shard_base": True, "min_size": 2**10,
     "remat": True, "merge_check": True},
    {"name": "mp_premerge", "data": 1, "model": 2, "steps": 2, "min_size": 2**10,
     "merge_mode": "premerge"},
    {"name": "dp_dropout", "data": 2, "model": 1, "steps": 2, "locon_dropout": 0.1},
]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The setup file the port's ranks load (the JAX UNet and adapters in the
    port, the batch, the JAX step's draws); a 4-rank world through
    ``RUN_2X2`` and a 2-rank one through ``PAIR_RUNS``, both running while
    the JAX trainer compiles and takes its steps on a (4, 2) mesh with the
    base sharded; and each pair run in one process on the global batch."""
    model, variables, net, lat, ctx = _jax_tiny(BATCH)
    rngs = [jax.random.fold_in(jax.random.key(3), i) for i in range(STEPS)]
    fed = []
    for r in rngs:
        noise, t = _jax_draws(r, BATCH)
        fed.append({"noise": torch.tensor(noise), "t": torch.tensor(t).long(), "seed": 0})
    setup = {"unet": tunet.state_dict_from_jax(variables["params"]),
             "adapters": {k: torch.tensor(np.array(v)) for k, v in net.state_dict().items()},
             "batch": {"latents": torch.tensor(lat), "context": torch.tensor(ctx)},
             "fed": fed}
    path = str(tmp_path_factory.mktemp("parallel") / "setup.pt")
    torch.save(setup, path)
    with ThreadPoolExecutor(2) as pool:
        quad = pool.submit(parallel.run_world, ranks.trainer_runs, 4, path, [RUN_2X2],
                           timeout=WORLD_TIMEOUT)
        pair = pool.submit(parallel.run_world, ranks.trainer_runs, 2, path, PAIR_RUNS,
                           timeout=WORLD_TIMEOUT)
        jtr = JaxTrainer(model, variables, net, lr=1e-3, mesh=jshd.make_mesh(data=4, model=2),
                         weight_dtype=jnp.float32, shard_base=True)
        batch = {"latents": jnp.asarray(lat), "context": jnp.asarray(ctx)}
        jlosses = [float(jtr.train_step(batch, r)) for r in rngs]
        quad, pair = quad.result(), pair.result()
    specs = jax.tree_util.tree_leaves(
        jtr.base_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"jax_losses": jlosses, "quad": quad, "pair": pair,
            "jax_sharded": sum(any(a is not None for a in s) for s in specs),
            "one": {run["name"]: ranks.train(setup, run, None) for run in PAIR_RUNS}}


def test_world_2x2_matches_jax_4x2(worlds):
    """A (2, 2) gloo world, the base sharded by the trainer, fed the JAX
    step's global noise and timesteps: the JAX (4, 2) trainer's losses."""
    for o in worlds["quad"]:
        np.testing.assert_allclose(o["2x2"]["losses"], worlds["jax_losses"], rtol=1e-4)
        assert len(o["2x2"]["sharded"]) == worlds["jax_sharded"] >= 1


@pytest.fixture(scope="module")
def pair_world(worlds):
    return worlds["pair"], worlds["one"]


@pytest.mark.parametrize("name", [r["name"] for r in PAIR_RUNS])
def test_world_pairs_match_one_process(pair_world, name):
    """(2, 1), (1, 2) with the base sharded (the trainer's rule, then at
    2**10 with whole-block checkpointing), premerge on (1, 2), and LoCon
    with dropout 0.1 on (2, 1): the one-process losses within rtol 1e-4,
    the adapter tensors equal on both ranks and close to one process's."""
    outs, one = pair_world
    for o in outs:
        np.testing.assert_allclose(o[name]["losses"], one[name]["losses"], rtol=1e-4)
    a0, a1 = outs[0][name]["adapters"], outs[1][name]["adapters"]
    assert set(a0) == set(a1) == set(one[name]["adapters"])
    for k in a0:
        assert torch.equal(a0[k], a1[k]), k
    tp.assert_trees_close({"n": outs[0][name]["adapters"]}, {"n": one[name]["adapters"]},
                          rel=1e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_dropout_shard_rows_of_global_mask(n):
    """Plain dropout on rank i's rows of a batch split over n ranks is those
    rows of the dropout of the whole batch under the same draw."""
    from lycoris_tpu_torch.modules.base import DROP_SALT, draw_generator, dropout

    x = torch.tensor(np.random.default_rng(0).standard_normal((8, 5, 6)), dtype=torch.float32)
    whole = dropout(draw_generator(11, DROP_SALT, "cpu"), x, 0.3)
    b = 8 // n
    rows = [dropout(draw_generator(11, DROP_SALT, "cpu"), x[i * b:(i + 1) * b], 0.3, (i, n))
            for i in range(n)]
    assert torch.equal(torch.cat(rows), whole)
    assert not torch.equal(rows[1], dropout(draw_generator(11, DROP_SALT, "cpu"), x[b:2 * b],
                                            0.3))


def test_world_sharded_base_bytes_and_merge(pair_world):
    """Under (1, 2) at 2**10 each rank holds less than 0.6x of the base;
    ``merge_to`` writes each rank's slice: the merged model's output is the
    one-process merged model's."""
    outs, one = pair_world
    for o in outs:
        assert o["mp"]["bytes"] < 0.6 * o["mp"]["full_bytes"]
        torch.testing.assert_close(o["mp"]["merged_out"], one["mp"]["merged_out"],
                                   rtol=1e-4, atol=1e-5)


def test_world_collective_counts(pair_world):
    """Per step: (2, 1) gathers no base leaf and makes one all-reduce; (1, 2)
    gathers every sharded leaf at least once and at most 4 times (the
    forward and the checkpointed recompute), and makes one all-reduce."""
    outs, _ = pair_world
    for o in outs:
        for c in o["dp"]["counts"]:
            assert c["collectives"] == {"all_reduce": 1}, c
            assert not c["gathers"]
        sharded = o["mp"]["sharded"]
        assert len(sharded) > 20
        for c in o["mp"]["counts"]:
            assert c["collectives"]["all_reduce"] == 1
            assert set(c["gathers"]) == set(sharded)
            assert max(c["gathers"].values()) <= 4, c["gathers"]
            assert c["collectives"]["all_gather"] == sum(c["gathers"].values())


def test_dryrun_multichip_4():
    dryrun_multichip(4, device="cpu", timeout=WORLD_TIMEOUT)


def test_dryrun_multichip_takes_a_card_a_rank(monkeypatch):
    """Without ``device=`` the ranks run on the cards through NCCL: with too
    few cards it raises before it starts a process, and never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card a rank"):
        dryrun_multichip(2)


def test_run_world_raises_with_failing_rank_tail():
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        parallel.run_world(ranks.fail_on_rank_one, 2, timeout=60)


def test_init_distributed_backend(monkeypatch, tmp_path):
    """NCCL unless the caller asks for the CPU; one process with no launcher
    environment joins no group; a failed initialisation raises: NCCL's
    error propagates, and a gloo rendezvous that no peer joins times out."""
    assert parallel.backend_for("cuda") == parallel.backend_for("cuda:1") == "nccl"
    assert parallel.backend_for("cpu") == "gloo"
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.init_distributed(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert shd.make_mesh() is None
    with pytest.raises(RuntimeError, match="needs a process group"):
        shd.make_mesh(devices=[0, 1])
    monkeypatch.setattr(parallel, "COLLECTIVE_TIMEOUT_S", 2)
    with pytest.raises(RuntimeError):
        parallel.init_distributed(f"file://{tmp_path}/rendezvous", num_processes=2,
                                  process_id=0, device="cpu")
    assert not torch.distributed.is_initialized()
    asked = []

    def refuse(backend, **kwargs):
        asked.append(backend)
        raise RuntimeError("NCCL error: unhandled system error")

    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: None)
    with pytest.raises(RuntimeError, match="NCCL error"):
        parallel.init_distributed("localhost:1", num_processes=2, process_id=0)
    assert asked == ["nccl"]
    assert not torch.distributed.is_initialized()


def test_shard_batch_rows():
    """Rank i's rows of dim 0; a batch that does not divide raises."""
    x = torch.arange(8.0).reshape(8, 1)
    mesh = StubMesh(4, 1, index=2)
    assert shd.batch_spec(3) == ("data", None, None)
    assert shd.shard_batch({"x": x}, mesh)["x"].flatten().tolist() == [4.0, 5.0]
    assert shd.shard_batch(x, None) is x
    with pytest.raises(ValueError):
        shd.shard_batch(torch.zeros(6, 1), mesh)
