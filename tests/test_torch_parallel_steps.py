"""The port's parallel train steps (``parallel/``: data parallelism, tensor
parallelism on the plain route, ZeRO-1) in spawned worlds of 2 and 4
ranks (``parallel.launch.run_world``: gloo over a ``FileStore``), each
held to the JAX package's ``make_train_step`` on the matching mesh of its
8-device virtual CPU mesh, from the same numpy weights and crops.

World of 2: DP on (2, 1), TP on (1, 2), ZeRO-1 on (2, 1). World of 4: TP
on (2, 2) (dp x tp), ZeRO-1 on (4, 1) and TP-fused on (2, 2) (the twins of
rows 1p, 4p, 7p and 8p, f32 compute, against JAX's ``tp_fused`` step with
its Pallas kernels in interpret mode, as JAX's ``tests/test_tp_fused.py``
runs it: loss within 2e-3 relative, that test's bound). Two f32 steps each (lr 1e-3,
the second with the last layer frozen), so ZeRO-1's sharded moments feed
an update. Tolerances, those of JAX's own ``tests/test_sharding.py``
for the sharded step against the single-device one: each step's loss
within 1e-5 absolute (TP: 1e-5 relative), the center within 1e-6, the
student parameters within 1e-3 absolute, and ZeRO-1's moments gathered
back within 1e-3 of each leaf's max (JAX's test: 1e-3 absolute). The first step's
gradients, gathered into the single-card layout, equal the port's
one-card step's within 1e-4 of each leaf's max (the bound at which
``tests/test_torch_train_step.py`` holds that step's gradients to JAX's).
"""

from functools import partial

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from dino_video_summarization_transformer_tpu.models import timesformer as jtsf
from dino_video_summarization_transformer_tpu.parallel import (
    build_mesh as jbuild_mesh, data_sharding, replicated, shard_state, tp_sharding_tree,
    zero_sharding_tree)
from dino_video_summarization_transformer_tpu.parallel.tp_fused import (
    permute_qkv_tree, tp_fused_forward_features, unpermute_qkv_tree)
from dino_video_summarization_transformer_tpu.train import optim as joptim
from dino_video_summarization_transformer_tpu.train import ssl as jssl
from dino_video_summarization_transformer_tpu.utils import synthetic as jsyn
from dino_video_summarization_transformer_tpu_torch.models import convert
from dino_video_summarization_transformer_tpu_torch.parallel import launch, worlds
from dino_video_summarization_transformer_tpu_torch.utils.synthetic import (
    make_numpy_head_params)

KW = dict(img_size=32, embed_dim=256, depth=1, num_heads=4, num_frames=2, num_classes=0)
OUT, B, N_LOCAL = 128, 4, 2
HYPER = [(1e-3, 1e-4, 0.99, 0.04, False), (1e-3, 1e-4, 0.99, 0.04, True)]
WORLD2 = [("dp", (2, 1)), ("tp", (1, 2)), ("zero1", (2, 1))]
WORLD4 = [("tp", (2, 2)), ("zero1", (4, 1)), ("tp_fused", (2, 2))]
METER_VALUES = [[1.0, 2.0, 4.0], [8.0]]  # a MetricLogger meter's values on ranks 0 and 1
# parameters after the two steps: JAX's 1e-3; TP-fused, whose gradients
# differ by bf16 roundings, 2 steps x 2.1 x lr (Adam's first steps are
# sign-like: a gradient near zero may flip, as in test_torch_train_step)
PARAM_TOL = {"dp": 1e-3, "tp": 1e-3, "zero1": 1e-3, "tp_fused": 2 * 2.1 * 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """numpy weights (JAX layout and the port's reference layout) and two
    steps' view-major crops."""
    jcfg = jtsf.TimeSformerConfig(**KW)
    backbone = jax.tree.map(np.asarray, jsyn.make_numpy_params(jcfg, seed=0))
    head = make_numpy_head_params(KW["embed_dim"], OUT, seed=1)
    r = np.random.RandomState(0)
    crops = [(r.randn(2 * B, 3, 2, 32, 32).astype(np.float32),
              r.randn(N_LOCAL * B, 3, 2, 32, 32).astype(np.float32)) for _ in HYPER]
    from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf

    spec = dict(cfg=KW, out_dim=OUT, backbone=convert.state_dict_from_jax_params(
        backbone, tsf.TimeSformerConfig(**KW)), head=convert.head_state_dict_from_jax(head),
        crops=crops, hyper=HYPER, n_local=N_LOCAL)
    return {"jcfg": jcfg, "student": {"backbone": backbone, "head": head}, "spec": spec}


def _to_port(tree):
    from dino_video_summarization_transformer_tpu_torch.models import timesformer as tsf

    cfg = tsf.TimeSformerConfig(**KW)
    sd = {"backbone." + k: v for k, v in convert.state_dict_from_jax_params(
        jax.tree.map(np.asarray, tree["backbone"]), cfg).items()}
    sd.update({"head." + k: v for k, v in convert.head_state_dict_from_jax(
        jax.tree.map(np.asarray, tree["head"])).items()})
    return sd


def _jax_steps(setup, kind, data, model):
    """JAX's ``make_train_step`` on a (data, model) mesh of the virtual
    devices: -> losses, center, student and Adam moments (port names)."""
    jcfg, st = setup["jcfg"], jax.tree.map(jnp.asarray, setup["student"])
    core, mask = joptim.build_optimizer("adamw", st)
    state = jssl.TrainState(st, jax.tree.map(jnp.copy, st), jnp.zeros((1, OUT)),
                            core.init(st), jnp.zeros((), jnp.int32))
    mesh = jbuild_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    fwd = None
    if kind == "tp_fused":  # JAX's own test's f32 compute, kernels in interpret mode
        state = state._replace(student=permute_qkv_tree(state.student, KW["num_heads"], model),
                               teacher=permute_qkv_tree(state.teacher, KW["num_heads"], model))
        fwd = partial(tp_fused_forward_features, cfg=jcfg, mesh=mesh,
                      compute_dtype=jnp.float32)
    if kind.startswith("tp"):
        sharding, state = tp_sharding_tree(state, mesh), shard_state(state, mesh)
    elif kind == "zero1":
        sharding = zero_sharding_tree(state, mesh)
        state = jax.device_put(state, sharding)
    else:
        sharding, state = None, jax.device_put(state, replicated(mesh))
    step = jssl.make_train_step(jcfg, core, mask, n_local_crops=N_LOCAL, mesh=mesh,
                                donate=False, state_sharding=sharding,
                                backbone_forward=fwd)
    losses = []
    for (g, l), hyper in zip(setup["spec"]["crops"], HYPER):
        state, m = step(state, jax.device_put(jnp.asarray(g), data_sharding(mesh)),
                        jax.device_put(jnp.asarray(l), data_sharding(mesh)), *hyper)
        losses.append(float(m["loss"]))
    adam, student = state.opt_state, state.student
    if kind == "tp_fused":
        student = unpermute_qkv_tree(student, KW["num_heads"], model)
    return {"loss": losses, "center": np.asarray(state.center),
            "student": _to_port(student),
            "mu": _to_port(adam.mu), "nu": _to_port(adam.nu)}


@pytest.fixture(scope="module")
def port_runs(setup):
    """The port: one card in this process, then the two worlds (the world
    of 2 also syncs a MetricLogger meter, the world of 4 broadcasts a
    node's batch)."""
    spec = setup["spec"]
    one = worlds.sharded_steps(0, 1, dict(spec, mode="one"))
    w2 = launch.run_world(worlds.run_calls, 2, [(worlds.sharded_steps, dict(
        spec, mode=m, mesh=mesh)) for m, mesh in WORLD2]
        + [(worlds.synchronized_meter, METER_VALUES)])
    w4 = launch.run_world(worlds.run_calls, 4, [(worlds.sharded_steps, dict(
        spec, mode=m, mesh=mesh, grads=m != "tp_fused")) for m, mesh in WORLD4]
        + [(worlds.node_broadcast, 2)])
    return one, {**{(m, mesh): [r[i] for r in w2] for i, (m, mesh) in enumerate(WORLD2)},
                 **{(m, mesh): [r[i] for r in w4] for i, (m, mesh) in enumerate(WORLD4)}}, \
        [r[-1] for r in w2], [r[-1] for r in w4]


def _check(ranks, ref, kind):
    """Every rank's losses and center, rank 0's gathered state, against a
    JAX mesh step's."""
    for out in ranks:
        for got, want in zip(out["loss"], ref["loss"]):
            tol = {"tp": 1e-5 * abs(want), "tp_fused": 2e-3 * abs(want)}.get(kind, 1e-5)
            assert abs(got - want) <= tol, (kind, got, want)
        if kind != "tp_fused":
            assert np.abs(out["center"][-1] - ref["center"]).max() <= 1e-6, kind
    state = ranks[0]["state"]
    for n, want in ref["student"].items():
        assert np.abs(state["student." + n] - want).max() <= PARAM_TOL[kind], (kind, n)
    return state


@pytest.mark.parametrize("kind,mesh", WORLD2 + WORLD4, ids=lambda v: str(v))
def test_sharded_step_matches_jax_mesh_step(setup, port_runs, kind, mesh):
    one, runs, _, _ = port_runs
    ranks = runs[kind, mesh]
    ref = _jax_steps(setup, kind, *mesh)
    state = _check(ranks, ref, kind)
    if kind == "zero1":
        for m in ("mu", "nu"):
            for n, want in ref[m].items():
                got = state[f"opt.{m}.{n}"]
                assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max() + 1e-30, (m, n)
    for n, want in one["grads"].items() if kind != "tp_fused" else ():
        got = ranks[0]["grads"][n]
        assert np.abs(got - want).max() <= 1e-4 * (np.abs(want).max() + 1e-30), (kind, n)
    # every rank of a model group holds the same (gathered) values
    assert all(np.array_equal(r["center"][-1], ranks[0]["center"][-1]) for r in ranks)


def test_worlds_agree_with_one_card(port_runs):
    """The sharded steps against the port's one-card f32 step on the same
    global batch: the losses within 1e-6 relative (TP-fused, whose shards
    round their terms to bf16: 2e-3, JAX's bound for its TP-fused step
    against the plain one), the student parameters within ``PARAM_TOL``."""
    one, runs, _, _ = port_runs
    for (kind, mesh), ranks in runs.items():
        rtol = 2e-3 if kind == "tp_fused" else 1e-6
        for got, want in zip(ranks[0]["loss"], one["loss"]):
            assert abs(got - want) <= rtol * abs(want), (kind, mesh, got, want)
        st = ranks[0]["state"]
        for k, v in one["state"].items():
            if k.startswith("student."):
                assert np.abs(st[k] - v).max() <= PARAM_TOL[kind], (kind, mesh, k)


def test_metric_logger_sums_over_the_world(port_runs):
    """``MetricLogger.synchronize_between_processes`` (the JAX CLI's
    ``:586``): every rank ends with the world's count and total."""
    for count, total, avg in port_runs[2]:
        assert (count, total, avg) == (4, 15.0, 3.75)


def test_node_batch_reaches_every_rank_of_its_node(port_runs):
    """The train CLI's hand-out of a node's batch (``mesh.broadcast_tree``
    over ``mesh.node_group``) in a world of 4 as 2 nodes of 2 ranks: each
    rank holds its node's first rank's tensors, and only those."""
    for rank, (a, b) in enumerate(port_runs[3]):
        src = rank // 2 * 2
        assert np.array_equal(a, np.full((2, 3), float(src), np.float32)), rank
        assert np.array_equal(b, np.arange(4) + src), rank
