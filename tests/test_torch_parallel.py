"""The port's mesh layer (parallel/mesh.py) and data-parallel training
(train/step.py::make_dp_train_step, ``fit(mesh=...)``) on 8 CPU shards,
against the port's one-device step and the reference's ``train_step`` on
its 8-device mesh (tests/conftest.py's virtual CPU devices).

The step: the half-width MatteNet (the reference's dry-run model) in f32 at
32x64, batch 8, from one numpy tree and batch.  Bars as
tests/test_torch_train.py's: the loss within 1e-5 relative and every
gradient leaf within 1e-4 relative L2 of the reference's (sums in another
order); the losses over three steps within 1e-4 relative (the updates feed
back, fit's bar).  Against the port's one-device step the data-parallel
gradient differs only by the order of the per-shard sums: 1e-5 relative
L2.  The batch's shards hold different boundary-mask counts (an empty
shard, a small and a large person), where a mean of per-shard losses is
another loss: the test shows that it is, and that the step's is the whole
batch's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu import models as jmodels
from video_stream_segmenetation_tpu import parallel as jparallel
from video_stream_segmenetation_tpu import train as jtrain
from video_stream_segmenetation_tpu.train import losses as JL
from video_stream_segmenetation_tpu_torch import parallel
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.models.modnet import MatteNet, init_mattenet_params
from video_stream_segmenetation_tpu_torch.runtime.config import default_knobs
from video_stream_segmenetation_tpu_torch.runtime.state import StreamState, init_state, state_tensors
from video_stream_segmenetation_tpu_torch.train import losses as TL
from video_stream_segmenetation_tpu_torch.train import step as TS
from video_stream_segmenetation_tpu_torch.train.loop import fit

CPU = torch.device("cpu")
N = 8
HW = (32, 64)
B = 8


def _cpu_mesh(n=N, n_model=1):
    return parallel.make_mesh(n, n_model, devices=[CPU] * (n * n_model))


# ---- the mesh helpers -----------------------------------------------------


def test_make_mesh_shapes_and_devices():
    mesh = _cpu_mesh()
    assert mesh.shape == {parallel.DATA_AXIS: 8, parallel.MODEL_AXIS: 1}
    assert mesh.data_devices == (CPU,) * 8 and mesh.devices == (CPU,) and mesh.first == CPU
    grid = parallel.make_mesh(4, 2, devices=[CPU] * 8)
    assert grid.shape == {"data": 4, "model": 2} and len(grid.data_devices) == 4
    assert parallel.make_mesh(devices=[CPU] * 6).shape["data"] == 6
    assert parallel.replicated(mesh) == (CPU,)
    with pytest.raises(ValueError, match="needs 9 devices"):
        parallel.make_mesh(9, devices=[CPU] * 8)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only refusal")
def test_make_mesh_refuses_without_a_card():
    """No CUDA device and no devices: it raises as resolve_device does, and
    never falls back to the CPU."""
    with pytest.raises(RuntimeError, match="is_available"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        parallel.make_mesh(2, devices=["cuda", "cuda"])


def test_stream_sharding_matches_the_reference():
    """Each shard's rows are the ones the reference's stream sharding puts
    on its device."""
    mesh = _cpu_mesh()
    jmesh = jparallel.make_mesh()
    for n in (8, 16, 64):
        x = jax.device_put(jnp.arange(n), jparallel.stream_sharding(jmesh))
        want = [(int(np.asarray(sh.data)[0]), int(np.asarray(sh.data)[-1]) + 1)
                for sh in sorted(x.addressable_shards, key=lambda sh: sh.index[0].start or 0)]
        assert parallel.stream_sharding(mesh, n) == want
    with pytest.raises(ValueError, match="divide"):
        parallel.stream_sharding(mesh, 9)


def test_shard_and_replicate_trees():
    mesh = _cpu_mesh(4)
    state = init_state(8, (4, 6), device="cpu")
    state.frame_idx.copy_(torch.arange(8, dtype=torch.int32))
    knobs = default_knobs(8, device="cpu")
    lanes = torch.arange(3 * 8 * 2).reshape(3, 8, 2)
    shards = parallel.shard_stream_tree(mesh, {"state": state, "knobs": knobs})
    assert len(shards) == 4
    for i, sh in enumerate(shards):
        assert isinstance(sh["state"], StreamState)
        assert sh["state"].frame_idx.tolist() == [2 * i, 2 * i + 1]
        assert sh["knobs"].num_streams == 2
    # the shards own their rows: a write to one leaves the tree alone
    shards[0]["state"].frame_idx[0] = 99
    assert int(state.frame_idx[0]) == 0
    by_axis1 = parallel.shard_stream_tree(mesh, lanes, axis=1)
    assert [tuple(t.shape) for t in by_axis1] == [(3, 2, 2)] * 4
    assert torch.equal(torch.cat(by_axis1, dim=1), lanes)
    rep = parallel.replicate_tree(mesh, {"w": np.ones((2, 2), np.float32),
                                         "b": [torch.zeros(3)]})
    assert list(rep) == [CPU]
    assert isinstance(rep[CPU]["w"], torch.Tensor) and rep[CPU]["b"][0].shape == (3,)


def test_gather_is_the_inverse_of_shard_and_replicas_are_their_own():
    mesh = _cpu_mesh(4)
    state = init_state(8, (4, 6), device="cpu")
    state.frame_idx.copy_(torch.arange(8, dtype=torch.int32))
    whole = parallel.gather_stream_tree(parallel.shard_stream_tree(mesh, state), CPU)
    assert isinstance(whole, StreamState)
    for a, b in zip(state_tensors(whole), state_tensors(state)):
        assert torch.equal(a, b)
    # one shard: the tree itself, no copy
    one = parallel.make_mesh(1, devices=[CPU])
    assert parallel.shard_stream_tree(one, state)[0].frame_idx is state.frame_idx
    model = torch.nn.Linear(3, 2)
    reps = parallel.shard_replicas(mesh, model)
    assert reps[0] is model and len({id(r) for r in reps}) == 4
    assert all(torch.equal(r.weight, model.weight) for r in reps)
    calls = []
    run = parallel.sharded_step(mesh, lambda d: lambda x: calls.append(x) or x)
    assert run([(5,), (7,)], shards=[1, 3]) == [5, 7] and calls == [5, 7]


def test_reductions_and_prefixes_keep_shard_order():
    xs = [torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0]),
          torch.tensor([-1e8]), torch.tensor([1.0])]
    # ((1e8 + 1) - 1e8) + 1 in f32: the order is the list's
    assert parallel.reduce_sum(xs, CPU).item() == 1.0
    assert torch.equal(parallel.gather_rows([torch.zeros(2, 3), torch.ones(1, 3)], CPU),
                       torch.tensor([[0.0] * 3] * 2 + [[1.0] * 3]))
    counts = [torch.tensor(c) for c in (3, 0, 2, 5)]
    from video_stream_segmenetation_tpu_torch.parallel.mesh import exclusive_prefix

    assert [int(t) for t in exclusive_prefix(counts, [CPU] * 4)] == [0, 3, 3, 5]
    mesh = _cpu_mesh(4)
    calls = []
    run = parallel.sharded_step(mesh, lambda d: lambda x, k=0: calls.append((d, x, k)) or x)
    assert run([(i,) for i in range(4)], [{"k": i} for i in range(4)]) == [0, 1, 2, 3]
    assert calls == [(CPU, i, i) for i in range(4)]


# ---- the card by default ----------------------------------------------------


def _no_device_calls():
    from video_stream_segmenetation_tpu_torch import bridge
    from video_stream_segmenetation_tpu_torch.models import quantized_face as QF
    from video_stream_segmenetation_tpu_torch.models import reference_face as RF
    from video_stream_segmenetation_tpu_torch.models.quantized import QuantizedMatteNetHD

    w = bridge.WEIGHTS_DIR
    return {
        "QuantizedMatteNetHD": lambda: QuantizedMatteNetHD(
            bridge.load_export(w / "mattenet_hd10_pico.npz"), 10, 4),
        "QuantizedFaceFinder": lambda: QF.QuantizedFaceFinder(
            QF.quantize_face_finder(bridge.load_export(w / "facefinder_128.npz")), 128),
        "QuantizedLandmarkNet": lambda: QF.QuantizedLandmarkNet(
            QF.quantize_landmark_net(bridge.load_export(w / "landmarknet_128.npz"))),
        "ReferenceFaceFinder": lambda: RF.ReferenceFaceFinder(),
        "ReferenceLandmarkNet": lambda: RF.ReferenceLandmarkNet(),
        "init_state": lambda: init_state(2, (4, 6)),
    }


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU-only refusal")
@pytest.mark.parametrize("name", sorted(_no_device_calls()))
def test_serving_constructors_default_to_the_card(name):
    """With no device given they ask for the card and, with none, raise
    resolve_device's error (as Engine does): none falls back to the CPU."""
    with pytest.raises(RuntimeError, match="is_available"):
        _no_device_calls()[name]()


# ---- the data-parallel step -----------------------------------------------


def _batch():
    """8 samples whose two-sample shards differ in boundary-mask counts:
    shard 0 empty, the others persons of growing size and softness."""
    g = np.random.default_rng(7)
    frames = g.random((B, *HW, 3), dtype=np.float32)
    yy, xx = np.mgrid[0:HW[0], 0:HW[1]].astype(np.float32)
    alpha = np.zeros((B, *HW), np.float32)
    for i in range(2, B):
        d = np.sqrt(((xx - 32) / (3.0 + 3 * i)) ** 2 + ((yy - 18) / (2.0 + 2 * i)) ** 2)
        alpha[i] = np.clip((1.05 - d) / (0.05 * i), 0, 1)
    frames = (frames * 0.5 + alpha[..., None] * 0.4).astype(np.float32)
    return frames, alpha


@pytest.fixture(scope="module")
def tree():
    jm = jmodels.MatteNet(width=0.5, dtype=jnp.float32)
    flax = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), dict(flax))


def test_half_width_tree_has_the_flax_shapes(tree):
    """The port's seeded MatteNet at width 0.5 (the dry run's) has the flax
    tree's names and shapes."""
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    assert shapes(init_mattenet_params(0, width=0.5)) == shapes(tree)


def _port_grads(tree, frames, gt, mesh):
    model = MatteNet(tree, device="cpu", dtype=torch.float32)
    model.requires_grad_(True)
    tx = TS.make_optimizer()
    if mesh is None:
        loss, metrics = TL.matting_loss(model(frames), gt, frames)
        names = [k for k, _ in model.named_parameters()]
        gs = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
        return loss.item(), dict(zip(names, (g.numpy() for g in gs)))
    step = TS.make_dp_train_step(model, tx, mesh, B)
    loss, _, summed = step.grads(frames, gt)
    return loss.item(), {k: g.numpy() for k, g in summed.items()}


@pytest.fixture(scope="module")
def reference(tree):
    """The reference's loss, gradient tree and three step losses on its
    8-device mesh (the batch sharded over 'data', the state replicated)."""
    jmesh = jparallel.make_mesh()
    jm = jmodels.MatteNet(width=0.5, dtype=jnp.float32)
    frames, gt = _batch()
    sh = lambda x: jax.device_put(  # noqa: E731
        jnp.asarray(x), NamedSharding(jmesh, P(jparallel.DATA_AXIS, *[None] * (x.ndim - 1))))
    fr, g = sh(frames), sh(gt)
    params = jparallel.replicate_tree(jmesh, jax.tree_util.tree_map(jnp.asarray, tree))
    vg = jax.jit(jax.value_and_grad(lambda p: JL.matting_loss(jm.apply(p, fr), g, fr)[0]))
    loss, grads = vg(params)
    tx = jtrain.make_optimizer(1e-3)
    state = jtrain.TrainState(params=params, opt_state=tx.init(params), step=0)
    state = jparallel.replicate_tree(jmesh, state)
    step = jax.jit(jtrain.make_train_step(jm, tx))
    losses = []
    for _ in range(3):
        state, metrics = step(state, fr, g)
        losses.append(float(metrics["loss"]))
    assert len(fr.sharding.device_set) == 8
    return float(loss), jax.tree_util.tree_map(np.asarray, grads), losses


def _as_port_names(grad_tree) -> dict:
    """A flax-named gradient tree -> the port MatteNet's parameter names
    (loaded into a model as its weights, read back in parameter order)."""
    m = MatteNet(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), grad_tree),
                 device="cpu", dtype=torch.float32)
    return {k: p.detach().numpy() for k, p in m.named_parameters()}


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_dp_gradients_match_one_device_and_reference(tree, reference):
    frames, gt = (torch.as_tensor(x) for x in _batch())
    one_loss, one = _port_grads(tree, frames, gt, None)
    dp_loss, dp = _port_grads(tree, frames, gt, _cpu_mesh())
    jloss, jgrads, _ = reference
    want = _as_port_names(jgrads)
    assert abs(dp_loss - one_loss) <= 1e-6 * abs(one_loss)
    assert abs(dp_loss - jloss) <= 1e-5 * abs(jloss)
    assert dp.keys() == one.keys() == want.keys()
    for k in dp:
        assert _rel(dp[k], one[k]) <= 1e-5, (k, _rel(dp[k], one[k]))
        assert _rel(dp[k], want[k]) <= 1e-4, (k, _rel(dp[k], want[k]))


def test_dp_loss_is_the_whole_batch_loss_not_a_shard_mean(tree):
    """The boundary-mask and foreground-weight sums normalise over the
    whole batch: the shards' mean of their own losses is another number."""
    frames, gt = (torch.as_tensor(x) for x in _batch())
    model = MatteNet(tree, device="cpu", dtype=torch.float32)
    whole, _ = TL.matting_loss(model(frames), gt, frames)
    ranges = parallel.stream_sharding(_cpu_mesh(4), B)
    mean = np.mean([TL.matting_loss(model(frames[a:b]), gt[a:b], frames[a:b])[1]["detail"].item()
                    for a, b in ranges])
    det_hw = tuple(model(frames[:1])["detail"].shape[-2:])
    bmask = [float(TL._boundary_mask(TL.resize_bilinear(
        gt[a:b], det_hw, method="half_pixel", channel_last=False)).sum()) for a, b in ranges]
    step = TS.make_dp_train_step(MatteNet(tree, device="cpu", dtype=torch.float32),
                                 TS.make_optimizer(), _cpu_mesh(4), B)
    loss, metrics, _ = step.grads(frames, gt)
    assert abs(loss.item() - whole.item()) <= 1e-6 * abs(whole.item())
    assert abs(metrics["detail"].item() - mean) > 1e-2 * abs(mean)
    assert len(set(bmask)) == len(bmask) and bmask[0] == 0.0, bmask


def test_dp_steps_match_one_device_and_reference(tree, reference):
    """Three whole steps (forward, backward, the summed gradient's clip and
    AdamW update, the replicas refreshed): the losses as fit's bar."""
    frames, gt = (torch.as_tensor(x) for x in _batch())
    runs = {}
    for name, mesh in (("one", None), ("dp", _cpu_mesh())):
        model = MatteNet(tree, device="cpu", dtype=torch.float32)
        model.requires_grad_(True)
        tx = TS.make_optimizer(1e-3)
        state, _ = TS.init_train_state(model, tx)
        step = (TS.make_train_step(model, tx) if mesh is None
                else TS.make_dp_train_step(model, tx, mesh, B))
        losses = []
        for _ in range(3):
            state, metrics = step(state, frames, gt)
            losses.append(metrics["loss"].item())
        runs[name] = losses
        if mesh is not None:
            for rep in step.replicas[1:]:
                for (k, p), (_, q) in zip(model.named_parameters(), rep.named_parameters()):
                    assert torch.equal(p, q), k
    for d, o, j in zip(runs["dp"], runs["one"], reference[2]):
        assert abs(d - o) <= 1e-4 * abs(o)
        assert abs(d - j) <= 1e-4 * abs(j)
    assert runs["dp"][-1] < runs["dp"][0]


def test_fit_on_a_mesh_matches_fit_on_one_device():
    """fit(mesh=...) from the same seed: the history's losses and IoU (on
    the whole batch, as one device's) and the trained tree."""
    runs = {}
    for name, mesh in (("one", None), ("mesh", _cpu_mesh(4))):
        m = MatteNetHD(10, 4, "pico", dtype=torch.float32, device="cpu")
        # steps_per_call is ignored under a mesh, as the reference ignores it
        runs[name] = fit(m, hw=(80, 160), batch=8, steps=3, lr=5e-4, log_every=1, mesh=mesh,
                         steps_per_call=1 if mesh is None else 3)
    (t1, h1), (tm, hm) = runs["one"], runs["mesh"]
    assert [r["step"] for r in hm] == [r["step"] for r in h1] == [0, 1, 2]
    for a, b in zip(hm, h1):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
        assert abs(a["iou"] - b["iou"]) <= 1e-2
    want = dict(jax.tree_util.tree_leaves_with_path(t1))
    for path, v in jax.tree_util.tree_leaves_with_path(tm):
        w = want[path]
        cos = float(np.dot(np.ravel(v), np.ravel(w))
                    / max(np.linalg.norm(v) * np.linalg.norm(w), 1e-30))
        assert cos >= 0.999, (path, cos)


def test_dp_step_refuses_a_batch_that_does_not_divide(tree):
    model = MatteNet(tree, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="divide"):
        TS.make_dp_train_step(model, TS.make_optimizer(), _cpu_mesh(), 12)
    step = TS.make_dp_train_step(model, TS.make_optimizer(), _cpu_mesh(), B)
    frames, gt = (torch.as_tensor(x[:4]) for x in _batch())
    with pytest.raises(ValueError, match="batch of 4"):
        step.grads(frames, gt)


def test_dp_mesh_dataclass_is_frozen():
    mesh = _cpu_mesh(2)
    with pytest.raises(dataclasses.FrozenInstanceError):
        mesh.grid = ()
