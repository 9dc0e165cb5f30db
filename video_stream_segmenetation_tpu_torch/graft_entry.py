"""Entry points (port of ``__graft_entry__.py``).

``entry(device)``: the flagship's single-device forward, the plan-B
MatteNetHD (stem stride 10) on s2d-packed u8 frames ``[S, 72, 128, 300]``
-> alpha ``[S, 288, 512]`` f32.

``dryrun_multichip(n, devices)``: the multi-device paths on an ``n``-shard
mesh at the reference's tiny geometry: a data-parallel training step, a
sharded serving step, ``Engine(mesh=...)`` through ``process`` and
``dispatch``/``collect``, the StreamScheduler rotation with groups that do
not align with the shards, and the fused-round mode.  ``devices`` defaults
to the visible cards, each used ``n / count`` times (on a one-card machine
``n`` virtual shards of it); ``[torch.device("cpu")] * n`` runs it on the
CPU.

    python -m video_stream_segmenetation_tpu_torch.graft_entry [--n 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

S_ENTRY = 4  # the reference's entry batch


def entry(device="cuda", params: dict | None = None):
    """``(forward, (model, frames_packed))``: ``forward(model, frames_packed)
    -> alpha [S, 288, 512] f32``, the plan-B MatteNetHD (bf16) on ``params``
    (a flax-named float tree; None: the seed-0 tree) over 4 random 720p
    frames packed at block 10, on ``device``."""
    from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD, init_params
    from video_stream_segmenetation_tpu_torch.ops.layout import space_to_depth
    from video_stream_segmenetation_tpu_torch.parallel.mesh import resolve_device

    dev = resolve_device(device)
    tree = init_params("full", 0, 10) if params is None else params
    model = MatteNetHD(stem_stride=10, head_upsample=4, decoder="full", params=tree,
                       device=dev)
    model.requires_grad_(False)

    def forward(model, frames_packed_u8):
        """u8 s2d-packed ``[S, 72, 128, 300]`` -> alpha ``[S, 288, 512]`` f32."""
        with torch.no_grad():
            return model(frames_packed_u8)["alpha"].to(torch.float32)

    frames = (np.random.default_rng(0).random((S_ENTRY, 720, 1280, 3)) * 255).astype(np.uint8)
    frames_packed = space_to_depth(torch.as_tensor(frames, device=dev), 10).contiguous()
    return forward, (model, frames_packed)


def _default_devices(n: int) -> list:
    from video_stream_segmenetation_tpu_torch.parallel.mesh import resolve_device

    resolve_device("cuda")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The multi-device paths over an ``n_devices``-shard mesh (module
    docstring), 2 streams a shard; asserts what the reference asserts (the
    state spans the shards, every group stepped) and returns a summary."""
    from video_stream_segmenetation_tpu_torch import parallel
    from video_stream_segmenetation_tpu_torch.models.blazeface import (
        FaceFinder,
        init_face_finder_params,
    )
    from video_stream_segmenetation_tpu_torch.models.facemesh import (
        LandmarkNet,
        init_landmark_net_params,
    )
    from video_stream_segmenetation_tpu_torch.models.modnet import (
        MatteNet,
        init_mattenet_params,
    )
    from video_stream_segmenetation_tpu_torch.runtime.config import (
        PipelineStatics,
        default_knobs,
    )
    from video_stream_segmenetation_tpu_torch.runtime.pipeline import (
        FaceModels,
        face_selections,
        make_step,
    )
    from video_stream_segmenetation_tpu_torch.runtime.presets import preset
    from video_stream_segmenetation_tpu_torch.runtime.scheduler import StreamScheduler
    from video_stream_segmenetation_tpu_torch.runtime.state import init_state
    from video_stream_segmenetation_tpu_torch.service.engine import Engine
    from video_stream_segmenetation_tpu_torch.train.step import (
        init_train_state,
        make_dp_train_step,
        make_optimizer,
    )

    devices = _default_devices(n_devices) if devices is None else list(devices)
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices (or repeats of one), got {len(devices)}")
    mesh = parallel.make_mesh(n_data=n_devices, devices=devices)
    dev = mesh.first
    s = 2 * n_devices  # 2 streams a shard
    mask_hw, frame_hw = (32, 64), (64, 128)
    gen = torch.Generator(device=dev).manual_seed(1)

    # ---- a data-parallel training step: replicated parameters, the batch
    # split over 'data', the whole batch's loss
    tree = init_mattenet_params(0, width=0.5)
    model = MatteNet(tree, device=dev, dtype=torch.float32)
    model.requires_grad_(True)
    tx = make_optimizer()
    tstate, _ = init_train_state(model, tx)
    train_step = make_dp_train_step(model, tx, mesh, s)
    frames = torch.rand((s, *mask_hw, 3), generator=gen, device=dev)
    alpha_gt = (torch.rand((s, *mask_hw), generator=gen, device=dev) > 0.5).to(torch.float32)
    tstate, metrics = train_step(tstate, frames, alpha_gt)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss

    # ---- a sharded serving step: the stream axis over 'data', the models
    # replicated, the face path's selection over the whole batch
    statics = PipelineStatics(frame_hw=frame_hw, mask_hw=mask_hw, fd_size=64, lmk_size=48,
                              background="color")
    face_tree, lmk_tree = init_face_finder_params(1), init_landmark_net_params(2)
    steps = {}
    for d in parallel.replicated(mesh):
        faces = FaceModels(FaceFinder(face_tree, 64, device=d), LandmarkNet(lmk_tree, device=d))
        steps[d] = make_step(MatteNet(tree, device=d), statics, faces)
    step = parallel.sharded_step(mesh, lambda d: steps[d])
    frames_u8 = (torch.rand((s, *frame_hw, 3), generator=gen, device=dev) * 255).to(torch.uint8)
    shards = parallel.shard_stream_tree(mesh, {
        "state": init_state(s, mask_hw, device=dev), "frames": frames_u8,
        "bg": torch.zeros((s, *frame_hw, 3), dtype=torch.uint8, device=dev),
        "knobs": default_knobs(s, device=dev), "gate": torch.ones((s,), dtype=torch.bool,
                                                                  device=dev)})
    sels = face_selections(statics, [t["state"].frame_idx for t in shards],
                           [t["gate"] for t in shards], s)
    outs = step([(t["state"], t["frames"], t["bg"], t["knobs"], t["gate"]) for t in shards],
                [{} if sel is None else {"face_sel": sel} for sel in sels])
    frame_out = parallel.gather_rows([o["frame"] for _, o in outs], dev)
    assert tuple(frame_out.shape) == (s, *frame_hw, 3), frame_out.shape

    # ---- the fast serving stack through Engine(mesh=...): process and
    # dispatch/collect (fast_int8_pico at the reference's tiny geometry)
    s2d = dataclasses.replace(preset("fast_int8_pico"), frame_hw=(80, 160), mask_hw=(32, 64),
                              fd_size=64, lmk_size=48, s2d_block=10, background="color")

    def spans(eng) -> int:
        return len({st.prev_alpha.device for st in eng._states}), len(eng._states)

    eng = Engine(s, s2d, mesh=mesh)
    for _ in range(s):
        eng.admit()
    assert len(eng._states) == n_devices
    frames_nat = (np.random.default_rng(2).random((s, 80, 160, 3)) * 255).astype(np.uint8)
    fout = eng.process(frames_nat)
    fout2 = eng.collect(eng.dispatch(frames_nat))
    assert fout2["frame"].shape[0] == s and not fout2["passthrough"]

    # ---- the production rotation over the mesh: groups that do not align
    # with the shards (StreamScheduler -> Engine.dispatch_range)
    group_sizes = [s - s // 3, s // 3]
    eng2 = Engine(s, s2d, mesh=mesh)
    sch = StreamScheduler(eng2, use_native_pool=False, group_sizes=group_sizes,
                          frame_source=lambda i0, i1: frames_nat[i0:i1])
    sch.admit_all()
    for _ in range(2 * len(group_sizes)):
        sch.step_pipelined()
    sch.drain()
    fi = eng2.state.frame_idx.cpu().numpy()
    assert fi.min() >= 2, f"the rotation did not step every group: {fi}"
    assert len(eng2._states) == n_devices

    # ---- the fused-round mode over the mesh (Engine.dispatch_round)
    eng3 = Engine(s, s2d, mesh=mesh)
    sch3 = StreamScheduler(eng3, use_native_pool=False, group_sizes=group_sizes,
                           frame_source=lambda i0, i1: frames_nat[i0:i1], fused_rounds=True)
    sch3.admit_all()
    round_outs = []
    for _ in range(3):
        r = sch3.step_round()
        if r is not None:
            round_outs.extend(r)
    tail = sch3.drain()
    if tail is not None:
        round_outs.extend(tail)
    fi3 = eng3.state.frame_idx.cpu().numpy()
    assert fi3.min() >= 3, f"the fused round did not step every group: {fi3}"
    assert len(round_outs) == 3 * len(group_sizes)
    assert not any(r["passthrough"] for r in round_outs)
    sch.stop()
    sch3.stop()
    summary = {"shards": n_devices, "devices": [str(d) for d in parallel.replicated(mesh)],
               "train_loss": loss, "serving_frame": tuple(frame_out.shape),
               "engine_frame": tuple(fout["frame"].shape), "engine_spans": spans(eng),
               "rotation": group_sizes, "rotation_frame_idx": fi.tolist(),
               "fused_rounds": len(round_outs), "fused_frame_idx": fi3.tolist()}
    print(f"dryrun_multichip ok: {n_devices} shards on {summary['devices']}, train loss "
          f"{loss:.4f}, serving step out {summary['serving_frame']}, fast_int8_pico "
          f"Engine(mesh) out {summary['engine_frame']} over {summary['engine_spans'][1]} "
          f"shards, the rotation {group_sizes} (dispatch_range) and the fused rounds "
          f"(dispatch_round) over the sharded state")
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8, help="data shards (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the visible cards, repeated) or 'cpu' (n CPU shards)")
    args = ap.parse_args(argv)
    devices = None if args.device == "cuda" else [torch.device(args.device)] * args.n
    dryrun_multichip(args.n, devices)


if __name__ == "__main__":
    main()
