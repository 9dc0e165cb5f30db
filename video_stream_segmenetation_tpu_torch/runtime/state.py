"""Per-stream runtime state as ``[S, ...]`` tensors on the engine's device
(port of ``runtime/state.py``).  Admission and eviction reset rows."""

from __future__ import annotations

import dataclasses

import torch

IDENTITY_AFFINE = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


@dataclasses.dataclass
class StreamState:
    prev_alpha: torch.Tensor  # [S, h, w] f32 EMA accumulator (mask res)
    affine: torch.Tensor  # [S, 6] f32 last merged affine (mask space)
    has_affine: torch.Tensor  # [S] bool
    initialized: torch.Tensor  # [S] bool
    frame_idx: torch.Tensor  # [S] int32
    # the model's per-stream state, a tuple of [S, ...] f32 tensors: the
    # RecurrentMatteNet's ConvGRU state (r1, r2, r3, r4; models/rvm.py), the
    # multi-class smoothed class maps ([S, h, w, K],), or () when unused
    rec: tuple = ()
    # translation tracking (prevFaceCenter, frameProcessor.ts:46): the
    # mask-space face centre [S, 2] f32 and its validity [S] bool
    face_center: torch.Tensor | None = None
    has_center: torch.Tensor | None = None

    @property
    def num_streams(self) -> int:
        return self.prev_alpha.shape[0]


def init_state(num_streams: int, mask_hw: tuple[int, int], device="cpu",
               rec: tuple = ()) -> StreamState:
    """Cold state; ``rec`` the model's zero state (moved to ``device``)."""
    h, w = mask_hw
    s = num_streams
    return StreamState(
        prev_alpha=torch.zeros((s, h, w), dtype=torch.float32, device=device),
        affine=torch.tensor(IDENTITY_AFFINE, dtype=torch.float32, device=device)
        .repeat(s, 1),
        has_affine=torch.zeros((s,), dtype=torch.bool, device=device),
        initialized=torch.zeros((s,), dtype=torch.bool, device=device),
        frame_idx=torch.zeros((s,), dtype=torch.int32, device=device),
        rec=tuple(t.to(device) for t in rec),
        face_center=torch.zeros((s, 2), dtype=torch.float32, device=device),
        has_center=torch.zeros((s,), dtype=torch.bool, device=device),
    )


def map_state(fn, state: StreamState, *others: StreamState) -> StreamState:
    """A StreamState of ``fn(t, *the others' t)`` over every tensor of
    ``state`` (the tuple ``rec`` element by element)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        ov = [getattr(o, f.name) for o in others]
        if isinstance(v, tuple):
            out[f.name] = tuple(fn(t, *(o[i] for o in ov)) for i, t in enumerate(v))
        elif v is None:
            out[f.name] = None
        else:
            out[f.name] = fn(v, *ov)
    return StreamState(**out)


def state_tensors(state: StreamState) -> list[torch.Tensor]:
    """Every tensor of ``state``, ``rec``'s included, in field order."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out.extend(v if isinstance(v, tuple) else () if v is None else (v,))
    return out


def reset_streams(state: StreamState, mask: torch.Tensor) -> None:
    """Cold-start, in place, the streams where ``mask`` [S] is True;
    recurrent state and class maps zero-fill (the documented RVM cold
    start, frameProcessorRVM.ts:48-53)."""
    state.prev_alpha[mask] = 0.0
    state.affine[mask] = torch.tensor(
        IDENTITY_AFFINE, dtype=torch.float32, device=state.affine.device
    )
    state.has_affine[mask] = False
    state.initialized[mask] = False
    state.frame_idx[mask] = 0
    if state.face_center is not None:
        state.face_center[mask] = 0.0
        state.has_center[mask] = False
    for t in state.rec:
        t[mask] = 0.0


def reset_stream(state: StreamState, s: int) -> None:
    """Reset a single stream slot by index."""
    mask = torch.zeros((state.num_streams,), dtype=torch.bool,
                       device=state.prev_alpha.device)
    mask[s] = True
    reset_streams(state, mask)
