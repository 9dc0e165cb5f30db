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
    # multi-class mode: the smoothed class maps [S, h, w, K] f32 (an empty
    # [S, 0] tensor with one class; the single-class step never reads it)
    rec: torch.Tensor | None = None

    @property
    def num_streams(self) -> int:
        return self.prev_alpha.shape[0]


def init_state(num_streams: int, mask_hw: tuple[int, int], device="cpu",
               num_classes: int = 1) -> StreamState:
    h, w = mask_hw
    s = num_streams
    rec_shape = (s, h, w, num_classes) if num_classes > 1 else (s, 0)
    return StreamState(
        prev_alpha=torch.zeros((s, h, w), dtype=torch.float32, device=device),
        affine=torch.tensor(IDENTITY_AFFINE, dtype=torch.float32, device=device)
        .repeat(s, 1),
        has_affine=torch.zeros((s,), dtype=torch.bool, device=device),
        initialized=torch.zeros((s,), dtype=torch.bool, device=device),
        frame_idx=torch.zeros((s,), dtype=torch.int32, device=device),
        rec=torch.zeros(rec_shape, dtype=torch.float32, device=device),
    )


def reset_streams(state: StreamState, mask: torch.Tensor) -> None:
    """Cold-start, in place, the streams where ``mask`` [S] is True."""
    state.prev_alpha[mask] = 0.0
    state.affine[mask] = torch.tensor(
        IDENTITY_AFFINE, dtype=torch.float32, device=state.affine.device
    )
    state.has_affine[mask] = False
    state.initialized[mask] = False
    state.frame_idx[mask] = 0
    if state.rec is not None:
        state.rec[mask] = 0.0


def reset_stream(state: StreamState, s: int) -> None:
    """Reset a single stream slot by index."""
    mask = torch.zeros((state.num_streams,), dtype=torch.bool,
                       device=state.prev_alpha.device)
    mask[s] = True
    reset_streams(state, mask)
