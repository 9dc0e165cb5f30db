"""Utilities (ports of ``utils/*``): checkpointing, timing and tracing, the
synthetic clips and their quality metrics, weight quantization."""

from video_stream_segmenetation_tpu_torch.utils.checkpoint import (  # noqa: F401
    face_checkpoint_paths,
    restore_engine,
    restore_params,
    save_engine,
    save_params,
)
from video_stream_segmenetation_tpu_torch.utils.profiling import (  # noqa: F401
    device_timer,
    time_fn,
    trace,
)
from video_stream_segmenetation_tpu_torch.utils.clips import (  # noqa: F401
    SyntheticClip,
    articulated_clip,
    load_reference_masks,
    mask_iou,
    parity_report,
    run_clip_through_engine,
    synthetic_clip,
    temporal_stability,
)
from video_stream_segmenetation_tpu_torch.utils.quantize import (  # noqa: F401
    dequantize_tree,
    quantization_error,
    quantize_tree,
    stochastic_round_bf16,
)
