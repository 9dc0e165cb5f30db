"""Runtime: per-stream state, live knobs, presets and the pipeline step."""
