"""The per-group rotation (StreamScheduler.step_pipelined ->
``Engine.dispatch_range``) over ``Engine(mesh=...)`` on 8 CPU shards
against the reference's mesh engine on its 8 virtual devices: groups
[11, 5], which do not align with the shards, 3 rounds, the face path on
(bars as tests/test_torch_mesh_rotation.py's docstring; the port's
one-device comparison of this rotation is there too)."""

from tests.torch_mesh_engines import CPU8, check_against_reference, port_engine, rotate
from tests.torch_threads import one_torch_thread  # noqa: F401
from video_stream_segmenetation_tpu_torch import parallel


def test_pipelined_rotation_matches_the_reference_mesh_engine():
    eng = port_engine(parallel.make_mesh(8, devices=CPU8))
    got = rotate(eng, fused=False)
    assert len(eng._states) == 8
    check_against_reference(eng, got, fused=False)
