"""On the card: ``fit(mesh=..., loss_fn=...)`` over 4 virtual shards of it
against one device, with losses.make_pipeline_loss and the SaliencyNet's
U2 loss, and one step of the photo-background trainers' losses
(train/realbg.py) on the card against the CPU port, at a small geometry on
photos the test writes.  Marked ``gpu``: without a card each test skips.
The card's machine has no JAX, so this file imports none; run it there
with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_realbg_gpu.py -q

Bars: one step's loss within 1e-6 relative and its summed gradients' least
leaf cosine chip_smoke.py's MESH_GRAD_COS against one device; fit's losses
within chip_smoke.py's MESH_LOSS_RTOL; the card's f32 step against the
CPU's by chip_smoke.py's STEP_F32_LOSS_TOL and STEP_F32_GRAD_TOL (cuDNN's
f32 algorithms sum in other orders, TF32 off).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from video_stream_segmenetation_tpu_torch import parallel
from video_stream_segmenetation_tpu_torch.models.mattenet_hd import MatteNetHD
from video_stream_segmenetation_tpu_torch.models.u2net import SaliencyNet
from video_stream_segmenetation_tpu_torch.runtime.precision import pinned
from video_stream_segmenetation_tpu_torch.train import realbg as RB
from video_stream_segmenetation_tpu_torch.train import realdata as R
from video_stream_segmenetation_tpu_torch.train.loop import fit
from video_stream_segmenetation_tpu_torch.train.losses import make_pipeline_loss

N, HW, B = 4, (80, 160), 8
# the mesh's gradients at chip_smoke.py's geometry: at 2 rows a shard cuDNN
# takes other algorithms for the SaliencyNet's convs than at 8, and a
# BatchNorm variance leaf of it departs by a cosine of 1 - 2.2e-7 (one
# device's repeat: 1 - 4e-14); at 8 rows a shard 1 - 1.1e-12
MESH_HW, MESH_B = (240, 320), 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("loss", ["pipeline", "u2"])
def test_a_loss_fn_over_the_mesh_matches_one_device_on_the_card(card, loss):
    import chip_smoke

    mesh = parallel.make_mesh(N, devices=[card] * N)
    gap = chip_smoke.dp_grad_gap(mesh, card, MESH_HW, MESH_B, loss=loss)
    assert gap["loss_rel"] <= 1e-6 and gap["min_cos"] >= chip_smoke.MESH_GRAD_COS, gap
    runs = {}
    for name, m in (("one", None), ("mesh", mesh)):
        model = MatteNetHD(10, 4, "pico", dtype=torch.float32, device=card)
        runs[name] = fit(model, hw=HW, batch=B, steps=2, lr=1.5e-4, log_every=1, mesh=m,
                         loss_fn=make_pipeline_loss(model))[1]
    for a, b in zip(runs["mesh"], runs["one"]):
        assert abs(a["loss"] - b["loss"]) <= chip_smoke.MESH_LOSS_RTOL * abs(b["loss"])


@pytest.mark.gpu
def test_a_realbg_step_matches_the_cpu_port(card, tmp_path):
    import chip_smoke

    g = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(g.integers(0, 256, (90, 160, 3), dtype=np.uint8)).save(
            tmp_path / f"p{i}.png")
    bank = torch.as_tensor(R.load_background_bank((40, 64), tmp_path, as_uint8=True))
    frames, gt = RB.mixed_data_fn(bank, RB.THREE_WAY, (40, 64))(
        torch.Generator().manual_seed(1), 4, (32, 32))
    tree = RB.warm_tree("u2net")
    side = {}
    for d in ("cpu", card):
        m = SaliencyNet(tree, device=d, dtype=torch.float32)
        m.requires_grad_(True)
        with pinned():
            loss, _ = RB.u2_loss_fn(m)(frames.to(d), gt.to(d))
            grads = torch.autograd.grad(loss, list(m.parameters()))
        side[str(d)] = loss.item(), [t.double().cpu().flatten() for t in grads]
    (lc, gc), (lg, gg) = side["cpu"], side[str(card)]
    assert abs(lg - lc) <= chip_smoke.STEP_F32_LOSS_TOL * abs(lc), (lg, lc)
    for a, b in zip(gg, gc):
        assert float((a - b).norm()) <= chip_smoke.STEP_F32_GRAD_TOL * max(float(b.norm()), 1e-30)
