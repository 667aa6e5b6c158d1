"""The reference against the port on the CPU at 64x64 (both in float32,
TF32 irrelevant there): one score window's records and one training
step's losses and gradients, from one state dict."""

import pytest
import torch

from benchmark import seeding
from benchmark.counts import model as model_counts
from benchmark.reference import model as ref
from benchmark.reference import score as ref_score
from benchmark.reference import train as ref_train

NET = {"net_tag": "unet_vq_twostream", "in_channel": [12, 6],
       "out_channel": [3, 2], "embed_dim": 64, "n_embed": 32, "k": 2}


def _port_generator(per_sample):
    from ammcnet_aaai2021_torch.configs import NetConfig
    from ammcnet_aaai2021_torch.models import build_generator

    return build_generator(NetConfig(n_embed=NET["n_embed"],
                                     dtype="float32"),
                           per_sample_diff=per_sample)


def test_score_window_records_agree():
    from ammcnet_aaai2021_torch.eval.infer import _make_score_batch

    state = seeding.make_state(model_counts.build_generator(NET, True), 3,
                               "generator", "cpu")
    port = seeding.load_state(_port_generator(True), state).eval()
    mine = seeding.load_state(
        model_counts.build_generator(NET, True, device="cpu"), state).eval()
    g = torch.Generator().manual_seed(0)
    video = torch.randint(0, 256, (12, 64, 64, 3), generator=g,
                          dtype=torch.uint8)
    flows = torch.randn(11, 64, 64, 2, generator=g) * 0.02
    starts = torch.arange(8)
    with torch.no_grad():
        want = _make_score_batch(port, 5, 4, 3, 2, "psnr", None, False)(
            video, flows, starts)
        got = ref_score.records(mine, video, flows, 8)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_train_step_agrees():
    from ammcnet_aaai2021_torch.configs import LossConfig
    from ammcnet_aaai2021_torch.models.discriminator import PixelDiscriminator
    from ammcnet_aaai2021_torch.models.flownet_sd import FlowNet2SD
    from ammcnet_aaai2021_torch.train.optim import make_optimizers
    from ammcnet_aaai2021_torch.configs import OptimConfig
    from ammcnet_aaai2021_torch.train.state import TrainState
    from ammcnet_aaai2021_torch.train.steps import make_twostream_train_step

    with torch.device("meta"):
        d_meta, f_meta = ref.PixelDiscriminator(), ref.FlowNet2SD()
    states = {"g": seeding.make_state(model_counts.build_generator(NET, False),
                                      4, "generator", "cpu"),
              "d": seeding.make_state(d_meta, 4, "discriminator", "cpu"),
              "f": seeding.make_state(f_meta, 4, "flownet", "cpu")}
    split = seeding.TrainSplit([9, 10], 64, 4, "cpu")
    batch = split.gather(split.draw(seeding.numpy_rng(4, "order"), 2, set()))

    gen = seeding.load_state(_port_generator(False), states["g"]).train()
    disc = seeding.load_state(PixelDiscriminator(dtype=torch.float32),
                              states["d"]).train()
    flow = seeding.load_state(FlowNet2SD(dtype=torch.float32), states["f"])
    flow.eval().requires_grad_(False)
    state = TrainState(0, gen, disc, *make_optimizers(OptimConfig(), gen,
                                                      disc))
    metrics = make_twostream_train_step(LossConfig())(state, batch, flow)
    port_grads = [p.grad for p in gen.parameters()]

    r_gen = seeding.load_state(model_counts.build_generator(
        NET, False, device="cpu"), states["g"])
    r_disc = seeding.load_state(ref.PixelDiscriminator(), states["d"])
    r_flow = seeding.load_state(ref.FlowNet2SD(), states["f"]).eval()
    g_opt = ref_train.make_adam(r_gen.parameters(), 2e-4)
    d_opt = ref_train.make_adam(r_disc.parameters(), 2e-5)
    g_loss, d_loss, g_grads, _ = ref_train.train_step(
        r_gen, r_disc, r_flow, g_opt, d_opt, batch)
    assert float(g_loss) == pytest.approx(float(metrics["g_loss"]), rel=1e-5)
    assert float(d_loss) == pytest.approx(float(metrics["d_loss"]), rel=1e-5)
    for mine, theirs in zip(g_grads, port_grads):
        torch.testing.assert_close(mine, theirs, rtol=2e-3, atol=1e-6)
    for (name, p), (_, q) in zip(r_gen.state_dict().items(),
                                 gen.state_dict().items()):
        torch.testing.assert_close(p.float(), q.float(), rtol=1e-4,
                                   atol=1e-5, msg=name)
