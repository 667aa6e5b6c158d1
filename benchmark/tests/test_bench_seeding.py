"""What a run makes from its seed: the same seed gives the same data, every
seed gives the same sizes, scenes move, served weights are of their type,
and the check's sample has the longest video first."""

import numpy as np
import pytest
import torch

from benchmark import seeding
from benchmark.drivers import score


@pytest.mark.parametrize("channels", [1, 3])
def test_scene_frames_are_seeded_smooth_and_moving(channels):
    def draw(seed):
        return seeding.scene_frames(torch.Generator().manual_seed(seed), 6,
                                    48, channels, "cpu")

    a, b, c = draw(5), draw(5), draw(6)
    assert a.shape == (6, 48, 48, channels) and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)
    f = a.float()
    # smooth: neighbouring pixels differ far less than uniform noise (85)
    assert (f[:, 1:] - f[:, :-1]).abs().mean() < 10
    # moving: consecutive frames differ by more than the sensor noise
    assert (f[1:] - f[:-1]).abs().amax() > 20


def test_make_videos_same_sizes_for_every_seed():
    def shapes(seed, frames):
        vids = seeding.make_videos([7, 5], 32, 1, True, 4, seed, "cpu",
                                   pin=False, frames=frames)
        return [(v["rgb"].shape, v["op"].shape, v["true_frames"])
                for v in vids]

    for frames in seeding.FRAMES:
        assert shapes(1, frames) == shapes(2 ** 33 + 7, frames)
    with pytest.raises(ValueError, match="unknown frames"):
        shapes(1, "stripes")


def test_as_served_rounds_to_the_type():
    state = {"w": torch.randn(100)}
    served = seeding.as_served(state, "bfloat16")["w"]
    assert served.dtype == torch.float32
    assert torch.equal(served, served.to(torch.bfloat16).float())
    assert not torch.equal(served, state["w"])


def test_check_sample_starts_with_a_longest_video():
    videos = [{"true_frames": t} for t in (120, 180, 150, 180, 90)]
    for seed in range(20):
        ids = score.sample_ids(videos, seed, 3)
        assert len(set(ids)) == 3 and ids[0] in (1, 3)
    assert score.sample_ids(videos, 4, 3) == score.sample_ids(videos, 4, 3)
    assert np.all([0 <= i < 5 for i in ids])
