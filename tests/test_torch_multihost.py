"""PyTorch port: the multi-process slice on ``torch.distributed`` (gloo, CPU).

* the record-shard helpers of ``parallel/multihost.py``, one for one with
  ``tests/test_multihost_eval.py::TestRecordShardMerge``, and
  ``parallel/mesh.py:shard_batch``;
* one launch of two gloo ranks (``tests/torch_dp_worker.py``, a file
  ``init_method``, every worker reaped by PID) feeds the rest:
  - the EMA: ``quantize_topk(train=True, group=...)`` on each rank's half
    of a global latent, through B2's wrapper and the plain lookup, against
    the JAX ``quantize_topk`` on the whole (the tolerances of
    ``tests/test_memory_op.py:185-245``: the same float32 values summed in
    another order);
  - BatchNorm: the group ``BatchNorm2d`` against one single-process
    ``BatchNorm2d`` on the global batch: output, input gradient, affine
    gradients (summed over the ranks: each rank's loss is its shard's sum)
    and running statistics, 1e-5 (float32 sums in another order);
  - the step: 2 ranks of one sample each against a single-process port run
    on the global batch of 2, float32, 64x64, K = 2 steps.  Step 1: losses
    1e-5 relative, gradients 2e-2 per tensor and 5e-3 over the generator
    relative to their norms (``tests/test_torch_train.py``'s bounds: the
    BatchNorm backward loses digits level by level, and the ranks sum its
    statistics in another order), BatchNorm statistics and codebooks 1e-5.
    Step 2 runs from parameters that Adam's first, sign-like update
    (about ``lr * sign(g)``) moved by up to ``2 * lr`` wherever rounding
    decides the sign of a near-zero gradient (about 0.2 % of them here):
    losses within 5e-4 relative (JAX's two-process test,
    ``tests/test_multihost_train.py``), every parameter within Adam's
    ``2 * K * lr``, BatchNorm statistics within 1e-2 of their scale, the
    codebooks' top-1 histograms equal and each codeword within 1e-2 of its
    RMS (a codeword with few rows follows the mean of its latents, which
    move as the BatchNorm statistics do).  The
    ranks' replicas stay bitwise equal, and the remat step under the group
    is the plain one's;
  - scoring: ``run_test --device cpu`` on 2 ranks gives rank 0 a pickle
    bitwise the single-process one (each video is scored by the same
    forwards, whichever rank takes it), rank 1 ``{"fps", "rank"}``, and
    the run's shard directory is consumed.
"""

import copy
import json
import os
import pickle
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ammcnet_aaai2021_tpu.ops import memory as jmemory
from ammcnet_aaai2021_torch.configs import LossConfig, NetConfig, OptimConfig
from ammcnet_aaai2021_torch.models import (BatchNorm2d, build_model,
                                           init_flownet_weights)
from ammcnet_aaai2021_torch.parallel import mesh, multihost
from ammcnet_aaai2021_torch.runners import run_test
from ammcnet_aaai2021_torch.train.state import create_train_state
from ammcnet_aaai2021_torch.train.steps import make_twostream_train_step
from torch_dp_worker import launch, run_steps

torch.set_num_threads(2)

SIZE, N_EMBED, DIM, K = 64, 32, 16, 2
STEPS = 2
RECORD_KEYS = ("rgb_img_pred_records", "rgb_fea_comm_records",
               "op_img_pred_records", "op_fea_comm_records")


def _rel(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


# ---------------------------------------------------------------------------
# the helpers (tests/test_multihost_eval.py:134-260)


def test_roundtrip_and_order(tmp_path, rng, monkeypatch):
    names = ["01", "02", "03"]
    keys = ["rgb_img_pred_records", "rgb_fea_comm_records"]
    full = {k: [rng.random(5 + i) for i in range(3)] for k in keys}
    # two ranks: rank 0 gets videos 0 and 2, rank 1 video 1 (round robin)
    shard_dir = str(tmp_path)
    multihost.write_record_shard(
        shard_dir, {k: [full[k][0], full[k][2]] for k in keys}, ["01", "03"])
    monkeypatch.setattr(multihost, "process_index", lambda group=None: 1)
    multihost.write_record_shard(shard_dir, {k: [full[k][1]] for k in keys},
                                 ["02"])
    merged = multihost.merge_record_shards(shard_dir, names, n_shards=2)
    for k in keys:
        for a, b in zip(merged[k], full[k]):
            np.testing.assert_array_equal(a, b)


def test_missing_video_raises(tmp_path, rng):
    multihost.write_record_shard(
        str(tmp_path), {"rgb_img_pred_records": [rng.random(4)]}, ["01"])
    with pytest.raises(RuntimeError, match="missing videos"):
        multihost.merge_record_shards(str(tmp_path), ["01", "02"])


def test_stale_higher_rank_shard_ignored(tmp_path, rng, monkeypatch):
    keys = ["rgb_img_pred_records"]
    stale = {k: [rng.random(5)] for k in keys}
    monkeypatch.setattr(multihost, "process_index", lambda group=None: 1)
    multihost.write_record_shard(str(tmp_path), stale, ["01"])
    monkeypatch.setattr(multihost, "process_index", lambda group=None: 0)
    fresh = {k: [rng.random(5)] for k in keys}
    multihost.write_record_shard(str(tmp_path), fresh, ["01"])
    merged = multihost.merge_record_shards(str(tmp_path), ["01"], n_shards=1)
    np.testing.assert_array_equal(merged[keys[0]][0], fresh[keys[0]][0])


def test_wait_for_shards_sees_late_file(tmp_path):
    path = tmp_path / "records_00000.pkl"

    def write_late():
        time.sleep(0.2)
        path.write_bytes(b"x")

    t = threading.Thread(target=write_late)
    t.start()
    multihost.wait_for_shards(str(tmp_path), n_shards=1, timeout_s=10,
                              poll_s=0.05)
    t.join(timeout=10)
    assert not t.is_alive()


def test_wait_for_shards_timeout_names_missing_ranks(tmp_path):
    with pytest.raises(TimeoutError, match=r"\[0, 1\]"):
        multihost.wait_for_shards(str(tmp_path), n_shards=2, timeout_s=0.2,
                                  poll_s=0.05)


def test_consume_shard_dir_renames_then_removes(tmp_path):
    d = tmp_path / "run_abc"
    d.mkdir()
    (d / "records_00000.pkl").write_bytes(b"x")
    multihost.consume_shard_dir(str(d))
    assert not d.exists()
    assert not (tmp_path / "run_abc.consumed").exists()


def test_wait_for_merge_returns_once_consumed(tmp_path):
    d = tmp_path / "run_def"
    d.mkdir()

    def consume_late():
        time.sleep(0.2)
        multihost.consume_shard_dir(str(d))

    t = threading.Thread(target=consume_late)
    t.start()
    multihost.wait_for_merge(str(d), timeout_s=10, poll_s=0.05)
    t.join(timeout=10)
    assert not t.is_alive() and not d.exists()


def test_wait_for_merge_timeout_warns_not_hangs(tmp_path):
    d = tmp_path / "run_ghi"
    d.mkdir()
    with pytest.warns(RuntimeWarning, match="did not consume"):
        multihost.wait_for_merge(str(d), timeout_s=0.2, poll_s=0.05)


def test_run_token_single_process_is_fresh_hex():
    a, b = multihost.agree_on_run_token(), multihost.agree_on_run_token()
    assert a != b and len(a) == 32
    int(a, 16)  # valid hex


def test_warm_collectives_single_process_noop():
    # no process group: nothing to align, and nothing is started
    multihost.warm_collectives()
    assert not torch.distributed.is_initialized()


def test_single_process_helpers_are_the_identity():
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)
    assert multihost.host_shard(["a", "b", "c"]) == ["a", "b", "c"]
    assert multihost.host_seed(7) == 7
    batch = {"rgb": np.zeros((3, 2), np.uint8), "op": torch.ones(3, 4)}
    got = multihost.make_global_batch(batch, "cpu")
    assert torch.equal(got["op"], batch["op"]) and got["rgb"].shape == (3, 2)
    with pytest.raises(ValueError, match="leading sizes"):
        multihost.make_global_batch({"rgb": torch.zeros(2), "op": torch.zeros(3)},
                                    "cpu")
    lin = torch.nn.Linear(2, 2)
    assert mesh.replicate(lin) is lin


def test_shard_batch_takes_contiguous_equal_blocks():
    batch = {"rgb": torch.arange(8).reshape(4, 2), "op": np.arange(4)}
    got = mesh.shard_batch(batch, 1, 2)
    assert torch.equal(got["rgb"], torch.tensor([[4, 5], [6, 7]]))
    np.testing.assert_array_equal(got["op"], [2, 3])
    with pytest.raises(ValueError, match="equal rank shards"):
        mesh.shard_batch(batch, 0, 3)


# ---------------------------------------------------------------------------
# two gloo ranks


def _train_setup():
    model = build_model(NetConfig(dtype="float32", n_embed=N_EMBED), "training")
    state = create_train_state(model.generator, model.discriminator,
                               OptimConfig(), 3)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():  # BN statistics and affine away from the init
        for m in state.generator.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.8, 1.2, generator=g)
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.uniform_(-0.1, 0.1, generator=g)
    flownet = init_flownet_weights(model.flow_network,
                                   torch.Generator().manual_seed(7)).eval()
    return state, flownet


def _score_tree(root):
    """3 videos x 10 frames of 64x64 .npy frames and flows (an uneven deal
    over 2 ranks), with toydata.json labels."""
    g = np.random.default_rng(12)
    labels = {}
    for vi, name in enumerate(("01", "02", "03")):
        fdir = os.path.join(root, "toydata", "testing", "frames", name)
        odir = os.path.join(root, "toydata", "testing", "flows", name)
        os.makedirs(fdir)
        os.makedirs(odir)
        for t in range(10):
            np.save(os.path.join(fdir, f"{t:03d}.npy"),
                    g.integers(0, 255, (SIZE, SIZE, 3), np.uint8))
            if t < 9:
                np.save(os.path.join(odir, f"{t:03d}.npy"),
                        g.normal(0, 2, (SIZE, SIZE, 2)).astype(np.float32))
        labels[name] = {"length": 10, "gt": [[2 + vi, 7]]}
    with open(os.path.join(root, "toydata", "toydata.json"), "w") as fh:
        json.dump(labels, fh)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every multi-process case in one launch of two ranks; returns
    (inputs, the ranks' outputs)."""
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.normal(size=(8, 4, 4, DIM)).astype(np.float32))
    embed = rng.normal(size=(DIM, N_EMBED)).astype(np.float32)
    codebook = (torch.from_numpy(embed),
                torch.from_numpy(rng.uniform(0, 3, N_EMBED).astype(np.float32)),
                torch.from_numpy(embed.copy()))
    x = torch.from_numpy((rng.normal(size=(4, 8, 6, 6)) * 2 + 0.5)
                         .astype(np.float32))
    bn = BatchNorm2d(8)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
        bn.running_mean.uniform_(-0.1, 0.1)
        bn.running_var.uniform_(0.8, 1.2)
    grad_out = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    state, flownet = _train_setup()
    batch = {"rgb": torch.from_numpy(
                 rng.integers(0, 256, (2, 5, SIZE, SIZE, 3), dtype=np.uint8)),
             "op": torch.from_numpy(rng.normal(0, 0.5, (2, 4, SIZE, SIZE, 2))
                                    .astype(np.float32))}
    train = {"task": "train", "n_embed": N_EMBED,
             "init": copy.deepcopy(state.generator.state_dict()),
             "disc": copy.deepcopy(state.discriminator.state_dict()),
             "flownet": flownet.state_dict(), "batch": batch,
             "steps": STEPS, "remat": False}
    root = str(tmp_path_factory.mktemp("mh_tree"))
    _score_tree(root)
    save = str(tmp_path_factory.mktemp("mh_save"))
    argv = ["--dataset_name", "toydata", "--data_dir", root,
            "--image_size", str(SIZE), "--device", "cpu"]
    specs = {"ema": {"task": "ema", "z": z, "codebook": codebook, "k": K},
             "bn": {"task": "bn", "x": x, "grad_out": grad_out,
                    "state": bn.state_dict()},
             "train": train, "remat": {**train, "remat": True},
             "score": {"task": "score", "argv": argv + ["--save_dir", save]},
             "replicate": {"task": "replicate"}, "uneven": {"task": "uneven"}}
    outs = launch(str(tmp_path_factory.mktemp("mh_work")), specs)
    inputs = {"z": z, "codebook": codebook, "x": x, "bn": bn,
              "grad_out": grad_out, "state": state, "flownet": flownet,
              "batch": batch, "root": root, "argv": argv, "save": save}
    return inputs, outs


@pytest.mark.parametrize("use_kernel", [True, False])
def test_two_rank_ema_equals_the_jax_lookup_on_the_whole(two_ranks,
                                                         use_kernel):
    inputs, outs = two_ranks
    cb = jmemory.Codebook(*(jnp.asarray(t.numpy()) for t in inputs["codebook"]))
    *_, want = jmemory.quantize_topk(jnp.asarray(inputs["z"].numpy()), cb, K,
                                     train=True)
    for out in outs:
        embed, cluster_size, embed_avg = out["ema"][use_kernel]
        np.testing.assert_allclose(cluster_size.numpy(),
                                   np.asarray(want.cluster_size),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(embed_avg.numpy(),
                                   np.asarray(want.embed_avg),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(embed.numpy(), np.asarray(want.embed),
                                   rtol=1e-4, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(outs[0]["ema"][use_kernel],
                                                 outs[1]["ema"][use_kernel]))


def test_group_batchnorm_is_the_global_batchs(two_ranks):
    inputs, outs = two_ranks
    ref = copy.deepcopy(inputs["bn"]).train()
    x = inputs["x"].clone().requires_grad_(True)
    y = ref(x)
    (y * inputs["grad_out"]).sum().backward()
    got = [o["bn"] for o in outs]
    torch.testing.assert_close(torch.cat([g["y"] for g in got]), y.detach(),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([g["x_grad"] for g in got]), x.grad,
                               rtol=1e-5, atol=1e-5)
    for name in ("weight_grad", "bias_grad"):
        torch.testing.assert_close(got[0][name] + got[1][name],
                                   getattr(ref, name[:-5]).grad,
                                   rtol=1e-5, atol=1e-5)
    for g in got:
        for key, val in ref.state_dict().items():
            torch.testing.assert_close(g["state"][key], val, rtol=1e-5,
                                       atol=1e-5)


@pytest.fixture(scope="module")
def single_process_steps(two_ranks):
    """The port's step on the global batch in this process, from the same
    state (``run_steps``' record)."""
    inputs, _ = two_ranks
    return run_steps(make_twostream_train_step(LossConfig()), inputs["state"],
                     inputs["batch"], inputs["flownet"], STEPS)


def test_two_rank_step_losses_equal_one_process(two_ranks,
                                                single_process_steps):
    _, outs = two_ranks
    want = single_process_steps["metrics"]
    got = outs[0]["train"]["metrics"]
    assert len(got) == STEPS and set(got[0]) == set(want[0])
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5, err_msg=k)
        for s in range(1, STEPS):
            np.testing.assert_allclose(got[s][k], want[s][k], rtol=5e-4,
                                       err_msg=f"step {s + 1} {k}")
    assert outs[1]["train"]["metrics"] == got  # the global metrics everywhere


def test_two_rank_first_step_equals_one_process(two_ranks,
                                                single_process_steps):
    """Step 1: the averaged gradients of G and D, BatchNorm statistics and
    codebooks; every rank holds the same."""
    _, outs = two_ranks
    want = single_process_steps["first"]
    got = outs[0]["train"]["first"]
    for model in ("g_grads", "d_grads"):
        for name, g in want[model].items():
            assert _rel(got[model][name], g) < 2e-2, name
            assert torch.equal(outs[1]["train"]["first"][model][name],
                               got[model][name]), name
    flat = lambda grads: torch.cat([g.ravel() for g in grads.values()])
    assert _rel(flat(got["g_grads"]), flat(want["g_grads"])) < 5e-3
    for key, val in want["state"].items():
        if key not in want["g_grads"]:
            torch.testing.assert_close(got["state"][key], val, rtol=1e-5,
                                       atol=1e-5, msg=key)


def test_two_rank_steps_state_equals_one_process(two_ranks,
                                                 single_process_steps):
    """After ``STEPS`` steps: parameters within Adam's ``2 * K * lr``,
    BatchNorm statistics and codewords within 1e-2 of their scale, equal
    top-1 histograms; the replicas bitwise equal."""
    _, outs = two_ranks
    want = single_process_steps["state"]
    got = outs[0]["train"]["state"]
    params = set(single_process_steps["first"]["g_grads"])
    bound = 2 * STEPS * OptimConfig().lr_g
    for key, val in want.items():
        assert torch.equal(outs[1]["train"]["state"][key], got[key]), key
        if key in params:
            assert float((got[key] - val).abs().max()) <= bound, key
        elif key.endswith("running_mean"):
            scale = want[key[:-4] + "var"].sqrt()
            assert bool(((got[key] - val).abs() <= 1e-2 * scale).all()), key
        elif key.endswith("running_var"):
            torch.testing.assert_close(got[key], val, rtol=1e-2, atol=0,
                                       msg=key)
        elif key.endswith(("cluster_size", "num_batches_tracked")):
            assert torch.equal(got[key], val), key
        else:
            assert key.endswith(("embed", "embed_avg")), key
            rms = val.square().mean(0, keepdim=True).sqrt()  # a codeword's
            assert bool(((got[key] - val).abs() <= 1e-2 * rms).all()), key


def test_two_rank_remat_step_is_the_plain_step(two_ranks):
    """``remat=True`` under a group reruns each BatchNorm's all-reduces in
    the backward pass, in the same order on every rank; the step is the
    plain one's (tests/test_torch_train.py's remat bounds)."""
    _, outs = two_ranks
    for out in outs:
        plain, remat = out["train"], out["remat"]
        for a, b in zip(plain["metrics"], remat["metrics"]):
            assert a["g_loss"] == pytest.approx(b["g_loss"], rel=1e-6)
        for key, val in plain["state"].items():
            if key in plain["first"]["g_grads"]:
                torch.testing.assert_close(remat["state"][key], val, rtol=0,
                                           atol=1e-6)
            else:
                assert torch.equal(remat["state"][key], val), key


def test_two_rank_scoring_merges_the_single_process_records(two_ranks,
                                                            tmp_path):
    inputs, outs = two_ranks
    single = run_test.main(inputs["argv"] + ["--save_dir", str(tmp_path)])
    with open(single["pickle"], "rb") as fh:
        want = pickle.load(fh)
    got_ret = outs[0]["score"]
    assert outs[1]["score"]["rank"] == 1 and set(outs[1]["score"]) == {
        "fps", "rank"}
    assert got_ret["auc"] == single["auc"]
    with open(got_ret["pickle"], "rb") as fh:
        got = pickle.load(fh)
    assert got["dataset"] == want["dataset"] == "toydata"
    for key in RECORD_KEYS:
        assert len(got[key]) == len(want[key]) == 3
        for g, w in zip(got[key], want[key]):
            assert g.dtype == w.dtype and np.array_equal(g, w), key
    shard_root = os.path.join(inputs["save"], "record_shards")
    assert os.listdir(shard_root) == []  # run_<token> consumed


def test_two_rank_helpers(two_ranks):
    """``replicate`` makes every rank hold rank 0's module, and
    ``make_global_batch`` refuses shards of unequal sizes on every rank."""
    _, outs = two_ranks
    for key, val in outs[0]["replicate"].items():
        assert torch.equal(outs[1]["replicate"][key], val)
    torch.manual_seed(0)
    assert torch.equal(outs[0]["replicate"]["weight"],
                       torch.nn.Linear(3, 2).weight.detach())
    for out in outs:
        assert "sizes [1, 2]" in out["uneven"]


def test_step_refuses_a_generator_off_its_group(two_ranks):
    inputs, _ = two_ranks
    step = make_twostream_train_step(LossConfig(), group=object())
    with pytest.raises(ValueError, match="process group"):
        step(inputs["state"], inputs["batch"], inputs["flownet"])
