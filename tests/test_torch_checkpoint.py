"""PyTorch port: the JAX package's checkpoints, read without JAX
(``ammcnet_aaai2021_torch/tools/jax_checkpoint.py``).

The JAX package writes each checkpoint here (its ``save_msgpack``,
``save_checkpoint`` and a 2-step ``run_train``), and the port reads it:

* a ``.msgpack`` generator loads bitwise what the port's weight bridge
  makes of the same tree (``state_dict_from_jax``), bfloat16, npscalar and
  chunked leaves included; ``chip_smoke.py``'s writer gives flax's bytes;
* the port's ``run_test`` on an orbax step dir (raw variables, and the
  full train state through ``--exp_tag``) prints the JAX ``run_test``'s
  "the optimal auc =" line and its records within 1e-4 of their scale
  (bf16 convolutions of two frameworks on the CPU, as
  ``tests/test_torch_infer.py`` holds the two CLIs);
* the converted full train state resumes: one port step from it against
  one JAX step from the same orbax state, at the stage-2 step parity's
  tolerances (``tests/test_torch_train.py``: losses 1e-5 relative,
  BatchNorm statistics and codebooks 1e-5, gradients, and so Adam's new
  moments, 2e-2 per tensor relative to their norms); the moments and the
  step count carry across bitwise.

Shapes are small: 64x64 frames, 16 codewords.
"""

import copy
import importlib.util
import os
import pickle

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ammcnet_aaai2021_tpu.configs import LossConfig as JLossConfig
from ammcnet_aaai2021_tpu.configs import NetConfig as JNetConfig
from ammcnet_aaai2021_tpu.configs import OptimConfig as JOptimConfig
from ammcnet_aaai2021_tpu.models import PixelDiscriminator as JDisc
from ammcnet_aaai2021_tpu.models import build_generator as j_build_generator
from ammcnet_aaai2021_tpu.models.flownet_sd import FlowNet2SD as JFlowNet
from ammcnet_aaai2021_tpu.tools.torch_convert import convert_twostream
from ammcnet_aaai2021_tpu.train.checkpoint import restore_checkpoint as j_restore
from ammcnet_aaai2021_tpu.train.checkpoint import save_checkpoint as j_save
from ammcnet_aaai2021_tpu.train.checkpoint import save_msgpack
from ammcnet_aaai2021_tpu.train.optim import make_optimizers as j_make_optimizers
from ammcnet_aaai2021_tpu.train.state import AMMCTrainState
from ammcnet_aaai2021_tpu.train.steps import make_twostream_train_step as j_make_step
from ammcnet_aaai2021_torch.configs import LossConfig, NetConfig, OptimConfig
from ammcnet_aaai2021_torch.models import FlowNet2SD, build_model, init_weights
from ammcnet_aaai2021_torch.runners import run_test
from ammcnet_aaai2021_torch.tools import jax_checkpoint
from ammcnet_aaai2021_torch.tools.weights import (
    flownet_state_from_jax,
    load_generator_checkpoint,
    single_stream_state_from_jax,
    state_dict_from_jax,
)
from ammcnet_aaai2021_torch.train.checkpoint import restore_checkpoint
from ammcnet_aaai2021_torch.train.state import create_train_state
from ammcnet_aaai2021_torch.train.steps import make_twostream_train_step

torch.set_num_threads(2)

SIZE, N_EMBED = 64, 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD_KEYS = ("rgb_img_pred_records", "rgb_fea_comm_records",
               "op_img_pred_records", "op_fea_comm_records")


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def jax_variables():
    """The JAX package's two-stream and stage-1 generators, float32, 16
    codewords, initialized at 64x64 (numpy leaves)."""
    two = j_build_generator(JNetConfig(dtype="float32", n_embed=N_EMBED))
    v2 = two.init({"params": jax.random.PRNGKey(0)},
                  jnp.zeros((1, SIZE, SIZE, 12)), jnp.zeros((1, SIZE, SIZE, 6)),
                  True)
    one = j_build_generator(JNetConfig(dtype="float32", n_embed=N_EMBED,
                                       net_tag="unet_vq_topk_res",
                                       data_type="rgb"))
    v1 = one.init({"params": jax.random.PRNGKey(1)},
                  jnp.zeros((1, SIZE, SIZE, 12)), True)
    return {"two_stream": _numpy(v2), "single_stream": _numpy(v1)}


@pytest.mark.parametrize("kind", ["two_stream", "single_stream"])
def test_msgpack_generator_loads_bitwise(jax_variables, tmp_path, kind):
    variables = jax_variables[kind]
    path = str(tmp_path / f"{kind}.msgpack")
    save_msgpack(path, variables)
    want = (state_dict_from_jax if kind == "two_stream"
            else single_stream_state_from_jax)(variables)
    _assert_state_dicts_equal(load_generator_checkpoint(path), want)
    # the generator built from the shapes loads it strictly
    net = jax_checkpoint.net_config_of(variables)
    assert (net.net_tag, net.data_type, net.embed_dim, net.n_embed, net.k) == (
        ("unet_vq_twostream", "rgb_op") if kind == "two_stream"
        else ("unet_vq_topk_res", "rgb")) + (64, N_EMBED, 2)
    build_model(net).generator.load_state_dict(want)


def _edge_tree(case):
    rng = np.random.default_rng(5)
    if case == "bfloat16":
        x = rng.normal(size=(3, 5)).astype(np.float32)
        return {"a": {"w": jnp.asarray(x, jnp.bfloat16)}}, {
            "a": {"w": np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)}}
    if case == "npscalar":
        tree = {"s": np.float32(2.5), "i": np.int32(-7), "n": 300,
                "f": 0.125, "b": True, "z": None}
        return tree, tree
    if case == "chunked":
        x = rng.normal(size=(40, 7)).astype(np.float32)
        return {"big": x, "small": {"v": x[:2]}}, {"big": x,
                                                   "small": {"v": x[:2]}}
    return {"c": 1 + 2j}, None  # flax ext type 2, native_complex


@pytest.mark.parametrize("case", ["bfloat16", "npscalar", "chunked",
                                  "complex"])
def test_msgpack_edge_cases(tmp_path, monkeypatch, case):
    tree, want = _edge_tree(case)
    if case == "chunked":  # force flax to split the 1120-byte leaf
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    data = flax.serialization.to_bytes(tree)
    if case == "chunked":
        assert b"__msgpack_chunked_array__" in data
    path = str(tmp_path / "x.msgpack")
    with open(path, "wb") as fh:
        fh.write(data)
    if case == "complex":
        with pytest.raises(ValueError, match="complex"):
            jax_checkpoint.read_msgpack(path)
        return
    got = jax_checkpoint.read_msgpack(path)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path_, g), (_, w) in zip(flat_got, flat_want):
        assert np.asarray(g).dtype == np.asarray(w).dtype, path_
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    if case == "npscalar":
        assert got["s"].shape == () and got["z"] is None


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_writer_gives_flax_bytes(tmp_path):
    """``chip_smoke.flax_variables`` is the JAX converter's tree of a port
    state dict, ``msgpack_bytes`` of it is ``flax.serialization.to_bytes``,
    and the port reads it back bitwise; with tensorstore, its orbax writer
    gives a step dir the port reads back bitwise."""
    import tensorstore as ts

    smoke = _chip_smoke()
    gen = build_model(NetConfig(n_embed=N_EMBED)).generator
    sd = init_weights(gen, torch.Generator().manual_seed(2)).state_dict()
    variables = smoke.flax_variables(sd)
    jv = convert_twostream({k: v.numpy() for k, v in sd.items()})
    got_leaves = {jax.tree_util.keystr(p): leaf for p, leaf in
                  jax.tree_util.tree_leaves_with_path(variables)}
    want_leaves = {jax.tree_util.keystr(p): leaf for p, leaf in
                   jax.tree_util.tree_leaves_with_path(jv)}
    assert set(got_leaves) == set(want_leaves)
    for p, leaf in got_leaves.items():
        np.testing.assert_array_equal(leaf, np.asarray(want_leaves[p]),
                                      err_msg=p)
    data = smoke.msgpack_bytes(variables)
    assert data == flax.serialization.to_bytes(variables)
    path = str(tmp_path / "g.msgpack")
    with open(path, "wb") as fh:
        fh.write(data)
    want = {k: v for k, v in sd.items()}
    _assert_state_dicts_equal(load_generator_checkpoint(path), want)
    step_dir = str(tmp_path / "orbax" / "000000")
    smoke.write_orbax(step_dir, variables, ts)
    _assert_state_dicts_equal(load_generator_checkpoint(step_dir), want)


# ---------------------------------------------------------------------------
# orbax step dirs of the JAX package


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's toydata tree (2 training and 2 test videos of 12
    frames, 64x64); an orbax step dir of raw generator variables
    (``save_checkpoint``, the released widths); and a JAX ``run_train`` of 2
    steps (backend device, 16 codewords) whose step-2 dir holds the full
    train state."""
    from ammcnet_aaai2021_tpu.runners.run_train import main as j_train
    from ammcnet_aaai2021_tpu.tools.make_toydata import make_toydata

    root = str(tmp_path_factory.mktemp("jax_ckpt"))
    make_toydata(root, num_train_videos=2, num_test_videos=2,
                 frames_per_video=12, image_size=SIZE)
    gen = build_model(NetConfig()).generator
    sd = init_weights(gen, torch.Generator().manual_seed(4)).state_dict()
    raw = j_save(os.path.join(root, "raw_ckpt"), 0,
                 convert_twostream({k: v.numpy() for k, v in sd.items()}))
    registry = os.path.join(root, "runs", "registry.json")
    run_dir = j_train([
        "--dataset_name", "toydata", "--data_dir", root, "--image_size",
        str(SIZE), "--batch_size", "2", "--iterations", "2", "--n_embed",
        str(N_EMBED), "--backend", "device", "--step_log", "1",
        "--step_save", "2", "--save_dir", os.path.join(root, "runs"),
        "--registry", registry, "--exp_tag", "jax-run"])
    return {"root": root, "raw": raw, "raw_sd": sd, "registry": registry,
            "run_dir": run_dir,
            "step_dir": os.path.join(run_dir, "training", "checkpoints",
                                     "000002")}


def _result_line(out):
    return [line for line in out.splitlines()
            if line.startswith("the optimal") and "loss_file" not in line]


@pytest.mark.parametrize("kind", ["raw_variables", "train_state"])
def test_run_test_on_orbax_matches_the_jax_cli(jax_runs, tmp_path, capsys,
                                               kind):
    from ammcnet_aaai2021_tpu.runners import run_test as j_run_test

    base = ["--dataset_name", "toydata", "--data_dir", jax_runs["root"],
            "--image_size", str(SIZE)]
    if kind == "raw_variables":
        base += ["--ckptfile", jax_runs["raw"]]
        _assert_state_dicts_equal(load_generator_checkpoint(jax_runs["raw"]),
                                  jax_runs["raw_sd"])
    else:
        # the run's latest step dir, through the registry.  Two steps from
        # the init leave the commit distances equal across frames to 1e-5
        # of their size, under the 1e-4 at which the two frameworks' bf16
        # convolutions agree, so their per-video min-max ranks are rounding
        # noise: they are held as records, and the fused AUC takes the
        # frame PSNRs alone
        base += ["--exp_tag", "jax-run", "--registry", jax_runs["registry"],
                 "--lam_fea_comm", "0"]
        raw = j_restore(os.path.dirname(jax_runs["step_dir"]), step=2)
        _assert_state_dicts_equal(
            load_generator_checkpoint(jax_runs["step_dir"]),
            state_dict_from_jax(_numpy({"params": raw["g_params"],
                                        **raw["g_state"]})))
    results = []
    for name, main, extra in (("jax", j_run_test.main, []),
                              ("torch", run_test.main, ["--device", "cpu"])):
        res = main(base + ["--save_dir", str(tmp_path / name), *extra])
        with open(res["pickle"], "rb") as fh:
            results.append((_result_line(capsys.readouterr().out),
                            pickle.load(fh)))
    (jline, want), (tline, got) = results
    assert len(tline) == 1 and tline == jline
    for key in RECORD_KEYS:
        assert [len(r) for r in got[key]] == [12, 12]
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(w).max()),
                                       err_msg=key)


def test_orbax_without_tensorstore_raises_naming_the_converter(jax_runs,
                                                               monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore") as err:
        load_generator_checkpoint(jax_runs["step_dir"])
    assert "python -m ammcnet_aaai2021_torch.tools.jax_checkpoint" in str(err.value)


def test_fix_branches_optimizer_state_converts(jax_variables, tmp_path):
    """A ``--fix_branches`` run's generator optimizer (optax masked chains,
    the rgb and op moments masked out) converts to the port's bridge-only
    Adam, bitwise; restoring it into an optimizer over every branch
    raises, naming the flag."""
    variables = jax_variables["two_stream"]
    params = variables["params"]
    g_tx, d_tx = j_make_optimizers(JOptimConfig(), g_mask={
        "rgb": False, "op": False, "bridge": True})
    d_params = _numpy(JDisc(dtype=jnp.float32).init(
        {"params": jax.random.PRNGKey(3)}, jnp.zeros((1, SIZE, SIZE, 3)))[
        "params"])
    rng = np.random.default_rng(9)

    def noise(tree):
        return jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=np.shape(x)).astype(np.float32)), tree)

    g_state = g_tx.update(noise(params), g_tx.init(params), params)[1]
    d_state = d_tx.update(noise(d_params), d_tx.init(d_params), d_params)[1]
    step_dir = j_save(str(tmp_path / "jax"), 1, {
        "step": np.int32(1), "g_params": params,
        "g_state": {k: v for k, v in variables.items() if k != "params"},
        "g_opt_state": g_state, "d_params": d_params,
        "d_opt_state": d_state})
    out = str(tmp_path / "port")
    jax_checkpoint.main([step_dir, out])
    adam = g_state[0].inner_state[0]
    mu = state_dict_from_jax(_numpy({**variables, "params": {
        **params, "bridge": adam.mu["bridge"]}}))
    nets = []
    for mask in ({"rgb": False, "op": False, "bridge": True}, None):
        model = build_model(NetConfig(dtype="float32", n_embed=N_EMBED),
                            "training")
        nets.append(create_train_state(model.generator, model.discriminator,
                                       OptimConfig(), 5, g_mask=mask))
    restore_checkpoint(out, nets[0])
    names = [n for n, _ in nets[0].generator.named_parameters()
             if n.startswith("bridge.")]
    got = nets[0].g_opt.state_dict()["state"]
    assert sorted(got) == list(range(len(names)))
    for i, name in enumerate(names):
        assert torch.equal(got[i]["exp_avg"], mu[name]), name
        assert got[i]["step"].item() == 1.0
    with pytest.raises(ValueError, match="--fix_branches"):
        restore_checkpoint(os.path.dirname(step_dir), nets[1])


# ---------------------------------------------------------------------------
# a converted full train state resumes


@pytest.fixture(scope="module")
def resumed_pair(jax_runs, tmp_path_factory):
    """The JAX step-2 state converted by the CLI, restored into a float32
    port state; and one step of each package from the same orbax state on
    one batch (float32, its flow teacher converted from the JAX one)."""
    out = str(tmp_path_factory.mktemp("converted"))
    ckpt_dir = os.path.join(out, "training", "checkpoints")
    path = jax_checkpoint.main([jax_runs["step_dir"], ckpt_dir])
    assert path == os.path.join(ckpt_dir, "000002")
    raw = j_restore(os.path.join(jax_runs["run_dir"], "training",
                                 "checkpoints"), step=2)
    model = build_model(NetConfig(dtype="float32", n_embed=N_EMBED),
                        "training")
    state = create_train_state(model.generator, model.discriminator,
                               OptimConfig(), 99)
    restore_checkpoint(ckpt_dir, state)
    converted = {"g_opt": copy.deepcopy(state.g_opt.state_dict()["state"]),
                 "dir": ckpt_dir, "state_dict": copy.deepcopy(
                     state.generator.state_dict()),
                 "step": state.step, "g_sched": state.g_sched.last_epoch}

    jf = JFlowNet(dtype=jnp.float32)
    flow_vars = jf.init({"params": jax.random.PRNGKey(2)},
                        jnp.zeros((1, SIZE, SIZE, 3, 2)))
    flownet = FlowNet2SD(dtype=torch.float32).eval()
    flownet.load_state_dict(flownet_state_from_jax(flow_vars))
    rng = np.random.default_rng(8)
    batch = {"rgb": rng.integers(0, 256, (2, 5, SIZE, SIZE, 3), dtype=np.uint8),
             "op": rng.normal(0, 0.5, (2, 4, SIZE, SIZE, 2)).astype(np.float32)}
    g_tx, d_tx = j_make_optimizers(JOptimConfig())
    jstate = AMMCTrainState(
        step=jnp.asarray(raw["step"]), g_params=raw["g_params"],
        g_state=raw["g_state"], g_opt_state=g_tx.init(raw["g_params"]),
        d_params=raw["d_params"], d_opt_state=d_tx.init(raw["d_params"]))
    # the optax states as orbax restored them, in the tuple structure
    jstate = jstate.replace(
        g_opt_state=jax.tree.unflatten(
            jax.tree.structure(jstate.g_opt_state),
            jax.tree.leaves(raw["g_opt_state"])),
        d_opt_state=jax.tree.unflatten(
            jax.tree.structure(jstate.d_opt_state),
            jax.tree.leaves(raw["d_opt_state"])))
    jgen = j_build_generator(JNetConfig(dtype="float32", n_embed=N_EMBED,
                                        use_pallas_memory=True))
    jstep = jax.jit(j_make_step(jgen, JDisc(dtype=jnp.float32), jf,
                                JLossConfig(), g_tx, d_tx))
    jnew, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           flow_vars)
    metrics = make_twostream_train_step(LossConfig())(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, flownet)
    adam = jstate.g_opt_state[0]
    jadam = {"count": adam.count, "mu": adam.mu, "nu": adam.nu,
             "g_state": raw["g_state"]}
    return jadam, converted, jnew, jmetrics, state, metrics


def test_converted_state_carries_moments_and_step(resumed_pair):
    jadam, converted, *_ = resumed_pair
    assert converted["step"] == 2 and converted["g_sched"] == 2
    assert int(jadam["count"]) == 2
    model = build_model(NetConfig(dtype="float32", n_embed=N_EMBED), "training")
    names = [n for n, _ in model.generator.named_parameters()]
    mu = state_dict_from_jax(_numpy({**jadam["g_state"],
                                     "params": jadam["mu"]}))
    nu = state_dict_from_jax(_numpy({**jadam["g_state"],
                                     "params": jadam["nu"]}))
    assert sorted(converted["g_opt"]) == list(range(len(names)))
    for i, name in enumerate(names):
        s = converted["g_opt"][i]
        assert s["step"].item() == 2.0 and s["step"].dtype == torch.float32
        assert torch.equal(s["exp_avg"], mu[name]), name
        assert torch.equal(s["exp_avg_sq"], nu[name]), name


def test_one_step_from_the_converted_state_matches_jax(resumed_pair):
    _, _, jnew, jmetrics, state, metrics = resumed_pair
    assert state.step == 3 and int(jnew.step) == 3
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-5, err_msg=k)
    sd = {k: v.numpy() for k, v in state.generator.state_dict().items()}
    want = convert_twostream(sd)
    for col in ("batch_stats", "codebook"):
        got = jax.tree_util.tree_leaves_with_path(want[col])
        ref = jax.tree_util.tree_leaves_with_path(jnew.g_state[col])
        assert [p for p, _ in got] == [p for p, _ in ref]
        for (path, a), (_, b) in zip(got, ref):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))
    # Adam's new moments: the carried part exact, the new gradient's part at
    # the gradients' tolerance
    adam = jnew.g_opt_state[0]
    names = [n for n, _ in state.generator.named_parameters()]
    variables = _numpy({"params": adam.mu, **jnew.g_state})
    mu = state_dict_from_jax(variables)
    nu = state_dict_from_jax({**variables, "params": _numpy(adam.nu)})
    opt = state.g_opt.state_dict()["state"]
    for i, name in enumerate(names):
        assert opt[i]["step"].item() == 3.0 and int(adam.count) == 3
        assert _rel(opt[i]["exp_avg"], mu[name]) < 2e-2, name
        assert _rel(opt[i]["exp_avg_sq"], nu[name]) < 2e-2, name


def test_resume_reads_the_jax_run_directly(jax_runs, resumed_pair):
    """``restore_checkpoint`` on the JAX run's own checkpoint dir (what
    ``run_train --resume <jax run>`` calls) fills the state as the
    converter's step dir does."""
    _, converted, *_ = resumed_pair
    states = []
    for ckpt_dir in (os.path.join(jax_runs["run_dir"], "training",
                                  "checkpoints"), converted["dir"]):
        model = build_model(NetConfig(dtype="float32", n_embed=N_EMBED),
                            "training")
        state = create_train_state(model.generator, model.discriminator,
                                   OptimConfig(), 7)
        states.append(restore_checkpoint(ckpt_dir, state))
    direct, via = states
    assert direct.step == via.step == 2
    _assert_state_dicts_equal(direct.generator.state_dict(),
                              converted["state_dict"])
    for a, b in ((direct.g_opt, via.g_opt), (direct.d_opt, via.d_opt),
                 (direct.g_sched, via.g_sched)):
        sa, sb = a.state_dict(), b.state_dict()
        if "state" in sa:
            for i, s in sb["state"].items():
                for k, t in s.items():
                    assert torch.equal(sa["state"][i][k], t), (i, k)
            assert sa["param_groups"] == sb["param_groups"]
        else:
            assert sa == sb
