"""PyTorch port: the serving artifact (``eval/export.py``,
``runners/export_model.py``) and the kernels' registered ops
(``ops/library.py``).

Mirrors ``tests/test_export.py`` (round trip, self-contained, bad magic,
platform mismatch, the CLI with ``--check`` and ``--int8``), then holds
the artifact against the JAX package's ``make_multi_video_scorer`` on
the same weights and chunk, refuses a JAX artifact, loads and scores in a
process without the port's ``models``, holds the calibrated int8
forward's artifact (its graph calls the int8 quantize and the
convolutions as registered ops) against the live scorer, and runs
``torch.library.opcheck`` on the five registered ops.  Small sizes
(32x32, 64 codewords, float32); the JAX side runs its plain lookup.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ammcnet_aaai2021_tpu.configs import NetConfig as JNetConfig
from ammcnet_aaai2021_tpu.eval import infer as jinfer
from ammcnet_aaai2021_tpu.models import build_generator as j_build_generator
from ammcnet_aaai2021_torch.configs import NetConfig
from ammcnet_aaai2021_torch.eval.export import (ChunkScorer, export_scorer,
                                                load_scorer, read_header,
                                                save_scorer)
from ammcnet_aaai2021_torch.eval.infer import pad_video_to_bucket
from ammcnet_aaai2021_torch.models import build_generator
from ammcnet_aaai2021_torch.ops import int8_kernels as ik
from ammcnet_aaai2021_torch.ops import memory_kernels as mk
from ammcnet_aaai2021_torch.tools.weights import state_dict_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, N_EMBED = 32, 64
N_VIDEOS, T, BUCKET, WB = 2, 14, 16, 8


@pytest.fixture(scope="module")
def setup():
    """One set of weights, JAX-initialized, in both packages (float32)."""
    jcfg = JNetConfig(dtype="float32", use_pallas_memory=False,
                      n_embed=N_EMBED)
    jgen = j_build_generator(jcfg, per_sample_diff=True)
    variables = jgen.init({"params": jax.random.PRNGKey(0)},
                          jnp.zeros((1, SIZE, SIZE, 12)),
                          jnp.zeros((1, SIZE, SIZE, 6)))
    gen = build_generator(NetConfig(dtype="float32", n_embed=N_EMBED),
                          per_sample_diff=True)
    gen.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray,
                                                         variables)))
    return {"jgen": jgen, "variables": variables, "gen": gen.eval()}


def _chunk(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    videos = [pad_video_to_bucket(
        rng.integers(0, 255, (T, SIZE, SIZE, 3), np.uint8),
        rng.normal(0, 0.02, (T - 1, SIZE, SIZE, 2)).astype(dtype),
        bucket=BUCKET) for _ in range(N_VIDEOS)]
    return (tuple(v[0] for v in videos), tuple(v[1] for v in videos))


def _tensors(chunk):
    rgbs, ops = chunk
    return (tuple(torch.from_numpy(r) for r in rgbs),
            tuple(torch.from_numpy(o) for o in ops))


def _save(setup, tmp_path, name="scorer.ammc", **extra):
    path = str(tmp_path / name)
    header = save_scorer(path, setup["gen"], n_videos=N_VIDEOS,
                         frames=BUCKET, size=SIZE, window_batch=WB, **extra)
    return path, header


@pytest.fixture(scope="module")
def artifact(setup, tmp_path_factory):
    return _save(setup, tmp_path_factory.mktemp("export"),
                 extra_meta={"exp_tag": "test_export"})


def test_export_roundtrip_matches_live_scorer(setup, artifact):
    path, header = artifact
    assert header["kind"] == "ammcnet_chunk_scorer"
    assert header["exp_tag"] == "test_export"
    assert header["platforms"] == ["cpu"]
    assert header["torch_version"] == torch.__version__
    assert read_header(path) == header

    score_chunk, hdr2 = load_scorer(path, device="cpu")
    assert hdr2 == header
    rgbs, ops = _tensors(_chunk(1))
    before = mk.quantize_topk_fused.launches
    with torch.no_grad():
        got = score_chunk(rgbs, ops)
        want = ChunkScorer(setup["gen"], window_batch=WB)(rgbs, ops)
    # CPU tensors take B1's plain version inside the loaded graph too
    assert mk.quantize_topk_fused.launches == before
    assert tuple(got.shape) == tuple(header["out_shape"]) == (2, 4, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_export_artifact_is_self_contained(setup):
    """The artifact holds the weights: its bytes exceed 0.9x the
    parameters' and buffers', and changing the live module's weights after
    the export leaves the loaded artifact's output as it was."""
    import copy
    import io

    gen = copy.deepcopy(setup["gen"])
    blob = export_scorer(gen, n_videos=1, frames=BUCKET, size=SIZE,
                         window_batch=WB)
    assert blob[:8] == b"AMMCSCR1"
    n_bytes = sum(t.numel() * t.element_size()
                  for t in gen.state_dict().values())
    assert len(blob) > 0.9 * n_bytes
    (n,) = np.frombuffer(blob[8:16], "<u8")
    loaded = torch.export.load(io.BytesIO(blob[16 + int(n):])).module()
    rgbs, ops = _tensors(_chunk(2))
    rgbs, ops = rgbs[:1], ops[:1]
    with torch.no_grad():
        before = loaded(rgbs, ops)
        for p in gen.parameters():
            p.mul_(0.5)
        after = loaded(rgbs, ops)
        live = ChunkScorer(gen, window_batch=WB)(rgbs, ops)
    assert torch.equal(before, after)
    assert not torch.allclose(live, after)


def test_export_bad_magic_rejected(tmp_path):
    path = str(tmp_path / "junk.ammc")
    with open(path, "wb") as f:
        f.write(b"NOTANART" + b"\x00" * 64)
    with pytest.raises(ValueError, match="not an ammcnet scorer artifact"):
        read_header(path)
    with pytest.raises(ValueError, match="not an ammcnet scorer artifact"):
        load_scorer(path, device="cpu")


def test_export_platform_mismatch_rejected(artifact, monkeypatch):
    """A CPU artifact asked to serve on CUDA raises before deserializing
    (here, with no GPU at all)."""
    path, _ = artifact

    def no_load(*args, **kwargs):
        raise AssertionError("deserialized before the platform check")
    monkeypatch.setattr(torch.export, "load", no_load)
    with pytest.raises(ValueError, match="cannot serve on"):
        load_scorer(path, device="cuda")
    with pytest.raises(ValueError, match="cannot serve on"):
        load_scorer(path)  # the default device is cuda


def test_export_model_cli_toydata(tmp_path):
    """The CLI on toydata: a bf16 artifact with ``--check`` (reload +
    live-scorer agreement), then the int8 forward calibrated on training
    clips, also checked, under 0.55x the bf16 artifact's bytes."""
    from ammcnet_aaai2021_torch.runners.export_model import main
    from ammcnet_aaai2021_torch.tools.make_toydata import make_toydata

    root = str(tmp_path / "data")
    make_toydata(root, frames_per_video=12, image_size=SIZE)
    out = str(tmp_path / "scorer.ammc")
    common = ["--dataset_name", "toydata", "--data_dir", root,
              "--image_size", str(SIZE), "--frames", "16",
              "--window_batch", "4", "--platforms", "cpu", "--device", "cpu",
              "--check"]
    res = main(common + ["--out", out, "--n_videos", "2"])
    assert res["forward"] == "bf16"
    assert res["check_max_diff"] <= 1e-2
    assert os.path.getsize(out) == res["bytes"]
    assert res["platforms"] == ["cpu"]

    out8 = str(tmp_path / "scorer_int8.ammc")
    res8 = main(common + ["--out", out8, "--n_videos", "1", "--int8",
                          "--calib_batches", "1", "--calib_batch_size", "2"])
    assert res8["forward"] == "int8-calibrated"
    assert res8["calib_clips"] == 2
    assert res8["check_max_diff"] <= 1e-2
    assert res8["bytes"] < 0.55 * res["bytes"]
    assert read_header(out8)["forward"] == "int8-calibrated"
    with pytest.raises(ValueError, match="--platforms"):
        main(common + ["--out", out, "--platforms", "cuda"])


def test_artifact_matches_the_jax_multi_video_scorer(setup, artifact):
    """The whole slice: the port's artifact against JAX's
    ``make_multi_video_scorer`` on the same weights and chunk."""
    path, _ = artifact
    chunk = _chunk(3)
    score_chunk, _ = load_scorer(path, device="cpu")
    with torch.no_grad():
        got = score_chunk(*_tensors(chunk)).numpy()
    live = jinfer.make_multi_video_scorer(setup["jgen"], setup["variables"],
                                          window_batch=WB)
    want = np.asarray(live(tuple(jnp.asarray(r) for r in chunk[0]),
                           tuple(jnp.asarray(o) for o in chunk[1])))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_a_jax_artifact_is_refused_naming_jax(setup, tmp_path):
    from ammcnet_aaai2021_tpu.eval.export import save_scorer as j_save

    path = str(tmp_path / "jax.ammc")
    j_save(path, setup["jgen"], setup["variables"], n_videos=1, frames=16,
           size=SIZE, window_batch=8, platforms=("cpu",))
    assert "jax_version" in read_header(path)
    with pytest.raises(ValueError, match="JAX"):
        load_scorer(path, device="cpu")


def test_artifact_serves_without_the_ports_models(setup, artifact,
                                                  tmp_path):
    """A process that imports only ``eval.export`` loads the artifact and
    scores: the port's ``models`` (and JAX) stay out of ``sys.modules``."""
    path, _ = artifact
    rgbs, ops = _tensors(_chunk(4))
    inputs = str(tmp_path / "inputs.pt")
    output = str(tmp_path / "output.pt")
    torch.save({"rgbs": rgbs, "ops": ops}, inputs)
    code = (
        "import json, sys, torch\n"
        "from ammcnet_aaai2021_torch.eval.export import load_scorer\n"
        f"score_chunk, header = load_scorer({path!r}, device='cpu')\n"
        f"x = torch.load({inputs!r})\n"
        "with torch.no_grad():\n"
        "    out = score_chunk(x['rgbs'], x['ops'])\n"
        f"torch.save(out, {output!r})\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith("
        "('ammcnet_aaai2021_torch.models', 'jax', 'ammcnet_aaai2021_tpu')))))"
        "\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    with torch.no_grad():
        want = ChunkScorer(setup["gen"], window_batch=WB)(rgbs, ops)
    np.testing.assert_allclose(torch.load(output).numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_int8_artifact_calls_the_quantize_kernel(setup, tmp_path):
    """The calibrated int8 forward exported: each forward of the graph
    (two window batches) calls ``ammcnet::quantize_pack_int8`` at its 24
    statically quantized inputs and the convolutions at 34 and 6, and the
    loaded artifact scores as the live scorer does."""
    from ammcnet_aaai2021_torch.models import quantized as pq

    kw = dict(embed_dim=64, n_embed=N_EMBED, k=NetConfig().k,
              per_sample_diff=True)
    qvars = pq.quantize_twostream_variables(setup["gen"].state_dict())
    g = torch.Generator().manual_seed(9)
    cal = [(torch.rand(2, 12, SIZE, SIZE, generator=g) * 2 - 1,
            torch.randn(2, 6, SIZE, SIZE, generator=g) * 0.02)]
    qcal = pq.calibrate_act_scales(pq.make_quantized_forward(qvars, **kw),
                                   qvars, cal)
    model = pq.make_quantized_forward(qcal, **kw)
    path = str(tmp_path / "int8.ammc")
    save_scorer(path, model, n_videos=1, frames=BUCKET, size=SIZE,
                window_batch=WB)
    score_chunk, _ = load_scorer(path, device="cpu")
    targets = [str(n.target) for n in score_chunk.graph.nodes
               if n.op == "call_function"]
    forwards = -(-(BUCKET - 4) // WB)
    for name, per_forward in (("quantize_pack_int8", 24),
                              ("qconv3x3_int8", 34),
                              ("qconv_transpose2x2_int8", 6)):
        assert sum(f"ammcnet.{name}" in t for t in targets) == \
            per_forward * forwards, name
    rgbs, ops = _tensors(_chunk(6))
    rgbs, ops = rgbs[:1], tuple(o.to(torch.bfloat16) for o in ops[:1])
    with torch.no_grad():
        got = score_chunk(rgbs, ops)
        want = ChunkScorer(model, window_batch=WB)(rgbs, ops)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def _op_cases():
    g = torch.Generator().manual_seed(7)
    flat = torch.randn(37, 16, generator=g)
    embed = torch.randn(16, 24, generator=g)
    x = torch.randint(-127, 128, (2, 5, 6, 32), dtype=torch.int8,
                      generator=g)
    wk = torch.randint(-127, 128, (64, 9, 32), dtype=torch.int8,
                       generator=g)
    wt = torch.randint(-127, 128, (64, 1, 32), dtype=torch.int8,
                       generator=g)
    sx = torch.tensor([0.01])
    scale, bias = torch.rand(10, generator=g), torch.rand(10, generator=g)
    conv = (x, wk, sx, scale, bias, 10)
    act = torch.randn(2, 12, 6, 8, generator=g) * 0.5
    skip = (torch.randn(2, 6, 8, 64, generator=g) * 0.5).bfloat16()
    return {
        "quantize_topk_k1": ("quantize_topk", (flat, embed, 1), {}),
        "quantize_topk_k2": ("quantize_topk", (flat.bfloat16(), embed, 2),
                             {}),
        "quantize_topk_train": ("quantize_topk_train", (flat, embed, 2), {}),
        "qconv3x3_int8_relu": ("qconv3x3_int8", conv, {"relu": True}),
        "qconv3x3_int8_int8_out": ("qconv3x3_int8", conv,
                                   {"out_scale": torch.tensor([0.5])}),
        "qconv3x3_int8_acc": ("qconv3x3_int8", conv, {"acc": True}),
        "qconv_transpose2x2_int8": ("qconv_transpose2x2_int8",
                                    (x, wt, sx, scale, bias, 10), {}),
        "quantize_pack_int8_strided": ("quantize_pack_int8",
                                       (act.permute(0, 2, 3, 1), sx), {}),
        "quantize_pack_int8_cat": ("quantize_pack_int8", (skip, sx),
                                   {"skip": skip.flip(-1)}),
        "quantize_pack_int8_pool": ("quantize_pack_int8", (skip, sx),
                                    {"pool": True}),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_registered_op_passes_opcheck(case):
    name, args, kwargs = _op_cases()[case]
    op = getattr(torch.ops.ammcnet, name)
    torch.library.opcheck(op, args, kwargs)
    # the op's result is the kernel wrapper's (here its plain version's)
    wrapper = {"quantize_topk": mk.quantize_topk_fused,
               "quantize_topk_train": mk.quantize_topk_train_fused}.get(
        name) or getattr(ik, name)
    got = torch.utils._pytree.tree_leaves(op(*args, **kwargs))
    want = torch.utils._pytree.tree_leaves(wrapper(*args, **kwargs))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
