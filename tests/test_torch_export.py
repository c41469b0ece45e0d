"""PyTorch port, the exported serving pipeline (tools/export_model.py) and
the served kernels as registered operators (kernels/ops.py), on the CPU.

* Every operator passes ``torch.library.opcheck`` (schema, fake tensor,
  autograd registration, AOT dispatch) at small shapes.
* A tiny LiteHRNet + heatmap pipeline (64x64 crops of 96x96 frames)
  exported, saved, loaded and called, against the JAX package's
  ``build_serving_fn`` jitted on the same weights, with the JAX export
  test's own tolerances (tests/test_cli.py ``test_export_roundtrip``).
* A tiny HRFormer's exported graph holds one ``torch.ops.ipe`` node per
  kernel call and no inlined plain version: the plain W-MSA would show as
  ``aten.softmax.int``.
* (The int8 HRNet + fusion pipeline exported, against the live int8
  pipeline bit for bit and JAX's within bounds, lives in
  tests/test_torch_quant_serving.py, beside the JAX int8 reference it
  shares.)
* A call with inputs on another device than the program's raises.
"""

from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.config import get_config as jget_config
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.tools import export_model as jexport
from infantposeestimation_gaussianbias_tpu_torch import Config, PoseInference
from infantposeestimation_gaussianbias_tpu_torch.kernels import ops
from infantposeestimation_gaussianbias_tpu_torch.models import (
    hrformer, pose_estimator)
from infantposeestimation_gaussianbias_tpu_torch.tools import export_model
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    state_dict_from_jax)
from tests import torch_tiny
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

FRAME = 96
BATCH = 2
TINY_HRFORMER = dict(channels=(16, 32, 64, 128), num_heads=(1, 2, 4, 8),
                     stage_modules=(1, 1, 1))
# the tiny HRFormer's transformer blocks: two a branch, branches 2/3/4 in
# stages 2-4 of one module each (stage 1 is convolutional)
TINY_BLOCKS = 2 * (2 + 3 + 4)


def _g(seed):
    return torch.Generator().manual_seed(seed)


def _randn(*shape, seed=0, dtype=torch.float32):
    return torch.randn(*shape, generator=_g(seed)).to(dtype)


def _int8(*shape, seed=0):
    return torch.randint(-127, 128, shape, generator=_g(seed),
                         dtype=torch.int8)


def _k4_args(dtype):
    C, heads, ws, B = 16, 2, 7, 2
    return (_randn(B, ws * ws, C, seed=1, dtype=dtype),
            1 + 0.1 * _randn(C, seed=2), 0.1 * _randn(C, seed=3),
            _randn(C, 3 * C, seed=4, dtype=dtype) * 0.2,
            0.1 * _randn(3 * C, seed=5), _randn(heads, 49, 49, seed=6),
            _randn(C, C, seed=7, dtype=dtype) * 0.2, 0.1 * _randn(C, seed=8),
            torch.tensor([1.0, 0.5]), heads, [ws, ws, ws])


def _k5_args(dtype):
    C, M = 16, 2 * 49
    return (_randn(M, C, seed=1, dtype=dtype), 1 + 0.1 * _randn(C, seed=2),
            0.1 * _randn(C, seed=3), _randn(C, 4 * C, seed=4, dtype=dtype)
            * 0.2, 0.1 * _randn(4 * C, seed=5),
            _randn(4 * C, C, seed=6, dtype=dtype) * 0.1,
            0.1 * _randn(C, seed=7), torch.tensor([1.0, 0.5]), 49)


def _k9_args(variant):
    x = _int8(2, 8, 8, 16, seed=1)
    w = _int8(32, 3, 3, 16, seed=2)
    scale = torch.tensor(0.02)
    eff = (0.001 + 0.01 * torch.rand(32, generator=_g(3)),
           0.1 * _randn(32, seed=4))
    if variant == "int8-out":
        return (x, scale, w, *eff, 1, True, torch.tensor(0.05), None, None)
    # stride 2, a float32 residual, float32 out
    return (x, scale, w, *eff, 2, True, None, _randn(2, 4, 4, 32, seed=5),
            None)


OPCHECK_CASES = {
    "k1": lambda: (ops.window_attention_qkv,
                   (_randn(3, 49, 48, seed=1), _randn(2, 49, 49, seed=2), 2)),
    "k1 bf16 no bias": lambda: (ops.window_attention_qkv,
                                (_randn(3, 49, 48, seed=1,
                                        dtype=torch.bfloat16), None, 2)),
    "k4 fwd": lambda: (ops.fused_attn_half_fwd, _k4_args(torch.float32)),
    "k4 fwd bf16": lambda: (ops.fused_attn_half_fwd, _k4_args(torch.bfloat16)),
    "k5 fwd": lambda: (ops.fused_mlp_half_fwd, _k5_args(torch.float32)),
    "k5 fwd bf16": lambda: (ops.fused_mlp_half_fwd, _k5_args(torch.bfloat16)),
    "k9 int8 out": lambda: (ops.qconv, _k9_args("int8-out")),
    "k9 residual": lambda: (ops.qconv, _k9_args("residual")),
    "k10": lambda: (ops.qdense, (_randn(2, 5, 16, seed=1), _int8(24, 16),
                                 0.01 * torch.rand(24, generator=_g(2)),
                                 _randn(24, seed=3), torch.tensor(0.05),
                                 torch.bfloat16)),
}


@pytest.mark.parametrize("case", sorted(OPCHECK_CASES))
def test_operator_opcheck(case):
    """Each served kernel's operator: schema, fake tensor (the output's
    shape and dtype without data), autograd registration and AOT dispatch
    (``torch.library.opcheck``); its one implementation is the wrapper,
    here the plain version."""
    op, args = OPCHECK_CASES[case]()
    torch.library.opcheck(op, args)


def _lite_cfg(cfg):
    cfg.model.backbone = "litehrnet"
    cfg.model.head_type = "heatmap"
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = (64, 64)
    cfg.data.heatmap_size = (16, 16)
    # the flip test's export: test_torch_quant_serving.py's int8 pipeline
    cfg.eval.flip_test = False
    return cfg


def _requests(seed):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 255, (BATCH, FRAME, FRAME, 3)).astype(np.uint8)
    centers = rng.uniform(30, 60, (BATCH, 2)).astype(np.float32)
    scales = np.full((BATCH, 2), 64.0, np.float32)
    return frames, centers, scales


@pytest.fixture(scope="module")
def lite():
    """(the loaded LiteHRNet program, the requests, the JAX pipeline's
    keypoints and scores): JAX's jitted ``build_serving_fn`` and the
    port's export in two threads at once."""
    jcfg = _lite_cfg(jget_config())
    jm = jpe.build_model(jcfg)
    v = torch_tiny.random_variables(jm, seed=30, shape=(64, 64))
    req = _requests(31)
    serve = jexport.build_serving_fn(jcfg, SimpleNamespace(
        variables=jax.tree_util.tree_map(jnp.asarray, v),
        apply_fn=jm.apply), (FRAME, FRAME))
    with ThreadPoolExecutor(1) as pool:
        want = pool.submit(lambda: jax.tree_util.tree_map(
            np.asarray, jax.jit(serve)(*map(jnp.asarray, req))))
        blob = export_model.export_pipeline(
            _lite_cfg(Config()), state_dict_from_jax(
                v["params"], v["batch_stats"]), BATCH, (FRAME, FRAME),
            device="cpu")
        program = export_model.load_pipeline(blob)
        return program, req, want.result()


def test_exported_litehrnet_matches_jax(lite):
    """The loaded program against JAX's jitted serving function on the same
    weights and requests, at JAX's own export-test tolerances."""
    program, req, (want_k, want_s) = lite
    k, s = program.call(*map(torch.from_numpy, req))
    assert k.shape == (BATCH, 17, 2) and s.shape == (BATCH, 17)
    np.testing.assert_allclose(k.numpy(), want_k, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-4, atol=1e-5)


def test_call_on_another_device_raises(lite):
    """A program is made for the device it was exported on: inputs on
    another device raise, naming both; nothing is moved."""
    program, req, _ = lite
    assert program.device == torch.device("cpu")
    frames, centers, scales = map(torch.from_numpy, req)
    with pytest.raises(ValueError, match="exported for cpu"):
        program.call(frames.to("meta"), centers, scales)
    with pytest.raises(ValueError, match="scales lie on meta"):
        program.call(frames, centers, scales.to("meta"))


def _tiny_hrformer_cfg(cfg):
    torch_tiny.tiny_cfg(cfg, "fusion")
    cfg.model.backbone = "hrformer_tiny"
    return cfg


@pytest.fixture
def tiny_hrformer(monkeypatch):
    monkeypatch.setitem(pose_estimator.BACKBONES, "hrformer_tiny",
                        lambda **kw: hrformer.HRFormer(**TINY_HRFORMER, **kw))


@pytest.mark.parametrize("fused,int8", [("0", False), ("1", False),
                                        ("0", True)])
def test_exported_hrformer_holds_the_operators(tiny_hrformer, monkeypatch,
                                               fused, int8):
    """torch.export of a tiny HRFormer + fusion (crops -> outputs): one
    operator node per kernel call (K1 a block; under IPE_FUSED_BLOCK=1 K4
    and K5 a block; int8: K1 a block and K10 for the Dense layers wide
    enough to quantize) and no softmax or matmul, which the inlined plain
    W-MSA would leave; the exported forward equals the eager one."""
    monkeypatch.setenv("IPE_FUSED_BLOCK", fused)
    cfg = _tiny_hrformer_cfg(Config())
    crops = torch.from_numpy(torch_tiny.crops(40))
    calib = torch_tiny.crops(41, n=4) if int8 else None
    model = PoseInference(cfg, device="cpu", quantize=int8,
                          calibration_crops=calib).model
    model.requires_grad_(False)
    with torch.no_grad():
        program = torch.export.export(model, (crops,), strict=False)
        want = model(crops)
    nodes = Counter(str(n.target) for n in program.graph.nodes
                    if n.op == "call_function")
    ipe = {k: v for k, v in nodes.items() if k.startswith("ipe.")}
    if fused == "1":
        assert ipe == {"ipe.fused_attn_half_fwd.default": TINY_BLOCKS,
                       "ipe.fused_mlp_half_fwd.default": TINY_BLOCKS}
    elif int8:
        # the 128-wide branch's qkv, proj, fc1, fc2 and the 32- and
        # 64-wide branches' fc2 (tests/test_torch_quant_serving.py)
        assert ipe == {"ipe.window_attention_qkv.default": TINY_BLOCKS,
                       "ipe.qdense.default": 18}
    else:
        assert ipe == {"ipe.window_attention_qkv.default": TINY_BLOCKS}
    assert not [k for k in nodes if "softmax" in k or "matmul" in k], nodes
    got = program.module()(crops)
    for k in ("heatmaps", "offsets", "variances"):
        assert torch.equal(got[k], want[k]), k
