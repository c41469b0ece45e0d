"""PyTorch port, HRNet slice: the HRNet backbone with the heatmap and
fusion heads, the heatmap decodes, ``PoseInference.predict_batch`` and the
heatmap-head train step against the JAX package on the CPU, on the same
numpy inputs and weights; and the full-width weight bridge.

The tiny model is HRNet with base_channels 8 and stage modules (1, 1, 1)
at 64x64, registered as ``hrnet_tiny`` in both packages' ``BACKBONES``
(test-only; tests/torch_tiny.py).  Seeded numpy weights on the fusion
model's ``jax.eval_shape`` tree give both heads' weights, and one jitted
JAX train step is shared by the file.  Weights go JAX -> ``state_dict_from_jax`` -> the port.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu import inference as jinference
from infantposeestimation_gaussianbias_tpu.config import get_config as jget_config
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.ops import decode as jdecode
from infantposeestimation_gaussianbias_tpu.train import optim as joptim
from infantposeestimation_gaussianbias_tpu.train import step as jstep
from infantposeestimation_gaussianbias_tpu.train.state import (
    TrainState as JTrainState,
)
from infantposeestimation_gaussianbias_tpu_torch import (Config, PoseInference,
                                                          create_train_state,
                                                          make_train_step)
from infantposeestimation_gaussianbias_tpu_torch.models import hrnet
from infantposeestimation_gaussianbias_tpu_torch.models import pose_estimator
from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
    BasicBlock,
)
from infantposeestimation_gaussianbias_tpu_torch.ops import affine, decode
from infantposeestimation_gaussianbias_tpu_torch.train import draw_drop_masks
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    state_dict_from_jax,
)
from tests import torch_tiny
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

TINY_C, SIZE, HM = torch_tiny.TINY_C, torch_tiny.SIZE, torch_tiny.HM
# Float32 on both sides, on the CPU; only summation orders and XLA's
# fusions differ.  Through the untrained residual chains the maps reach
# magnitudes of ~1e2, and a sum's rounding scales with its terms, not with
# the output element: so the tolerance is OUT_TOL of the tensor's largest
# magnitude, plus OUT_TOL relative (measured: ~7e-6 of the largest).
OUT_TOL = 1e-4

_t = torch_tiny.t
_port = torch_tiny.port
_crops = torch_tiny.crops


@pytest.fixture(scope="module")
def tiny():
    """{head: (port cfg, JAX cfg, JAX model, JAX variables as numpy)} with
    ``hrnet_tiny`` registered in both BACKBONES for the module
    (tests/torch_tiny.py)."""
    with torch_tiny.tiny_models() as out:
        yield out


# -- the tiny model -----------------------------------------------------------

@pytest.mark.parametrize("head", ["heatmap", "fusion"])
def test_state_dict_loads_strict(tiny, head):
    cfg, _, _, variables = tiny[head]
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    model = pose_estimator.build_model(cfg, device="cpu")
    assert isinstance(model.backbone, hrnet.HRNet)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    assert "backbone.stage4.0.branches.3.3.conv2.weight" in sd
    if head == "heatmap":
        assert sd["head.final_layer.weight"].shape == (17, TINY_C, 1, 1)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("head", ["heatmap", "fusion"])
def test_forward_matches_jax(tiny, head, train):
    """Every output of the forward on the same crops; in train mode
    (batch statistics) also every BatchNorm's running statistics after it.
    Tolerance OUT_TOL, atol and rtol."""
    cfg, _, jmodel, variables = tiny[head]
    x = _crops(3)
    port = _port(cfg, variables)
    port.train(train)
    with torch.no_grad():
        out = port(_t(x))
    if train:
        ref, mutated = jmodel.apply(variables, jnp.asarray(x), True,
                                    mutable=["batch_stats"])
    else:
        ref = jmodel.apply(variables, jnp.asarray(x), False)
    assert set(out) == set(ref)
    for key in ref:
        assert out[key].shape == ref[key].shape, key
        want = np.asarray(ref[key])
        np.testing.assert_allclose(out[key].detach().numpy(), want,
                                   rtol=OUT_TOL,
                                   atol=OUT_TOL * np.abs(want).max(),
                                   err_msg=key)
    if train:
        want = state_dict_from_jax(variables["params"],
                                   jax.tree_util.tree_map(
                                       np.asarray, mutated["batch_stats"]))
        for name, buf in port.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                           atol=1e-5, rtol=1e-4,
                                           err_msg=name)


def test_basic_block_matches_jax():
    """One BasicBlock (the HRNet branch unit), eval and train mode."""
    from infantposeestimation_gaussianbias_tpu.models.layers import (
        BasicBlock as JBasicBlock,
    )

    x = np.random.RandomState(4).randn(2, 8, 6, 16).astype(np.float32)
    jblock = JBasicBlock(16)
    v = jax.tree_util.tree_map(np.array, jblock.init(
        jax.random.PRNGKey(3), jnp.asarray(x), False))
    rng = np.random.RandomState(5)
    for conv in ("conv1", "conv2"):
        bn = v["batch_stats"][conv]["norm"]["bn"]
        bn["mean"][...] = rng.randn(16) * 0.1
        bn["var"][...] = rng.rand(16) + 0.5
    block = BasicBlock(16)
    with torch.no_grad():
        for i in (1, 2):
            p = v["params"][f"conv{i}"]
            s = v["batch_stats"][f"conv{i}"]["norm"]["bn"]
            getattr(block, f"conv{i}").weight.copy_(
                _t(p["conv"]["kernel"].transpose(3, 2, 0, 1)))
            bn = getattr(block, f"bn{i}")
            bn.weight.copy_(_t(p["norm"]["bn"]["scale"]))
            bn.bias.copy_(_t(p["norm"]["bn"]["bias"]))
            bn.running_mean.copy_(_t(s["mean"]))
            bn.running_var.copy_(_t(s["var"]))
        for train in (False, True):
            block.train(train)
            got = block(_t(x)).numpy()
            ref = jblock.apply(v, jnp.asarray(x), train,
                               mutable=["batch_stats"])[0]
            np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5,
                                       rtol=1e-5)


# -- decodes ------------------------------------------------------------------

def _peaked(seed, B=3, H=16, W=12, K=17):
    """Noise plus one peak per map, some on the border, with distinct
    neighbours (no sign ties in the quarter shift)."""
    rng = np.random.RandomState(seed)
    hm = rng.rand(B, H, W, K).astype(np.float32) * 0.2
    ys, xs = rng.randint(0, H, (B, K)), rng.randint(0, W, (B, K))
    ys[0, :3], xs[0, :3] = (0, H - 1, 1), (W - 1, 0, 1)
    for b in range(B):
        for k in range(K):
            hm[b, ys[b, k], xs[b, k], k] += 1.0 + rng.rand()
    return hm


@pytest.mark.parametrize("method", ["argmax", "quarter", "taylor"])
def test_heatmap_decodes_match_jax(method):
    hm = _peaked(7)
    port = {"argmax": decode.argmax_decode, "quarter":
            decode.quarter_shift_decode, "taylor": decode.taylor_decode}
    ref = {"argmax": jdecode.argmax_decode, "quarter":
           jdecode.quarter_shift_decode, "taylor": jdecode.taylor_decode}
    coords, scores = port[method](_t(hm))
    jc, js = ref[method](jnp.asarray(hm))
    np.testing.assert_allclose(coords.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(js))


def test_argmax_tie_takes_the_first_index():
    hm = np.zeros((1, 4, 5, 2), np.float32)
    hm[0, 1, 3, 0] = hm[0, 2, 0, 0] = 1.0
    coords, _ = decode.argmax_decode(_t(hm))
    jc, _ = jdecode.argmax_decode(jnp.asarray(hm))
    np.testing.assert_array_equal(coords.numpy(), np.asarray(jc))
    assert coords[0, 0].tolist() == [3.0, 1.0]


@pytest.mark.parametrize("method", ["quarter", "taylor", "softargmax"])
def test_decode_outputs_dispatch_matches_jax(method):
    hm = _peaked(8)
    outputs = {"heatmaps": _t(hm)}
    coords, scores = pose_estimator.decode_outputs(outputs, "heatmap",
                                                   method)
    jc, js = jpe.decode_outputs({"heatmaps": jnp.asarray(hm)}, "heatmap",
                                method)
    np.testing.assert_allclose(coords.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=1e-6)


# -- serving -----------------------------------------------------------------

def _frames_and_boxes():
    rng = np.random.RandomState(9)
    frames = rng.randint(0, 256, (3, 90, 80, 3)).astype(np.uint8)
    bboxes = np.array([[5, 5, 70, 85], [0, 0, 80, 90], [20, 10, 60, 70]],
                      np.float32)
    return frames, bboxes


def _unsure(port, cfg, frames, bboxes, head):
    """(B, K) keypoints whose decode sits on a knife's edge between the two
    frameworks' roundings, from the port's flip-averaged heatmaps: for the
    heatmap head a runner-up within 1e-5 of the peak or a neighbour
    difference within 1e-5 of 0 (the quarter shift's sign); for the fusion
    head a soft-argmax within 1e-3 of a half-integer (round() ties)."""
    centers = (bboxes[:, :2] + bboxes[:, 2:]) / 2
    scales = (bboxes[:, 2:] - bboxes[:, :2]) * cfg.data.bbox_padding
    with torch.no_grad():
        crops = affine.crop_and_normalize(_t(frames), _t(centers),
                                          _t(scales), (SIZE, SIZE))
        hm = port.model(crops)["heatmaps"]
        hm = (hm + decode.flip_heatmaps(port.model(torch.flip(crops, [2]))[
            "heatmaps"], port._flip_index)) * 0.5
    if head == "fusion":
        g, _ = decode.soft_argmax(hm)
        frac = np.abs(g.numpy() % 1.0 - 0.5)
        return (frac < 1e-3).any(axis=-1)
    B, H, W, K = hm.shape
    flat = hm.permute(0, 3, 1, 2).reshape(B, K, H * W)
    top2 = flat.topk(2, dim=-1).values
    coords, _ = decode.argmax_decode(hm)
    xi, yi = coords[..., 0].long(), coords[..., 1].long()
    dx = decode._gather_hm(hm, xi + 1, yi) - decode._gather_hm(hm, xi - 1, yi)
    dy = decode._gather_hm(hm, xi, yi + 1) - decode._gather_hm(hm, xi, yi - 1)
    return ((top2[..., 0] - top2[..., 1] < 1e-5) | (dx.abs() < 1e-5)
            | (dy.abs() < 1e-5)).numpy()


@pytest.mark.parametrize("head,method,fold", [
    pytest.param("heatmap", "quarter", False, id="heatmap-quarter"),
    pytest.param("heatmap", "taylor", False, id="heatmap-taylor"),
    pytest.param("fusion", "quarter", False, id="fusion-quarter"),
    pytest.param("heatmap", "quarter", None, id="heatmap-quarter-folded"),
    pytest.param("fusion", "quarter", None, id="fusion-quarter-folded")])
def test_predict_batch_matches_jax(tiny, head, method, fold):
    """Whole slice: crop -> flip-tested forward -> decode by head type and
    ``cfg.eval.decode`` -> back-projection, 3 frames padded to a bucket
    of 4, against the JAX PoseInference: BN-fold off on both sides
    (``fold=False``: eval-mode BatchNorm), or each side's default (None:
    both fold, models/fold.py)."""
    cfg, jcfg, jmodel, variables = tiny[head]
    cfg.eval.decode = jcfg.eval.decode = method
    frames, bboxes = _frames_and_boxes()
    jinf = jinference.PoseInference(
        jcfg, state=SimpleNamespace(
            apply_fn=jmodel.apply,
            variables=jax.tree_util.tree_map(jnp.asarray, variables)),
        fold=fold)
    ref_k, ref_s = jinf.predict_batch(frames, bboxes)
    port = PoseInference(cfg, state_dict=state_dict_from_jax(
        variables["params"], variables["batch_stats"]), device="cpu",
        fold=fold)
    assert port.fold == (fold is None)
    kpts, scores = port.predict_batch(frames, bboxes)
    cfg.eval.decode = jcfg.eval.decode = "quarter"
    assert kpts.shape == (3, 17, 2) and scores.shape == (3, 17)
    assert np.isfinite(kpts).all()
    keep = ~_unsure(port, cfg, frames, bboxes, head)
    print(f"left out {int((~keep).sum())} of {keep.size} keypoints")
    assert keep.sum() >= keep.size // 2
    np.testing.assert_allclose(kpts[keep], ref_k[keep], atol=1e-3)
    np.testing.assert_allclose(scores, ref_s, rtol=1e-5, atol=1e-4)


# -- training -----------------------------------------------------------------

def _batch(seed, B=4):
    rng = np.random.RandomState(seed)
    kpts = rng.uniform(-4, SIZE + 4, (B, 17, 2)).astype(np.float32)
    vis = rng.choice([0, 1, 2], (B, 17), p=[0.1, 0.2, 0.7]).astype(
        np.float32)
    return {"image": rng.randn(B, SIZE, SIZE, 3).astype(np.float32),
            "keypoints": kpts, "visible": vis}


@pytest.fixture(scope="module")
def jax_step(tiny):
    """One JAX heatmap-head train step: (state, metrics)."""
    _, jcfg, model, variables = tiny["heatmap"]
    tx, _ = joptim.build_optimizer(jcfg, jcfg.train.steps_per_epoch or 1000)
    state = JTrainState.create(
        apply_fn=model.apply,
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]), tx=tx)
    step = jax.jit(jstep.make_train_step(jcfg, jcfg.data.keypoint_schema))
    state, metrics = step(state, jax.tree_util.tree_map(jnp.asarray,
                                                        _batch(10)),
                          jax.random.PRNGKey(0))
    return state, jax.tree_util.tree_map(np.asarray, metrics)


def test_train_step_matches_jax(tiny, jax_step):
    """One heatmap-head step against the JAX step.

    The loss (1e-4 relative) and the BatchNorm statistics are forward
    quantities.  The gradients (JAX's from AdamW's first moment, mu =
    0.1 g) are not smooth in the forward's roundings: the forwards agree
    to ~3e-5 of each map's scale, so now and then a ReLU input lies on
    the other side of 0 in one framework (for batch seed 12, one element
    of stage4 branch 2 block 3 at 2.3e-6 against 0), and on the 4x4 and
    2x2 maps of this tiny model such a flip moves every gradient below it
    by 1e-2 relative and more (5e-2 on that block's conv1).  So: the
    head's gradient, above every ReLU, to 1e-4 of its norm; the whole
    gradient vector and grad_norm to 2e-2 and 1e-3 relative (measured
    7e-3 and 1.8e-4)."""
    cfg, _, _, variables = tiny["heatmap"]
    state = create_train_state(cfg, device="cpu", state_dict=state_dict_from_jax(
        variables["params"], variables["batch_stats"]))
    assert draw_drop_masks(state.model, 4, torch.Generator()) is None
    _, metrics = make_train_step(cfg)(
        state, {k: _t(v) for k, v in _batch(10).items()}, None)
    jstate, jmetrics = jax_step
    assert set(metrics) == set(jmetrics) == {"total_loss", "heatmap_loss",
                                             "grad_norm"}
    for k in ("total_loss", "heatmap_loss"):
        np.testing.assert_allclose(metrics[k].item(), jmetrics[k],
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               jmetrics["grad_norm"], rtol=1e-3)
    j_grads = state_dict_from_jax(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, jstate.opt_state[0].mu), {})
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    for n in ("head.final_layer.weight", "head.final_layer.bias"):
        err = (grads[n] - j_grads[n]).norm().item()
        assert err <= 1e-4 * j_grads[n].norm().item(), (n, err)
    diff = torch.cat([(grads[n] - j_grads[n]).flatten() for n in grads])
    ref = torch.cat([j_grads[n].flatten() for n in grads])
    assert diff.norm().item() <= 2e-2 * ref.norm().item()
    j_stats = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    for name, buf in state.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), j_stats[name].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=name)


def test_remat_matches_no_remat(tiny):
    """Checkpointed HRModules (cfg.model.remat): the same loss, gradients
    and BatchNorm statistics as the plain forward; the recomputation
    leaves the running statistics alone."""
    cfg, _, _, variables = tiny["heatmap"]
    batch = {k: _t(v) for k, v in _batch(11).items()}
    results = []
    for remat in (False, True):
        cfg.model.remat = remat
        state = create_train_state(cfg, device="cpu",
                                   state_dict=state_dict_from_jax(
                                       variables["params"],
                                       variables["batch_stats"]))
        assert state.model.backbone.remat is remat
        _, metrics = make_train_step(cfg)(state, batch, None)
        results.append((metrics, {n: p.grad for n, p in
                                  state.model.named_parameters()},
                        dict(state.model.named_buffers())))
    cfg.model.remat = False
    (m0, g0, b0), (m1, g1, b1) = results
    for k in m0:
        assert m0[k].item() == pytest.approx(m1[k].item(), rel=1e-6), k
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-6, rtol=1e-5)
    for n in b0:
        torch.testing.assert_close(b1[n], b0[n], atol=0, rtol=0)


def test_fusion_head_train_step_runs(tiny):
    """The fusion head on HRNet: the six loss terms, finite, and a loss
    that falls over three steps on one batch."""
    cfg, _, _, variables = tiny["fusion"]
    state = create_train_state(cfg, device="cpu", state_dict=state_dict_from_jax(
        variables["params"], variables["batch_stats"]))
    step = make_train_step(cfg)
    batch = {k: _t(v) for k, v in _batch(12).items()}
    losses = []
    for _ in range(3):
        _, metrics = step(state, batch, None)
        assert all(np.isfinite(v.item()) for v in metrics.values())
        losses.append(metrics["total_loss"].item())
    assert {"heatmap_loss", "offset_loss", "grad_norm"} <= set(metrics)
    assert len(metrics) == 8 and losses[2] < losses[0]


# -- the default configuration at full width ------------------------------

@pytest.mark.parametrize("backbone,head", [
    pytest.param("hrnet_w32", "heatmap", id="heatmap"),
    pytest.param("hrnet_w32", "fusion", id="fusion"),
    pytest.param("hrnet_w48", "heatmap", id="w48-heatmap"),
    pytest.param("hrnet_w48", "fusion", id="w48-fusion")])
def test_full_width_names_and_shapes_match_jax(backbone, head):
    """``backbone`` + ``head`` at the published widths (hrnet_w32, the
    default config, and hrnet_w48): the JAX variables (zeros of the init
    tree's shapes) go through ``state_dict_from_jax`` into the port's
    ``load_state_dict(strict=True)``: every name and shape, and the
    parameter count."""
    jcfg = jget_config()
    jcfg.model.backbone = backbone
    jcfg.model.head_type = head
    model = jpe.build_model(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    sd = state_dict_from_jax(zeros["params"], zeros["batch_stats"])
    cfg = Config()
    assert cfg.model.backbone == "hrnet_w32"
    cfg.model.backbone = backbone
    cfg.model.head_type = head
    port = pose_estimator.build_model(cfg, device="cpu")
    port.load_state_dict(sd, strict=True)
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax
    width = int(backbone[len("hrnet_w"):])
    assert port.backbone.channels == (width, 2 * width, 4 * width, 8 * width)
    assert [len(getattr(port.backbone, f"stage{s}")) for s in (2, 3, 4)] == [
        1, 4, 3]


def test_default_config_entry_points():
    """build_model, PoseInference and make_train_step take the default
    Config() (hrnet_w32 + heatmap, bf16); without a device argument they
    run on CUDA and so raise here."""
    cfg = Config()
    assert (cfg.model.backbone, cfg.model.head_type) == ("hrnet_w32",
                                                         "heatmap")
    make_train_step(cfg)
    model = pose_estimator.build_model(cfg, device="cpu")
    assert model.compute_dtype == torch.bfloat16
    if not torch.cuda.is_available():
        for make in (PoseInference, pose_estimator.build_model,
                     create_train_state):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(cfg)
