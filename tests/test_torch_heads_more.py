"""PyTorch port, the remaining heads, their losses and decodes, and the
attention add-ons, module by module against the JAX package on the CPU:
the HeatmapHead's deconv stack (transposed-conv kernels 2, 3 and 4),
FusedHead, SimCCHead and its decode, the Stack-B losses
(losses/morphology.py) and ``combined_loss``, ``simcc_loss``,
``fused_alpha_decode``, CBAM and TransformerNeck; and the seeded
initialisers of the new layers.

Every module gets seeded numpy weights on its ``jax.eval_shape`` tree
(the rule of tests/torch_tiny.py ``random_variables``), converted by the
port's JAX bridge (``state_dict_from_jax``, ``attention_state_from_jax``)
and loaded with ``strict=True``.  Each JAX module's forward and gradient
are jitted (their eager op-by-op runs took 5-10 s a module); the losses
share one jitted JAX function.

Tolerances (float32 on both sides; only summation orders differ): module
outputs and gradients OUT_TOL of the tensor's largest magnitude plus
OUT_TOL relative; loss terms LOSS_RTOL relative; decoded coords 1e-5 px.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu import losses as jlosses
from infantposeestimation_gaussianbias_tpu.models import attention as jatt
from infantposeestimation_gaussianbias_tpu.models import heads as jheads
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.ops import decode as jdecode
from infantposeestimation_gaussianbias_tpu.train import step as jstep
from infantposeestimation_gaussianbias_tpu_torch import losses
from infantposeestimation_gaussianbias_tpu_torch.models import attention
from infantposeestimation_gaussianbias_tpu_torch.models import heads
from infantposeestimation_gaussianbias_tpu_torch.models import pose_estimator
from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
    BatchNorm,
    same_transpose_padding,
)
from infantposeestimation_gaussianbias_tpu_torch.ops import decode
from infantposeestimation_gaussianbias_tpu_torch.train.step import simcc_loss
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    attention_state_from_jax,
    init_weights,
    state_dict_from_jax,
)
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

OUT_TOL = 1e-4
LOSS_RTOL = 1e-4
K = 5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=OUT_TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _variables(module, x, seed):
    """Seeded numpy variables on ``module``'s init tree at input ``x``:
    kernels ~ N(0, 1/fan_in), BatchNorm scale 1 +- 0.1, running variance
    in [0.75, 1.25), everything else N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x)))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            v = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name.endswith("['scale']"):
            v = 1 + 0.1 * rng.randn(*s.shape)
        elif name.endswith("['var']"):
            v = rng.rand(*s.shape) * 0.5 + 0.75
        else:
            v = 0.1 * rng.randn(*s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _head_port(module, variables):
    """A port head loaded (strict) with a JAX head's variables."""
    sd = state_dict_from_jax({"head": variables["params"]},
                             {"head": variables.get("batch_stats", {})})
    module.load_state_dict({k[len("head."):]: v for k, v in sd.items()},
                           strict=True)
    return module


def _features(seed, shape=(2, 8, 6, 16)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _compare_head(jmod, port, x, seed):
    """Outputs in eval and train mode, the running statistics after the
    train forward, and the gradient of sum(outputs * r) with respect to
    the input and every parameter."""
    v = _variables(jmod, x, seed)
    port = _head_port(port, v)
    apply = jax.jit(jmod.apply, static_argnums=2,
                    static_argnames="mutable")
    for train in (False, True):
        port.train(train)
        xt = _t(x).requires_grad_(True)
        out = port(xt)
        if train:
            ref, mutated = apply(v, jnp.asarray(x), True,
                                 mutable=("batch_stats",))
        else:
            ref = apply(v, jnp.asarray(x), False)
        assert set(out) == set(ref)
        rng = np.random.RandomState(seed + 1)
        cot = {k: rng.randn(*np.shape(ref[k])).astype(np.float32)
               for k in ref}
        for k in ref:
            _close(out[k].detach().numpy(), ref[k], name=k)
        # gradients: the head's parameters and its input
        loss = sum((out[k] * _t(cot[k])).sum() for k in out)
        loss.backward()

        def jloss(params, x):
            o = jmod.apply(dict(v, params=params), x, train,
                           mutable=["batch_stats"] if train else False)
            o = o[0] if train else o
            return sum(jnp.sum(o[k] * cot[k]) for k in o)

        gp, gx = jax.jit(jax.grad(jloss, (0, 1)))(v["params"],
                                                   jnp.asarray(x))
        _close(xt.grad.numpy(), gx, name="dx")
        want = state_dict_from_jax({"head": jax.tree_util.tree_map(
            np.asarray, gp)}, {})
        for name, p in port.named_parameters():
            _close(p.grad.numpy(), want[f"head.{name}"], name=name)
            p.grad = None
    if "batch_stats" in v:
        want = state_dict_from_jax({"head": v["params"]}, {
            "head": jax.tree_util.tree_map(np.asarray,
                                           mutated["batch_stats"])})
        n = 0
        for name, buf in port.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buf.numpy(),
                                           want[f"head.{name}"].numpy(),
                                           atol=1e-5, rtol=1e-4,
                                           err_msg=name)
                n += 1
        assert n == 2 * sum(isinstance(m, BatchNorm) for m in port.modules())


# -- heads --------------------------------------------------------------------

@pytest.mark.parametrize("kernel", [2, 3, 4])
def test_deconv_head_matches_jax(kernel):
    """HeatmapHead with a two-layer stride-2 deconv stack: flax's
    ConvTranspose (SAME, its kernel unflipped on the dilated input) as
    torch's transposed conv with the kernel flipped; the odd kernel 3 pads
    one more row before than after (the port drops the last row)."""
    x = _features(1, (2, 5, 4, 12))
    jmod = jheads.HeatmapHead(K, num_deconv_layers=2, deconv_filters=(8, 6),
                              deconv_kernels=(kernel, kernel))
    port = heads.HeatmapHead(12, K, num_deconv_layers=2,
                             deconv_filters=(8, 6),
                             deconv_kernels=(kernel, kernel))
    assert port.deconv0.crop == (kernel == 3)
    _compare_head(jmod, port, x, seed=10 + kernel)
    assert port(_t(x))["heatmaps"].shape == (2, 20, 16, K)


@pytest.mark.parametrize("kernel,stride,want", [
    (1, 2, (0, 1, 0)), (2, 2, (0, 0, 0)), (3, 2, (0, 0, 1)),
    (4, 2, (1, 0, 0)), (5, 3, (1, 0, 0))])
def test_same_transpose_padding(kernel, stride, want):
    """(padding, output_padding, crop) from lax's SAME rule."""
    assert same_transpose_padding(kernel, stride) == want


def test_fused_head_matches_jax():
    """FusedHead: the heatmaps, the pooled regression coords and the
    offset-refined coords; its two ConvNorms' statistics."""
    x = _features(2)
    _compare_head(jheads.FusedHead(K), heads.FusedHead(16, K), x, seed=20)


@pytest.mark.parametrize("split", [2.0, 1.5])
def test_simcc_head_matches_jax(split):
    """SimCCHead at input (W, H) = (24, 32): x bins W x split, y bins
    H x split, each keypoint's map flattened in (H, W) order; and its
    decode (softmax expectation / split, min of the two peaks)."""
    x = _features(3)
    jmod = jheads.SimCCHead(K, (24, 32), split)
    port = heads.SimCCHead(16, K, (24, 32), split)
    assert heads.feature_size((24, 32)) == (8, 6)
    assert port.fc_x.out_features == int(24 * split)
    assert port.fc_y.out_features == int(32 * split)
    _compare_head(jmod, port, x, seed=30)
    rng = np.random.RandomState(4)
    sx = rng.randn(3, K, int(24 * split)).astype(np.float32) * 3
    sy = rng.randn(3, K, int(32 * split)).astype(np.float32) * 3
    coords, scores = heads.SimCCHead.decode(_t(sx), _t(sy), split)
    jc, js = jheads.SimCCHead.decode(jnp.asarray(sx), jnp.asarray(sy), split)
    np.testing.assert_allclose(coords.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("head", ["simcc", "fused"])
def test_decode_outputs_matches_jax(head):
    """``decode_outputs`` of the SimCC head (its decode at the default
    split) and of the fused head (its heatmaps by the decode method)."""
    rng = np.random.RandomState(5)
    if head == "simcc":
        outputs = {"simcc_x": rng.randn(2, K, 48), "simcc_y": rng.randn(
            2, K, 64)}
    else:
        outputs = {"heatmaps": rng.rand(2, 16, 12, K) + np.eye(16, 12)[
            None, :, :, None], "coords": rng.rand(2, K, 2)}
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    for method in ("quarter", "taylor"):
        c, s = pose_estimator.decode_outputs(
            {k: _t(v) for k, v in outputs.items()}, head, method)
        jc, js = jpe.decode_outputs(
            {k: jnp.asarray(v) for k, v in outputs.items()}, head, method)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)


def test_new_layers_seeded_init():
    """``init_weights`` draws flax's initialisers for the new layers:
    lecun-normal Dense layers (truncated at 2 std, variance 1 / fan-in),
    normal 0.001 transposed convs and prediction convs with zero bias,
    kaiming fan-out depthwise convs and the spatial-attention conv (its
    bias zero), normal 0.02 position embeddings."""
    from infantposeestimation_gaussianbias_tpu_torch.models.litehrnet import (
        DWSeparableBlock,
    )

    mods = torch.nn.ModuleDict({
        "fused": heads.FusedHead(64, 17),
        "simcc": heads.SimCCHead(64, 17, (192, 256)),
        "deconv": heads.HeatmapHead(64, 17, num_deconv_layers=1),
        "dw": DWSeparableBlock(96, 96),
        "cbam": attention.CBAM(256),
        "neck": attention.TransformerNeck(64, (16, 12))})
    init_weights(mods, seed=0)

    def std(w):
        return w.float().std().item()

    fc = mods["simcc"].fc_x.weight
    assert std(fc) == pytest.approx((1 / fc.shape[1]) ** 0.5, rel=0.05)
    assert fc.abs().max().item() <= 2 * (1 / fc.shape[1]) ** 0.5 / 0.8796
    assert not mods["simcc"].fc_x.bias.any()
    assert std(mods["deconv"].deconv0.weight) == pytest.approx(1e-3, rel=0.05)
    assert std(mods["fused"].hm.weight) == pytest.approx(1e-3, rel=0.1)
    dw = mods["dw"].dw.weight  # fan-out C x 9
    assert std(dw) == pytest.approx((2 / (96 * 9)) ** 0.5, rel=0.1)
    sa = mods["cbam"].sa.conv
    assert std(sa.weight) == pytest.approx((2 / 49) ** 0.5, rel=0.25)
    assert not sa.bias.any()
    assert std(mods["neck"].pos_embed) == pytest.approx(0.02, rel=0.05)
    assert std(mods["neck"].attn_0.query.weight) == pytest.approx(
        (1 / 64) ** 0.5, rel=0.1)


# -- losses and decodes ---------------------------------------------------------

def _loss_inputs(seed, B=3, h=16, w=12):
    """Predicted and target maps (positive, with peaks), weights with
    zeros, coords in [0, 1], SimCC logits and input-pixel keypoints."""
    rng = np.random.RandomState(seed)
    pred = rng.rand(B, h, w, K) * 0.3
    target = rng.rand(B, h, w, K) * 0.1
    for b in range(B):
        for k in range(K):
            target[b, rng.randint(h), rng.randint(w), k] += 1.0
            pred[b, rng.randint(h), rng.randint(w), k] += 0.8
    return {k: np.asarray(v, np.float32) for k, v in {
        "pred": pred, "target": target,
        "weight": rng.choice([0.0, 1.0, 2.0], (B, K)),
        "coords": rng.rand(B, K, 2), "refined": rng.rand(B, K, 2),
        "tcoords": rng.rand(B, K, 2),
        "simcc_x": rng.randn(B, K, 2 * w * 4) * 2,
        "simcc_y": rng.randn(B, K, 2 * h * 4) * 2,
        "kpts": rng.uniform(-2, 50, (B, K, 2))}.items()}


def _jax_losses(d):
    """Every loss of the file's tests on the JAX side, one jitted call."""
    p, t, wt = d["pred"], d["target"], d["weight"]
    out = {}
    for lt in ("mse", "smoothl1"):
        out[f"fused_pose {lt}"] = jlosses.fused_pose_loss(p, t, wt, lt)
        out[f"fused_pose {lt} unweighted"] = jlosses.fused_pose_loss(
            p, t, None, lt)
    out["stats mean"], out["stats var"] = jlosses.spatial_statistics(p)
    out["morph"] = jlosses.morphology_shape_loss(p, t, wt, 0.7, 0.3)
    out["morph unweighted"] = jlosses.morphology_shape_loss(p, t)
    for lt in ("smoothl1", "l1", "mse"):
        out[f"offset {lt}"] = jlosses.offset_regression_loss(
            d["coords"] * 3, d["tcoords"], wt, lt)
    out["joints"] = jlosses.joints_mse_loss(p, t, wt)
    out["joints unweighted"] = jlosses.joints_mse_loss(p, t, wt, False)
    preds = {"heatmaps": p, "coords": d["coords"],
             "refined_coords": d["refined"]}
    tgts = {"heatmaps": t, "weights": wt, "coords": d["tcoords"]}

    def total(preds):
        return jlosses.combined_loss(preds, tgts, 0.2, 0.9, 0.4, 0.6)

    (_, terms), grads = jax.value_and_grad(total, has_aux=True)(preds)
    out["combined"], out["combined grads"] = terms, grads
    out["combined no coords"] = jlosses.combined_loss(
        {"heatmaps": p}, {"heatmaps": t, "weights": wt})[1]
    out["simcc"] = jstep.simcc_loss(
        {"simcc_x": d["simcc_x"], "simcc_y": d["simcc_y"]}, d["kpts"], wt,
        (48, 64), 2.0, sigma=4.0)
    return out


@pytest.fixture(scope="module")
def jax_losses():
    d = _loss_inputs(6)
    out = jax.jit(_jax_losses)(jax.tree_util.tree_map(jnp.asarray, d))
    return d, jax.tree_util.tree_map(np.asarray, out)


def test_morphology_terms_match_jax(jax_losses):
    """Each Stack-B term: the per-pixel MSE / SmoothL1 (weighted or not),
    the spatial statistics, the morphology shape loss (non-default
    lambdas), the coordinate regression (SmoothL1, L1, MSE) and the
    per-joint 0.5 MSE (with and without the target weights)."""
    d, ref = jax_losses
    p, t, wt = _t(d["pred"]), _t(d["target"]), _t(d["weight"])
    got = {}
    for lt in ("mse", "smoothl1"):
        got[f"fused_pose {lt}"] = losses.fused_pose_loss(p, t, wt, lt)
        got[f"fused_pose {lt} unweighted"] = losses.fused_pose_loss(
            p, t, None, lt)
    got["stats mean"], got["stats var"] = losses.spatial_statistics(p)
    got["morph"] = losses.morphology_shape_loss(p, t, wt, 0.7, 0.3)
    got["morph unweighted"] = losses.morphology_shape_loss(p, t)
    for lt in ("smoothl1", "l1", "mse"):
        got[f"offset {lt}"] = losses.offset_regression_loss(
            _t(d["coords"]) * 3, _t(d["tcoords"]), wt, lt)
    got["joints"] = losses.joints_mse_loss(p, t, wt)
    got["joints unweighted"] = losses.joints_mse_loss(p, t, wt, False)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)


def test_combined_loss_matches_jax(jax_losses):
    """combined_loss with the fused head's coords (every term, the total
    and its gradient with respect to each prediction) and without them
    (heatmap and morph terms only)."""
    d, ref = jax_losses
    preds = {"heatmaps": _t(d["pred"]), "coords": _t(d["coords"]),
             "refined_coords": _t(d["refined"])}
    for v in preds.values():
        v.requires_grad_(True)
    tgts = {"heatmaps": _t(d["target"]), "weights": _t(d["weight"]),
            "coords": _t(d["tcoords"])}
    total, terms = losses.combined_loss(preds, tgts, 0.2, 0.9, 0.4, 0.6)
    assert set(terms) == {"heatmap", "morph", "regression", "refined",
                          "total"}
    for k, v in terms.items():
        np.testing.assert_allclose(v.item(), ref["combined"][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    total.backward()
    for k, v in preds.items():
        _close(v.grad.numpy(), ref["combined grads"][k], name=k)
    _, terms = losses.combined_loss({"heatmaps": _t(d["pred"])}, {
        "heatmaps": _t(d["target"]), "weights": _t(d["weight"])})
    assert set(terms) == set(ref["combined no coords"]) == {
        "heatmap", "morph", "total"}
    for k, v in terms.items():
        np.testing.assert_allclose(v.item(), ref["combined no coords"][k],
                                   rtol=LOSS_RTOL, err_msg=k)


def test_simcc_loss_matches_jax(jax_losses):
    """The SimCC loss: Gaussian 1-D targets (sigma 4 bins) against each
    axis's log-softmax, weighted over the keypoints, some keypoints off
    the input."""
    d, ref = jax_losses
    got = simcc_loss({"simcc_x": _t(d["simcc_x"]),
                      "simcc_y": _t(d["simcc_y"])}, _t(d["kpts"]),
                     _t(d["weight"]), 2.0, sigma=4.0)
    np.testing.assert_allclose(got.item(), ref["simcc"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("adaptive", [True, False])
def test_fused_alpha_decode_matches_jax(adaptive):
    """Taylor heatmap coords scaled to the image, blended with the
    regression coords (alpha 0.3, or maxval / (maxval + 0.1) where
    adaptive); without regression coords, the scaled heatmap coords."""
    d = _loss_inputs(7)
    hm, reg = d["pred"], d["coords"]
    for r in (reg, None):
        c, m = decode.fused_alpha_decode(
            _t(hm), None if r is None else _t(r), alpha=0.3,
            image_size=192.0, adaptive=adaptive)
        jc, jm = jdecode.fused_alpha_decode(
            jnp.asarray(hm), None if r is None else jnp.asarray(r),
            alpha=0.3, image_size=192.0, adaptive=adaptive)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-4)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


# -- attention add-ons ------------------------------------------------------------

def _compare_attention(jmod, port, x, seed):
    """Output and the gradient of sum(out * r) with respect to the input
    and every parameter."""
    v = _variables(jmod, x, seed)
    sd = attention_state_from_jax(v["params"])
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd, strict=True)
    xt = _t(x).requires_grad_(True)
    out = port(xt)
    r = np.random.RandomState(seed + 1).randn(*x.shape).astype(np.float32)

    @jax.jit
    def ref(p, x):
        def loss(p, x):
            y = jmod.apply({"params": p}, x)
            return jnp.sum(y * r), y
        return jax.grad(loss, (0, 1), has_aux=True)(p, x)

    (gp, gx), y = ref(v["params"], jnp.asarray(x))
    _close(out.detach().numpy(), y)
    (out * _t(r)).sum().backward()
    _close(xt.grad.numpy(), gx, name="dx")
    want = attention_state_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    for name, p in port.named_parameters():
        if name.endswith("key.bias"):
            # softmax is blind to a shift shared by every key: this
            # gradient is 0 but for rounding in both frameworks
            scale = np.abs(want[name.replace("key", "query")].numpy()).max()
            assert p.grad.abs().max().item() <= 1e-4 * scale, name
            continue
        _close(p.grad.numpy(), want[name], name=name)


def test_cbam_matches_jax():
    """CBAM (reduction 4): the channel gate's shared MLP on the average
    and max pools, then the 7x7 spatial gate with its bias."""
    _compare_attention(jatt.CBAM(reduction=4), attention.CBAM(16, 4),
                       _features(8), seed=40)


def test_transformer_neck_matches_jax():
    """TransformerNeck (2 layers, 4 heads, MLP ratio 2) on 8 x 6 x 16
    features: flax's LayerNorm eps 1e-6, tanh GELU, biased q/k/v/out
    projections, queries scaled by 1/sqrt(head dim), the position
    embedding of the 48 tokens."""
    _compare_attention(jatt.TransformerNeck(num_layers=2, num_heads=4),
                       attention.TransformerNeck(16, (8, 6), 2, 4),
                       _features(9), seed=50)
