"""PyTorch port, LiteHRNet and the heads it trains: the litehrnet backbone
with each head (heatmap, fusion, fused, simcc), the ``lightweight`` named
config, one train step per head and ``train_state_from_jax`` against the
JAX package on the CPU, on the same numpy inputs and weights; serving.

The model is the real ``litehrnet`` (24/48/96 channels) at a small,
non-square input of 48 x 64 (W x H; heatmaps 12 x 16), so that an (x, y)
or (W, H) mix-up shows.  Seeded numpy weights on each head's
``jax.eval_shape`` tree (tests/torch_tiny.py ``random_variables``) go
JAX -> ``state_dict_from_jax`` -> the port.  The JAX side is one jitted
reference function (the eval forward on the served crops and
their mirror images, and the train step's forward, loss terms, gradients
and BatchNorm statistics on one batch, JAX's own ``make_loss_fn`` on
JAX's own targets), for all four heads on one backbone's weights (see
``_jax_reference``), compiled in a thread beside the ``lightweight``
forward, once for the file.

Tolerances (float32 on both sides; only summation orders differ): the
forward OUT_TOL of each tensor's largest magnitude plus OUT_TOL relative
(the HRNet tests' rule), loss terms LOSS_RTOL relative, BatchNorm
statistics 1e-5 + 1e-4 relative, each head layer's gradient HEAD_GRAD_RTOL
of its norm, and the whole gradient vector WHOLE_GRAD_RTOL of its norm:
as HRNet's, a ReLU input within rounding of 0 in one framework moves
every gradient below it (tests/test_torch_hrnet.py says how much).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.config import get_config as jget_config
from infantposeestimation_gaussianbias_tpu.config import get_variant as jget_variant
from infantposeestimation_gaussianbias_tpu.models import heads as jheads
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.ops import decode as jdecode
from infantposeestimation_gaussianbias_tpu.ops import heatmap as jheatmap
from infantposeestimation_gaussianbias_tpu.train import optim as joptim
from infantposeestimation_gaussianbias_tpu.train import step as jstep
from infantposeestimation_gaussianbias_tpu_torch import (Config, PoseInference,
                                                          create_train_state,
                                                          get_variant,
                                                          make_train_step)
from infantposeestimation_gaussianbias_tpu_torch.models import litehrnet
from infantposeestimation_gaussianbias_tpu_torch.models import pose_estimator
from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
    BatchNorm,
)
from infantposeestimation_gaussianbias_tpu_torch.ops import affine, decode
from infantposeestimation_gaussianbias_tpu_torch.train import (
    optax_global_norm,
)
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    state_dict_from_jax,
    train_state_from_jax,
)
from tests import torch_tiny
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

HEADS = ("heatmap", "fusion", "fused", "simcc")
W, H = 48, 64            # input (W, H)
HM_W, HM_H = 12, 16      # stride-4 heatmaps
OUT_TOL = 1e-4
LOSS_RTOL = 1e-4
HEAD_GRAD_RTOL = 1e-4
WHOLE_GRAD_RTOL = 2e-2
STAT_TOL = (1e-5, 1e-4)  # atol, rtol
# each head's layers above every ReLU, whose gradients are compared tightly
HEAD_LAYERS = {
    "heatmap": ("head.final_layer.weight", "head.final_layer.bias"),
    "fusion": ("head.heatmap_branch.3.weight", "head.offset_branch.3.weight",
               "head.variance_branch.3.weight", "head.fusion_weight",
               "head.subpixel_refine.alpha"),
    "fused": ("head.reg_fc.weight", "head.reg_fc.bias",
              "head.refine_final.weight", "head.refine_final.bias"),
    "simcc": ("head.fc_x.weight", "head.fc_x.bias", "head.fc_y.weight",
              "head.fc_y.bias"),
}
LIGHT = 192  # the lightweight config's input side

_t = torch_tiny.t


def _cfg(cfg, head):
    cfg.model.backbone = "litehrnet"
    cfg.model.head_type = head
    cfg.model.hidden_dim = 16
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = (W, H)
    cfg.data.heatmap_size = (HM_W, HM_H)
    cfg.train.warmup_epochs = 0
    return cfg


def _port(cfg, variables):
    model = pose_estimator.build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]),
                          strict=True)
    return model


def _close(got, want, tol=OUT_TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _batch(seed, B=4):
    rng = np.random.RandomState(seed)
    kpts = (rng.uniform(-4, 1, (B, 17, 2)) + rng.uniform(0, 1, (B, 17, 2))
            * np.array([W + 4, H + 4])).astype(np.float32)
    vis = rng.choice([0, 1, 2], (B, 17), p=[0.1, 0.2, 0.7]).astype(
        np.float32)
    return {"image": rng.randn(B, H, W, 3).astype(np.float32),
            "keypoints": kpts, "visible": vis}


def _frames_and_boxes():
    rng = np.random.RandomState(9)
    frames = rng.randint(0, 256, (3, 90, 80, 3)).astype(np.uint8)
    bboxes = np.array([[5, 5, 70, 85], [0, 0, 80, 90], [20, 10, 60, 70]],
                      np.float32)
    return frames, bboxes


def _centers_scales(cfg, bboxes):
    return ((bboxes[:, :2] + bboxes[:, 2:]) / 2,
            (bboxes[:, 2:] - bboxes[:, :2]) * cfg.data.bbox_padding)


def _served_crops(cfg):
    """The port's normalised crops of the served frames (the crop itself is
    held against JAX in the serving tests)."""
    frames, bboxes = _frames_and_boxes()
    centers, scales = _centers_scales(cfg, bboxes)
    with torch.no_grad():
        return affine.crop_and_normalize(_t(frames), _t(centers),
                                          _t(scales), (W, H)).numpy()


def _apply_part(jm, part, params, stats, x, train):
    """``jm``'s backbone or head alone (PoseEstimator.__call__ is the one
    after the other): (outputs, its new BatchNorm statistics in train
    mode)."""
    variables = {"params": {part: params}, "batch_stats": {part: stats}}
    fn = lambda m, x, t: getattr(m, part)(x, t)  # noqa: E731
    if not train:
        return jm.apply(variables, x, False, method=fn), stats
    out, mutated = jm.apply(variables, x, True, method=fn,
                            mutable=["batch_stats"])
    return out, mutated["batch_stats"].get(part, {})


def _jax_reference(refs):
    """One jitted JAX function for every head: ``refs`` maps a head to its
    (JAX cfg, JAX model); every model has the same backbone weights.  (
    backbone params, stats, {head: (params, stats)}, crops, batch) ->
    {head: (eval outputs on the crops and, after them, their mirror
    images; train outputs on the batch's images; the new BatchNorm
    statistics; the loss terms; the gradients)}.  The backbone runs once
    per mode and its backward once, vmapped over the heads' feature
    gradients: the same numbers as each model's own train step, for one
    backbone's compile."""
    jm = next(iter(refs.values()))[1]
    jcfg = next(iter(refs.values()))[0]
    loss_fns = {h: jstep.make_loss_fn(c, c.data.keypoint_schema)
                for h, (c, _) in refs.items()}

    @jax.jit
    def ref(bb_params, bb_stats, heads, crops, batch):
        both = jnp.concatenate([crops, crops[:, :, ::-1]])
        feats_eval, _ = _apply_part(jm, "backbone", bb_params, bb_stats,
                                    both, False)
        feats, bb_vjp, new_bb = jax.vjp(
            lambda p: _apply_part(jm, "backbone", p, bb_stats,
                                  batch["image"], True), bb_params,
            has_aux=True)
        target, weight = jheatmap.generate_targets(
            batch["keypoints"], batch["visible"],
            tuple(jcfg.data.heatmap_size), tuple(jcfg.data.input_size),
            jcfg.data.sigma, "msra")
        out, feat_grads = {}, []
        for h, (params, stats) in heads.items():
            m = refs[h][1]

            def head_loss(f, p):
                o, new = _apply_part(m, "head", p, stats, f, True)
                loss, terms = loss_fns[h](o, batch, target, weight)
                return loss, (terms, o, new)

            (_, (terms, train_out, new_head)), (g_f, g_p) = (
                jax.value_and_grad(head_loss, (0, 1), has_aux=True)(
                    feats, params))
            eval_out, _ = _apply_part(m, "head", params, stats, feats_eval,
                                      False)
            feat_grads.append(g_f)
            out[h] = [eval_out, train_out,
                      {"backbone": new_bb, "head": new_head}, terms,
                      {"head": g_p}]
        (bb_grads,) = jax.vmap(bb_vjp)(jnp.stack(feat_grads))
        for i, h in enumerate(heads):
            out[h][4]["backbone"] = jax.tree_util.tree_map(
                lambda g: g[i], bb_grads)
        return out

    return ref


@pytest.fixture(scope="module")
def models():
    """{head: (port cfg, JAX cfg, JAX model, JAX variables as numpy,
    JAX reference results as numpy)}, every head on one backbone's seeded
    weights, and under "lightweight" the lightweight config's (variables,
    input, JAX heatmaps): the two JAX functions compiled in threads at
    once."""
    out = {}
    for i, head in enumerate(HEADS):
        jcfg = _cfg(jget_config(), head)
        jm = jpe.build_model(jcfg)
        v = torch_tiny.random_variables(jm, seed=10 + i, shape=(H, W))
        if i:  # the first head's backbone
            first = out[HEADS[0]][3]
            v = {k: {"backbone": first[k]["backbone"],
                     "head": v[k].get("head", {})} for k in v}
        if head == "fused":
            # non-negative maps, as a trained head's: the morphology term
            # normalises each map by its sum, and random weights put sums
            # near 0, where that division scales rounding up without bound
            v["params"]["head"]["hm"]["bias"][...] = 2.0
        out[head] = (_cfg(Config(), head), jcfg, jm, v)
    lcfg = jget_variant("lightweight")
    lcfg.model.compute_dtype = "float32"
    lm = jpe.build_model(lcfg)
    lv = torch_tiny.random_variables(lm, seed=20, shape=(LIGHT, LIGHT))
    lx = np.random.RandomState(4).randn(1, LIGHT, LIGHT, 3).astype(
        np.float32)
    v0 = out[HEADS[0]][3]
    numpy = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    with ThreadPoolExecutor(2) as pool:
        light = pool.submit(
            jax.jit(lambda v, x: lm.apply(v, x, False)["heatmaps"]), lv,
            jnp.asarray(lx))
        refs = _jax_reference({h: out[h][1:3] for h in HEADS})(
            v0["params"]["backbone"], v0["batch_stats"]["backbone"],
            {h: (out[h][3]["params"]["head"],
                 out[h][3]["batch_stats"].get("head", {})) for h in HEADS},
            jnp.asarray(_served_crops(out[HEADS[0]][0])),
            jax.tree_util.tree_map(jnp.asarray, _batch(7)))
        for head in HEADS:
            out[head] += (numpy(refs[head]),)
        out["lightweight"] = (lv, lx, numpy(light.result()))
    return out


# -- the backbone and the heads -----------------------------------------------

@pytest.mark.parametrize("head", HEADS)
def test_state_dict_loads_strict(models, head):
    """Every converted leaf has a port name and shape: the LiteHRNet blocks
    (the depthwise kernels kept as convs, not as an HRFormer block's
    Dense), the transitions and fuse layers by HRNet's rules, the head's
    leaves by the flax paths."""
    cfg, _, _, v, _ = models[head]
    sd = state_dict_from_jax(v["params"], v["batch_stats"])
    model = pose_estimator.build_model(cfg, device="cpu")
    assert isinstance(model.backbone, litehrnet.LiteHRNet)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    dw = "backbone.stage3.1.branches.2.1.dw.weight"
    assert sd[dw].shape == (96, 1, 3, 3)
    assert sd["backbone.stage3.0.fuse_layers.2.0.1.pw.weight"].shape == (
        96, 24, 1, 1)
    assert sd["backbone.stage3.0.fuse_layers.0.2.0.weight"].shape == (
        24, 96, 1, 1)
    assert sd["backbone.transition2.2.0.0.weight"].shape == (96, 48, 3, 3)
    kernel = v["params"]["backbone"]["stage3_module1"]["branch2_block1"][
        "dw"]["kernel"]
    np.testing.assert_array_equal(sd[dw].numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    if head == "simcc":
        assert sd["head.fc_x.weight"].shape == (W * 2, HM_W * HM_H)
        assert sd["head.fc_y.weight"].shape == (H * 2, HM_W * HM_H)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("head", HEADS)
def test_forward_matches_jax(models, head, train):
    """Every output of the forward: in eval mode on the served crops, in
    train mode (batch statistics) on the train batch's images, then also
    every BatchNorm's running statistics."""
    cfg, _, _, v, (eval_out, train_out, new_stats, _, _) = models[head]
    port = _port(cfg, v)
    port.train(train)
    x = _batch(7)["image"] if train else _served_crops(cfg)
    with torch.no_grad():
        out = port(_t(x))
    n = len(x)
    ref = train_out if train else {k: v[:n] if v.ndim else v
                                   for k, v in eval_out.items()}
    assert set(out) == set(ref)
    for key in ref:
        assert out[key].shape == ref[key].shape, key
        _close(out[key].detach().numpy(), ref[key], name=key)
    if train:
        want = state_dict_from_jax(v["params"], new_stats)
        n = 0
        for name, buf in port.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                           atol=STAT_TOL[0],
                                           rtol=STAT_TOL[1], err_msg=name)
                n += 1
        assert n == 2 * sum(isinstance(m, BatchNorm)
                            for m in port.modules())


def test_lightweight_forward_matches_jax(models):
    """``get_variant("lightweight")``: litehrnet + heatmap head at its
    192 x 192 input and 48 x 48 heatmaps (float32 on both sides here; the
    config computes in bf16), one crop, eval mode."""
    cfg = get_variant("lightweight")
    assert (cfg.model.backbone, cfg.model.head_type) == ("litehrnet",
                                                         "heatmap")
    assert tuple(cfg.data.input_size) == (LIGHT, LIGHT)
    cfg.model.compute_dtype = "float32"
    lv, lx, ref = models["lightweight"]
    with torch.no_grad():
        hm = _port(cfg, lv)(_t(lx))["heatmaps"]
    assert hm.shape == (1, 48, 48, 17)
    _close(hm.numpy(), ref)


def test_lightweight_serves_on_cpu():
    """PoseInference(get_variant("lightweight")) as configured (bf16,
    flip test, quarter decode): LiteHRNet does not fold, so it serves
    unfolded, as in the JAX package; BN-fold and int8 raise."""
    cfg = get_variant("lightweight")
    inf = PoseInference(cfg, device="cpu")
    assert inf.fold is False
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (3, 90, 70, 3)).astype(np.uint8)
    boxes = np.array([[0, 0, 70, 90], [5, 10, 60, 80], [10, 5, 50, 70]],
                     np.float32)
    kpts, scores = inf.predict_batch(frames, boxes)
    assert kpts.shape == (3, 17, 2) and scores.shape == (3, 17)
    assert np.isfinite(kpts).all() and np.isfinite(scores).all()
    with pytest.raises(ValueError, match="BN-fold"):
        PoseInference(cfg, device="cpu", fold=True)
    with pytest.raises(ValueError, match="int8 PTQ"):
        PoseInference(cfg, device="cpu", quantize=True)


# -- serving -------------------------------------------------------------------

def _unsure(port, cfg):
    """(B, K) keypoints whose quarter decode of the port's flip-averaged
    heatmaps of the served crops sits on a tie that a rounding may break
    either way: a runner-up within 1e-5 of the peak, or a neighbour
    difference within 1e-5 of 0 (the sign of the quarter shift)."""
    crops = _t(_served_crops(cfg))
    with torch.no_grad():
        hm = port.model(crops)["heatmaps"]
        hm = (hm + decode.flip_heatmaps(port.model(torch.flip(crops, [2]))[
            "heatmaps"], port._flip_index)) * 0.5
    B, h, w, K = hm.shape
    top2 = hm.permute(0, 3, 1, 2).reshape(B, K, h * w).topk(2, dim=-1).values
    coords, _ = decode.argmax_decode(hm)
    xi, yi = coords[..., 0].long(), coords[..., 1].long()
    g = decode._gather_hm
    dx = g(hm, xi + 1, yi) - g(hm, xi - 1, yi)
    dy = g(hm, xi, yi + 1) - g(hm, xi, yi - 1)
    return ((top2[..., 0] - top2[..., 1] < 1e-5) | (dx.abs() < 1e-5)
            | (dy.abs() < 1e-5)).numpy()


@pytest.mark.parametrize("head", ["heatmap", "fused"])
def test_predict_batch_matches_jax(models, head):
    """The heatmap and fused heads, served whole (crop -> flip-tested
    forward -> quarter decode -> back-projection; 3 frames padded to a
    bucket of 4) against the JAX package's serving pipeline on the same
    crops: its ``flip_inference`` on the JAX forward of the crops and their
    mirror images, the heatmap stride, ``transform_preds``.  Keypoints off
    a decode tie to 1e-3 px."""
    cfg, jcfg, _, v, (eval_out, *_) = models[head]
    frames, bboxes = _frames_and_boxes()
    n = len(frames)
    passes = iter([{k: x[:n] if x.ndim else x for k, x in eval_out.items()},
                   {k: x[n:] if x.ndim else x for k, x in eval_out.items()}])
    coords, ref_s = jpe.flip_inference(
        lambda *_: jax.tree_util.tree_map(jnp.asarray, next(passes)), None,
        jnp.zeros((n, H, W, 3)), jnp.asarray(jcfg.data.keypoint_schema.flip_index()), head,
        jcfg.eval.decode)
    centers, scales = _centers_scales(cfg, bboxes)
    ref_k = np.asarray(jdecode.transform_preds(
        coords * jnp.asarray([W / HM_W, H / HM_H]), jnp.asarray(centers),
        jnp.asarray(scales), (W, H)))
    port = PoseInference(cfg, state_dict=state_dict_from_jax(
        v["params"], v["batch_stats"]), device="cpu")
    assert port.fold is False
    kpts, scores = port.predict_batch(frames, bboxes)
    keep = ~_unsure(port, cfg)
    assert keep.sum() >= keep.size // 2
    np.testing.assert_allclose(kpts[keep], ref_k[keep], atol=1e-3)
    np.testing.assert_allclose(scores, ref_s, rtol=1e-5, atol=1e-4)


def test_simcc_serves_without_flip(models):
    """The SimCC head: the flip test raises in both packages (there are no
    heatmaps: a KeyError in JAX, a ValueError here); served with
    ``eval.flip_test`` off, its keypoints are the JAX model's SimCC decode
    of the same crops, back-projected from input pixels (the JAX
    PoseInference also multiplies them by the heatmap stride first, which
    the port does not: ``models.to_input_pixels``)."""
    cfg, _, _, v, (eval_out, *_) = models["simcc"]
    frames, bboxes = _frames_and_boxes()
    port = PoseInference(cfg, state_dict=state_dict_from_jax(
        v["params"], v["batch_stats"]), device="cpu")
    with pytest.raises(ValueError, match="simcc"):
        port.predict_batch(frames, bboxes)
    with pytest.raises(KeyError):
        jpe.flip_inference(lambda *_: eval_out, None, jnp.zeros((3, H, W, 3)),
                           jnp.arange(17), "simcc")
    assert pose_estimator.to_input_pixels(cfg) == (1.0, 1.0)
    cfg.eval.flip_test = False
    try:
        kpts, scores = port.predict_batch(frames, bboxes)
    finally:
        cfg.eval.flip_test = True
    centers, scales = _centers_scales(cfg, bboxes)
    n = len(frames)
    coords, ref_s = jheads.SimCCHead.decode(
        jnp.asarray(eval_out["simcc_x"][:n]),
        jnp.asarray(eval_out["simcc_y"][:n]))
    ref_k = jdecode.transform_preds(coords, jnp.asarray(centers),
                                    jnp.asarray(scales), (W, H))
    np.testing.assert_allclose(kpts, np.asarray(ref_k), atol=1e-3)
    np.testing.assert_allclose(scores, np.asarray(ref_s), atol=1e-5)


# -- training ------------------------------------------------------------------

@pytest.mark.parametrize("head", HEADS)
def test_train_step_matches_jax(models, head):
    """One train step of each head against JAX's forward, loss and
    gradient on the same batch: every loss term (the fused head's
    ``heatmap``, ``morph``, ``regression``, ``refined``; the SimCC head's
    ``simcc_loss``) and grad_norm, the head layers' gradients, the whole
    gradient vector, and the BatchNorm statistics; see the module doc for
    the tolerances."""
    cfg, _, _, v, (_, _, new_stats, terms, jgrads) = models[head]
    state = create_train_state(cfg, device="cpu", state_dict=state_dict_from_jax(
        v["params"], v["batch_stats"]))
    _, metrics = make_train_step(cfg)(
        state, {k: _t(x) for k, x in _batch(7).items()}, None)
    assert set(metrics) == set(terms) | {"grad_norm"}
    for k in terms:
        np.testing.assert_allclose(metrics[k].item(), terms[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    j_grads = state_dict_from_jax(jgrads, {})
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               optax_global_norm(list(j_grads.values())).item(),
                               rtol=1e-3)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    assert set(grads) == set(j_grads)
    for n in HEAD_LAYERS[head]:
        err = (grads[n] - j_grads[n]).norm().item()
        assert err <= HEAD_GRAD_RTOL * j_grads[n].norm().item(), (n, err)
    diff = torch.cat([(grads[n] - j_grads[n]).flatten() for n in grads])
    ref = torch.cat([j_grads[n].flatten() for n in grads])
    assert diff.norm().item() <= WHOLE_GRAD_RTOL * ref.norm().item()
    j_stats = state_dict_from_jax(v["params"], new_stats)
    for name, buf in state.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), j_stats[name].numpy(),
                                       atol=STAT_TOL[0], rtol=STAT_TOL[1],
                                       err_msg=name)


@pytest.mark.parametrize("head", ["fused", "simcc"])
def test_train_state_from_jax(models, head):
    """A JAX TrainState carried across whole: parameters and statistics
    (strict load), Adam's moments (seeded, non-zero) and count, and the
    step, each converted as the parameters are (the depthwise kernels and
    the head's Dense layers among them)."""
    cfg, jcfg, _, v, _ = models[head]
    tx, _ = joptim.build_optimizer(jcfg, jcfg.train.steps_per_epoch or 1000)
    opt_state = jax.tree_util.tree_map(np.asarray, tx.init(v["params"]))
    rng = np.random.RandomState(8)
    mu = jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), v["params"])
    nu = jax.tree_util.tree_map(
        lambda a: rng.rand(*a.shape).astype(np.float32), v["params"])
    opt_state = (opt_state[0]._replace(count=np.int32(3), mu=mu, nu=nu),
                 *opt_state[1:])
    state = train_state_from_jax(cfg, v["params"], v["batch_stats"],
                                 opt_state, np.int32(3), device="cpu")
    assert state.step == 3
    params = state_dict_from_jax(v["params"], v["batch_stats"])
    mu, nu = state_dict_from_jax(mu, {}), state_dict_from_jax(nu, {})
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), params[name], atol=0, rtol=0)
        st = state.optimizer.state[p]
        torch.testing.assert_close(st["exp_avg"], mu[name], atol=0, rtol=0)
        torch.testing.assert_close(st["exp_avg_sq"], nu[name], atol=0,
                                   rtol=0)
        assert st["step"].item() == 3.0
    dense = "head.fc_x.weight" if head == "simcc" else "head.reg_fc.weight"
    assert params[dense].dim() == 2
