"""PyTorch port, training slice: targets, losses, train-mode BatchNorm,
DropPath, schedule, optimizers and the whole ``make_train_step`` against
the JAX package on the CPU, on the same numpy inputs and weights.

The whole-step tests register a tiny HRFormer (drop-path 0) in both
packages' ``BACKBONES`` (test-only); the port's seeded weights go to JAX
through the JAX package's own importer (``convert_checkpoint``), and one
jitted JAX train step is shared per module.
"""

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu import losses as jlosses
from infantposeestimation_gaussianbias_tpu.config import get_variant
from infantposeestimation_gaussianbias_tpu.models import hrformer as jhr
from infantposeestimation_gaussianbias_tpu.models import layers as jlayers
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.ops import decode as jdecode
from infantposeestimation_gaussianbias_tpu.ops import heatmap as jheatmap
from infantposeestimation_gaussianbias_tpu.ops import photometric as jphoto
from infantposeestimation_gaussianbias_tpu.tools.import_torch_checkpoint import (
    convert_checkpoint,
)
from infantposeestimation_gaussianbias_tpu.train import optim as joptim
from infantposeestimation_gaussianbias_tpu.train import step as jstep
from infantposeestimation_gaussianbias_tpu.train.state import (
    TrainState as JTrainState,
)
from infantposeestimation_gaussianbias_tpu_torch import config, losses, parallel
from infantposeestimation_gaussianbias_tpu_torch.models import hrformer
from infantposeestimation_gaussianbias_tpu_torch.models import pose_estimator
from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
    BatchNorm,
    drop_path,
)
from infantposeestimation_gaussianbias_tpu_torch.ops import decode
from infantposeestimation_gaussianbias_tpu_torch.ops import heatmap
from infantposeestimation_gaussianbias_tpu_torch.train import (
    build_optimizer,
    create_train_state,
    draw_drop_masks,
    make_eval_step,
    make_loss_fn,
    make_lr_schedule,
    make_train_step,
    weight_decay_mask,
)
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    state_dict_from_jax,
    train_state_from_jax,
)

from tests import torch_grid
from tests.torch_jitter import jax_jitter_draws
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(channels=(8, 16, 32, 64), num_heads=(1, 2, 4, 8),
            stage_modules=(1, 1, 1))
SKELETON = np.asarray(get_variant("hrformer_base").data.keypoint_schema
                      .skeleton_array())
# Float32 on both sides, on the CPU; only summation orders and XLA's
# fusions differ.  Single loss reductions agree to ~1e-6 relative.
LOSS_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _peaked_maps(seed, B=2, H=16, W=12, K=17):
    rng = np.random.RandomState(seed)
    hm = rng.randn(B, H, W, K).astype(np.float32) * 0.3
    ys, xs = rng.randint(0, H, (B, K)), rng.randint(0, W, (B, K))
    hm[np.arange(B)[:, None], ys, xs, np.arange(K)[None]] += 3.0
    off = rng.randn(B, H, W, K, 2).astype(np.float32)
    var = np.abs(rng.randn(B, H, W, K)).astype(np.float32) + 0.5
    return hm, off, var


def _keypoints(seed, B, K, W, H, margin=8):
    """Keypoints over the input and a margin around it, visibility with
    some 0s: some targets fall wholly or partly off the map."""
    rng = np.random.RandomState(seed)
    kpts = np.stack([rng.uniform(-margin, W + margin, (B, K)),
                     rng.uniform(-margin, H + margin, (B, K))], -1)
    kpts[0, :4] = [[-40, 5], [W + 30, 10], [5, -40], [W - 1, H + 1]]
    vis = rng.choice([0, 1, 2], (B, K), p=[0.15, 0.15, 0.7])
    vis[0, :4] = 2
    return kpts.astype(np.float32), vis.astype(np.float32)


# -- targets, decode and losses on identical inputs --------------------------

@pytest.mark.parametrize("mode", ["msra", "exact"])
def test_generate_targets_matches_jax(mode):
    kpts, vis = _keypoints(0, 3, 17, 48, 64)
    tg, wt = heatmap.generate_targets(_t(kpts), _t(vis), (12, 16), (48, 64),
                                      2.0, mode)
    jtg, jwt = jheatmap.generate_targets(jnp.asarray(kpts), jnp.asarray(vis),
                                         (12, 16), (48, 64), 2.0, mode)
    assert tg.shape == (3, 16, 12, 17) and tg.dtype == torch.float32
    assert wt.shape == (3, 17) and wt.dtype == torch.float32
    np.testing.assert_allclose(tg.numpy(), np.asarray(jtg), atol=1e-6)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(jwt))
    assert (wt[0, :3] == 0).all() and (wt.numpy() == 0).any()


def test_soft_argmax_and_sampling_gradients_match_jax():
    """The decode functions the loss differentiates through carry the same
    gradients as JAX's: soft_argmax (beta 1) w.r.t. the heatmaps and
    sample_at_coords w.r.t. the maps and the coordinates."""
    hm, off, _ = _peaked_maps(1)
    rng = np.random.RandomState(2)
    cw = rng.randn(2, 17, 2).astype(np.float32)
    coords = rng.uniform(-1, 13, (2, 17, 2)).astype(np.float32)
    sw = rng.randn(2, 17, 2).astype(np.float32)

    def j_loss(h, o, c):
        xy, _ = jdecode.soft_argmax(h, beta=1.0)
        return (jnp.sum(xy * cw)
                + jnp.sum(jdecode.sample_at_coords(o, c) * sw))

    jg = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(hm), jnp.asarray(off),
                                            jnp.asarray(coords))
    th, to, tc = (_t(a).requires_grad_() for a in (hm, off, coords))
    xy, _ = decode.soft_argmax(th, beta=1.0)
    loss = (xy * _t(cw)).sum() + (decode.sample_at_coords(to, tc)
                                  * _t(sw)).sum()
    loss.backward()
    for got, want in zip((th.grad, to.grad, tc.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


TERMS = ["heatmap_loss", "offset_loss", "peak_loss", "variance_loss",
         "overlap_loss", "shape_loss", "total_loss"]


@pytest.mark.parametrize("use_weight", [True, False])
@pytest.mark.parametrize("term", TERMS)
def test_fusion_loss_term_and_grads_match_jax(term, use_weight):
    """Each weighted term, and its gradients w.r.t. heatmaps, offsets and
    variances, against JAX's jax.grad of the same term."""
    hm, off, var = _peaked_maps(3)
    kpts, vis = _keypoints(4, 2, 17, 48, 64)
    tgt, wt = (np.asarray(a) for a in jheatmap.generate_targets(
        jnp.asarray(kpts), jnp.asarray(vis), (12, 16), (48, 64), 2.0, "msra"))
    kw = dict(input_size=(48, 64), weights=(1.0, 1.0, 0.5, 0.1, 0.05, 0.05),
              target_sigma=2.0, use_target_weight=use_weight)

    def j_term(h, o, v):
        out = {"heatmaps": h, "offsets": o, "variances": v}
        return jlosses.fusion_pose_loss(out, jnp.asarray(tgt),
                                        jnp.asarray(wt), jnp.asarray(kpts),
                                        jnp.asarray(SKELETON), **kw)[term]

    args = tuple(jnp.asarray(a) for a in (hm, off, var))
    j_val, j_grads = jax.value_and_grad(j_term, argnums=(0, 1, 2))(*args)
    th, to, tv = (_t(a).requires_grad_() for a in (hm, off, var))
    terms = losses.fusion_pose_loss(
        {"heatmaps": th, "offsets": to, "variances": tv}, _t(tgt), _t(wt),
        _t(kpts), torch.from_numpy(SKELETON).long(), **kw)
    assert set(terms) == set(TERMS)
    assert all(v.dtype == torch.float32 for v in terms.values())
    np.testing.assert_allclose(terms[term].item(), float(j_val),
                               rtol=LOSS_RTOL, atol=1e-7)
    terms[term].backward()
    for got, want in zip((th.grad, to.grad, tv.grad), j_grads):
        got = np.zeros(want.shape, np.float32) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6,
                                   rtol=1e-4)


@pytest.mark.parametrize("use_weight", [True, False])
def test_keypoint_mse_loss_matches_jax(use_weight):
    hm, _, var = _peaked_maps(5)
    wt = np.random.RandomState(6).choice([0.0, 1.0, 2.0], (2, 17)).astype(
        np.float32)
    got = losses.keypoint_mse_loss(_t(hm), _t(var), _t(wt), use_weight)
    want = jlosses.keypoint_mse_loss(jnp.asarray(hm), jnp.asarray(var),
                                     jnp.asarray(wt), use_weight)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


def test_loss_fn_heads_match_jax():
    """make_loss_fn of every head with a loss of its own against the JAX
    step's: the heatmap head's weighted MSE, the fused head's combined
    Stack-B loss (keypoints normalised by the input size; its terms
    renamed as the JAX step does) and the SimCC head's loss (sigma
    ``data.sigma`` x the split ratio), every term."""
    hm, _, var = _peaked_maps(7)
    kpts, _ = _keypoints(8, 2, 17, 192, 256)
    wt = np.random.RandomState(9).choice([0.0, 2.0], (2, 17)).astype(
        np.float32)
    rng = np.random.RandomState(10)
    outputs = {
        "heatmap": {"heatmaps": hm},
        # non-negative maps: the morphology term normalises each by its sum
        "fused": {"heatmaps": np.abs(hm), "coords": rng.rand(2, 17, 2),
                  "refined_coords": rng.rand(2, 17, 2)},
        "simcc": {"simcc_x": rng.randn(2, 17, 384) * 2,
                  "simcc_y": rng.randn(2, 17, 512) * 2}}
    want_terms = {"heatmap": {"heatmap_loss"},
                  "fused": {"heatmap", "morph", "regression", "refined"},
                  "simcc": {"simcc_loss"}}
    assert config.get_variant("hrnet_w32").model.head_type == "heatmap"
    for head, out in outputs.items():
        out = {k: v.astype(np.float32) for k, v in out.items()}
        cfg = config.get_variant("hrnet_w32")
        jcfg = get_variant("hrnet_w32")
        cfg.model.head_type = jcfg.model.head_type = head
        loss, terms = make_loss_fn(cfg)(
            {k: _t(v) for k, v in out.items()}, {"keypoints": _t(kpts)},
            _t(var), _t(wt))
        jloss, jterms = jstep.make_loss_fn(jcfg, jcfg.data.keypoint_schema)(
            {k: jnp.asarray(v) for k, v in out.items()},
            {"keypoints": jnp.asarray(kpts)}, jnp.asarray(var),
            jnp.asarray(wt))
        assert set(terms) == set(jterms) == want_terms[head] | {"total_loss"}
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
        for k in jterms:
            np.testing.assert_allclose(terms[k].item(), float(jterms[k]),
                                       rtol=LOSS_RTOL, err_msg=f"{head} {k}")


# -- train-mode BatchNorm and DropPath ----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax(dtype):
    """Batch statistics with the biased variance, the running-stat update
    0.9 * running + 0.1 * batch, and the float32 affine cast back to the
    input dtype; the input gradient too."""
    rng = np.random.RandomState(7)
    x = (rng.randn(3, 5, 4, 6) * 2 + 1).astype(np.float32)
    scale = rng.rand(6).astype(np.float32) + 0.5
    bias = rng.randn(6).astype(np.float32)
    mean0 = rng.randn(6).astype(np.float32) * 0.1
    var0 = rng.rand(6).astype(np.float32) + 0.5
    gy = rng.randn(*x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    bn = jlayers.BatchNorm()
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}

    def j_apply(xx):
        return bn.apply(variables, xx, True, mutable=["batch_stats"])

    (jy, jstats), vjp = jax.vjp(j_apply, jnp.asarray(x).astype(jdt))
    (jgx,) = vjp((jnp.asarray(gy).astype(jdt),
                  jax.tree_util.tree_map(jnp.zeros_like, jstats)))

    tbn = BatchNorm(6).train()
    with torch.no_grad():
        tbn.weight.copy_(_t(scale))
        tbn.bias.copy_(_t(bias))
        tbn.running_mean.copy_(_t(mean0))
        tbn.running_var.copy_(_t(var0))
    tx = _t(x).to(tdt).requires_grad_()
    ty = tbn(tx)
    ty.backward(_t(gy).to(tdt))
    assert ty.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ty.float().detach().numpy(),
                               np.asarray(jy, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(jgx, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(jstats["batch_stats"]["mean"]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(jstats["batch_stats"]["var"]),
                               atol=1e-6, rtol=1e-6)


def test_drop_path_scales_kept_samples():
    """Kept samples are scaled by 1 / (1 - rate), dropped ones zeroed, as
    the JAX DropPath's where(mask, x / keep, 0); bf16 stays bf16."""
    x = torch.from_numpy(np.random.RandomState(8).randn(4, 3, 2, 5).astype(
        np.float32))
    keep = torch.tensor([True, False, True, False])
    y = drop_path(x, keep, 0.2)
    np.testing.assert_allclose(y[0].numpy(), x[0].numpy() / 0.8, rtol=1e-6)
    assert (y[1] == 0).all() and (y[3] == 0).all()
    assert drop_path(x, None, 0.2) is x and drop_path(x, keep, 0.0) is x
    assert drop_path(x.bfloat16(), keep, 0.2).dtype == torch.bfloat16


def test_drop_masks_come_from_the_generator():
    cfg = _tiny_cfg()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(pose_estimator.BACKBONES, "tiny_hrformer",
                   lambda **kw: hrformer.HRFormer(**TINY, drop_path_rate=0.25,
                                                  **kw))
        model = pose_estimator.build_model(cfg, device="cpu")
    a = draw_drop_masks(model, 64, torch.Generator().manual_seed(1))
    b = draw_drop_masks(model, 64, torch.Generator().manual_seed(1))
    # 3 modules with 2, 3 and 4 branches of 2 blocks, 2 drop paths a block
    assert a.shape == (2 * 2 * (2 + 3 + 4), 64) and a.dtype == torch.bool
    assert torch.equal(a, b)
    assert abs(a.float().mean().item() - 0.75) < 0.05
    with pytest.raises(ValueError, match="drop_masks"):
        model.train()(torch.zeros(1, 64, 48, 3))


# -- schedule and optimizers ---------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 5])
def test_lr_schedule_matches_jax(warmup):
    args = (5e-4, 5e-7, warmup, (8, 12), 0.1)
    port, ref = make_lr_schedule(*args), joptim.make_lr_schedule(*args)
    for step in range(16):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-7)
    assert port(0) == pytest.approx(5e-7 if warmup else 5e-4)


def _toy():
    """A Linear, a LayerNorm and a scalar: decayed and undecayed leaves."""
    model = torch.nn.Module()
    model.dense = torch.nn.Linear(3, 4)
    model.norm = torch.nn.LayerNorm(4)
    model.alpha = torch.nn.Parameter(torch.tensor(0.5))
    rng = np.random.RandomState(9)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(_t(np.asarray(rng.randn(*p.shape), np.float32)))
    return model


def _toy_tree(tensors):
    # copies: jnp.asarray may alias a numpy buffer that torch updates in place
    t = {k: v.detach().numpy().copy() for k, v in tensors.items()}
    return {"dense": {"kernel": t["dense.weight"].T, "bias": t["dense.bias"]},
            "norm": {"scale": t["norm.weight"], "bias": t["norm.bias"]},
            "alpha": t["alpha"]}


@pytest.mark.parametrize("name,clip", [("adamw", 0.0), ("adamw", 0.5),
                                       ("adam", 0.0), ("sgd", 0.0),
                                       ("sgd", 0.5)])
def test_optimizers_match_optax(name, clip):
    """Three updates with fixed gradients (the schedule in its warmup) on a
    toy module against the JAX package's optax chain on the same tree."""
    from infantposeestimation_gaussianbias_tpu_torch.train.state import (
        TrainState)

    cfg = config.get_variant("hrformer_base")
    cfg.train.optimizer, cfg.train.grad_clip_norm = name, clip
    cfg.train.warmup_epochs, cfg.train.weight_decay = 1, 0.1
    model = _toy()
    opt, schedule = build_optimizer(cfg, model, steps_per_epoch=4)
    state = TrainState(model, opt, schedule, grad_clip_norm=clip)
    jcfg = get_variant("hrformer_base")
    jcfg.train.optimizer, jcfg.train.grad_clip_norm = name, clip
    jcfg.train.warmup_epochs, jcfg.train.weight_decay = 1, 0.1
    tx, _ = joptim.build_optimizer(jcfg, 4)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    _toy_tree(dict(model.named_parameters())))
    opt_state = tx.init(params)
    rng = np.random.RandomState(10)
    for _ in range(3):
        grads = {n: _t(np.asarray(rng.randn(*p.shape), np.float32))
                 for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        state.apply_gradients()
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, _toy_tree(grads)), opt_state,
            params)
        params = optax.apply_updates(params, updates)
    got = _toy_tree(dict(model.named_parameters()))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-7)
    assert state.step == 3


# -- the whole step on a tiny HRFormer ----------------------------------------

def _tiny_cfg(cfg=None):
    cfg = cfg or config.get_variant("hrformer_base")
    cfg.model.backbone = "tiny_hrformer"
    cfg.model.hidden_dim = 16
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = (48, 64)
    cfg.data.heatmap_size = (12, 16)
    cfg.train.warmup_epochs = 0
    return cfg


def _batch(seed, B=4):
    rng = np.random.RandomState(seed)
    kpts, vis = _keypoints(seed + 1, B, 17, 48, 64)
    return {"image": rng.randn(B, 64, 48, 3).astype(np.float32),
            "keypoints": kpts, "visible": vis}


def _port_state(cfg, variables):
    return create_train_state(cfg, device="cpu", state_dict=state_dict_from_jax(
        variables["params"], variables["batch_stats"]))


def _jax_state(cfg, model, variables):
    tx, _ = joptim.build_optimizer(cfg, cfg.train.steps_per_epoch or 1000)
    return JTrainState.create(
        apply_fn=model.apply,
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]), tx=tx)


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, JAX cfg, JAX model, JAX variables as numpy) with the tiny
    backbone (drop-path 0) registered in both BACKBONES for the module.
    The weights are the port's seeded init with sharper prediction convs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jpe.BACKBONES, "tiny_hrformer", lambda **kw: jhr.HRFormer(
            drop_path_rate=0.0, **TINY, **kw))
        mp.setitem(pose_estimator.BACKBONES, "tiny_hrformer",
                   lambda **kw: hrformer.HRFormer(drop_path_rate=0.0, **TINY,
                                                  **kw))
        cfg, jcfg = _tiny_cfg(), _tiny_cfg(get_variant("hrformer_base"))
        port = pose_estimator.build_model(cfg, device="cpu")
        rng = np.random.RandomState(11)
        with torch.no_grad():
            for final in (port.head.heatmap_branch[3],
                          port.head.offset_branch[3]):
                final.weight.copy_(_t(rng.randn(*final.weight.shape)
                                      .astype(np.float32) * 0.3))
        params, stats = convert_checkpoint(
            {k: v.numpy().copy() for k, v in port.state_dict().items()},
            head_type="fusion")
        yield cfg, jcfg, jpe.build_model(jcfg), {"params": params,
                                                  "batch_stats": stats}


@pytest.fixture(scope="module")
def jax_step(tiny):
    """The jitted JAX train step of the tiny model (no jitter)."""
    _, jcfg, _, _ = tiny
    return jax.jit(jstep.make_train_step(jcfg, jcfg.data.keypoint_schema))


@pytest.fixture(scope="module")
def jax_steps(tiny, jax_step):
    """The JAX step's states and metrics over 3 steps on one batch."""
    _, jcfg, model, variables = tiny
    step = jax_step
    state = _jax_state(jcfg, model, variables)
    batch = jax.tree_util.tree_map(jnp.asarray, _batch(12))
    out = []
    for i in range(3):
        state, metrics = step(state, batch, jax.random.PRNGKey(i))
        out.append((state, jax.tree_util.tree_map(np.asarray, metrics)))
    return out


def _port_grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


def _assert_grads_close(grads, j_grads, grad_norm):
    """Per tensor, |g - g_jax| <= 5e-3 |g_jax| + 1e-7 grad_norm.  The two
    forwards agree to ~1e-6, but where a ReLU input lies that close to 0
    the two masks differ at that element; one such element moves the
    gradients below it by ~1e-3 relative.  The absolute floor covers the
    tensors whose gradient is zero up to rounding (a bias feeding only a
    train-mode BatchNorm)."""
    for n, g in grads.items():
        err = (g - j_grads[n]).norm().item()
        assert err <= 5e-3 * j_grads[n].norm().item() + 1e-7 * grad_norm, (
            n, err, j_grads[n].norm().item())


def _jax_named(tree_params, tree_stats=None):
    """JAX params (and batch stats) -> the port's names, via weights.py."""
    sd = state_dict_from_jax(tree_params, tree_stats or {})
    return {k: v for k, v in sd.items()}


# The same step over a 2 x 2 grid of gloo ranks on the CPU (tests/torch_grid.py
# ``train_rank``): its global batch is _batch(12), so it is held against the
# JAX step above, and its ranks run while that step compiles.

def _grid_drop_masks():
    """DropPath masks (rate 0.2) of the tiny model for a global batch of 4,
    from a seeded generator."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("tiny_hrformer", "tiny_hrformer_dp"):
            mp.setitem(pose_estimator.BACKBONES, name, None)
        torch_grid.register_tiny()
        model = pose_estimator.build_model(
            torch_grid.tiny_cfg("tiny_hrformer_dp"), device="cpu")
        return draw_drop_masks(model, 4, torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def grid_steps(tiny, request):
    """Every rank's results: one grid step of the tiny model, and one of
    the DropPath model (the same weights) with _grid_drop_masks()."""
    _, _, _, variables = tiny
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    with ThreadPoolExecutor(1) as pool:
        out = pool.submit(parallel.run_grid, torch_grid.train_rank, 2, 2,
                          "gloo", device="cpu",
                          args=(sd, _batch(12), _grid_drop_masks().numpy()),
                          timeout=300)
        request.getfixturevalue("jax_steps")
        return out.result()


def test_grid_train_step_matches_jax(tiny, grid_steps, jax_steps):
    """Loss terms and grad_norm (rtol 1e-4), the parameters after the
    update where the gradient is far from 0 (as test_train_step_matches_jax
    below), the global BatchNorm running statistics; every rank's
    parameters and statistics are the same bit for bit, and no rank loaded
    JAX."""
    _, _, _, variables = tiny
    assert all(r["jax_modules"] == [] for r in grid_steps)
    jstate, jmetrics = jax_steps[0]
    first = grid_steps[0]["train"]
    for r in grid_steps[1:]:
        for key in ("params", "buffers"):
            for n, v in r["train"][key].items():
                np.testing.assert_array_equal(v, first[key][n], err_msg=n)
    for k, v in first["metrics"].items():
        np.testing.assert_allclose(v, jmetrics[k], rtol=1e-4, err_msg=k)
    j_grads = _jax_named(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, jstate.opt_state[0].mu))
    j_now = _jax_named(jax.tree_util.tree_map(np.asarray, jstate.params),
                       jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    p0 = _jax_named(variables["params"])
    grad_norm = first["metrics"]["grad_norm"]
    for n, p in first["params"].items():
        g = j_grads[n].numpy()
        big = (np.abs(g) > 1e-2 * np.abs(g).max()) & (
            np.abs(g) > 1e-7 * grad_norm)
        np.testing.assert_allclose((p - p0[n].numpy())[big],
                                   (j_now[n] - p0[n]).numpy()[big],
                                   atol=1e-6, rtol=1e-3, err_msg=n)
    for n, b in first["buffers"].items():
        np.testing.assert_allclose(b, j_now[n].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=n)


def test_grid_train_step_with_drop_path_matches_one_process(tiny, grid_steps):
    """DropPath 0.2 with the same global masks: the grid step (each rank
    its columns) against the port's single-process step on the whole
    batch; the same loss terms, and the same update where the gradient is
    far from 0 (a bias that feeds only a train-mode BatchNorm has a zero
    gradient up to rounding, and AdamW moves it by lr times that noise's
    sign)."""
    _, _, _, variables = tiny
    masks = _grid_drop_masks()
    assert 0 < masks.sum() < masks.numel()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("tiny_hrformer", "tiny_hrformer_dp"):
            mp.setitem(pose_estimator.BACKBONES, name, None)
        torch_grid.register_tiny()
        cfg = torch_grid.tiny_cfg("tiny_hrformer_dp")
        state = _port_state(cfg, variables)
    p0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    _, metrics = make_train_step(cfg)(
        state, {k: _t(v) for k, v in _batch(12).items()}, None,
        drop_masks=masks)
    got = grid_steps[0]["train_dp"]
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v.item(), rtol=1e-5,
                                   err_msg=k)
    grad_norm = metrics["grad_norm"].item()
    for n, p in state.model.named_parameters():
        g = p.grad.numpy()
        big = (np.abs(g) > 1e-2 * np.abs(g).max()) & (
            np.abs(g) > 1e-7 * grad_norm)
        np.testing.assert_allclose((got["params"][n] - p0[n].numpy())[big],
                                   (p.detach() - p0[n]).numpy()[big],
                                   atol=1e-6, rtol=1e-3, err_msg=n)


# Tensor parallelism (cfg.parallel.tensor_parallel) over the same 2 x 2
# grid and batch, three steps (torch_grid.tp_train_rank): against the JAX
# step above, the total loss's bound in test_train_loss_trajectory_matches_jax
# (JAX's own 2 x 4 tensor-parallel step, tests/test_train.py, agrees with
# that step to 5e-3); against the port's one process at lr 1e-5, where
# AdamW's +-lr moves of the weights whose gradient is rounding noise are
# too small to part the runs (at the config's 5e-4 they move grad_norm
# by ~4e-3 in two steps): the terms within 1e-5 relative, grad_norm 1e-4
# (the blocks' squares summed over the model group), the weights within
# 2 lr a step.  AdamW moves a weight by about lr whatever its gradient, so
# the first step's gradients, the blocks assembled, hold the direction:
# each tensor within TP_GRAD_RTOL of its norm plus 1e-7 grad_norm (the
# floor of _assert_grads_close, for the gradients that are rounding noise).
TP_JAX_RTOL = 1e-3
TP_TERM_RTOL, TP_NORM_RTOL, TP_LR = 1e-5, 1e-4, 1e-5
TP_GRAD_RTOL = 1e-5


def test_grid_tp_steps_match_jax(grid_steps, jax_steps):
    """Every loss term of each of the three tensor-parallel steps against
    the JAX step's; the loss falls."""
    got = grid_steps[0]["tp"]["metrics"]
    for g, (_, want) in zip(got, jax_steps):
        for k, v in want.items():
            if k != "grad_norm":
                np.testing.assert_allclose(g[k], v, rtol=TP_JAX_RTOL,
                                           err_msg=k)
    assert got[2]["total_loss"] < got[0]["total_loss"]


def test_grid_tp_steps_match_one_process(tiny, grid_steps):
    """Three tensor-parallel steps at lr 1e-5 against one process's: terms
    and grad_norm each step, the first step's gradients, the weights
    after; every rank reports the same terms and holds the same
    replicated parameters bit for bit."""
    cfg, _, _, variables = tiny
    cfg = _tiny_cfg()
    cfg.train.lr = TP_LR
    state = _port_state(cfg, variables)
    step = make_train_step(cfg)
    batch = {k: _t(v) for k, v in _batch(12).items()}
    want, grads = [], None
    for _ in range(3):
        _, metrics = step(state, batch, None)
        want.append({k: v.item() for k, v in metrics.items()})
        grads = grads or {n: p.grad.clone()
                          for n, p in state.model.named_parameters()}
    first = grid_steps[0]["tp_low"]
    assert first["grads"].keys() == grads.keys()
    for n, g in grads.items():
        err = np.linalg.norm(first["grads"][n] - g.numpy())
        bound = TP_GRAD_RTOL * g.norm().item() + 1e-7 * want[0]["grad_norm"]
        assert err <= bound, (n, err, g.norm().item())
    for g, w in zip(first["metrics"], want):
        for k, v in w.items():
            rtol = TP_NORM_RTOL if k == "grad_norm" else TP_TERM_RTOL
            np.testing.assert_allclose(g[k], v, rtol=rtol, err_msg=k)
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(first["full"][n], p.detach().numpy(),
                                   atol=2 * TP_LR * 3, rtol=0, err_msg=n)
    for r in grid_steps[1:]:
        for run in ("tp", "tp_low"):
            assert r[run]["metrics"] == grid_steps[0][run]["metrics"]
            for n, v in r[run]["replicated"].items():
                np.testing.assert_array_equal(
                    v, grid_steps[0][run]["replicated"][n], err_msg=n)


def test_grid_tp_blocks_and_moments_keep_their_rows(tiny, grid_steps):
    """After the steps every cut weight holds out / 2 rows on its model
    rank and its AdamW moments are blocks of that shape (JAX's
    assert_partitioned): every Dense of the tiny model's 9 branches x 2
    blocks and both shared convs, 74 tensors."""
    _, _, _, variables = tiny
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    for r in grid_steps:
        tp = r["tp"]
        assert len(tp["table"]) == 4 * 2 * (2 + 3 + 4) + 2
        for n, dim in tp["table"].items():
            full = sd[n].shape
            assert dim == 0 and tp["shapes"][n] == (full[0] // 2, *full[1:])
            assert tp["moments"][n] == tp["shapes"][n], n


def test_train_step_matches_jax(tiny, jax_steps):
    """One step: every loss term and grad_norm; every gradient (JAX's from
    AdamW's first moment, mu = 0.1 g); the parameters after the update
    where |g| >> eps; the BatchNorm running statistics."""
    cfg, _, _, variables = tiny
    state = _port_state(cfg, variables)
    p0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    _, metrics = make_train_step(cfg)(
        state, {k: _t(v) for k, v in _batch(12).items()}, None)
    jstate, jmetrics = jax_steps[0]
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), jmetrics[k],
                                   rtol=1e-4, err_msg=k)

    j_grads = _jax_named(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, jstate.opt_state[0].mu))
    j_params = _jax_named(jax.tree_util.tree_map(np.asarray, jstate.params),
                          jax.tree_util.tree_map(np.asarray,
                                                 jstate.batch_stats))
    grads = _port_grads(state.model)
    grad_norm = metrics["grad_norm"].item()
    _assert_grads_close(grads, j_grads, grad_norm)
    for n, p in state.model.named_parameters():
        g = grads[n]
        # AdamW's first step moves a weight by about lr * sign(g): compare
        # where |g| is far above eps (1e-8), above rounding noise and far
        # from a sign flip.
        big = (g.abs() > 1e-2 * g.abs().max()) & (g.abs() > 1e-7 * grad_norm)
        np.testing.assert_allclose((p.detach() - p0[n])[big].numpy(),
                                   (j_params[n] - p0[n])[big].numpy(),
                                   atol=1e-6, rtol=1e-3, err_msg=n)
    for name, buf in state.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), j_params[name].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=name)


def test_train_step_with_jitter_matches_jax(tiny, jax_step, jax_steps):
    """The preemie config's photometric jitter (0.2, 0.2, 0.2) inside the
    port's step, fed JAX's draws for a key, against the JAX step on the
    batch that JAX's own ``color_jitter_normalized`` jittered with that key
    (the JAX step's jitter is the same op on the same image, in the same
    place: after the targets, before the forward).  The bounds of
    test_train_step_matches_jax."""
    cfg, jcfg, model, variables = tiny
    amounts = (0.2, 0.2, 0.2)
    batch = _batch(16)
    key = jax.random.PRNGKey(21)
    jbatch = dict(batch, image=np.asarray(jphoto.color_jitter_normalized(
        key, jnp.asarray(batch["image"]), jcfg.data.pixel_mean,
        jcfg.data.pixel_std, *amounts)))
    # jax_steps' optimizer object: it is a static field of the state, and
    # a new one would compile the jitted step again
    state0 = _jax_state(jcfg, model, variables).replace(
        tx=jax_steps[0][0].tx)
    jstate, jmetrics = jax_step(state0,
                                jax.tree_util.tree_map(jnp.asarray, jbatch),
                                jax.random.PRNGKey(0))
    factors, orders = jax_jitter_draws(key, 4, amounts)
    state = _port_state(cfg, variables)
    cfg.data.color_jitter = amounts
    try:
        step = make_train_step(cfg)
    finally:
        cfg.data.color_jitter = (0.0, 0.0, 0.0)
    _, metrics = step(state, {k: _t(v) for k, v in batch.items()}, None,
                      jitter=(_t(factors), _t(orders)))
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-4, err_msg=k)
    j_grads = _jax_named(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, jstate.opt_state[0].mu))
    _assert_grads_close(_port_grads(state.model), j_grads,
                        metrics["grad_norm"].item())


def test_carried_jax_state_continues_like_jax(tiny, jax_steps):
    """JAX's state after one step (parameters, BatchNorm statistics, AdamW
    moments and count, step) carried across by train_state_from_jax; the
    port's next step against JAX's second step on the same batch: every
    loss term and grad_norm (rtol 1e-4), the first moments (as the
    gradients), the parameters' update (as the gradients), the
    statistics."""
    cfg, _, _, _ = tiny
    as_np = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda x: np.array(x), tree)
    j0, _ = jax_steps[0]
    j1, jmetrics = jax_steps[1]
    state = train_state_from_jax(cfg, as_np(j0.params), as_np(j0.batch_stats),
                                 as_np(j0.opt_state), as_np(j0.step),
                                 device="cpu")
    assert state.step == 1
    mu0 = _jax_named(as_np(j0.opt_state[0].mu))
    for n, p in state.model.named_parameters():
        assert torch.equal(state.optimizer.state[p]["exp_avg"], mu0[n]), n
        assert state.optimizer.state[p]["step"].item() == 1.0
    p0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    _, metrics = make_train_step(cfg)(
        state, {k: _t(v) for k, v in _batch(12).items()}, None)
    assert state.step == 2
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), jmetrics[k],
                                   rtol=1e-4, err_msg=k)
    j_now = _jax_named(as_np(j1.params), as_np(j1.batch_stats))
    j_mu = _jax_named(as_np(j1.opt_state[0].mu))
    grad_norm = metrics["grad_norm"].item()
    # the first moments, 0.9 mu + 0.1 g: as the gradients, per tensor
    _assert_grads_close({n: state.optimizer.state[p]["exp_avg"]
                         for n, p in state.model.named_parameters()},
                        j_mu, grad_norm)
    for n, p in state.model.named_parameters():
        # The second update, lr * mu_hat / sqrt(nu_hat), follows the
        # gradient's value (the first one only its sign), so it differs
        # per element as the gradients do: per tensor, as the gradients.
        # A tensor whose gradient is rounding noise (a bias that feeds only
        # a train-mode BatchNorm) moves by lr times the noise's sign.
        if p.grad.norm().item() < 1e-5 * grad_norm:
            continue
        step, j_step = p.detach() - p0[n], j_now[n] - p0[n]
        err = (step - j_step).norm().item()
        assert err <= 5e-3 * j_step.norm().item(), (n, err)
    for name, buf in state.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), j_now[name].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=name)


def test_train_loss_trajectory_matches_jax(tiny, jax_steps):
    """Total loss over 3 steps on one batch, and it falls."""
    cfg, _, _, variables = tiny
    state = _port_state(cfg, variables)
    step = make_train_step(cfg)
    batch = {k: _t(v) for k, v in _batch(12).items()}
    got = [step(state, batch, None)[1]["total_loss"].item()
           for _ in range(3)]
    want = [float(m["total_loss"]) for _, m in jax_steps]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[2] < got[0]


def test_grad_accum_matches_jax(tiny):
    """grad_accum_steps = 2: per-microbatch BatchNorm updates, float32
    gradient sums averaged, averaged loss terms."""
    cfg, jcfg, model, variables = tiny
    cfg.train.grad_accum_steps = jcfg.train.grad_accum_steps = 2
    try:
        jstate, jmetrics = jax.jit(jstep.make_train_step(
            jcfg, jcfg.data.keypoint_schema))(
                _jax_state(jcfg, model, variables),
                jax.tree_util.tree_map(jnp.asarray, _batch(13)),
                jax.random.PRNGKey(0))
        state = _port_state(cfg, variables)
        _, metrics = make_train_step(cfg)(
            state, {k: _t(v) for k, v in _batch(13).items()}, None)
    finally:
        cfg.train.grad_accum_steps = jcfg.train.grad_accum_steps = 1
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-4, err_msg=k)
    j_grads = _jax_named(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, jstate.opt_state[0].mu))
    _assert_grads_close(_port_grads(state.model), j_grads,
                        metrics["grad_norm"].item())
    j_stats = _jax_named(jax.tree_util.tree_map(np.asarray, jstate.params),
                         jax.tree_util.tree_map(np.asarray,
                                                jstate.batch_stats))
    for name, buf in state.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), j_stats[name].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=name)


def test_eval_step_is_the_eval_forward_and_loss(tiny):
    """The eval step is the eval-mode forward (running statistics; held
    against JAX by test_torch_serving) and the loss (held against JAX
    above), with no update; the model's mode is restored."""
    cfg, _, _, variables = tiny
    state = _port_state(cfg, variables)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch = {k: _t(v) for k, v in _batch(14).items()}
    outputs, terms = make_eval_step(cfg)(state, batch)
    assert state.model.training and state.step == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with torch.no_grad():
        want = state.model.eval()(batch["image"])
        target, weight = heatmap.generate_targets(
            batch["keypoints"], batch["visible"], (12, 16), (48, 64), 2.0)
        _, want_terms = make_loss_fn(cfg)(want, batch, target, weight)
    torch.testing.assert_close(outputs["heatmaps"], want["heatmaps"])
    assert set(terms) == set(TERMS)
    for k in terms:
        torch.testing.assert_close(terms[k], want_terms[k])


def test_weight_decay_mask_matches_jax(tiny):
    """Decay exactly the leaves optax's mask decays (kernels, ndim >= 2),
    mapped to the port's names."""
    cfg, _, _, variables = tiny
    mask = joptim.weight_decay_mask(variables["params"])
    as_arrays = jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, float(m), np.float32), mask,
        variables["params"])
    want = {k: bool(v.flatten()[0] > 0)
            for k, v in _jax_named(as_arrays).items()
            if not k.endswith("relative_position_index")}
    got = weight_decay_mask(pose_estimator.build_model(cfg, device="cpu"))
    assert got == want
    assert sum(got.values()) and not all(got.values())


def test_remat_matches_no_remat(tiny):
    """Checkpointed HRFormerModules (cfg.model.remat) give the same loss,
    gradients and BatchNorm statistics as the plain forward, with DropPath
    on and the same masks: the recomputation reuses the masks and leaves
    the running statistics alone."""
    cfg, _, _, variables = tiny
    batch = {k: _t(v) for k, v in _batch(15).items()}
    results = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(pose_estimator.BACKBONES, "tiny_hrformer",
                   lambda **kw: hrformer.HRFormer(drop_path_rate=0.3, **TINY,
                                                  **kw))
        for remat in (False, True):
            cfg.model.remat = remat
            state = _port_state(cfg, variables)
            assert state.model.backbone.remat is remat
            _, metrics = make_train_step(cfg)(
                state, batch, torch.Generator().manual_seed(16))
            results.append((metrics, _port_grads(state.model),
                            dict(state.model.named_buffers())))
        cfg.model.remat = False
    (m0, g0, b0), (m1, g1, b1) = results
    for k in m0:
        assert m0[k].item() == pytest.approx(m1[k].item(), rel=1e-6), k
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-6, rtol=1e-5)
    for n in b0:
        torch.testing.assert_close(b1[n], b0[n], atol=0, rtol=0)


def test_step_refuses_color_jitter():
    """The step took no jitter before ops/photometric.py was ported and
    refused the preemie config; now it builds for it, and jitters only
    where data.color_jitter asks (the preemie config's is held against
    JAX in test_train_step_with_jitter_matches_jax)."""
    cfg = config.get_variant("preemie")
    assert tuple(cfg.data.color_jitter) == (0.2, 0.2, 0.2)
    assert callable(make_train_step(cfg))
    assert math.isclose(config.get_variant("hrformer_base").data
                        .color_jitter[0], 0.0)
