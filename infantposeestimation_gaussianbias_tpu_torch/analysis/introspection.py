"""Model introspection and quantitative analysis.

Port of infantposeestimation_gaussianbias_tpu/analysis/introspection.py
(itself a rebuild of the reference's hook-based suites,
nn_quantitative_viz.py and advanced_analysis.py): parameter counts (total
and per layer), weight and gradient statistics, activations captured with
forward hooks keyed by module name, activation statistics with dead
channels, error distributions, confidence calibration, input-gradient
saliency, occlusion sensitivity, Grad-CAM on the backbone's features and
DropPath (MC) uncertainty.

The functions take the port's ``PoseEstimator`` (a torch module) where the
JAX ones take a flax model and its variables; images and maps keep the
JAX package's NHWC layout (the port's models are NHWC throughout:
heatmaps (B, H, W, K), backbone features (B, H, W, C)).  Each runs on the
device the model's parameters lie on, in eval mode (``train=False``)
unless it says otherwise, and gives the model back in the mode it had.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import frozen_batch_stats
from ..train.step import draw_drop_masks

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def _named(params: Params) -> Iterator[tuple]:
    if isinstance(params, nn.Module):
        return iter(params.named_parameters())
    return iter(params.items())


def _numpy64(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy().ravel()


@contextlib.contextmanager
def _mode(model: nn.Module, train: bool) -> Iterator[None]:
    """``model`` in train or eval mode inside the block, its own after."""
    was = model.training
    model.train(train)
    try:
        yield
    finally:
        model.train(was)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _image(model: nn.Module, x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=_device(model))


# -- parameters (ref nn_quantitative_viz.py:545-600) -----------------------

def count_parameters(params: Params) -> int:
    return sum(int(v.numel()) for _, v in _named(params))


def per_layer_parameters(params: Params) -> Dict[str, int]:
    return {name: int(v.numel()) for name, v in _named(params)}


def parameter_summary(params: Params, top: int = 20) -> str:
    per = per_layer_parameters(params)
    total = sum(per.values())
    lines = [f"total parameters: {total / 1e6:.2f}M ({total:,})"]
    for name, n in sorted(per.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {n / 1e6:7.3f}M  {name}")
    return "\n".join(lines)


# -- weights (ref advanced_analysis.py:153-312, WeightAnalyzer) -------------

def weight_statistics(model: nn.Module,
                      sparsity_levels=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
                      ) -> Dict:
    """Weight-distribution statistics over the conv and linear weights (the
    JAX package's flax ``kernel`` leaves; torch also names BatchNorm's and
    LayerNorm's scale ``weight``, so the filter is by module type): overall
    mean/std, per-layer mean/std/min/max, sparsity ratios at log-spaced
    thresholds, and normal Q-Q pairs of every n-th weight
    (``scipy.stats.probplot`` semantics).  The Q-Q sample depends on the
    order and layout of the weights, so it differs from the JAX package's;
    the rest does not."""
    from scipy import stats as sstats

    per_layer = {}
    chunks = []
    for name, module in model.named_modules():
        if not isinstance(module, (nn.Conv2d, nn.Linear)):
            continue
        w = _numpy64(module.weight)
        per_layer[f"{name}.weight"] = {
            "mean": float(w.mean()), "std": float(w.std()),
            "min": float(w.min()), "max": float(w.max()), "n": int(w.size)}
        chunks.append(w)
    allw = np.concatenate(chunks) if chunks else np.zeros(1)
    sample = np.sort(allw[:: max(1, len(allw) // 10_000)])
    osm, osr = sstats.probplot(sample, dist="norm", fit=False)
    slope, intercept, r = sstats.linregress(osm, osr)[:3]
    return {
        "overall": {"mean": float(allw.mean()), "std": float(allw.std()),
                    "n": int(allw.size)},
        "per_layer": per_layer,
        "sparsity": {float(t): float((np.abs(allw) < t).mean())
                     for t in sparsity_levels},
        "qq": {"theoretical": osm, "ordered": osr,
               "slope": float(slope), "intercept": float(intercept),
               "r": float(r)},
    }


def gradient_statistics(grads: Params) -> Dict[str, Dict]:
    """Per-parameter gradient mean/std/min/max/norm (ref
    advanced_analysis.py:249-312): from a name -> gradient mapping, or from
    a module's ``.grad`` (parameters without one are left out)."""
    if isinstance(grads, nn.Module):
        grads = {n: p.grad for n, p in grads.named_parameters()
                 if p.grad is not None}
    out = {}
    for name, value in grads.items():
        g = _numpy64(value)
        out[name] = {"mean": float(g.mean()), "std": float(g.std()),
                     "min": float(g.min()), "max": float(g.max()),
                     "norm": float(np.linalg.norm(g))}
    return out


# -- activations (ref advanced_analysis.py:15-151) --------------------------

def _record(out: dict, name: str, value) -> None:
    if isinstance(value, torch.Tensor):
        out[name] = value.detach().float().cpu().numpy()
    elif isinstance(value, dict):
        for k, v in value.items():
            _record(out, f"{name}/{k}", v)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _record(out, f"{name}/{i}", v)


def capture_activations(model: nn.Module, x,
                        filter_fn: Optional[Callable[[str, nn.Module],
                                                     bool]] = None
                        ) -> Dict[str, np.ndarray]:
    """Every submodule's output on NHWC images x (eval mode, no gradient),
    by forward hooks keyed by the module's name (``name/key`` for a dict
    output, ``name/i`` for a list); ``filter_fn(name, module)`` picks the
    modules.  The counterpart of flax ``capture_intermediates``."""
    acts: Dict[str, np.ndarray] = {}
    hooks = []
    for name, module in model.named_modules():
        if name and (filter_fn is None or filter_fn(name, module)):
            hooks.append(module.register_forward_hook(
                lambda m, args, out, name=name: _record(acts, name, out)))
    try:
        with _mode(model, False), torch.no_grad():
            model(_image(model, x))
    finally:
        for h in hooks:
            h.remove()
    return acts


def activation_statistics(acts: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """Mean/std/sparsity per captured activation; for a 4-D map the
    'dead' fraction is the share of channels that never activate.  The
    port's maps are NHWC, as the JAX package's, so channels are the last
    axis and the maximum runs over (0, 1, 2)."""
    stats = {}
    for name, a in acts.items():
        a = np.asarray(a, np.float32)
        entry = {
            "mean": float(a.mean()),
            "std": float(a.std()),
            "sparsity": float((a == 0).mean()),
            "shape": tuple(a.shape),
        }
        if a.ndim == 4:  # NHWC: dead channels
            dead = a.max(axis=(0, 1, 2)) <= 0
            entry["dead_channel_fraction"] = float(dead.mean())
        stats[name] = entry
    return stats


# -- prediction quality (ref nn_quantitative_viz.py:64-255) ----------------

def error_distribution(pred: np.ndarray, gt: np.ndarray,
                       mask: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-keypoint pixel-error statistics."""
    err = np.linalg.norm(pred - gt, axis=-1)  # (B, K)
    valid = mask > 0
    per_kpt_mean = np.array([
        err[:, k][valid[:, k]].mean() if valid[:, k].any() else np.nan
        for k in range(err.shape[1])])
    return {
        "errors": err,
        "per_keypoint_mean": per_kpt_mean,
        "overall_mean": float(err[valid].mean()) if valid.any() else np.nan,
        "overall_median": float(np.median(err[valid])) if valid.any()
        else np.nan,
    }


def confidence_calibration(scores: np.ndarray, correct: np.ndarray,
                           bins: int = 10) -> Dict[str, np.ndarray]:
    """Reliability curve: accuracy within confidence bins, and the ECE."""
    edges = np.linspace(0, 1, bins + 1)
    accs, confs, weights = [], [], []
    s, c = scores.reshape(-1), correct.reshape(-1)
    for i in range(bins):
        sel = (s >= edges[i]) & (s < edges[i + 1] + (i == bins - 1))
        if sel.any():
            accs.append(float(c[sel].mean()))
            confs.append(float(s[sel].mean()))
            weights.append(sel.mean())
        else:
            accs.append(np.nan)
            confs.append((edges[i] + edges[i + 1]) / 2)
            weights.append(0.0)
    accs_a = np.asarray(accs)
    confs_a = np.asarray(confs)
    w = np.asarray(weights)
    valid = ~np.isnan(accs_a)
    ece = float(np.sum(w[valid] * np.abs(accs_a[valid] - confs_a[valid])))
    return {"bin_accuracy": accs_a, "bin_confidence": confs_a,
            "bin_weight": w, "ece": ece}


# -- sensitivity (ref advanced_analysis.py:313-429) -------------------------

# Occluded images per forward in occlusion_sensitivity.
OCCLUSION_BATCH = 16

def _peak(heatmaps: torch.Tensor, keypoint: int) -> torch.Tensor:
    """Largest activation of one keypoint's map per image, (B,)."""
    return heatmaps[..., keypoint].float().amax(dim=(1, 2))


def saliency_map(model: nn.Module, x, keypoint: int) -> np.ndarray:
    """|d max-heatmap-activation / d input| per pixel of one (H, W, 3)
    image, the largest over the colour channels: (H, W)."""
    img = _image(model, x).requires_grad_()
    with _mode(model, False), torch.enable_grad():
        score = _peak(model(img[None])["heatmaps"], keypoint)[0]
        (g,) = torch.autograd.grad(score, img)
    return g.abs().amax(dim=-1).cpu().numpy()


def occlusion_sensitivity(model: nn.Module, x, keypoint: int,
                          patch: int = 16, stride: int = 16) -> np.ndarray:
    """Drop of the keypoint's peak when a zero patch slides over the (H, W,
    3) image, one score per patch position; the occluded images run
    ``OCCLUSION_BATCH`` at a time (eval mode: each image on its own)."""
    img = _image(model, x)
    H, W = img.shape[:2]
    hs = list(range(0, H - patch + 1, stride))
    ws = list(range(0, W - patch + 1, stride))
    occluded = img[None].repeat(len(hs) * len(ws), 1, 1, 1)
    for n, (y, xx) in enumerate((y, xx) for y in hs for xx in ws):
        occluded[n, y:y + patch, xx:xx + patch, :] = 0.0
    with _mode(model, False), torch.no_grad():
        base = _peak(model(img[None])["heatmaps"], keypoint)
        scores = torch.cat([
            _peak(model(occluded[i:i + OCCLUSION_BATCH])["heatmaps"],
                  keypoint)
            for i in range(0, len(occluded), OCCLUSION_BATCH)])
    sens = (base - scores).double().cpu().numpy()
    return sens.reshape(len(hs), len(ws))


def grad_cam(model: nn.Module, x, keypoint: int) -> np.ndarray:
    """Grad-CAM over the backbone's features: relu(sum_c w_c F_c), w the
    spatial mean of d score / d F, normalised to a peak of 1 (ref
    nn_quantitative_viz.py:358-457); (H', W') at the feature stride.  The
    model splits at ``model.backbone`` and ``model.head``; the features
    are NHWC."""
    img = _image(model, x)
    with _mode(model, False):
        with torch.no_grad():
            feats = model.backbone(img[None])
        f = feats.detach().requires_grad_()
        with torch.enable_grad():
            score = _peak(model.head(f)["heatmaps"], keypoint)[0]
            (g,) = torch.autograd.grad(score, f)
    w = g.float().mean(dim=(1, 2), keepdim=True)  # (1, 1, 1, C)
    cam = torch.relu((w * feats.float()).sum(dim=-1))[0]
    cam = cam / (cam.max() + 1e-8)
    return cam.cpu().numpy()


def mc_droppath_uncertainty(model: nn.Module, x, generator: torch.Generator,
                            n_samples: int = 10) -> Dict[str, np.ndarray]:
    """MC uncertainty by stochastic depth: ``n_samples`` train-mode
    forwards of the NHWC batch x, each with DropPath masks drawn from the
    caller's ``generator``, mean and std of the heatmaps.  BatchNorm
    normalises with the batch's statistics, as in training, but its
    running statistics stay as they were (the JAX function discards the
    updated ``batch_stats``).  The masks cannot match the JAX package's
    draws: compare distributions, or pass the same masks to both."""
    xs = _image(model, x)
    outs = []
    with _mode(model, True), frozen_batch_stats(), torch.no_grad():
        for _ in range(n_samples):
            masks = draw_drop_masks(model, xs.shape[0], generator,
                                    xs.device)
            outs.append(model(xs, masks)["heatmaps"].float().cpu().numpy())
    stack = np.stack(outs)
    return {"mean": stack.mean(0), "std": stack.std(0)}
