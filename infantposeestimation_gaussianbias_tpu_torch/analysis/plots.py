"""Quantitative analysis plots.

Port of infantposeestimation_gaussianbias_tpu/analysis/plots.py, the
plotting layer of the reference's nn_quantitative_viz.py
(PerformanceAnalyzer / TrainingAnalyzer): PCK-vs-threshold curves,
per-keypoint accuracy heatmap, error histograms, precision-recall curves,
confidence-calibration plot, training curves, gradient-flow bars, weight
distribution, feature maps and gradient statistics.  All figure-producing,
Agg-backed, on numpy inputs (the port's analysis functions return numpy).

matplotlib is imported by ``_plt()`` when a figure is made, never when the
module is imported: the machine with the card has none, and the analysis
that feeds these plots runs there (cli/analyze.py splits the two).
Layer names are the port's dotted state-dict names
(``introspection.gradient_statistics``, ``per_layer_grad_norms``,
``introspection.weight_statistics``), where the JAX package's are flax
paths joined by "/".
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_pck_curves(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray,
                    norm: np.ndarray,
                    keypoint_names: Optional[Sequence[str]] = None,
                    thresholds: Optional[np.ndarray] = None,
                    out_path: Optional[str] = None):
    """PCK vs threshold, overall + per keypoint."""
    plt = _plt()
    thresholds = (np.linspace(0.02, 0.5, 25) if thresholds is None
                  else thresholds)
    dist = np.linalg.norm(pred - gt, axis=-1) / np.maximum(
        norm[:, None], 1e-8)
    valid = mask > 0
    fig, ax = plt.subplots(figsize=(8, 5))
    overall = [(dist[valid] <= t).mean() for t in thresholds]
    ax.plot(thresholds, overall, "k-", lw=2, label="overall")
    K = pred.shape[1]
    for k in range(K):
        v = valid[:, k]
        if not v.any():
            continue
        curve = [(dist[:, k][v] <= t).mean() for t in thresholds]
        name = keypoint_names[k] if keypoint_names else str(k)
        ax.plot(thresholds, curve, alpha=0.4, label=name)
    ax.set_xlabel("normalized distance threshold")
    ax.set_ylabel("PCK")
    ax.legend(fontsize=6, ncol=3)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_accuracy_heatmap(pck_per_kpt: np.ndarray,
                          keypoint_names: Sequence[str],
                          out_path: Optional[str] = None):
    """Per-keypoint accuracy as a labeled heat strip."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(pck_per_kpt[None, :], vmin=0, vmax=1, cmap="RdYlGn",
                   aspect="auto")
    ax.set_xticks(range(len(keypoint_names)))
    ax.set_xticklabels([n.replace("_", "\n") for n in keypoint_names],
                       fontsize=6)
    ax.set_yticks([])
    for k, v in enumerate(pck_per_kpt):
        ax.text(k, 0, f"{v:.2f}", ha="center", va="center", fontsize=6)
    fig.colorbar(im, ax=ax)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_error_histogram(errors: np.ndarray, mask: np.ndarray,
                         out_path: Optional[str] = None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.hist(errors[mask > 0].ravel(), bins=50)
    ax.set_xlabel("pixel error")
    ax.set_ylabel("count")
    ax.set_title(f"median {np.median(errors[mask > 0]):.2f} px")
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def precision_recall_curve(scores: np.ndarray, correct: np.ndarray):
    """PR points over score-sorted detections. Returns (precision, recall)."""
    order = np.argsort(-scores.ravel())
    c = correct.ravel()[order]
    tp = np.cumsum(c)
    precision = tp / np.arange(1, len(c) + 1)
    recall = tp / max(c.sum(), 1)
    return precision, recall


def plot_pr_curve(scores: np.ndarray, correct: np.ndarray,
                  out_path: Optional[str] = None):
    plt = _plt()
    p, r = precision_recall_curve(scores, correct)
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.plot(r, p)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_ylim(0, 1.05)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_calibration(cal: Dict[str, np.ndarray],
                     out_path: Optional[str] = None):
    """Reliability diagram from introspection.confidence_calibration."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.plot([0, 1], [0, 1], "k--", alpha=0.5)
    ax.bar(cal["bin_confidence"], np.nan_to_num(cal["bin_accuracy"]),
           width=0.08, alpha=0.7)
    ax.set_xlabel("confidence")
    ax.set_ylabel("accuracy")
    ax.set_title(f"ECE = {cal['ece']:.3f}")
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_training_curves(metrics_jsonl: str,
                         keys: Optional[Sequence[str]] = None,
                         out_path: Optional[str] = None):
    """Loss/LR curves from the MetricsWriter JSONL stream
    (TrainingAnalyzer parity, the reference's
    nn_quantitative_viz.py:457-545)."""
    import json

    plt = _plt()
    records: List[Dict] = []
    with open(metrics_jsonl) as f:
        for line in f:
            records.append(json.loads(line))
    if keys is None:
        keys = sorted({k for r in records for k in r
                       if k not in ("step", "time")})
    fig, ax = plt.subplots(figsize=(9, 5))
    for key in keys:
        pts = [(r["step"], r[key]) for r in records if key in r]
        if pts:
            xs, ys = zip(*pts)
            ax.plot(xs, ys, label=key, alpha=0.8)
    ax.set_xlabel("step")
    ax.set_yscale("log")
    ax.legend(fontsize=7)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_gradient_flow(grad_norms: Dict[str, float],
                       out_path: Optional[str] = None,
                       top: int = 40):
    """Per-layer gradient norms (gradient-flow bars)."""
    plt = _plt()
    items = sorted(grad_norms.items(), key=lambda kv: -kv[1])[:top]
    names = [".".join(k.split(".")[-2:]) for k, _ in items]
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar(range(len(items)), [v for _, v in items])
    ax.set_xticks(range(len(items)))
    ax.set_xticklabels(names, rotation=90, fontsize=5)
    ax.set_yscale("log")
    ax.set_ylabel("grad norm")
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def per_layer_grad_norms(grads: Mapping) -> Dict[str, float]:
    """The L2 norm of each gradient of a name -> tensor mapping (e.g. ``{n:
    p.grad for n, p in model.named_parameters()}``), by the same names."""
    return {name: float(np.linalg.norm(g.detach().cpu().double().numpy()))
            for name, g in grads.items()}


def plot_weight_distribution(stats: Dict, out_path: Optional[str] = None):
    """Weight-distribution figure (ref advanced_analysis.py:153-248):
    overall stats, normal Q-Q, per-layer mean+-std errorbars, and the
    sparsity-vs-threshold curve, from introspection.weight_statistics."""
    plt = _plt()
    fig = plt.figure(figsize=(14, 9))
    gs = fig.add_gridspec(2, 2, hspace=0.35, wspace=0.3)

    qq = stats["qq"]
    ax = fig.add_subplot(gs[0, 0])
    ax.plot(qq["theoretical"], qq["ordered"], ".", ms=2, alpha=0.6)
    xs = np.asarray([qq["theoretical"].min(), qq["theoretical"].max()])
    ax.plot(xs, qq["slope"] * xs + qq["intercept"], "r-", lw=1,
            label=f"fit r={qq['r']:.4f}")
    ax.set_xlabel("theoretical normal quantiles")
    ax.set_ylabel("ordered weights")
    ax.set_title("Q-Q plot (normality check)")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)

    ax = fig.add_subplot(gs[0, 1])
    levels = sorted(stats["sparsity"])
    ax.plot(range(len(levels)),
            [100 * stats["sparsity"][t] for t in levels], "o-")
    ax.set_xticks(range(len(levels)))
    ax.set_xticklabels([f"{t:.0e}" for t in levels], rotation=45)
    ax.set_xlabel("|w| threshold")
    ax.set_ylabel("sparsity (%)")
    ax.set_title("weight sparsity")
    ax.grid(alpha=0.3)

    ax = fig.add_subplot(gs[1, :])
    per = stats["per_layer"]
    names = list(per)[:30]
    means = [per[n]["mean"] for n in names]
    stds = [per[n]["std"] for n in names]
    ax.errorbar(range(len(names)), means, yerr=stds, fmt="o-", capsize=3)
    ax.axhline(0, color="r", ls="--", lw=0.8)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels([".".join(n.split(".")[-3:-1]) or n
                        for n in names], rotation=60, ha="right", fontsize=6)
    ax.set_ylabel("weight value")
    ax.set_title("per-layer weight mean +- std")
    ax.grid(alpha=0.3)

    o = stats["overall"]
    fig.suptitle(f"Weight distribution — mean {o['mean']:.2e}, "
                 f"std {o['std']:.2e}, n={o['n']:,}")
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_feature_maps(acts: Dict[str, np.ndarray], layer: str,
                      out_path: Optional[str] = None,
                      max_channels: int = 16, sample: int = 0):
    """Feature-map grid for one captured activation (the reference's
    FeatureVisualizer, nn_quantitative_viz.py:255-358): first
    `max_channels` channels of one sample, each min-max normalized."""
    plt = _plt()
    fm = np.asarray(acts[layer])
    if fm.ndim != 4:
        raise ValueError(f"{layer}: expected (B, H, W, C), got {fm.shape}")
    fm = fm[sample]
    C = min(max_channels, fm.shape[-1])
    cols = int(np.ceil(np.sqrt(C)))
    rows = int(np.ceil(C / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 2 * rows))
    axes = np.atleast_1d(axes).ravel()
    for c in range(C):
        m = fm[..., c]
        span = m.max() - m.min()
        axes[c].imshow((m - m.min()) / (span + 1e-8), cmap="viridis")
        axes[c].set_title(f"ch {c}", fontsize=6)
    for ax in axes:
        ax.axis("off")
    fig.suptitle(f"feature maps: {layer}  {tuple(fm.shape)}", fontsize=9)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_gradient_statistics(gstats: Dict[str, Dict],
                             out_path: Optional[str] = None,
                             top: int = 40):
    """Gradient mean/std/range/norm panels per layer
    (ref advanced_analysis.py:249-312)."""
    plt = _plt()
    names = list(gstats)[:top]
    idx = range(len(names))
    fig, axes = plt.subplots(2, 2, figsize=(13, 8))
    axes[0, 0].bar(idx, [gstats[n]["mean"] for n in names], alpha=0.7)
    axes[0, 0].axhline(0, color="r", ls="--", lw=0.8)
    axes[0, 0].set_title("gradient mean by layer")
    axes[0, 1].bar(idx, [gstats[n]["std"] for n in names], alpha=0.7,
                   color="orange")
    axes[0, 1].set_title("gradient std by layer")
    mins = [gstats[n]["min"] for n in names]
    maxs = [gstats[n]["max"] for n in names]
    axes[1, 0].fill_between(idx, mins, maxs, alpha=0.3)
    axes[1, 0].plot(idx, mins, "b-", lw=0.8, label="min")
    axes[1, 0].plot(idx, maxs, "r-", lw=0.8, label="max")
    axes[1, 0].legend(fontsize=7)
    axes[1, 0].set_title("gradient range by layer")
    norms = [max(gstats[n]["norm"], 1e-20) for n in names]
    axes[1, 1].semilogy(idx, norms, "o-", ms=3)
    axes[1, 1].set_title("gradient norm by layer (log)")
    for ax in axes.flat:
        ax.grid(alpha=0.3)
        ax.set_xlabel("layer index")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
