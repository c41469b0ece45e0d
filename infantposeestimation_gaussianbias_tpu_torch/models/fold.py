"""BN-fold float serving: inference BatchNorm baked into the conv before it.

Port of infantposeestimation_gaussianbias_tpu/models/fold.py
(``fold_batchnorm`` lives in ops/quant.py, as in the JAX package).  At
inference a BatchNorm is a per-channel affine (a, b), so

    bn(conv(x, W)) = conv(x, W * a) + b

with ``a = weight * rsqrt(running_var + 1e-5)`` and
``b = bias - running_mean * a`` in float32, the affine the port's eval
BatchNorm applies (models/layers.py).  Folding removes the BatchNorm's
elementwise pass from every served conv.

Serving flow, as in the JAX package:

    sd     = model.state_dict()                 # float, trained
    folded = build_model(cfg, fold=True)        # biased convs, no norms
    folded.load_state_dict(fold_state_dict(sd))

A folded model keeps every name of the unfolded one: each folded norm is
an ``nn.Identity`` in its place and its conv gains a ``bias``.  Every
BatchNorm of the port's models follows a bias-free conv (the JAX
package's ConvNorm), so every BatchNorm folds; GroupNorm holds no running
statistics and never folds.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import torch

from ..ops.quant import fold_batchnorm

_BN_STATE = ("weight", "bias", "running_mean", "running_var",
             "num_batches_tracked")


def _conv_of(norm: str) -> str:
    """The conv that a BatchNorm follows, by the reference's names: entry
    ``n`` of a Sequential follows entry ``n - 1``; ``bnN`` follows
    ``convN``."""
    head, _, last = norm.rpartition(".")
    prefix = f"{head}." if head else ""
    if last.isdigit() and int(last) > 0:
        return f"{prefix}{int(last) - 1}"
    m = re.fullmatch(r"bn(\d)", last)
    if m:
        return f"{prefix}conv{m.group(1)}"
    raise KeyError(f"no conv before the BatchNorm {norm!r}")


def convnorm_pairs(state_dict: Mapping[str, torch.Tensor]
                   ) -> List[Tuple[str, str]]:
    """(conv, BatchNorm) module names of every conv + BatchNorm pair of a
    state dict, in key order: the pairs ``fold_state_dict`` folds."""
    pairs = []
    for key in state_dict:
        if not key.endswith(".running_var"):
            continue
        norm = key[: -len(".running_var")]
        conv = _conv_of(norm)
        w = state_dict.get(f"{conv}.weight")
        if w is None or w.dim() != 4:
            raise KeyError(f"no conv weight {conv}.weight before {norm!r}")
        if f"{conv}.bias" in state_dict:
            raise KeyError(f"{conv} has a bias; a folded pair's conv has "
                           "none")
        pairs.append((conv, norm))
    return pairs


def fold_state_dict(state_dict: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """State dict of a float model -> that of ``build_model(cfg,
    fold=True)``: each conv + BatchNorm pair becomes the conv with weight
    ``W * a`` and bias ``b`` (float32, on the weight's device), the
    BatchNorm's entries dropped.  Every other entry passes through, so a
    folded state dict folds to itself."""
    out = dict(state_dict)
    for conv, norm in convnorm_pairs(state_dict):
        a, b = fold_batchnorm(*(state_dict[f"{norm}.{k}"]
                                for k in _BN_STATE[:4]))
        w = state_dict[f"{conv}.weight"]
        out[f"{conv}.weight"] = w.float() * a.to(w.device)[:, None, None,
                                                           None]
        out[f"{conv}.bias"] = b.to(w.device)
        for k in _BN_STATE:
            out.pop(f"{norm}.{k}", None)
    return out
