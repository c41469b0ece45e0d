"""Weights for the port: seeded initialisation and the JAX bridge.

``init_weights`` fills a PoseEstimator from a ``torch.Generator`` with the
JAX package's initialisers (kaiming-normal fan-out convs, among them the
BasicBlocks' and LiteHRNet's depthwise ones; truncated-normal 0.02 Linears
and RPE tables, and flax's default lecun-normal for the Dense layers that
keep it (the fused and SimCC heads', the attention add-ons'); normal 0.001
prediction convs with zero bias, the heatmap head's ``final_layer`` among
them, and transposed convs; normal 0.02 position embeddings; identity
norms; 0.5 decode logits).  The two frameworks draw different numbers
from one seed, so the port's random weights are its own.

``state_dict_from_jax`` turns the JAX package's variables (numpy arrays),
float or BN-folded, into the port's state dict, named as the reference
checkpoint where one exists (HRNet, HRFormer, the heatmap and fusion
heads) and as the flax module paths elsewhere (LiteHRNet, the deconv
stack, the fused and SimCC heads; see models/litehrnet.py and
models/heads.py).  It is the inverse of ``tools/import_torch_checkpoint.convert_checkpoint`` of the JAX
package (its ``convert_hrnet_backbone``, ``convert_hrformer_backbone``,
``convert_heatmap_head`` and ``convert_fusion_head``): flax conv kernels (kh, kw, I, O) become (O, I, kh, kw), Dense
kernels (I, O) become (O, I), BatchNorm scale/bias/mean/var become
weight/bias/running_mean/running_var, GroupNorm scale/bias weight/bias;
a depthwise kernel (kh, kw, 1, C) becomes (C, 1, kh, kw) like any conv's,
and a transposed conv's (kh, kw, I, O) kernel becomes (I, O, kh, kw)
flipped in both spatial axes (layers.ConvTranspose2d).
``attention_state_from_jax`` does the same for a CBAM or TransformerNeck
(models/attention.py): multi-head attention kernels (C, heads, hd) and
(heads, hd, C) become (C, C) Linear weights.

``quant_state_from_jax`` turns the JAX package's int8 PTQ serving variables
(``params``, ``qparams``, ``batch_stats``: its ``quantize_model``'s
output) into the state dict of the port's ``build_model(cfg, quant=True)``:
conv weights (kh, kw, I, O) int8 become (O, kh, kw, I), the layout K9
reads, Dense (I, O) int8 become (O, I), scales and biases keep their
values, each named as the port's module that reads it.

``train_state_from_jax`` carries a JAX ``TrainState`` across as a whole:
its parameters and BatchNorm statistics as above, the optax Adam moments
(``mu``, ``nu``, laid out as the parameters and converted the same way)
and update count into the ``torch.optim`` AdamW state, and its step, so
that a run checkpointed by the JAX trainer continues in the port.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .models.attention import TransformerNeck
from .models.heads import FusionHead
from .models.hrformer import WindowAttention
from .models.layers import (BatchNorm, Conv2d, ConvTranspose2d, GroupNorm,
                            Linear)
from .ops.msa import relative_position_index

# -- seeded initialisation ---------------------------------------------------


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and buffer of ``model`` from a generator seeded
    with ``seed``, in module order.  Returns the model."""
    g = torch.Generator().manual_seed(seed)

    def trunc_normal(t: torch.Tensor, std: float) -> None:
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=g)

    for m in model.modules():
        if isinstance(m, Conv2d):
            if m.bias is not None and m.init == "auto":
                # the heads' 1x1 prediction convs
                nn.init.normal_(m.weight, std=0.001, generator=g)
            else:
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                nn.init.normal_(m.weight, std=(2.0 / fan_out) ** 0.5,
                                generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, ConvTranspose2d):
            nn.init.normal_(m.weight, std=0.001, generator=g)
        elif isinstance(m, Linear):
            # flax's lecun_normal: a truncated normal of variance 1 / fan-in
            # (its std rescaled by the truncation's 0.8796)
            trunc_normal(m.weight, 0.02 if m.init == "trunc_normal" else
                         (1.0 / m.in_features) ** 0.5 / 0.87962566103423978)
            m.bias.zero_()
        elif isinstance(m, (BatchNorm, GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.reset_running_stats()
        elif isinstance(m, WindowAttention):
            trunc_normal(m.relative_position_bias_table, 0.02)
        elif isinstance(m, FusionHead):
            m.fusion_weight.fill_(0.5)
            m.subpixel_refine.alpha.fill_(0.5)
        elif isinstance(m, TransformerNeck):
            nn.init.normal_(m.pos_embed, std=0.02, generator=g)
    return model


# -- JAX variables -> state dict ----------------------------------------------

def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


_HEAD_CONVNORMS = {
    "shared0": ("shared_layers.0", "shared_layers.1"),
    "shared1": ("shared_layers.3", "shared_layers.4"),
    "hm_conv": ("heatmap_branch.0", "heatmap_branch.1"),
    "off_conv": ("offset_branch.0", "offset_branch.1"),
    "var_conv": ("variance_branch.0", "variance_branch.1"),
    "reg_conv": ("reg_conv.0", "reg_conv.1"),
    "refine_conv": ("refine_conv.0", "refine_conv.1"),
}
_HEAD_FINALS = {"hm_final": "heatmap_branch.3", "off_final": "offset_branch.3",
                "var_final": "variance_branch.3", "final": "final_layer",
                "hm": "hm", "refine_final": "refine_final",
                "kpt_conv": "kpt_conv"}
_HEAD_DENSE = ("reg_fc", "fc_x", "fc_y")


def _convnorm_names(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax ConvNorm module path -> (torch conv name, torch BN name)."""
    p = "/".join(path)
    if p in ("stem1", "stem2"):
        return f"conv{p[-1]}", f"bn{p[-1]}"
    if p in _HEAD_CONVNORMS:
        return _HEAD_CONVNORMS[p]
    m = re.fullmatch(r"layer1_block(\d+)/conv(\d)", p)
    if m:
        b, i = m.groups()
        return f"layer1.{b}.conv{i}", f"layer1.{b}.bn{i}"
    m = re.fullmatch(r"layer1_block(\d+)/downsample", p)
    if m:
        base = f"layer1.{m.group(1)}.downsample"
        return f"{base}.0", f"{base}.1"
    m = re.fullmatch(r"transition(\d)_(\d)", p)
    if m:
        t, i = m.groups()
        # transition t feeds t+1 branches; branch t is the new lowest one,
        # which the reference wraps in one more Sequential.
        base = f"transition{t}.{i}.0" if i == t else f"transition{t}.{i}"
        return f"{base}.0", f"{base}.1"
    m = re.fullmatch(r"stage(\d)_module(\d+)/branch(\d)_block(\d+)/conv(\d)",
                     p)
    if m:  # an HRNet BasicBlock's ConvNorm
        s, mod, br, blk, i = m.groups()
        base = f"stage{s}.{mod}.branches.{br}.{blk}"
        return f"{base}.conv{i}", f"{base}.bn{i}"
    m = re.fullmatch(r"stage(\d)_module(\d+)/fuse(\d)_(\d)(?:_(\d))?", p)
    if m:
        s, mod, i, j, k = m.groups()
        base = f"stage{s}.{mod}.fuse_layers.{i}.{j}"
        if k is not None:
            base = f"{base}.{k}"
        return f"{base}.0", f"{base}.1"
    raise KeyError(f"no reference name for ConvNorm {p!r}")


def _dw_block_name(path: Tuple[str, ...]) -> str:
    """flax LiteHRNet DWSeparableBlock path -> the port's module name."""
    p = "/".join(path)
    if p == "layer1":
        return p
    m = re.fullmatch(r"stage(\d)_module(\d+)/branch(\d)_block(\d+)", p)
    if m:
        s, mod, br, blk = m.groups()
        return f"stage{s}.{mod}.branches.{br}.{blk}"
    m = re.fullmatch(r"stage(\d)_module(\d+)/fuse(\d)_(\d)_(\d)", p)
    if m:
        s, mod, i, j, k = m.groups()
        return f"stage{s}.{mod}.fuse_layers.{i}.{j}.{k}"
    raise KeyError(f"no port name for the DWSeparableBlock {p!r}")


def _norm_name(path: Tuple[str, ...]) -> str:
    """flax Norm module path (``.../norm``, a DWSeparableBlock's
    ``dw_norm``/``pw_norm``, a head's ``deconv{i}_norm``) -> the port's
    norm module name."""
    *owner, last = path
    if last == "norm":  # a ConvNorm's
        return _convnorm_names(tuple(owner))[1]
    if last in ("dw_norm", "pw_norm"):
        return f"{_dw_block_name(tuple(owner))}.{last}"
    if not owner and re.fullmatch(r"deconv\d+_norm", last):
        return last
    raise KeyError(f"no port name for the norm {'/'.join(path)!r}")


_BLOCK_LEAVES = {
    ("norm1", "scale"): "norm1.weight", ("norm1", "bias"): "norm1.bias",
    ("norm2", "scale"): "norm2.weight", ("norm2", "bias"): "norm2.bias",
    ("attn", "rpe_table"): "attn.relative_position_bias_table",
}


def _param_entry(part: str, path: Tuple[str, ...], value: np.ndarray
                 ) -> Tuple[str, np.ndarray]:
    """One flax parameter leaf -> (torch name without prefix, array)."""
    if part == "head" and path[0] == "fusion_weight":
        return "fusion_weight", value
    if part == "head" and path[0] == "subpixel_alpha":
        return "subpixel_refine.alpha", value
    if part == "head" and path[0] in _HEAD_FINALS:
        name = _HEAD_FINALS[path[0]]
        if path[1] == "kernel":
            return f"{name}.weight", value.transpose(3, 2, 0, 1)
        return f"{name}.bias", value
    if part == "head" and path[0] in _HEAD_DENSE:
        return f"{path[0]}.{'weight' if path[1] == 'kernel' else 'bias'}", (
            value.T if path[1] == "kernel" else value)
    if (part == "head" and re.fullmatch(r"deconv\d+", path[0])
            and path[1:] == ("kernel",)):
        return f"{path[0]}.weight", np.ascontiguousarray(
            value[::-1, ::-1].transpose(2, 3, 0, 1))
    # ConvNorm leaves: (..., conv, kernel) and (..., norm, bn|gn,
    # scale|bias)
    if path[-2:] == ("conv", "kernel"):
        conv, _ = _convnorm_names(path[:-2])
        return f"{conv}.weight", value.transpose(3, 2, 0, 1)
    if path[-2:] == ("conv", "bias"):  # a folded ConvNorm (models/fold.py)
        conv, _ = _convnorm_names(path[:-2])
        return f"{conv}.bias", value
    if len(path) >= 3 and path[-2] in ("bn", "gn"):
        return (f"{_norm_name(path[:-2])}."
                f"{'weight' if path[-1] == 'scale' else 'bias'}", value)
    # LiteHRNet's depthwise-separable blocks: before the HRFormer rule
    # below, whose block paths theirs share
    if path[-2:] in (("dw", "kernel"), ("pw", "kernel")):
        return (f"{_dw_block_name(path[:-2])}.{path[-2]}.weight",
                value.transpose(3, 2, 0, 1))
    # HRFormer block leaves: norm1/2, attn.qkv/proj, the RPE table, mlp.fc1/2
    m = re.fullmatch(r"stage(\d)_module(\d+)", path[0])
    b = re.fullmatch(r"branch(\d)_block(\d+)", path[1]) if m else None
    if b:
        base = (f"stage{m.group(1)}.{m.group(2)}.branches."
                f"{b.group(1)}.{b.group(2)}")
        rest = path[2:]
        if rest in _BLOCK_LEAVES:
            return f"{base}.{_BLOCK_LEAVES[rest]}", value
        layer = ".".join(rest[:-1])  # attn.qkv, attn.proj, mlp.fc1, mlp.fc2
        if rest[-1] == "kernel":
            return f"{base}.{layer}.weight", value.T
        return f"{base}.{layer}.bias", value
    raise KeyError(f"no reference name for {part}/{'/'.join(path)}")


def state_dict_from_jax(params: Mapping, batch_stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """JAX PoseEstimator variables (``params``/``batch_stats`` trees with
    ``backbone`` and ``head``) -> the port's state dict.  Folded variables
    (the JAX ``fold_variables``: ConvNorms as a biased ``conv``, no
    ``norm``, ``batch_stats`` passed through) give the state dict of
    ``build_model(cfg, fold=True)``: the statistics of a norm that folded
    are left out, as the folded model stops reading them."""
    sd: Dict[str, torch.Tensor] = {}
    for part in ("backbone", "head"):
        for path, value in _flatten(params.get(part, {})).items():
            name, arr = _param_entry(part, path, value)
            sd[f"{part}.{name}"] = torch.tensor(arr, dtype=torch.float32)
            if name.endswith("relative_position_bias_table"):
                ws = (int(round(np.sqrt(arr.shape[0]))) + 1) // 2
                idx = name[: -len("relative_position_bias_table")]
                sd[f"{part}.{idx}relative_position_index"] = torch.from_numpy(
                    relative_position_index(ws).astype(np.int64))
        for path, value in _flatten(batch_stats.get(part, {})).items():
            if len(path) < 3 or path[-2] != "bn":
                raise KeyError(f"unexpected batch stat {part}/{'/'.join(path)}")
            bn = _norm_name(path[:-2])
            if f"{part}.{bn}.weight" not in sd:  # folded into its conv
                continue
            stat = {"mean": "running_mean", "var": "running_var"}[path[-1]]
            sd[f"{part}.{bn}.{stat}"] = torch.tensor(value,
                                                     dtype=torch.float32)
            sd[f"{part}.{bn}.num_batches_tracked"] = torch.tensor(0)
    return sd


def attention_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The ``params`` of a JAX CBAM or TransformerNeck (models/attention.py,
    numpy) -> the state dict of the port's module of the same arguments."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        leaf = path[-1]
        name = ".".join(path[:-1])
        if path == ("pos_embed",):
            name, arr = "pos_embed", value
        elif path[-2:] == ("conv", "kernel"):  # SpatialAttention's
            name, arr = f"{name}.weight", value.transpose(3, 2, 0, 1)
        elif re.fullmatch(r"ln[12]_\d+", path[0]):
            name, arr = f"{name}.{'weight' if leaf == 'scale' else 'bias'}", value
        elif leaf == "kernel":
            # a Dense (I, O); an attention projection: query/key/value
            # (C, heads, hd), out (heads, hd, C)
            arr = (value.reshape(-1, value.shape[-1]) if path[-2] == "out"
                   else value.reshape(value.shape[0], -1)).T
            name = f"{name}.weight"
        else:  # a bias: (heads, hd) of an attention projection, flattened
            name, arr = f"{name}.bias", value.reshape(-1)
        sd[name] = torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32)
    return sd


# -- JAX int8 PTQ variables -> quantized state dict ----------------------------

def _scale_owner(part: str, path: Tuple[str, ...]) -> str:
    """The port's name of a module that holds a calibrated scale leaf (an
    HRNet's input, a residual block's output, an exchange module's fused
    sums)."""
    p = "/".join(path)
    if not p:
        return part
    m = re.fullmatch(r"layer1_block(\d+)", p)
    if m:
        return f"{part}.layer1.{m.group(1)}"
    m = re.fullmatch(r"stage(\d)_module(\d+)(?:/branch(\d)_block(\d+))?", p)
    if m:
        s, mod, br, blk = m.groups()
        base = f"{part}.stage{s}.{mod}"
        return base if br is None else f"{base}.branches.{br}.{blk}"
    raise KeyError(f"no reference name for the module {part}/{p}")


def _dense_name(part: str, path: Tuple[str, ...]) -> str:
    """The port's name of an HRFormer block's Dense (attn/qkv, attn/proj,
    mlp/fc1, mlp/fc2)."""
    name, _ = _param_entry(part, path + ("kernel",), np.zeros((1, 1)))
    return f"{part}.{name[: -len('.weight')]}"


def quant_state_from_jax(params: Mapping, qparams: Mapping,
                         batch_stats: Optional[Mapping] = None
                         ) -> Dict[str, torch.Tensor]:
    """The JAX package's int8 serving variables (numpy trees) -> the state
    dict of the port's ``build_model(cfg, quant=True)``: the float entries
    the int8 forward reads (``state_dict_from_jax`` of ``params`` and
    ``batch_stats``), and every int8 buffer of ``qparams``."""
    sd = state_dict_from_jax(params, batch_stats or {})
    for part in ("backbone", "head"):
        nodes: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
        for path, value in _flatten(qparams.get(part, {})).items():
            nodes.setdefault(path[:-1], {})[path[-1]] = value
        for path, leaves in nodes.items():
            if "eff_scale" in leaves:  # a ConvNorm
                conv, _ = _convnorm_names(path)
                prefix = f"{part}.{conv}"
                leaves = dict(leaves, w_int8=leaves["w_int8"].transpose(
                    3, 0, 1, 2))
            elif "in_scale" in leaves:  # a Dense
                prefix = _dense_name(part, path)
                leaves = dict(leaves, w_int8=leaves["w_int8"].T)
            else:  # calibrated scales of a module
                prefix = _scale_owner(part, path)
            for k, v in leaves.items():
                sd[f"{prefix}.{k}"] = torch.from_numpy(v.copy(order="C"))
    return sd


# -- JAX train state -> port TrainState ---------------------------------------

def optax_state_of(opt_state: Any, fields: Tuple[str, ...]) -> Tuple:
    """The fields of the first optax state inside a JAX optimizer state
    (a chain, optionally behind a clip) that has them all: ("mu", "nu",
    "count") of Adam's ``ScaleByAdamState``, ("trace",) of SGD's
    ``TraceState``."""
    if all(hasattr(opt_state, k) for k in fields):
        return tuple(getattr(opt_state, k) for k in fields)
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            try:
                return optax_state_of(sub, fields)
            except ValueError:
                continue
    raise ValueError(f"no optimizer state with {fields} in {type(opt_state)}")


def train_state_from_jax(cfg, params: Mapping, batch_stats: Mapping,
                         opt_state: Any, step: int, device="cuda"):
    """A port TrainState (train/state.py) from a JAX TrainState's numpy
    leaves: the model from ``params`` and ``batch_stats``
    (``state_dict_from_jax``), the optimizer's state from ``opt_state``
    (Adam and AdamW: the moments ``mu`` and ``nu`` and the update count;
    SGD: the momentum ``trace``), each laid out as the parameters and
    converted as they are, and ``step``."""
    from .train.step import create_train_state

    state = create_train_state(cfg, device=device, state_dict=state_dict_from_jax(
        params, batch_stats))
    named = list(state.model.named_parameters())
    if cfg.train.optimizer.lower() == "sgd":
        (trace,) = optax_state_of(opt_state, ("trace",))
        trace = state_dict_from_jax(trace, {})
        for name, p in named:
            state.optimizer.state[p] = {"momentum_buffer": trace[name].to(p)}
    else:
        mu, nu, count = optax_state_of(opt_state, ("mu", "nu", "count"))
        mu, nu = state_dict_from_jax(mu, {}), state_dict_from_jax(nu, {})
        for name, p in named:
            state.optimizer.state[p] = {
                "step": torch.tensor(float(np.asarray(count)),
                                     dtype=torch.float32),
                "exp_avg": mu[name].to(p),
                "exp_avg_sq": nu[name].to(p)}
    state.step = int(np.asarray(step))
    return state
