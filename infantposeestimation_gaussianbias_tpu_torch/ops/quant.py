"""Post-training int8 quantization (PTQ) for serving.

Port of infantposeestimation_gaussianbias_tpu/ops/quant.py, over the
port's layouts and state-dict names:

* ``QTensor``: int8 data and its 0-d float32 dequantization scale.
  Activations flow between the int8 layers in this form: a producer
  quantizes once and every consumer folds the scale into its epilogue.
* weights: per-output-channel symmetric int8 (``quantize_weight``; the
  output channel is the FIRST axis, torch's layout).  A conv's int8 weight
  is kept as (Co, kh, kw, Ci), the layout K9 reads
  (``conv_weight_layout``); a Linear's as (Co, Ci).
* BatchNorm folding: inference BN is a per-channel affine (a, b), folded
  into the conv's epilogue as ``acc * (in_scale * w_scale * a) + b``.
* calibration: the float model records the running abs-max of every
  tensor that will be quantized (models/layers.py ``sow_absmax``); scales
  are ``absmax / 127``.
* ``convert_tree``: the float state dict and the calibration record ->
  the int8 serving buffers (``qparams``), named as the modules that read
  them.

The int8 products run on K9 and K10 (kernels/quant.py); for CPU tensors
their plain versions, which equal the kernels bit for bit.  Rounding is
half to even (``torch.round``, as ``jnp.round``) and clamps to +-127.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..kernels import quant as qk

INT8_MAX = qk.INT8_MAX
EPS = 1e-5


class QTensor(NamedTuple):
    """int8 data + 0-d float32 dequantization scale (x ~= data * scale)."""

    data: torch.Tensor   # int8
    scale: torch.Tensor  # () float32

    @property
    def shape(self):
        return self.data.shape

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.data.to(dtype) * self.scale.to(dtype)


def scale_of(absmax) -> torch.Tensor:
    """The symmetric int8 scale of a calibrated abs-max: max(absmax,
    1e-12) / 127 in float32."""
    return torch.clamp_min(torch.as_tensor(absmax, dtype=torch.float32),
                           1e-12) / INT8_MAX


def quantize_act(x: torch.Tensor, absmax) -> QTensor:
    """Per-tensor symmetric int8 quantization with scale absmax / 127."""
    scale = scale_of(absmax).to(x.device)
    q = torch.clamp(torch.round(x.float() / scale), -INT8_MAX, INT8_MAX)
    return QTensor(q.to(torch.int8), scale)


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 weights.  ``w`` is a conv's
    (O, I, kh, kw) or a Linear's (O, I): the output channel is the first
    axis.  Returns {"w_int8" (w's shape), "w_scale" (O,)}."""
    wf = w.float()
    absmax = torch.clamp_min(wf.abs().reshape(wf.shape[0], -1).amax(dim=1),
                             1e-12)
    scale = absmax / INT8_MAX
    q = torch.round(wf / scale.reshape((-1,) + (1,) * (wf.dim() - 1)))
    return {"w_int8": torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8),
            "w_scale": scale}


def conv_weight_layout(w: torch.Tensor) -> torch.Tensor:
    """A conv weight (O, I, kh, kw) in the layout K9 reads: (O, kh, kw, I),
    contiguous."""
    return w.permute(0, 2, 3, 1).contiguous()


def fold_batchnorm(weight: torch.Tensor, bias: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor,
                   eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm -> per-channel (a, b), bn(x) = x * a + b, in
    float32."""
    a = weight.float() * torch.rsqrt(var.float() + eps)
    return a, bias.float() - mean.float() * a


def requantize(y: torch.Tensor, out_scale: torch.Tensor) -> QTensor:
    """float32 -> int8 with a calibrated static scale (the reciprocal
    taken once, so each element is multiplied, not divided)."""
    scale = out_scale.float()
    return QTensor(qk.requantize_values(y, scale), scale)


def qconv_affine(x: QTensor, q: Mapping[str, torch.Tensor],
                 stride: int = 1) -> torch.Tensor:
    """Quantized conv + dequant + folded-BN affine -> float32
    (pre-activation), padding kh // 2.  ``q`` holds w_int8 (Co, kh, kw,
    Ci), eff_scale (Co,) = w_scale * bn_a and eff_bias (Co,) = bn_b.  K9
    fuses the rest of a ConvNorm's epilogue as well (kernels/quant.py
    ``qconv``)."""
    return qk.qconv(x.data, x.scale, q["w_int8"], q["eff_scale"],
                    q["eff_bias"], stride)


def qdense(x: torch.Tensor, q: Mapping[str, torch.Tensor],
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Quantized Dense on a float input: per-tensor int8 quantization with
    the static ``in_scale``, int8 x int8 -> int32 (K10), then
    ``acc * (in_scale * w_scale) + bias``.  ``q`` holds w_int8 (O, I),
    w_scale (O,), bias (O,), in_scale ()."""
    return qk.qdense(x, q["w_int8"], q["w_scale"], q["bias"], q["in_scale"],
                     out_dtype)


# -- conversion: float state dict + calibration -> int8 serving buffers ------

def convert_dense(weight: torch.Tensor, bias: Optional[torch.Tensor],
                  in_absmax) -> Dict[str, torch.Tensor]:
    """One Linear (weight (O, I), bias) and its calibrated input abs-max
    -> the buffers qdense reads."""
    qw = quantize_weight(weight)
    if bias is None:
        bias = torch.zeros(weight.shape[0])
    return {"w_int8": qw["w_int8"], "w_scale": qw["w_scale"],
            "bias": bias.float(), "in_scale": scale_of(in_absmax).to(
                weight.device)}


def convert_convnorm(conv_weight: torch.Tensor,
                     bn: Optional[Tuple[torch.Tensor, ...]],
                     out_absmax=None) -> Dict[str, torch.Tensor]:
    """One conv (O, I, kh, kw) + BatchNorm (weight, bias, running_mean,
    running_var) -> {w_int8 (O, kh, kw, I), eff_scale, eff_bias[,
    out_scale]}.  A GroupNorm depends on the data and cannot fold: its
    ConvNorms cannot be quantized (``bn`` None raises)."""
    if bn is None:
        raise ValueError("quantization requires batchnorm ConvNorms")
    qw = quantize_weight(conv_weight)
    a, b = fold_batchnorm(*bn)
    out = {"w_int8": conv_weight_layout(qw["w_int8"]),
           "eff_scale": qw["w_scale"] * a, "eff_bias": b}
    if out_absmax is not None:
        out["out_scale"] = scale_of(out_absmax).to(conv_weight.device)
    return out


def convert_tree(state_dict: Mapping[str, torch.Tensor],
                 calib: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The int8 serving buffers of a float model, as a flat dict named as
    the modules of ``build_model(cfg, quant=True)`` that read them:

    * every conv + BatchNorm pair (models/fold.py ``convnorm_pairs``)
      -> ``{conv}.w_int8``, ``.eff_scale``, ``.eff_bias`` and, where the
      calibration recorded ``{conv}.out_absmax``, ``.out_scale``;
    * every Linear whose input was recorded (``{linear}.in_absmax``) ->
      ``{linear}.w_int8``, ``.w_scale``, ``.bias``, ``.in_scale``;
    * every other record ``X_absmax`` (an input, a block's output, a fused
      sum) -> ``X_scale``.
    """
    from ..models.fold import convnorm_pairs

    out: Dict[str, torch.Tensor] = {}
    consumed = set()
    for key, absmax in calib.items():
        if not key.endswith(".in_absmax"):
            continue
        lin = key[: -len(".in_absmax")]
        for k, v in convert_dense(state_dict[f"{lin}.weight"],
                                  state_dict.get(f"{lin}.bias"),
                                  absmax).items():
            out[f"{lin}.{k}"] = v
        consumed.add(key)
    for conv, norm in convnorm_pairs(state_dict):
        absmax = calib.get(f"{conv}.out_absmax")
        for k, v in convert_convnorm(
                state_dict[f"{conv}.weight"],
                tuple(state_dict[f"{norm}.{s}"] for s in (
                    "weight", "bias", "running_mean", "running_var")),
                absmax).items():
            out[f"{conv}.{k}"] = v
        if absmax is not None:
            consumed.add(f"{conv}.out_absmax")
    for key, absmax in calib.items():
        if key not in consumed and key.endswith("_absmax"):
            out[key[: -len("_absmax")] + "_scale"] = scale_of(absmax)
    return out
