"""HRFormer backbone: multi-resolution transformer on NHWC feature maps.

Port of infantposeestimation_gaussianbias_tpu/models/hrformer.py (the
unfused path).  Module and parameter names follow the reference's state
dict (``conv1``/``bn1``, ``layer1.{b}``, ``transition{t}.{i}``,
``stage{s}.{m}.branches.{br}.{blk}.attn.qkv``,
``...attn.relative_position_bias_table``, ``stage{s}.{m}.fuse_layers.{i}.{j}``)
so that a reference checkpoint loads with ``load_state_dict``.

Training: every block applies DropPath after its attention and its MLP,
at one rate for the whole backbone, as the JAX package does.  DropPath
holds no parameters and draws nothing itself: the caller passes the keep
masks of all blocks as one (num_drop_paths, B) bool tensor
(train/step.py ``draw_drop_masks``), so that a checkpointed module
recomputes with the same masks and tests can give both frameworks the
same ones.  ``remat`` wraps each HRFormerModule in
``torch.utils.checkpoint``; its recomputation leaves the BatchNorm running
statistics alone (layers.frozen_batch_stats).

Fused half-blocks: with ``use_pallas`` (``cfg.model.use_pallas``) and the
``IPE_FUSED_BLOCK`` environment variable on (``_fused_blocks_enabled``,
read when a block runs, as in the JAX package), a block runs as K4 then K5
(kernels/fused_block.py) on one window layout, from the same parameters.

Process grid (parallel/mesh.py): ``models.build_model`` sets ``grid`` on
every WindowAttention (and BatchNorm).  With a grid of more than one rank
the attention core is K3, ``window_attention_sharded`` (each rank's
windows, its heads when the model axis divides them), as the JAX
``WindowAttention`` calls ``window_attention_pallas_qkv_sharded`` under a
multi-device mesh; and the blocks never fuse, as the JAX gate requires
``mesh is None``.

int8 PTQ (``quant``, the JAX package's Dense-only mode): the Linears of
the blocks whose input is at least ``QUANT_MIN_FEATURES`` wide (qkv and
proj by C, fc1 by C, fc2 by the hidden width) are QDense on K10; the conv
trunk, the norms and the narrow Linears stay float, the BatchNorms
unfolded.  Calibration records those Linears' inputs
(``layers.sow_absmax``).  Under ``quant`` and under calibration the
blocks never fuse, ``IPE_FUSED_BLOCK`` or not (JAX hrformer.py:199-201).

Base:  channels (78, 156, 312, 624), heads (2, 4, 8, 16), window 7,
       modules per stage (1, 4, 2), 2 blocks per branch, drop-path 0.2.
Small: channels (32, 64, 128, 256), heads (1, 2, 4, 8), drop-path 0.1.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops as kops
from ..kernels.fused_block import fused_attn_half, fused_mlp_half
from ..kernels.window_msa import window_attention, window_attention_sharded
from ..ops import msa
from .layers import (Bottleneck, Conv2d, Linear, QDense, apply_transition,
                     drop_path, fuse, is_calibrating, make_fuse_layers,
                     make_norm, make_transition, remat_contexts, sow_absmax)

BLOCKS_PER_BRANCH = 2
MLP_RATIO = 4
# Dense-PTQ width gate (JAX hrformer.py:60-64): a Linear is quantized only
# where its input is at least this wide.
QUANT_MIN_FEATURES = 128


def dense(in_features: int, out_features: int, compute_dtype: torch.dtype,
          quant: bool) -> nn.Module:
    """A block's Linear: its QDense twin under ``quant`` when the input is
    at least QUANT_MIN_FEATURES wide."""
    if quant and in_features >= QUANT_MIN_FEATURES:
        return QDense(in_features, out_features, compute_dtype)
    return Linear(in_features, out_features, compute_dtype=compute_dtype)


def sow_dense_input(layer: nn.Module, x: torch.Tensor) -> None:
    """Record a wide Linear's input at ``{layer}.in_absmax``."""
    if x.shape[-1] >= QUANT_MIN_FEATURES:
        sow_absmax(layer, "in_absmax", x, conv=False)


def _fused_blocks_enabled(dim: int) -> bool:
    """The fused half-block gate of the JAX package (its
    ``models/hrformer.py`` ``_fused_blocks_enabled``), read when a block
    runs: ``IPE_FUSED_BLOCK=0`` (the default) never fuses, ``=1`` fuses
    every block, any other value fuses the blocks of width
    ``dim >= IPE_FUSED_BLOCK_MIN_C`` (default 128)."""
    flag = os.environ.get("IPE_FUSED_BLOCK", "0")
    if flag == "0":
        return False
    if flag == "1":
        return True
    return dim >= int(os.environ.get("IPE_FUSED_BLOCK_MIN_C", "128"))


class WindowAttention(nn.Module):
    """W-MSA with relative position bias over (nW, N, C) windows; the
    attention core is the fused kernel pair (kernels/window_msa.py: K1
    forward, K2 backward), which takes its plain version for CPU tensors;
    under a process grid of more than one rank (``grid``), K3."""

    grid = None  # set by models.build_model under a process grid

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 compute_dtype: torch.dtype = torch.float32,
                 quant: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            msa.relative_position_index(window_size).astype("int64")))
        self.qkv = dense(dim, 3 * dim, compute_dtype, quant)
        self.proj = dense(dim, dim, compute_dtype, quant)

    def rpe_bias(self) -> torch.Tensor:
        """(num_heads, N, N) float32 bias gathered from the table."""
        N = self.window_size ** 2
        table = self.relative_position_bias_table
        bias = table[self.relative_position_index.reshape(-1)]
        return bias.reshape(N, N, self.num_heads).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sow_dense_input(self.qkv, x)
        qkv = self.qkv(x).contiguous()
        if self.grid is not None and self.grid.size > 1:
            out = window_attention_sharded(qkv, self.rpe_bias(),
                                           self.num_heads, self.grid)
        elif torch.compiler.is_exporting():  # one operator node (kernels/ops)
            out = kops.window_attention_qkv(qkv, self.rpe_bias(),
                                            self.num_heads)
        else:
            out = window_attention(qkv, self.rpe_bias(), self.num_heads)
        sow_dense_input(self.proj, out)
        return self.proj(out)


class Mlp(nn.Module):
    """Linear -> exact-erf GELU -> Linear."""

    def __init__(self, dim: int, hidden: int,
                 compute_dtype: torch.dtype = torch.float32,
                 quant: bool = False):
        super().__init__()
        self.fc1 = dense(dim, hidden, compute_dtype, quant)
        self.fc2 = dense(hidden, dim, compute_dtype, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sow_dense_input(self.fc1, x)
        y = F.gelu(self.fc1(x))
        sow_dense_input(self.fc2, y)
        return self.fc2(y)


class HRFormerBlock(nn.Module):
    """LN -> window MSA -> DropPath residual -> LN -> MLP -> DropPath
    residual on an NHWC map.

    LayerNorm statistics are float32 with eps 1e-5; the normalised map
    drops to the compute dtype before the window partition, as in the JAX
    block (hrformer.py:188-227).  With ``use_pallas`` and the fused gate
    on, no process grid, no ``quant`` and no calibration running, the
    block runs ``_fused`` instead."""

    DROP_PATHS = 2  # keep masks per block: after attention, after the MLP

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 compute_dtype: torch.dtype = torch.float32,
                 drop_path_rate: float = 0.0, use_pallas: bool = False,
                 quant: bool = False):
        super().__init__()
        self.dim = dim
        self.window_size = window_size
        self.compute_dtype = compute_dtype
        self.drop_path_rate = drop_path_rate
        self.use_pallas = use_pallas
        self.quant = quant
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads, compute_dtype,
                                    quant)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, MLP_RATIO * dim, compute_dtype, quant)

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: (2, B) bool DropPath masks, or None for none."""
        if (self.use_pallas and self.attn.grid is None and not self.quant
                and not is_calibrating() and _fused_blocks_enabled(self.dim)):
            return self._fused(x, keep)
        B, H, W, C = x.shape
        ws, dt, rate = self.window_size, self.compute_dtype, self.drop_path_rate
        y = self.norm1(x.float()).to(dt)
        wins, (Hp, Wp) = msa.window_partition(y, ws)
        wins = self.attn(wins)
        y = msa.window_reverse(wins.reshape(-1, ws, ws, C), ws, H, W, Hp, Wp)
        x = x + drop_path(y, None if keep is None else keep[0], rate)
        y = self.norm2(x.float()).to(dt)
        return x + drop_path(self.mlp(y), None if keep is None else keep[1],
                             rate)

    def _scales(self, keep: Optional[torch.Tensor], B: int,
                device) -> tuple:
        """The two (B,) float32 DropPath scales, mask / (1 - rate)."""
        if keep is None or self.drop_path_rate == 0.0:
            ones = torch.ones(B, dtype=torch.float32, device=device)
            return ones, ones
        k = keep.to(torch.float32) / (1.0 - self.drop_path_rate)
        return k[0], k[1]

    def _fused(self, x: torch.Tensor,
               keep: Optional[torch.Tensor]) -> torch.Tensor:
        """The JAX block's ``_fused``: K4 then K5 on one window layout (one
        partition, one reverse), from the parameters of the unfused path.
        The MLP is per token, so it runs on the windowed rows: pad tokens
        compute values that ``window_reverse`` crops off."""
        B, H, W, C = x.shape
        ws, dt = self.window_size, self.compute_dtype
        attn, mlp = self.attn, self.mlp
        xw, (Hp, Wp) = msa.window_partition(x.to(dt), ws)
        nW, N = xw.shape[0], ws * ws
        dp1, dp2 = self._scales(keep, B, x.device)
        # one operator node each while exporting (kernels/ops)
        exporting = torch.compiler.is_exporting()
        attn_half = kops.fused_attn_half_fwd if exporting else fused_attn_half
        mlp_half = kops.fused_mlp_half_fwd if exporting else fused_mlp_half
        xw = attn_half(
            xw.contiguous(), self.norm1.weight, self.norm1.bias,
            attn.qkv.weight.to(dt).t(), attn.qkv.bias, attn.rpe_bias(),
            attn.proj.weight.to(dt).t(), attn.proj.bias, dp1,
            attn.num_heads, (H, W, ws))
        y = mlp_half(
            xw.reshape(nW * N, C), self.norm2.weight, self.norm2.bias,
            mlp.fc1.weight.to(dt).t(), mlp.fc1.bias,
            mlp.fc2.weight.to(dt).t(), mlp.fc2.bias, dp2, (nW // B) * N)
        return msa.window_reverse(y.reshape(nW, ws, ws, C), ws, H, W, Hp, Wp)


class HRFormerModule(nn.Module):
    """Exchange unit: transformer branches + all-pairs conv fusion.

    Fuse layer (i, j): for j > i a 1x1 ConvNorm then a bilinear upsample;
    for j < i a chain of stride-2 3x3 ConvNorms, ReLU on all but the last.
    The sum over j is followed by a ReLU."""

    def __init__(self, channels: Sequence[int], heads: Sequence[int],
                 window_size: int = 7,
                 compute_dtype: torch.dtype = torch.float32,
                 drop_path_rate: float = 0.0, use_pallas: bool = False,
                 norm: str = "batchnorm", fold: bool = False,
                 quant: bool = False):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype)
        self.branches = nn.ModuleList([
            nn.Sequential(*[HRFormerBlock(c, h, window_size,
                                          drop_path_rate=drop_path_rate,
                                          use_pallas=use_pallas, quant=quant,
                                          **kw)
                            for _ in range(BLOCKS_PER_BRANCH)])
            for c, h in zip(channels, heads)])
        self.num_drop_paths = (len(channels) * BLOCKS_PER_BRANCH
                               * HRFormerBlock.DROP_PATHS)
        self.fuse_layers = make_fuse_layers(channels, compute_dtype, norm,
                                            fold)

    def forward(self, xs: List[torch.Tensor],
                keep: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """``keep``: (num_drop_paths, B) bool DropPath masks, block by
        block in branch order, or None for none."""
        ys = []
        n = HRFormerBlock.DROP_PATHS
        for i, (branch, x) in enumerate(zip(self.branches, xs)):
            for b, block in enumerate(branch):
                k = i * BLOCKS_PER_BRANCH + b
                x = block(x, None if keep is None else keep[n * k:n * k + n])
            ys.append(x)
        return fuse(self.fuse_layers, ys, self)


class HRFormer(nn.Module):
    """HRFormer backbone on NHWC images; returns the stride-4 features.
    ``fold``: the BN-folded serving form of its convs (models/fold.py);
    the transformer blocks have no BatchNorm and do not change.
    ``quant``: the int8 Dense-only form (see the module doc)."""

    def __init__(self, channels: Tuple[int, ...] = (78, 156, 312, 624),
                 num_heads: Tuple[int, ...] = (2, 4, 8, 16),
                 stage_modules: Tuple[int, ...] = (1, 4, 2),
                 window_size: int = 7,
                 compute_dtype: torch.dtype = torch.float32,
                 drop_path_rate: float = 0.2, remat: bool = False,
                 use_pallas: bool = False, norm: str = "batchnorm",
                 fold: bool = False, quant: bool = False):
        super().__init__()
        self.channels = tuple(channels)
        self.drop_path_rate = drop_path_rate
        self.remat = remat
        kw = dict(compute_dtype=compute_dtype, norm=norm, fold=fold)
        self.conv1 = Conv2d(3, 64, 3, stride=2, bias=fold,
                            compute_dtype=compute_dtype)
        self.bn1 = make_norm(norm, 64, fold)
        self.conv2 = Conv2d(64, 64, 3, stride=2, bias=fold,
                            compute_dtype=compute_dtype)
        self.bn2 = make_norm(norm, 64, fold)
        self.layer1 = nn.Sequential(Bottleneck(64, 64, **kw),
                                    Bottleneck(256, 64, **kw))
        prev = [256]
        for s, modules in enumerate(stage_modules):
            cur = list(channels[: s + 2])
            trans = make_transition(prev, cur, **kw)
            setattr(self, f"transition{s + 1}", trans)
            setattr(self, f"stage{s + 2}", nn.ModuleList([
                HRFormerModule(cur, num_heads[: s + 2], window_size,
                               drop_path_rate=drop_path_rate,
                               use_pallas=use_pallas, quant=quant, **kw)
                for _ in range(modules)]))
            prev = cur
        self.num_stages = len(stage_modules)
        self.num_drop_paths = sum(m.num_drop_paths for m in self.modules()
                                  if isinstance(m, HRFormerModule))

    def forward(self, x: torch.Tensor,
                drop_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``drop_masks``: (num_drop_paths, B) bool DropPath keep masks,
        module by module, or None; required in training at a non-zero
        drop-path rate."""
        if (self.training and self.drop_path_rate > 0
                and drop_masks is None):
            raise ValueError("training at a non-zero drop-path rate needs "
                             "drop_masks (see train.step.draw_drop_masks)")
        remat = self.remat and torch.is_grad_enabled()
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        at = 0
        for t in range(1, self.num_stages + 1):
            trans = getattr(self, f"transition{t}")
            xs = apply_transition(trans, xs)
            for module in getattr(self, f"stage{t + 1}"):
                keep = (None if drop_masks is None
                        else drop_masks[at:at + module.num_drop_paths])
                at += module.num_drop_paths
                if remat:
                    xs = checkpoint(module, xs, keep, use_reentrant=False,
                                    context_fn=remat_contexts)
                else:
                    xs = module(xs, keep)
        return xs[0]


def hrformer_base(compute_dtype: torch.dtype = torch.float32,
                  window_size: int = 7, remat: bool = False,
                  use_pallas: bool = False,
                  norm: str = "batchnorm", fold: bool = False,
                  quant: bool = False) -> HRFormer:
    return HRFormer(channels=(78, 156, 312, 624), num_heads=(2, 4, 8, 16),
                    compute_dtype=compute_dtype, window_size=window_size,
                    drop_path_rate=0.2, remat=remat, use_pallas=use_pallas,
                    norm=norm, fold=fold, quant=quant)


def hrformer_small(compute_dtype: torch.dtype = torch.float32,
                   window_size: int = 7, remat: bool = False,
                   use_pallas: bool = False,
                   norm: str = "batchnorm", fold: bool = False,
                   quant: bool = False) -> HRFormer:
    return HRFormer(channels=(32, 64, 128, 256), num_heads=(1, 2, 4, 8),
                    compute_dtype=compute_dtype, window_size=window_size,
                    drop_path_rate=0.1, remat=remat, use_pallas=use_pallas,
                    norm=norm, fold=fold, quant=quant)
