"""PyTorch port, K9 and K10 on the CPU: the launch plans of the Hopper
int8 kernels (``kernels/quant.py`` ``conv_plan``, ``dense_plan``) and an
emulation of their tiling against the plain versions.

A CUDA kernel cannot run here.  What surrounds it can:
  * the plan at every int8 conv of hrnet_w32 and hrnet_w48 (heatmap and
    fusion heads) and every QDense of hrformer_base and hrformer_small,
    at b = 1, 32 and 64, the shapes found by running each int8 model on
    the CPU with the two wrappers replaced by shape-only stand-ins: the
    shared memory fits the opt-in limit with its ring, the N tile is a
    legal int8 ``wgmma`` width, the depth padding and the split of the
    depth (K9) or of N (K10) cover the work exactly once;
  * emulations of the kernels' tiling in torch (``conv_tiled_emulation``:
    16-byte chunks per tap, zeros outside the image and past K, N tiles,
    int32 partials of a split depth summed; ``dense_tiled_emulation``:
    rows quantized once into the block, the padded weights, N tiles split
    over blocks) equal ``qconv_reference`` / ``qdense_reference`` under
    ``torch.equal``;
  * the int8 modules' state dicts keep their keys (the padded weights
    are a cached attribute, not a buffer).
Pure torch (no JAX), one intra-op thread.
"""

import functools
from typing import Optional

import pytest

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu_torch import get_variant  # noqa: E402
from infantposeestimation_gaussianbias_tpu_torch.kernels import (  # noqa: E402
    quant as qk)
from infantposeestimation_gaussianbias_tpu_torch.models import (  # noqa: E402
    build_model)
from infantposeestimation_gaussianbias_tpu_torch.models.layers import (  # noqa: E402
    QConvNorm, QDense)
from tests.torch_tiny import one_torch_thread  # noqa: E402,F401

SMS = 132  # the H100's SMs
BATCHES = (1, 32, 64)
MODELS = [("hrnet_w32", "heatmap"), ("hrnet_w32", "fusion"),
          ("hrnet_w48", "heatmap"), ("hrnet_w48", "fusion"),
          ("hrformer_base", "fusion"), ("hrformer_small", "fusion")]


@functools.lru_cache(maxsize=None)
def int8_shapes(backbone: str, head: str) -> tuple:
    """The distinct (conv or dense) calls of one int8 forward of a crop at
    the config's input size, as phase 27 of chip_smoke.py tells them
    apart: ("conv", H, W, C, Co, k, stride, relu, int8 out, residual
    dtype) and ("dense", rows per crop, K, N)."""
    cfg = get_variant(backbone)
    cfg.model.head_type = head
    cfg.model.compute_dtype = "float32"
    model = build_model(cfg, "cpu", quant=True)
    seen = set()

    def conv(x, xs, w, es, eb, stride=1, relu=False, out_scale=None,
             residual=None, res_scale=None):
        B, H, W, C = x.shape
        Co, k = w.shape[0], w.shape[1]
        seen.add(("conv", H, W, C, Co, k, stride, relu, out_scale is not None,
                  "" if residual is None else str(residual.dtype)))
        Ho, Wo = qk.conv_out_size(H, W, k, stride)
        return torch.zeros(B, Ho, Wo, Co, dtype=torch.int8 if out_scale
                           is not None else torch.float32)

    def dense(x, w, *args):
        out_dtype = args[4] if len(args) > 4 else torch.float32
        seen.add(("dense", x.numel() // x.shape[-1], w.shape[1], w.shape[0]))
        return torch.zeros(*x.shape[:-1], w.shape[0], dtype=out_dtype)

    real = qk.qconv, qk.qdense
    qk.qconv, qk.qdense = conv, dense
    try:
        W, H = cfg.data.input_size
        with torch.inference_mode():
            model(torch.zeros(1, H, W, 3))
    finally:
        qk.qconv, qk.qdense = real
    return tuple(sorted(seen))


def test_shapes_found_per_model():
    """The int8 paths the chip checks name: hrnet_w32 + fusion has 38
    distinct conv calls (phase 27), hrformer_base 13 Dense shapes."""
    counts = {m: len(int8_shapes(*m)) for m in MODELS}
    assert counts[("hrnet_w32", "fusion")] == 38, counts
    assert counts[("hrformer_base", "fusion")] == 13, counts
    assert all(n for n in counts.values()), counts
    assert all(s[0] == "conv" for s in int8_shapes("hrnet_w48", "fusion"))
    assert all(s[0] == "dense" for s in int8_shapes("hrformer_small",
                                                    "fusion"))


@pytest.mark.parametrize("backbone", ["hrnet_w32", "hrnet_w48"])
@pytest.mark.parametrize("head", ["heatmap", "fusion"])
@pytest.mark.parametrize("B", BATCHES)
def test_conv_plan_is_legal(backbone, head, B):
    for _, H, W, C, Co, k, stride, *_ in int8_shapes(backbone, head):
        p = qk.conv_plan(B, H, W, C, Co, k, stride, SMS)
        Ho, Wo = qk.conv_out_size(H, W, k, stride)
        where = (backbone, head, B, H, W, C, Co, k, stride, p)
        assert p.M == B * Ho * Wo and p.K == k * k * C, where
        assert p.byte_route == (C % 16 != 0), where
        assert p.bn in qk.CONV_TILES_N and p.bn in qk.WGMMA_N_INT8, where
        # the N tile holds Co up to 256 (128 at one or two slices), or
        # narrows to 64 where the tiles would fall short of the SMs
        widest = next(n for n in qk.CONV_TILES_N
                      if n >= min(Co, 256 if p.slices > 2 else 128))
        assert (p.bn == widest or p.byte_route
                or (64 <= p.bn < widest
                    and p.m_tiles * -(-Co // (2 * p.bn)) < SMS)), where
        assert p.wg in (1, 2), where
        assert p.m_tiles == -(-p.M // (64 * p.wg)), where
        assert p.n_tiles == -(-Co // p.bn), where
        # the depth: slices of 128 bytes cover K, the splits cover the
        # slices once, each split at least two slices when split
        assert p.slices * qk.SLICE >= p.K > (p.slices - 1) * qk.SLICE, where
        assert p.splits * p.per_split >= p.slices, where
        assert (p.splits - 1) * p.per_split < p.slices, where
        assert p.splits == 1 or p.per_split >= 2, where
        # a two-slice ring only where no split has more than two slices
        assert p.stages == (2 if p.per_split <= 2 else qk.STAGES), where
        tiles = p.m_tiles * p.n_tiles
        assert p.splits == 1 or tiles < SMS, where
        assert p.ws == (tiles * p.splits * 64 * p.wg * p.bn
                        if p.splits > 1 else 0), where
        # shared memory: the ring or the epilogue's int32 tile (row stride
        # bn + 8), whichever is larger, the scales, the alignment slack
        assert p.smem == qk.conv_smem(p.bn, p.wg, p.stages) <= qk.MAX_SMEM, where
        assert p.smem >= 64 * p.wg * (p.bn + 8) * 4 + 1024, where
        assert p.smem >= p.stages * (64 * p.wg + p.bn) * qk.SLICE + 1024, where
        assert p.m_tiles < 2 ** 31 and p.n_tiles * p.splits < 65536, where


@pytest.mark.parametrize("backbone", ["hrformer_base", "hrformer_small"])
@pytest.mark.parametrize("B", BATCHES)
def test_dense_plan_is_legal(backbone, B):
    for _, rows, K, N in int8_shapes(backbone, "fusion"):
        M = B * rows
        p = qk.dense_plan(M, K, N, SMS)
        where = (backbone, B, M, K, N, p)
        assert p.Kp % qk.SLICE == 0 and 0 <= p.Kp - K < qk.SLICE, where
        assert p.slices == p.Kp // qk.SLICE, where
        assert qk.DENSE_TILE_N in qk.WGMMA_N_INT8, where
        assert p.n_tiles == -(-N // qk.DENSE_TILE_N), where
        assert p.m_tiles == -(-M // (64 * p.wg)), where
        assert p.n_split * p.per_split >= p.n_tiles, where
        assert (p.n_split - 1) * p.per_split < p.n_tiles, where
        # N is split only as far as the row tiles fall short of the SMs
        assert p.n_split == 1 or p.m_tiles * (p.n_split - 1) < SMS, where
        assert p.smem == qk.dense_smem(p.wg, p.slices) <= qk.MAX_SMEM, where
        # the resident rows: 64 wg rows of every slice
        assert p.smem >= p.slices * 64 * p.wg * qk.SLICE, where


def test_dense_plan_refuses_rows_too_deep():
    with pytest.raises(ValueError, match="too deep"):
        qk.dense_plan(64, 4096, 128, SMS)


def _conv_inputs(g, B, H, W, C, Co, k, stride, res):
    x = torch.randint(-127, 128, (B, H, W, C), dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (Co, k, k, C), dtype=torch.int8,
                      generator=g)
    x_scale = torch.rand((), generator=g) * 0.01 + 0.01
    eff_scale = torch.rand(Co, generator=g) * 1e-3 + 1e-3
    eff_bias = torch.randn(Co, generator=g)
    Ho, Wo = qk.conv_out_size(H, W, k, stride)
    kw = dict(stride=stride)
    if res == "int8":
        kw["residual"] = torch.randint(-127, 128, (B, Ho, Wo, Co),
                                       dtype=torch.int8, generator=g)
        kw["res_scale"] = torch.rand((), generator=g) * 0.01 + 0.01
    elif res == "float32":
        kw["residual"] = torch.randn(B, Ho, Wo, Co, generator=g)
    return (x, x_scale, w, eff_scale, eff_bias), kw


def _exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, D) @ b (N, D)^T of int8 values, exact, as int64."""
    return torch.round(a.double() @ b.double().t()).to(torch.int64)


def conv_tiled_emulation(x: torch.Tensor, x_scale: torch.Tensor,
                         w: torch.Tensor, eff_scale: torch.Tensor,
                         eff_bias: torch.Tensor, stride: int = 1,
                         relu: bool = False,
                         out_scale: Optional[torch.Tensor] = None,
                         residual: Optional[torch.Tensor] = None,
                         res_scale: Optional[torch.Tensor] = None,
                         plan: Optional[qk.ConvPlan] = None,
                         sms: int = 132) -> torch.Tensor:
    """K9 as its launch ``plan`` tiles it (default: ``conv_plan`` at
    ``sms``), on the CPU: the depth in 128-byte slices, each 16-byte chunk
    of an output pixel's row taken from the input pixel of its tap (r, s)
    at channel offset k % C (byte by byte on the byte route), zeros outside
    the image and past K; the N tiles with zero weight rows past Co; each
    split's int32 partial sum, the partials summed; then the epilogue's
    float steps.  Equal to ``qconv_reference`` wherever the kernel is."""
    B, H, W, C = x.shape
    Co, k = w.shape[0], w.shape[1]
    Ho, Wo = qk.conv_out_size(H, W, k, stride)
    if plan is None:
        plan = qk.conv_plan(B, H, W, C, Co, k, stride, sms)
    M, K, pad = plan.M, plan.K, k // 2
    m = torch.arange(M)
    b, rem = m // (Ho * Wo), m % (Ho * Wo)
    ih0, iw0 = (rem // Wo) * stride - pad, (rem % Wo) * stride - pad
    xf = x.reshape(-1).to(torch.int64)
    wk = torch.zeros(plan.n_tiles * plan.bn, K, dtype=torch.int64)
    wk[:Co] = w.reshape(Co, K).to(torch.int64)

    def a_slice(sl: int) -> torch.Tensor:
        """(M, 128) int64: the staged A slice ``sl``."""
        kk = sl * qk.SLICE + torch.arange(qk.SLICE)
        if not plan.byte_route:  # whole 16-byte chunks: one tap each
            kk = (kk // 16) * 16
        tap, ch = kk // C, kk % C
        if not plan.byte_route:
            ch = ch + torch.arange(qk.SLICE) % 16
        r, s = tap // k, tap % k
        ih, iw = ih0[:, None] + r, iw0[:, None] + s
        inside = ((ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
                  & ((sl * qk.SLICE + torch.arange(qk.SLICE)) < K))
        idx = ((b[:, None] * H + ih.clamp(0, H - 1)) * W
               + iw.clamp(0, W - 1)) * C + ch.clamp(0, C - 1)
        return torch.where(inside, xf[idx], torch.zeros((), dtype=torch.int64))

    total = torch.zeros(M, plan.n_tiles * plan.bn, dtype=torch.int32)
    for z in range(plan.splits):
        part = torch.zeros(M, plan.n_tiles * plan.bn, dtype=torch.int64)
        for sl in range(z * plan.per_split,
                        min(plan.slices, (z + 1) * plan.per_split)):
            kk = sl * qk.SLICE + torch.arange(qk.SLICE)
            b_sl = torch.where(kk < K, wk[:, kk.clamp(max=K - 1)],
                               torch.zeros((), dtype=torch.int64))
            part += _exact_mm(a_slice(sl), b_sl)
        total += part.to(torch.int32)  # int32 partials, summed exactly
    acc = total[:, :Co].reshape(B, Ho, Wo, Co)
    return qk._epilogue(acc, x_scale, eff_scale, eff_bias, residual, res_scale,
                     relu, out_scale).contiguous()


def dense_tiled_emulation(x: torch.Tensor, w: torch.Tensor,
                          w_scale: torch.Tensor, bias: torch.Tensor,
                          in_scale: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32,
                          plan: Optional[qk.DensePlan] = None,
                          sms: int = 132) -> torch.Tensor:
    """K10 as ``plan`` tiles it (default: ``dense_plan`` at ``sms``), on
    the CPU: each block's rows quantized once into (64 wg, Kp) int8, zero
    past K and past M; the padded weights (``padded_dense_weight``); each
    block's N tiles (its split of them) over the 128-byte depth slices;
    then the epilogue.  Equal to ``qdense_reference``."""
    K, N = x.shape[-1], w.shape[0]
    rows = x.reshape(-1, K)
    M = rows.shape[0]
    if plan is None:
        plan = qk.dense_plan(M, K, N, sms)
    BM = 64 * plan.wg
    inv = 1.0 / in_scale.float()
    wp = qk.padded_dense_weight(w, plan.Kp, plan.n_tiles * qk.DENSE_TILE_N)
    acc = torch.zeros(plan.m_tiles * BM, plan.n_tiles * qk.DENSE_TILE_N,
                      dtype=torch.int32)
    for mt in range(plan.m_tiles):
        res = torch.zeros(BM, plan.slices * qk.SLICE, dtype=torch.int64)
        blk = rows[mt * BM:(mt + 1) * BM].float()
        res[:blk.shape[0], :K] = torch.clamp(torch.round(blk * inv),
                                             -qk.INT8_MAX, qk.INT8_MAX).long()
        for sp in range(plan.n_split):
            for nt in range(sp * plan.per_split,
                            min(plan.n_tiles, (sp + 1) * plan.per_split)):
                cols = slice(nt * qk.DENSE_TILE_N, (nt + 1) * qk.DENSE_TILE_N)
                tile = torch.zeros(BM, qk.DENSE_TILE_N, dtype=torch.int64)
                for sl in range(plan.slices):
                    depth = slice(sl * qk.SLICE, min((sl + 1) * qk.SLICE, plan.Kp))
                    tile += _exact_mm(res[:, depth],
                                      wp[cols, depth].long())
                acc[mt * BM:(mt + 1) * BM, cols] = tile.to(torch.int32)
    out = qk._epilogue(acc[:M, :N], in_scale, w_scale, bias, None, None, False,
                    None)
    return out.to(out_dtype).reshape(*x.shape[:-1], N)


# (B, H, W, C, Co, k, stride, relu, out, residual, sms): the stem (C = 3,
# the byte route), stride 2, odd W, Co = 32, Co past one N tile (288),
# a ragged last depth step (K % 32 == 16), int8 and float32 residuals,
# int8 and float32 outputs, and plans split over the depth (few SMs'
# worth of tiles: sms large against M)
CONV_CASES = [
    (2, 17, 13, 3, 64, 3, 2, True, "int8", None, 132),
    (1, 9, 7, 32, 32, 3, 1, True, "int8", "int8", 132),
    (2, 8, 11, 64, 32, 3, 2, False, "float32", None, 132),
    (1, 6, 5, 256, 64, 3, 1, True, "int8", "int8", 132),
    (1, 5, 7, 64, 288, 1, 1, True, "int8", "float32", 132),
    (2, 7, 9, 48, 40, 1, 1, False, "float32", None, 132),
    (1, 6, 6, 128, 128, 3, 2, True, "int8", None, 4096),
    (3, 5, 3, 16, 32, 3, 1, False, "float32", "float32", 132),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(
    map(str, c[:7])) + f"-{c[8]}-{c[9]}")
def test_conv_tiled_emulation_equals_reference(case):
    B, H, W, C, Co, k, stride, relu, out, res, sms = case
    g = torch.Generator().manual_seed(B * 1000 + H * 10 + C)
    args, kw = _conv_inputs(g, B, H, W, C, Co, k, stride, res)
    kw["relu"] = relu
    if out == "int8":
        kw["out_scale"] = torch.rand((), generator=g) * 0.5 + 0.5
    plan = qk.conv_plan(B, H, W, C, Co, k, stride, sms)
    if sms > 132:  # this case is there to split the depth
        assert plan.splits > 1, plan
    want = qk.qconv_reference(*args, **kw)
    got = conv_tiled_emulation(*args, **kw, sms=sms)
    assert got.dtype == want.dtype and torch.equal(got, want), plan


# (rows, K, N, x dtype, out dtype, sms): K = 156 (a ragged 16-byte chunk
# and depth step), K past one resident slice, N past one tile and not a
# multiple of 8 (78, 156, 468), rows past one block, N split over blocks
DENSE_CASES = [
    (150, 156, 468, torch.bfloat16, torch.bfloat16, 132),
    (70, 156, 78, torch.float32, torch.float32, 132),
    (200, 312, 156, torch.bfloat16, torch.float32, 4096),
    (65, 300, 130, torch.float32, torch.bfloat16, 132),
    (33, 624, 260, torch.bfloat16, torch.bfloat16, 4096),
]


@pytest.mark.parametrize("case", DENSE_CASES, ids=lambda c: "x".join(
    map(str, c[:3])) + f"-{str(c[3])[6:]}-{str(c[4])[6:]}")
def test_dense_tiled_emulation_equals_reference(case):
    rows, K, N, xd, od, sms = case
    g = torch.Generator().manual_seed(rows + K + N)
    x = (torch.randn(rows, K, generator=g) * 2).to(xd)
    w = torch.randint(-127, 128, (N, K), dtype=torch.int8, generator=g)
    w_scale = torch.rand(N, generator=g) * 1e-3 + 1e-3
    bias = torch.randn(N, generator=g)
    in_scale = torch.rand((), generator=g) * 0.01 + 0.02
    plan = qk.dense_plan(rows, K, N, sms)
    if sms > 132:
        assert plan.n_split > 1, plan
    want = qk.qdense_reference(x, w, w_scale, bias, in_scale, od)
    got = dense_tiled_emulation(x, w, w_scale, bias, in_scale, od,
                                 sms=sms)
    assert got.dtype == want.dtype == od and torch.equal(got, want), plan


def test_padded_weights_are_cached_and_follow_the_tensor():
    w = torch.randint(-127, 128, (78, 156), dtype=torch.int8)
    a = qk.padded_dense_weight(w, 160, 128)
    assert a.shape == (128, 160) and torch.equal(a[:78, :156], w)
    assert not a[78:].any() and not a[:, 156:].any()
    assert qk.padded_dense_weight(w, 160, 128) is a
    w[0, 0] = -w[0, 0] if w[0, 0] else 5  # in place: made again
    b = qk.padded_dense_weight(w, 160, 128)
    assert b is not a and torch.equal(b[:78, :156], w)


def test_int8_state_dicts_keep_their_keys():
    conv = QConvNorm(32, 64, 3)
    dense = QDense(156, 468)
    qk.padded_dense_weight(dense.w_int8, 160, 512)
    assert list(conv.state_dict()) == ["w_int8", "eff_scale", "eff_bias",
                                       "out_scale"]
    assert list(dense.state_dict()) == ["w_int8", "w_scale", "bias",
                                        "in_scale"]
    assert dense.state_dict()["w_int8"].shape == (468, 156)


def test_split_buffers_are_kept_per_stream():
    """K9's split-K partials and counters: one pair per (card, stream), so
    that split launches on two streams never share them; grown, never
    shrunk, for a larger plan."""
    dev = torch.device("cpu")  # the bookkeeping is the same on a card
    qk._SPLIT_BUFFERS.clear()
    try:
        a_ws, a_cnt = qk._split_buffers(dev, 11, 64, 4)
        b_ws, b_cnt = qk._split_buffers(dev, 22, 64, 4)
        assert a_ws.data_ptr() != b_ws.data_ptr()
        assert a_cnt.data_ptr() != b_cnt.data_ptr()
        assert qk._split_buffers(dev, 11, 32, 2)[0] is a_ws
        c_ws, c_cnt = qk._split_buffers(dev, 11, 128, 8)
        assert c_ws.numel() >= 128 and c_cnt.numel() >= 8
        assert not c_cnt.any()
        assert qk._split_buffers(dev, 22, 64, 4)[0] is b_ws
    finally:
        qk._SPLIT_BUFFERS.clear()


def test_ablated_variants_refuse_the_cpu():
    """The one-phase variants are a measurement on the card: no plain
    version stands in for them."""
    x = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    w = torch.zeros(16, 3, 3, 16, dtype=torch.int8)
    one = torch.ones(())
    with pytest.raises(ValueError, match="on the card only"):
        qk._qconv_ablate(2, x, one, w, torch.ones(16), torch.zeros(16))
    with pytest.raises(ValueError, match="on the card only"):
        qk._qdense_ablate(2, torch.zeros(4, 16), torch.zeros(8, 16,
                          dtype=torch.int8), torch.ones(8), torch.zeros(8),
                          one)
