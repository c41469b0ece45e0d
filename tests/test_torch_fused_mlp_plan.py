"""PyTorch port, K5's tiling (csrc/fused_mlp.cu, csrc/mlp_gemm.cuh) on the
CPU: the host plan (``fused_block.mlp_plan``) that picks every stage's
tile, the weights as the kernels read them (bf16 rows padded by the wrapper,
``mlp_weight_rows``; float32 weights split on the card into three bf16
terms, ``split_terms`` below in plain PyTorch), and a plain-PyTorch
emulation of the backward's tiling held against the plain version
``fused_mlp_half_bwd_reference``.

A CUDA kernel cannot run here.  What the kernels add to the plain version's
maths is where the padding lies (C rounded up to 8, zero) and the order of
every split sum: dln over the hidden dimension in slices of 64 in order;
db1 per row tile of the hidden stage, db2, dgamma and dbeta per LayerNorm
block, each partial row summed by the fixed-order column sum (8 strided
row groups, then the groups in order); dW1 and dW2 per row chunk, added in
chunk order.  The emulation repeats those at hrformer_base's real widths on
a small M and must hold the bounds that chip_smoke.py holds the kernels to
on the card (phase 7), unchanged: each output's relative norm of the
difference within FUSED_REL_TOL and every element within FUSED_LOCAL_TOL of
the output's largest magnitude.  No JAX: the plain version is the port's
own spec, held against the JAX kernel in tests/test_torch_fused_block.py.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402  (the card's bounds, one source of truth)
from infantposeestimation_gaussianbias_tpu_torch.kernels import (  # noqa: E402
    fused_block as fb)

SMS = 132  # the H100's SMs
# The branches of the named HRFormer configs: (map H, map W, C, heads),
# hidden = 4C.  hrformer_base at 256x192 ("b0"-"b3"), hrformer_small at
# 256x192 (C 32-256), hrformer_base_384 at 384x288 (base's widths, 154 /
# 42 / 12 / 4 windows an image).
BRANCHES = {"b0": (64, 48, 78, 2), "b1": (32, 24, 156, 4),
            "b2": (16, 12, 312, 8), "b3": (8, 6, 624, 16),
            "small_b0": (64, 48, 32, 1), "small_b1": (32, 24, 64, 2),
            "small_b2": (16, 12, 128, 4), "small_b3": (8, 6, 256, 8),
            "b384_b0": (96, 72, 78, 2), "b384_b1": (48, 36, 156, 4),
            "b384_b2": (24, 18, 312, 8), "b384_b3": (12, 9, 624, 16)}
# Each config's training batch and the served batch (32 crops, flipped).
BATCHES = {"": (32, 64), "small_": (32, 64), "b384_": (16, 64)}
PLAN_CASES = [(branch, ws, batch, terms)
              for branch in BRANCHES for ws in (7, 8)
              for batch in BATCHES[branch[:branch.index("b", 1)]
                                   if "_" in branch else ""]
              for terms in (1, 3)]
# The plans whose grids fall short of one wave of 132 blocks, by stage: at
# window 8 and the training batch hrformer_small's two narrow maps hold
# few rows (b2: 12 windows of 64 tokens an image, 8,192 rows; b3: 2, 2,048
# rows), so its weight-gradient reductions (atb), b3's fc2 and dln
# products, b2's float32 single-block forward (one block per 64 rows) and
# b3's proj tile of K4's forward take fewer blocks than SMs.  Everywhere
# else every stage fills the card.
MLP_SHORT = {("small_b2", 8, 32): {"atb", "single"},
             ("small_b3", 8, 32): {"fc2", "dln", "atb"}}
ATTN_SHORT = {("small_b3", 8, 32): {"proj"}}
ATTN_CASES = sorted({case[:3] for case in PLAN_CASES})


def _rows(branch: str, ws: int, batch: int) -> int:
    Hm, Wm = BRANCHES[branch][:2]
    return batch * -(-Hm // ws) * -(-Wm // ws) * ws * ws


def split_terms(w: torch.Tensor, width: int) -> torch.Tensor:
    """csrc/fused_common.cuh ``split_weights_kernel`` in plain PyTorch: a
    float32 (R, K) weight as (3, R, width) bf16 terms, each the rounding of
    what the terms before it left, columns K .. width zero."""
    R, K = w.shape
    out = torch.zeros((3, R, width), dtype=torch.bfloat16)
    rest = w.float()
    for t in range(3):
        out[t, :, :K] = rest
        rest = rest - out[t, :, :K].float()
    return out


def staged(w: torch.Tensor, width: int) -> torch.Tensor:
    """An (R, K) weight as K5's products read it, the float32 sum of its
    bf16 terms, (R, width)."""
    if w.dtype == torch.bfloat16:
        return fb.mlp_weight_rows(w, width).float()
    return split_terms(w, width).float().sum(dim=0)


def _case_id(case) -> str:
    return "-".join(map(str, case))


@pytest.mark.parametrize("branch,ws,batch,terms", PLAN_CASES,
                         ids=map(_case_id, PLAN_CASES))
def test_mlp_plan_fits_and_fills_the_card(branch, ws, batch, terms):
    """At every branch of hrformer_base, hrformer_small and
    hrformer_base_384, window 7 and 8, the training and the served batch:
    the plan takes the rows (within the grid's row bound) and every tile
    stays a legal one; every product stage's grid holds one full wave of
    132 blocks (so do the LayerNorm stages' and the weight-gradient
    reduction's), except the stages MLP_SHORT names; the partial rows
    match the grids that write them.  That every tile fits the 232,448 B
    a block may opt in to, csrc/fused_mlp.cu asserts when it compiles."""
    C = BRANCHES[branch][2]
    M = _rows(branch, ws, batch)
    plan = fb.mlp_plan(M, C, 4 * C, SMS, terms)
    assert -(-M // fb.MLP_TILES[0][0]) <= 65535  # the rows' grid bound
    assert plan["width"] % 8 == 0 and 0 <= plan["width"] - C < 8
    assert all(plan[stage] in range(len(fb.MLP_TILES))
               for stage in ("fc1", "fc2", "hidden", "dln"))
    short = {stage for stage in ("fc1", "fc2", "hidden", "dln")
             if fb.mlp_blocks(M, 4 * C if stage in ("fc1", "hidden") else C,
                              plan[stage]) < SMS}
    assert plan["hidden"] <= 1  # two accumulator sets
    # the float32 single-block form at C <= 160 only (base b0, b1 and
    # every small branch but b3), one block per 64 rows
    assert plan["single"] == (C <= 160 and terms == 3)
    if plan["single"] and -(-M // 64) < SMS:
        short.add("single")
    rpb = plan["rows_per_block"]
    assert 8 <= rpb <= 64
    if -(-M // rpb) < SMS:
        short.add("rows_per_block")
    tiles = -(-4 * C // fb._ATB_TILE) * -(-C // fb._ATB_TILE)
    if not all(tiles * s >= SMS for s in plan["atb_splits"]):
        short.add("atb")
    assert short == MLP_SHORT.get((branch, ws, batch), set()) - (
        set() if plan["single"] else {"single"}), (short, plan)
    assert plan["part_rows"] == (-(-M // rpb), 3 * C)
    bm = fb.MLP_TILES[plan["hidden"]][0]
    assert plan["part_hidden"] == (-(-M // bm), 4 * C)


@pytest.mark.parametrize("branch,ws,batch", ATTN_CASES,
                         ids=map(_case_id, ATTN_CASES))
def test_attn_fwd_plan_fits_and_fills_the_card(branch, ws, batch):
    """K4's forward plan at the same shapes: 16-byte ln and o rows, stage
    (b)'s chunks the backward's, a wave of at least 132 (chunk, head)
    blocks at every shape, and stage (c)'s tile by K5's rule, its grid one
    full wave except where ATTN_SHORT says."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        window_msa)

    Hm, Wm, C, H = BRANCHES[branch]
    nW = batch * fb.window_geometry((Hm, Wm, ws))[0]
    M = nW * ws * ws
    assert M == _rows(branch, ws, batch)
    plan = fb.attn_fwd_plan(nW, ws * ws, C, H, SMS)
    assert plan["width"] % 8 == 0 and 0 <= plan["width"] - C < 8
    assert plan["wpb"] == window_msa.bwd_windows_per_block(nW, H, SMS)
    assert -(-nW // plan["wpb"]) * H >= SMS, plan
    assert plan["proj"] == fb._mlp_tile(M, C, SMS)
    short = {"proj"} if fb.mlp_blocks(M, C, plan["proj"]) < SMS else set()
    assert short == ATTN_SHORT.get((branch, ws, batch), set()), plan


@pytest.mark.parametrize("M,C,hidden", [(64, 77, 308), (64, 642, 2568),
                                        (64, 624, 2500),
                                        (64 * 65536, 78, 312)])
def test_mlp_plan_rejects_shapes_the_kernels_do_not_take(M, C, hidden):
    """An odd C, C > 640, hidden not a multiple of 8 or more row tiles than
    a grid dimension holds: the plan raises before any launch."""
    with pytest.raises(ValueError):
        fb.mlp_plan(M, C, hidden, SMS)


@pytest.mark.parametrize("C,width", [(78, 80), (156, 160), (312, 312),
                                     (624, 624)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_terms_sum_to_the_weight(C, width, dtype):
    """The weight as the products read it: a float32 one as three bf16
    terms (the card's split) whose float32 sum is the weight bit for bit, a
    bf16 one as itself (the wrapper's rows); columns C .. width zero; no
    copy for a bf16 weight whose rows need no padding."""
    rng = np.random.RandomState(C)
    w = torch.from_numpy(rng.randn(4 * C, C).astype(np.float32) * C ** -0.5)
    w = w.to(dtype)
    if dtype == torch.float32:
        terms = split_terms(w, width)
        with pytest.raises(ValueError):
            fb.mlp_weight_rows(w, width)
    else:
        t = fb.mlp_weight_rows(w, width)
        # from the transposed view of an (in, out) weight: the same array
        assert torch.equal(fb.mlp_weight_rows(w.t().contiguous().t(), width),
                           t)
        assert t.is_contiguous()
        if width == C:
            assert t.data_ptr() == w.data_ptr()
        terms = t[None]
    assert terms.dtype == torch.bfloat16
    assert terms.shape == ((3 if dtype == torch.float32 else 1), 4 * C, width)
    total = terms[0].float()
    for extra in terms[1:]:
        total = total + extra.float()
    assert torch.equal(total[:, :C], w.float())
    assert not torch.any(terms[:, :, C:].float())


def _colsum(part: torch.Tensor) -> torch.Tensor:
    """fused_common.cuh ``colsum_kernel``: rows r = ry, ry + 8, ... summed
    per group ry in order, then the 8 groups in order."""
    groups = [part[ry::8].sum(dim=0) if ry < part.shape[0]
              else torch.zeros(part.shape[1]) for ry in range(8)]
    out = groups[0]
    for g in groups[1:]:
        out = out + g
    return out


def _blocks(t: torch.Tensor, rows: int) -> torch.Tensor:
    """Per block of ``rows`` rows, the column sums: one partial row each."""
    return torch.stack([c.sum(dim=0) for c in t.split(rows)])


def _atb(a: torch.Tensor, b: torch.Tensor, splits: int) -> torch.Tensor:
    """fused_common.cuh ``launch_atb``: a^T b per chunk of rows (chunks of
    ceil(M / splits) rounded up to the 64-row slice), added in chunk
    order."""
    M = a.shape[0]
    chunk = -(-(-(-M // splits)) // 64) * 64
    out = torch.zeros(a.shape[1], b.shape[1])
    for z in range(splits):
        out = out + a[z * chunk:(z + 1) * chunk].t() @ b[z * chunk:(z + 1) * chunk]
    return out


def mlp_bwd_tiled(x2, gamma, beta, w1, b1, w2, b2, dp, dy, tps, plan):
    """K5's backward as the kernels tile it (see the module doc), in plain
    PyTorch: (dx, dgamma, dbeta, dw1, db1, dw2, db2) in the plain version's
    layouts."""
    M, C = x2.shape
    hidden = w1.shape[1]
    width = plan["width"]
    x = x2.float()
    ln, xhat, rstd = fb._layernorm(x, gamma.float(), beta.float())
    # (a) lnb and dob at row stride `width`, zero past C; db2 per block
    lnb = torch.zeros(M, width)
    lnb[:, :C] = fb._bf16(ln)
    do = fb._row_scale(dp, M, tps) * dy.float()
    dob = torch.zeros(M, width)
    dob[:, :C] = fb._bf16(do)
    rpb = plan["rows_per_block"]
    db2 = _colsum(_blocks(do, rpb))
    # the weights as staged: W1 (hidden, width), W2 (C, hidden), term sums
    w1p, w2p = staged(w1.t(), width), staged(w2.t(), hidden)
    # (b) h and dg over the padded k; db1 per row tile of the hidden stage
    h = lnb @ w1p.t() + b1.float()
    dh = (dob[:, :C] @ w2p) * fb.gelu_tanh_grad(h)  # W2's rows past C: zero
    gb, dhb = fb._bf16(fb.gelu_tanh(h)), fb._bf16(dh)
    db1 = _colsum(_blocks(dh, fb.MLP_TILES[plan["hidden"]][0]))
    # (c) dln over the hidden dimension in 64-deep slices, in order; the
    # LayerNorm backward per row; dgamma and dbeta per block
    dln = torch.zeros(M, width)
    for k in range(0, hidden, 64):
        dln = dln + dhb[:, k:k + 64] @ w1p[k:k + 64]
    dln = dln[:, :C]
    dgamma = _colsum(_blocks(dln * xhat, rpb))
    dbeta = _colsum(_blocks(dln, rpb))
    dx = dy.float() + fb._layernorm_bwd(dln, xhat, rstd, gamma.float())
    # (d) the weight gradients by row chunks
    s1, s2 = plan["atb_splits"]
    dw1 = _atb(dhb, lnb[:, :C], s1)  # (hidden, C)
    dw2 = _atb(dob[:, :C], gb, s2)   # (C, hidden)
    return (dx.to(x2.dtype), dgamma, dbeta, dw1.t().to(w1.dtype), db1,
            dw2.t().to(w2.dtype), db2)


def _inputs(C: int, M: int, tps: int, dtype, seed: int):
    """Numpy-seeded K5 inputs as chip_smoke.py's ``_half_inputs`` makes
    them (weights in the (in, out) layout, a DropPath vector that drops
    one sample)."""
    rng = np.random.RandomState(seed)

    def rn(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    hidden = 4 * C
    samples = -(-M // tps)
    dp = torch.full((samples,), 1 / 0.8)
    dp[1] = 0.0
    return dict(x2=rn(M, C).to(dtype), gamma=1 + 0.2 * rn(C), beta=0.1 * rn(C),
                w1=rn(C, hidden, scale=C ** -0.5).to(dtype), b1=0.1 * rn(hidden),
                w2=rn(hidden, C, scale=hidden ** -0.5).to(dtype),
                b2=0.1 * rn(C), dp=dp, dy=rn(M, C).to(dtype), tps=tps)


NAMES = ["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("branch", sorted(b for b in BRANCHES
                                          if not b.startswith("b384")))
def test_tiled_backward_holds_phase7_bounds(branch, dtype):
    """The backward's tiling at the branch's real width on 229 rows (three
    full 64-row tiles and a ragged one, ragged LayerNorm blocks, several
    row chunks) against the plain version, to the card's bounds."""
    C = BRANCHES[branch][2]
    M, tps = 229, 49
    a = _inputs(C, M, tps, dtype, seed=C)
    plan = dict(fb.mlp_plan(M, C, 4 * C, SMS, 3 if dtype == torch.float32 else 1),
                atb_splits=(3, 2))  # several chunks at this M
    args = (a["x2"], a["gamma"], a["beta"], a["w1"], a["b1"], a["w2"], a["b2"],
            a["dp"])
    got = mlp_bwd_tiled(*args, a["dy"], tps, plan)
    want = fb.fused_mlp_half_bwd_reference(*args, a["dy"], tps)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err, rel, big = chip_smoke._err(g, w)
        assert rel <= chip_smoke.FUSED_REL_TOL[dtype], (name, rel)
        assert err <= chip_smoke.FUSED_LOCAL_TOL * big, (name, err, big)


def test_tiled_backward_zero_padding_at_c78():
    """At C = 78 the k loops run to 80 (16-byte rows): W1's staged padding
    columns are zero, and the padded tiling gives what the same tiling
    without padding gives, up to float32 rounding of the products."""
    C, M, tps = 78, 229, 49
    a = _inputs(C, M, tps, torch.float32, seed=3)
    plan = fb.mlp_plan(M, C, 4 * C, SMS, 3)
    assert plan["width"] == 80
    w1p = split_terms(a["w1"].t(), 80)
    assert w1p.shape == (3, 4 * C, 80) and not torch.any(w1p[:, :, C:].float())
    args = (a["x2"], a["gamma"], a["beta"], a["w1"], a["b1"], a["w2"], a["b2"],
            a["dp"], a["dy"], tps)
    padded = mlp_bwd_tiled(*args, plan)
    unpadded = mlp_bwd_tiled(*args, dict(plan, width=C))
    for name, p, u in zip(NAMES, padded, unpadded):
        err, _, big = chip_smoke._err(p, u)
        assert err <= 1e-5 * big, (name, err, big)


def test_forward_tiling_matches_plain_version():
    """The forward as the three-stage form computes it, padded to width 80
    at C = 78 (bf16 lnb and g), against the plain version: the padding adds
    exact zeros."""
    C, M, tps = 78, 229, 49
    a = _inputs(C, M, tps, torch.bfloat16, seed=4)
    width = fb.mlp_plan(M, C, 4 * C, SMS)["width"]
    x = a["x2"].float()
    ln, _, _ = fb._layernorm(x, a["gamma"], a["beta"])
    lnb = torch.zeros(M, width)
    lnb[:, :C] = fb._bf16(ln)
    w1p = staged(a["w1"].t(), width)
    g = fb._bf16(fb.gelu_tanh(lnb @ w1p.t() + a["b1"]))
    w2p = staged(a["w2"].t(), 4 * C)
    y = (x + fb._row_scale(a["dp"], M, tps) * (g @ w2p.t() + a["b2"])).to(
        torch.bfloat16)
    want = fb.fused_mlp_half_reference(
        a["x2"], a["gamma"], a["beta"], a["w1"], a["b1"], a["w2"], a["b2"],
        a["dp"], tps)
    err, rel, big = chip_smoke._err(y, want)
    assert rel <= chip_smoke.FUSED_REL_TOL[torch.bfloat16]
    assert err <= chip_smoke.FUSED_LOCAL_TOL * big
    assert math.isclose(float(y.float().abs().max()), big, rel_tol=1e-2)
