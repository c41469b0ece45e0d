"""PyTorch port, the tensor-core W-MSA backward core that K2 and K4's
backward share (csrc/wmsa_core.cuh): its split-bf16 arithmetic,
emulated in plain PyTorch (``window_msa.attention_bwd_core_emulation``),
against the float32 plain versions, and the Python side of the kernels'
geometry.

A CUDA kernel cannot run here; its products are bf16 x bf16 -> float32
tensor-core products of bf16 terms of each operand, which the emulation
repeats term for term (each product of terms is exact in float32).  With
the term counts the kernels use, the emulation must hold the bounds that
chip_smoke.py holds the kernels to on the card, unchanged:
  * K2 (phase 3): dqkv within F32_ATOL (atol = rtol = 1e-4) for float32
    inputs and BF16_TOL (2e-2) for bf16 inputs, dbias within DBIAS_TOL
    (1e-4, absolute and relative), summed over the training batch's windows;
  * K4's attention core (phase 7): each output's relative norm of the
    difference within FUSED_REL_TOL[float32] (1e-3) and every element
    within FUSED_LOCAL_TOL (2^-4) of the output's largest magnitude.
Inputs are numpy-seeded at hrformer_base's b0 (N 49, hd 39, H 2; K2 at
the 2,240 windows of a batch of 32) and b3 (H 16, 64 windows) shapes.  No JAX:
the plain versions are the port's own spec, held against JAX in
tests/test_torch_msa.py and tests/test_torch_fused_block.py.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402  (the card's bounds, one source of truth)
from infantposeestimation_gaussianbias_tpu_torch.kernels import (  # noqa: E402
    fused_block, window_msa)

SHAPES = {"b0": (2240, 49, 2, 39), "b3": (64, 49, 16, 39)}


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(nW, N, H*hd) -> (nW, H, N, hd)."""
    nW, N, C = t.shape
    return t.reshape(nW, N, H, C // H).permute(0, 2, 1, 3)


def _flat(t: torch.Tensor) -> torch.Tensor:
    """(nW, H, N, hd) -> (nW, N, H*hd)."""
    nW, H, N, hd = t.shape
    return t.permute(0, 2, 1, 3).reshape(nW, N, H * hd)


@functools.lru_cache(maxsize=None)
def _k2_case(branch: str, dtype: torch.dtype):
    """Numpy-seeded K2 inputs of a branch and the plain version's result:
    (q, k, v, do as float32 (nW, H, N, hd), bias, dqkv, dbias)."""
    nW, N, H, hd = SHAPES[branch]
    C = H * hd
    rng = np.random.RandomState(nW + H)
    qkv = torch.from_numpy(rng.randn(nW, N, 3 * C).astype(np.float32)).to(dtype)
    dout = torch.from_numpy(rng.randn(nW, N, C).astype(np.float32)).to(dtype)
    bias = torch.from_numpy(rng.randn(H, N, N).astype(np.float32))
    ref_dqkv, ref_dbias = window_msa.window_attention_qkv_bwd_reference(
        qkv, bias, dout, H)
    q, k, v = (_heads(t, H) for t in qkv.float().chunk(3, dim=-1))
    return q, k, v, _heads(dout.float(), H), bias, ref_dqkv, ref_dbias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("branch", sorted(SHAPES))
def test_k2_core_emulation_holds_k2_bounds(branch, dtype):
    q, k, v, do, bias, ref_dqkv, ref_dbias = _k2_case(branch, dtype)
    dq, dk, dv, dbias, o = window_msa.attention_bwd_core_emulation(
        q, k, v, do, bias, window_msa.K2_CORE_TERMS[dtype])
    assert o is None
    dqkv = torch.cat([_flat(dq), _flat(dk), _flat(dv)], dim=-1).to(dtype)
    tol = chip_smoke.F32_ATOL if dtype == torch.float32 else chip_smoke.BF16_TOL
    torch.testing.assert_close(dqkv.float(), ref_dqkv.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(dbias, ref_dbias, atol=chip_smoke.DBIAS_TOL,
                               rtol=chip_smoke.DBIAS_TOL)


def test_k2_float32_needs_three_terms():
    """Three terms is the least that holds: with two bf16 terms of K2's
    float32 q, k, v, dO, dbias summed over b0's 2,240 windows leaves
    DBIAS_TOL."""
    q, k, v, do, bias, _, ref_dbias = _k2_case("b0", torch.float32)
    dbias = window_msa.attention_bwd_core_emulation(q, k, v, do, bias, 2)[3]
    tol = chip_smoke.DBIAS_TOL
    assert ((dbias - ref_dbias).abs() > tol + tol * ref_dbias.abs()).any()


def _k4_core_inputs(branch: str):
    """K4's attention-core operands as its plain backward makes them: q, k,
    v from the masked qkv recompute, do_h from bf16(dp dy) and Wproj, at the
    branch's map size (64 x 48 at b0, 8 x 6 at b3, windows of 7) and batch
    (2 images at b0, 32 at b3)."""
    _, N, H, hd = SHAPES[branch]
    C = H * hd
    geom, B = {"b0": ((64, 48, 7), 2), "b3": ((8, 6, 7), 32)}[branch]
    nW = B * fused_block.window_geometry(geom)[0]
    rng = np.random.RandomState(C)

    def rn(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    xw, dy = rn(nW, N, C), rn(nW, N, C)
    gamma, beta = 1 + 0.2 * rn(C), 0.1 * rn(C)
    wqkv, bqkv = rn(C, 3 * C, scale=C ** -0.5), 0.1 * rn(3 * C)
    rpe, wproj = rn(H, N, N), rn(C, C, scale=C ** -0.5)
    dp = torch.from_numpy((rng.rand(B) > 0.2).astype(np.float32) / 0.8)
    *_, (q, k, v), p, o = fused_block._attn_forward_parts(
        xw, gamma, beta, wqkv, bqkv, rpe, H, geom)
    nwin = fused_block.window_geometry(geom)[0]
    dpo = fused_block._row_scale(dp, nW, nwin)[:, :, None] * dy
    do = _heads(fused_block._bf16(dpo) @ wproj.t(), H)
    return q, k, v, do, rpe, p, _heads(o, H)


@pytest.mark.parametrize("branch", sorted(SHAPES))
def test_k4_core_emulation_holds_fused_bounds(branch):
    q, k, v, do, rpe, p, o = _k4_core_inputs(branch)
    hd = q.shape[-1]
    scale = hd ** -0.5
    # K4's plain backward (fused_attn_half_bwd_reference), its core alone
    dv = p.transpose(-2, -1) @ do
    dprob = do @ v.transpose(-2, -1)
    ds = p * (dprob - (dprob * p).sum(dim=-1, keepdim=True))
    refs = (scale * (ds @ k), scale * (ds.transpose(-2, -1) @ q), dv,
            ds.sum(dim=0), o)
    outs = window_msa.attention_bwd_core_emulation(
        q, k, v, do, rpe, window_msa.K4_CORE_TERMS, with_o=True)
    for name, out, ref in zip(("dq", "dk", "dv", "drpe", "o"), outs, refs):
        diff = out - ref
        rel = (diff.norm() / ref.norm()).item()
        assert rel <= chip_smoke.FUSED_REL_TOL[torch.float32], (name, rel)
        assert (diff.abs().max()
                <= chip_smoke.FUSED_LOCAL_TOL * ref.abs().max()), name


@pytest.mark.parametrize("N,hd", [(49, 39), (64, 39), (49, 32)])
def test_core_emulation_keeps_padding_out(N, hd):
    """The padded tokens take no share of the softmax: with v all ones, O =
    rowsum(P) is 1 on every real row (1 - 49/64 if the 15 pad tokens of N
    = 49 took their share)."""
    rng = np.random.RandomState(N + hd)
    q, k, do = (torch.from_numpy(rng.randn(3, 2, N, hd).astype(np.float32))
                for _ in range(3))
    bias = torch.from_numpy(rng.randn(2, N, N).astype(np.float32))
    out = window_msa.attention_bwd_core_emulation(
        q, k, torch.ones_like(q), do, bias, 3, with_o=True)
    assert all(t.shape == q.shape for t in (out[0], out[1], out[2], out[4]))
    assert out[3].shape == bias.shape
    torch.testing.assert_close(out[4], torch.ones_like(q), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("N,hd,want", [(49, 39, (64, 48)), (64, 39, (64, 48)),
                                       (49, 32, (64, 32)), (16, 8, (16, 16))])
def test_core_padding(N, hd, want):
    assert window_msa.core_padding(N, hd) == want


@pytest.mark.parametrize("dtype,terms", [(torch.bfloat16, 1),
                                         (torch.float32, 3)])
def test_split_terms_are_exact_to_their_count(dtype, terms):
    """A bf16 input is one exact term; three terms hold a float32 to its
    last bit (8 + 8 + 8 significant bits)."""
    x = torch.from_numpy(np.random.RandomState(1).randn(4096)
                         .astype(np.float32)).to(dtype).float()
    parts = window_msa.split_terms(x, terms)
    total = parts[0]
    for t in parts[1:]:
        total = total + t
    assert torch.equal(total, x)
    assert all(torch.equal(t, t.to(torch.bfloat16).float()) for t in parts)


@pytest.mark.parametrize("branch,ws,sms,wpb,chunks", [
    ("b0", 7, 132, 9, 249), ("b3", 7, 132, 2, 32), ("b0", 8, 132, 6, 256),
    ("b3", 8, 132, 1, 32)])
def test_attn_bwd_plan(branch, ws, sms, wpb, chunks):
    """K4's backward chunks: stage (b) one block per (chunk, head) as K2's
    grid, ~4 blocks per SM (b3: 512 blocks, not the 64 of one block per
    window); partial rows per window and per chunk (drpe per chunk, not per
    window)."""
    _, N, H, hd = SHAPES[branch]
    N = ws * ws
    C = H * hd
    nW = {"b0": 32 * (-(-64 // ws)) * (-(-48 // ws)),
          "b3": 32 * (-(-8 // ws)) * (-(-6 // ws))}[branch]
    plan = fused_block.attn_bwd_plan(nW, N, C, H, sms)
    assert (plan["wpb"], plan["chunks"]) == (wpb, chunks)
    assert plan["wpb"] == window_msa.bwd_windows_per_block(nW, H, sms)
    assert (chunks - 1) * wpb < nW <= chunks * wpb
    assert plan["rows_part"] == (nW, 3 * C)
    assert plan["chunk_part"] == (chunks, 3 * C + H * N * N)
    assert plan["stats"] == (2, nW * N)
