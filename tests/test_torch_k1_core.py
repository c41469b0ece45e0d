"""PyTorch port, K1 and K1-hm on the tensor-core forward core, on the CPU:
the W-MSA forward as its kernel (csrc/window_msa.cu) computes it, per
(chunk of windows, head) through the forward core's split-bf16 products
(csrc/wmsa_core.cuh ``attention_fwd``), emulated in plain PyTorch
(``window_msa.window_attention_qkv_emulation`` and
``window_attention_hm_emulation``), and the kernel's grid plan.

A CUDA kernel cannot run here.  With K1_CORE_TERMS, the emulation must
hold the bounds that chip_smoke.py holds K1 and K1-hm to on the card,
unchanged: F32_ATOL (absolute, 1e-4) for float32 inputs, BF16_TOL (2e-2,
absolute and relative) for bf16 ones:
  * K1 against ``window_attention_qkv_reference`` and against the JAX
    ``window_attention_pallas_qkv`` (jitted, interpreted), at
    hrformer_base's b0, b3 and b0 window-8 shapes, with and without bias;
  * the float32 term count: the least that holds F32_ATOL at b0 with the
    2,240 windows of a batch of 32 (one term does not);
  * a head range and every windows-per-block value give the whole
    launch's result bit for bit;
  * K1-hm against ``window_attention_hm_reference`` and the JAX
    ``window_attention_pallas_hm``, and equal to K1 bit for bit;
  * ``fwd_plan`` at every chip_smoke BRANCH_SHAPES row at b = 32 and 64:
    the chunks tile the windows, the shared memory fits the opt-in, and the
    grid fills a wave of the H100's 132 SMs.
Inputs are numpy-seeded.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402  (the card's bounds, one source of truth)
from infantposeestimation_gaussianbias_tpu.ops.pallas import (  # noqa: E402
    window_msa as jwm)
from infantposeestimation_gaussianbias_tpu_torch.kernels import (  # noqa: E402
    window_msa)

SMS = 132  # the H100's SMs
# (nW, N, H, hd): hrformer_base's b0 (one image: 70 windows), b3 (two
# images: 4 windows) and b0 at window 8 (one image: 48 windows)
SHAPES = {"b0": (70, 49, 2, 39), "b3": (4, 49, 16, 39),
          "b0 ws8": (48, 64, 2, 39)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: several test processes share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(nW, N, H, hd, seed):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(nW, N, 3 * H * hd).astype(np.float32)
    bias = rng.randn(H, N, N).astype(np.float32)
    return qkv, bias


def _wpb(nW, N, H, hd, dtype):
    return window_msa.fwd_plan(nW, N, hd, H, dtype, SMS)["wpb"]


def _assert_within(out, ref, dtype, what):
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=chip_smoke.F32_ATOL, rtol=0,
                                   msg=what)
    else:
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=chip_smoke.BF16_TOL,
                                   rtol=chip_smoke.BF16_TOL, msg=what)


@functools.lru_cache(maxsize=None)
def _jax_qkv(branch: str, dtype: str, with_bias: bool) -> np.ndarray:
    """The JAX kernel on the branch's inputs (no bias: zeros, its None)."""
    nW, N, H, hd = SHAPES[branch]
    qkv, bias = _inputs(nW, N, H, hd, nW + H)
    jb = jnp.asarray(bias if with_bias else np.zeros_like(bias))
    with jwm.interpret_mode():
        out = jwm.window_attention_pallas_qkv(jnp.asarray(qkv, JDT[dtype]),
                                              jb, H)
        return np.array(out.astype(jnp.float32))


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", sorted(TDT))
@pytest.mark.parametrize("branch", sorted(SHAPES))
def test_k1_emulation_matches_plain_and_jax(branch, dtype, with_bias):
    nW, N, H, hd = SHAPES[branch]
    qkv, bias = _inputs(nW, N, H, hd, nW + H)
    dt = TDT[dtype]
    tq = torch.from_numpy(qkv).to(dt)
    tb = torch.from_numpy(bias) if with_bias else None
    got = window_msa.window_attention_qkv_emulation(
        tq, tb, H, _wpb(nW, N, H, hd, dt))
    ref = window_msa.window_attention_qkv_reference(tq, tb, H)
    assert got.dtype == dt and got.shape == ref.shape == (nW, N, H * hd)
    _assert_within(got, ref, dt, "plain")
    jref = torch.from_numpy(_jax_qkv(branch, dtype, with_bias))
    _assert_within(got.float(), jref, dt, "jax")


@functools.lru_cache(maxsize=None)
def _b0_train():
    """b0 at the 2,240 windows of a batch of 32, float32, and the plain
    version's output."""
    nW, N, H, hd = 2240, 49, 2, 39
    qkv, bias = _inputs(nW, N, H, hd, 32)
    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    return tq, tb, window_msa.window_attention_qkv_reference(tq, tb, H)


def test_k1_float32_terms_hold_at_b0():
    tq, tb, ref = _b0_train()
    got = window_msa.window_attention_qkv_emulation(
        tq, tb, 2, _wpb(2240, 49, 2, 39, torch.float32))
    err = (got - ref).abs().max().item()
    assert err <= chip_smoke.F32_ATOL, err


def test_k1_float32_term_count_is_the_least():
    """One bf16 term fewer than K1_CORE_TERMS[float32] leaves F32_ATOL."""
    tq, tb, ref = _b0_train()
    nW, N, H, hd = 280, 49, 2, 39
    q, k, v = (t.reshape(-1, N, H, hd)[:nW].permute(0, 2, 1, 3)
               for t in tq.chunk(3, dim=-1))
    fewer = window_msa.K1_CORE_TERMS[torch.float32] - 1
    o = window_msa.attention_fwd_core_emulation(q, k, v, tb, fewer)
    err = (o.permute(0, 2, 1, 3).reshape(nW, N, H * hd) - ref[:nW]).abs()
    assert err.max() > chip_smoke.F32_ATOL


@pytest.mark.parametrize("dtype", sorted(TDT))
@pytest.mark.parametrize("branch", ["b0", "b3"])
def test_k1_head_range_and_wpb_are_bit_exact(branch, dtype):
    """Each (window, head) is computed the same way whatever block it falls
    in: every windows-per-block value and each head range give the whole
    launch's columns bit for bit (zeros elsewhere)."""
    nW, N, H, hd = SHAPES[branch]
    nW = min(nW, 12)
    qkv, bias = _inputs(nW, N, H, hd, 3)
    tq, tb = torch.from_numpy(qkv).to(TDT[dtype]), torch.from_numpy(bias)
    whole = window_msa.window_attention_qkv_emulation(tq, tb, H, nW)
    for wpb in range(1, nW):
        assert torch.equal(
            window_msa.window_attention_qkv_emulation(tq, tb, H, wpb), whole)
    for h0, hl in {(H - 1, 1), (0, H // 2), (H // 2, H - H // 2), (1, 1)}:
        part = window_msa.window_attention_qkv_emulation(tq, tb, H, 5,
                                                         (h0, hl))
        cols = slice(h0 * hd, (h0 + hl) * hd)
        assert torch.equal(part[..., cols], whole[..., cols]), (h0, hl)
        rest = torch.ones(H * hd, dtype=torch.bool)
        rest[cols] = False
        assert not part[..., rest].any()


def _head_major(qkv: np.ndarray, H: int):
    nW, N, C3 = qkv.shape
    split = qkv.reshape(nW, N, 3, H, C3 // 3 // H).transpose(2, 3, 0, 1, 4)
    return [np.ascontiguousarray(x) for x in split]


@functools.lru_cache(maxsize=None)
def _jax_hm(dtype: str, with_bias: bool) -> np.ndarray:
    nW, N, H, hd = SHAPES["b0"]
    qkv, bias = _inputs(nW, N, H, hd, 5)
    jq, jk, jv = (jnp.asarray(x, JDT[dtype]) for x in _head_major(qkv, H))
    jb = jnp.asarray(bias if with_bias else np.zeros_like(bias))
    with jwm.interpret_mode():
        out = jwm.window_attention_pallas_hm(jq, jk, jv, jb)
        return np.array(out.astype(jnp.float32))


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", sorted(TDT))
def test_k1_hm_emulation_matches_plain_jax_and_k1(dtype, with_bias):
    nW, N, H, hd = SHAPES["b0"]
    qkv, bias = _inputs(nW, N, H, hd, 5)
    dt = TDT[dtype]
    q, k, v = (torch.from_numpy(x).to(dt) for x in _head_major(qkv, H))
    tb = torch.from_numpy(bias) if with_bias else None
    wpb = _wpb(nW, N, H, hd, dt)
    got = window_msa.window_attention_hm_emulation(q, k, v, tb, wpb)
    ref = window_msa.window_attention_hm_reference(q, k, v, tb)
    assert got.dtype == dt and got.shape == ref.shape == (H, nW, N, hd)
    _assert_within(got, ref, dt, "plain")
    _assert_within(got.float(), torch.from_numpy(_jax_hm(dtype, with_bias)),
                   dt, "jax")
    # the window-major path of phase 14: K1-hm equals K1 bit for bit
    flat = window_msa.window_attention_qkv_emulation(
        torch.from_numpy(qkv).to(dt), tb, H, wpb)
    assert torch.equal(got.permute(1, 2, 0, 3).reshape(nW, N, H * hd), flat)


@pytest.mark.parametrize("B", [chip_smoke.TRAIN_BATCH, chip_smoke.SERVE_BATCH])
@pytest.mark.parametrize("row", chip_smoke.BRANCH_SHAPES, ids=lambda r: r[0])
def test_fwd_plan(row, B):
    """K1's grid at every shape chip_smoke runs it: the chunks tile the
    windows exactly, a block's shared memory fits the opt-in with at least
    two blocks per SM, the grid puts at least two blocks on each of the
    132 SMs, and the chunks are K2's."""
    _, w, N, H, hd = row
    nW = B * w
    for dt in (torch.float32, torch.bfloat16):
        plan = window_msa.fwd_plan(nW, N, hd, H, dt, SMS)
        wpb, chunks = plan["wpb"], plan["chunks"]
        assert (chunks - 1) * wpb < nW <= chunks * wpb
        assert wpb == window_msa.bwd_windows_per_block(nW, H, SMS)
        assert plan["smem"] <= window_msa.MAX_SMEM
        assert plan["blocks_per_sm"] >= 2
        assert chunks * H >= 2 * SMS, (chunks, H)
    # hrformer_base b0: 4 bf16 blocks per SM by registers (5 fit its
    # shared memory), 3 float32 ones
    if row[0] == "base b0":
        bf = window_msa.fwd_plan(nW, N, hd, H, torch.bfloat16, SMS)
        f32 = window_msa.fwd_plan(nW, N, hd, H, torch.float32, SMS)
        assert (bf["smem"], bf["blocks_per_sm"]) == (40324, 4)
        assert (f32["smem"], f32["blocks_per_sm"]) == (68548, 3)
