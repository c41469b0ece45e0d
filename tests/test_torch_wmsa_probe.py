"""PyTorch port, the W-MSA measurement path: K1-hm's plain version and the
window-major wrapper against the JAX package's head-major Pallas kernel,
K8's plain versions against the TPU probe's own kernel bodies, and the
port's probe ``main()`` on the CPU.

The JAX side runs its Pallas kernels in TPU interpret mode on the CPU.
The probe's ``run_variant`` times its calls, so the bodies are wrapped
here in a pallas_call of the same grid and block specs instead.  Importing
the probe sets the JAX compilation-cache options; this file puts them back
right after, so that later files on the same worker are not affected.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

_CACHE_OPTIONS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs")
_saved = {k: getattr(jax.config, k) for k in _CACHE_OPTIONS}
from infantposeestimation_gaussianbias_tpu.tools import (  # noqa: E402
    probe_wmsa_ablate as jprobe,
)
for _k, _v in _saved.items():
    jax.config.update(_k, _v)

from infantposeestimation_gaussianbias_tpu.ops.pallas import (  # noqa: E402
    window_msa as jwm,
)
from infantposeestimation_gaussianbias_tpu_torch.kernels import (  # noqa: E402
    window_msa, window_msa_ablate as ablate,
)
from infantposeestimation_gaussianbias_tpu_torch.tools import (  # noqa: E402
    probe_wmsa_ablate as probe,
)

# Float32 on both sides: the same maths in another summation order.
F32_TOL = 1e-5
# bf16 outputs: both round float32 results that agree to ~1e-6 once to
# bf16, so an element may land one ulp apart (2^-8 of its magnitude).
BF16_TOL = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's many small torch ops: with
    several test processes sharing the CPU's cores, torch's default of a
    thread per core makes each op wait on the others (the probe's timing
    loop took ~2 min that way, 0.4 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy()


def test_probe_import_leaves_the_cache_options():
    assert {k: getattr(jax.config, k) for k in _CACHE_OPTIONS} == _saved


# -- K1-hm ---------------------------------------------------------------------

@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_attention_hm_matches_pallas(dtype, with_bias):
    """K1-hm's plain version against ``window_attention_pallas_hm`` and
    ``window_attention_wm`` against ``window_attention_pallas``, on the
    same numpy inputs (H=2, nW=3, N=16, hd=8)."""
    H, nW, N, hd = 2, 3, 16, 8
    rng = np.random.RandomState(7 + with_bias)
    q, k, v = (rng.randn(H, nW, N, hd).astype(np.float32) for _ in range(3))
    bias = rng.randn(H, N, N).astype(np.float32) if with_bias else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    # JAX's None bias is zeros (window_msa.py:64-65); passing the zeros
    # here reuses one compiled kernel per dtype.  The port gets None.
    jb = jnp.zeros((H, N, N)) if bias is None else jnp.asarray(bias)
    with pltpu.force_tpu_interpret_mode():
        want_hm = np.asarray(jwm.window_attention_pallas_hm(jq, jk, jv, jb),
                             np.float32)
        want_wm = np.asarray(jwm.window_attention_pallas(
            *(jnp.swapaxes(x, 0, 1) for x in (jq, jk, jv)), jb), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    got_hm = window_msa.window_attention_hm(tq, tk, tv, tb)
    got_wm = window_msa.window_attention_wm(
        *(x.transpose(0, 1) for x in (tq, tk, tv)), tb)
    assert got_hm.dtype == tdt and got_hm.shape == (H, nW, N, hd)
    assert got_wm.shape == (nW, H, N, hd)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(got_hm), want_hm, atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got_wm), want_wm, atol=tol, rtol=tol)
    assert window_msa.HM_LAUNCHES == 0  # CPU tensors: the plain version


def test_window_attention_hm_equals_flat_k1_reference():
    """Head-major and flat layouts of the same qkv give the same result."""
    nW, N, H, hd = 5, 49, 2, 39
    qkv = torch.from_numpy(
        np.random.RandomState(3).randn(nW, N, 3 * H * hd).astype(np.float32))
    bias = torch.from_numpy(
        np.random.RandomState(4).randn(H, N, N).astype(np.float32))
    q, k, v = qkv.view(nW, N, 3, H, hd).permute(2, 3, 0, 1, 4)
    out = window_msa.window_attention_hm(q, k, v, bias)
    flat = window_msa.window_attention_qkv_reference(qkv, bias, H)
    torch.testing.assert_close(
        out.permute(1, 2, 0, 3).reshape(nW, N, H * hd), flat,
        atol=F32_TOL, rtol=F32_TOL)


# -- K8 ------------------------------------------------------------------------

def _probe_call(body, qkv, bias, H, GB, G=1):
    """The probe's pallas_call (``run_variant``, without the timing)."""
    nW, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // H
    if G > 1:
        bias_in = jwm._packed_bias(bias, G)
        body = jax.tree_util.Partial(body, num_heads=H, scale=hd ** -0.5,
                                     pack=G)
    else:
        bias_in = bias
        body = jax.tree_util.Partial(body, num_heads=H, scale=hd ** -0.5)
    return pl.pallas_call(
        body,
        grid=(nW // GB,),
        in_specs=[pl.BlockSpec((GB, N, C3), lambda w: (w, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(bias_in.shape, lambda w: (0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((GB, N, C), lambda w: (w, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((nW, N, C), qkv.dtype),
    )(qkv, bias_in)


_BODIES = {"empty": jprobe._kernel_empty,
           "gemmonly": jprobe._kernel_gemmonly,
           "softonly": jprobe._kernel_softonly,
           "full": jprobe._attn_qkv_kernel,
           "packslim": jprobe._kernel_packslim}


@pytest.mark.parametrize("variant", ablate.VARIANTS)
def test_ablate_reference_matches_probe_bodies(variant):
    """Each K8 plain version against the probe's body on the probe's bf16
    qkv and float32 bias (nW=6, N=49, C=64, H=2: hd 32, G 4).  The probe's
    grid needs nW to divide by its block; the port pads, so the JAX side
    runs 8 windows, the last two zeros, and the first 6 are compared."""
    nW, N, C, H = 6, 49, 64, 2
    G = ablate.pack_factor(H, C, N)
    assert G == jwm._pack_factor(H, C, N) == 4
    qkv, bias = probe.make_inputs(nW, N, C, H, "cpu")
    padded = np.concatenate([qkv.float().numpy(),
                             np.zeros((2, N, 3 * C), np.float32)])
    with pltpu.force_tpu_interpret_mode():
        want = _probe_call(_BODIES[variant], jnp.asarray(padded, jnp.bfloat16),
                           jnp.asarray(bias.numpy()), H, GB=4,
                           G=G if variant == "packslim" else 1)
    want = np.asarray(want, np.float32)[:nW]
    if variant == "packslim":  # the caller packs, as the probe does
        bias = ablate.packed_bias(bias, G)
    got = ablate.window_attention_ablate(variant, qkv, bias, H)
    assert got.dtype == torch.bfloat16 and got.shape == (nW, N, C)
    if variant == "empty":
        np.testing.assert_array_equal(_np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, atol=BF16_TOL,
                                   rtol=BF16_TOL)
    assert ablate.ABLATE_LAUNCHES == 0  # CPU tensors: the plain version


def test_packed_bias_matches_jax():
    bias = np.random.RandomState(5).randn(2, 7, 7).astype(np.float32)
    got = ablate.packed_bias(torch.from_numpy(bias), 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jwm._packed_bias(bias, 3)))


@pytest.mark.parametrize("H,C,N", [(1, 32, 49), (2, 78, 49), (16, 624, 49),
                                   (2, 78, 64), (4, 16, 16)])
def test_pack_factor_matches_jax(H, C, N):
    assert ablate.pack_factor(H, C, N) == jwm._pack_factor(H, C, N)


def test_plan_follows_the_probe_and_shared_memory():
    """The probe's order (empty/full over the sweep, then gemmonly,
    softonly; packslim last at G), without what the shared-memory test
    refuses: on the card the kernel's own reckoning (at the default shape
    8 windows of 49 tokens exceed a block's 227 KB), on the CPU none."""
    asked = []

    def fits(variant, N, hd, wpb, pack=1):
        asked.append((variant, N, hd, wpb, pack))
        return wpb < 8

    runs = probe.plan(8960, 49, 32, 1, 1, fits)
    assert runs == [("empty", 1), ("full", 1), ("empty", 2), ("full", 2),
                    ("empty", 4), ("full", 4), ("gemmonly", 1),
                    ("softonly", 1), ("packslim", 4)]
    assert ("full", 49, 32, 8, 1) in asked
    assert asked[-1] == ("packslim", 49, 32, 4, 4)
    everything = probe.plan(8960, 49, 32, 1, 1, lambda *_: True)
    assert everything[6:8] == [("empty", 8), ("full", 8)]


def test_probe_main_on_cpu(monkeypatch, capsys):
    """The port's probe at a tiny PROBE_SHAPE times the plain versions on
    the CPU and returns one row per (variant, windows per block)."""
    monkeypatch.setenv("PROBE_SHAPE", "6,16,32,2")
    monkeypatch.setenv("PROBE_GB", "2")
    rows = probe.main(device="cpu")
    assert [(r["variant"], r["windows_per_block"]) for r in rows] == \
        probe.plan(6, 16, 32, 2, 2, lambda *_: True)
    assert rows[0]["windows_per_block"] == 2
    assert all(np.isfinite(r["ms"]) and (r["nW"], r["N"], r["C"], r["H"])
               == (6, 16, 32, 2) for r in rows)
    out = capsys.readouterr().out
    assert "shape nW=6 N=16 C=32 H=2" in out
    assert out.count(" ms\n") == len(rows)
