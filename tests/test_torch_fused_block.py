"""PyTorch port, fused half-blocks (K4 attention, K5 MLP): the port's plain
versions and its fused HRFormer path against the JAX package on the CPU,
on the same numpy inputs and weights.

Kernel-level cases run the JAX kernels under
``pltpu.force_tpu_interpret_mode()``, as tests/test_fused_block.py does.
Block- and model-level cases run them under the JAX module's own generic
interpreter (``fused_block.interpret_mode()``: the same kernel bodies,
cheaper to trace), with ``IPE_FUSED_BLOCK`` set by ``monkeypatch``.

Tolerances: both sides do the TPU kernels' maths (bf16-rounded activation
operands, float32 accumulation and statistics) in other summation orders.
A sum that lands on the other side of a bf16 rounding boundary moves that
one operand by one bf16 ulp (2^-8 relative), so element-wise checks allow
a few 1e-3 where such roundings feed the compared value, and whole tensors
are compared by their relative norm.  Where that leaves little room
between the fused and the unfused path, the test also records which
blocks called K4 and K5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.config import get_variant
from infantposeestimation_gaussianbias_tpu.models import hrformer as jhr
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.ops import msa as jmsa
from infantposeestimation_gaussianbias_tpu.ops.pallas import fused_block as jfb
from infantposeestimation_gaussianbias_tpu.ops.pallas import window_msa as jwm
from infantposeestimation_gaussianbias_tpu.tools.import_torch_checkpoint import (
    convert_checkpoint,
    convert_hrformer_backbone,
)
from infantposeestimation_gaussianbias_tpu.train import optim as joptim
from infantposeestimation_gaussianbias_tpu.train import step as jstep
from infantposeestimation_gaussianbias_tpu.train.state import (
    TrainState as JTrainState,
)
from infantposeestimation_gaussianbias_tpu_torch import config
from infantposeestimation_gaussianbias_tpu_torch.kernels import fused_block as fb
from infantposeestimation_gaussianbias_tpu_torch.models import hrformer
from infantposeestimation_gaussianbias_tpu_torch.models import pose_estimator
from infantposeestimation_gaussianbias_tpu_torch.train import (
    create_train_state,
    make_train_step,
)
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    init_weights,
    state_dict_from_jax,
)
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

JDT = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
TDT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# One stage (two branches, C = 8 and 16): the smallest HRFormer with every
# kind of layer, and four fused blocks for the interpreter to run.
TINY = dict(channels=(8, 16), num_heads=(1, 2), stage_modules=(1,))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _np(x):
    return np.asarray(x, np.float32)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# -- K5 ---------------------------------------------------------------------------

def _mlp_inputs(M=40, C=16, hidden=64, tps=10, seed=0):
    rng = np.random.RandomState(seed)
    B = -(-M // tps)
    dp = (np.arange(B) % 2 == 0).astype(np.float32) / 0.7  # samples 1, 3 dropped
    return dict(
        x=rng.randn(M, C), gamma=rng.rand(C) + 0.5, beta=rng.randn(C) * 0.1,
        w1=rng.randn(C, hidden) * 0.3, b1=rng.randn(hidden) * 0.1,
        w2=rng.randn(hidden, C) * 0.2, b2=rng.randn(C) * 0.1, dp=dp,
        dy=rng.randn(M, C), tps=tps)


def _jax_mlp(a, dtype):
    """JAX K5 forward and VJP (x, gamma, beta, w1, b1, w2, b2) at dy."""
    jd = JDT[dtype]
    dpv = np.zeros((1, 128), np.float32)
    dpv[0, :len(a["dp"])] = a["dp"]
    args = (jnp.asarray(a["x"], jd), jnp.asarray(a["gamma"], jnp.float32)[None],
            jnp.asarray(a["beta"], jnp.float32)[None], jnp.asarray(a["w1"], jd),
            jnp.asarray(a["b1"], jnp.float32)[None], jnp.asarray(a["w2"], jd),
            jnp.asarray(a["b2"], jnp.float32)[None])
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(lambda *xs: jfb.fused_mlp_half(
            *xs, jnp.asarray(dpv), a["tps"]), *args)
        grads = vjp(jnp.asarray(a["dy"], jd))
    return y, grads


def _port_mlp_args(a, dtype):
    td = TDT[dtype]
    return (_t(a["x"], td), _t(a["gamma"]), _t(a["beta"]), _t(a["w1"], td),
            _t(a["b1"]), _t(a["w2"], td), _t(a["b2"]), _t(a["dp"]))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mlp_half_matches_jax(dtype):
    """Forward and every gradient (through the autograd Function) of K5's
    plain version against the JAX kernel, with a DropPath vector that
    drops two of four samples.  The float32 case pins the bf16 roundings of
    ln and g: the port agrees with the JAX kernel far closer than pure
    float32 maths does."""
    a = _mlp_inputs()
    jy, jg = _jax_mlp(a, dtype)
    args = [t.requires_grad_(i < 7) for i, t in
            enumerate(_port_mlp_args(a, dtype))]
    y = fb.fused_mlp_half(*args, a["tps"])
    y.backward(_t(a["dy"], TDT[dtype]))
    assert y.dtype == TDT[dtype]
    # bf16: the same roundings in the same places, within one output ulp;
    # float32: summation order only.
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(y.detach().float()), _np(jy), atol=tol,
                               rtol=tol)
    names = ["x", "gamma", "beta", "w1", "b1", "w2", "b2"]
    for name, t, want in zip(names, args, jg):
        got = t.grad.float().numpy().reshape(np.shape(want))
        assert t.grad.dtype == t.dtype, name
        # one output ulp of a bf16 gradient; float32 sums in another order
        assert _rel(got, want) < (4e-3 if dtype == "bfloat16" else 1e-5), name
    if dtype == "float32":
        x = _t(a["x"])
        ln = torch.nn.functional.layer_norm(x, (16,), _t(a["gamma"]),
                                            _t(a["beta"]), 1e-5)
        h = ln @ _t(a["w1"]) + _t(a["b1"])
        pure = x + _t(a["dp"])[torch.arange(40) // 10][:, None] * (
            fb.gelu_tanh(h) @ _t(a["w2"]) + _t(a["b2"]))
        assert np.abs(_np(jy) - pure.numpy()).max() > 1e-4
        assert np.abs(_np(jy) - _np(y.detach())).max() < 1e-5


def test_mlp_half_reference_is_the_bwd_of_the_forward():
    """The explicit backward of K5's plain version equals autograd through
    its forward (float32 weights, so no output rounding intervenes), but
    for the bf16 roundings of do and dh that the TPU kernel makes."""
    a = _mlp_inputs(seed=1)
    args = _port_mlp_args(a, "float32")
    grads = fb.fused_mlp_half_bwd_reference(*args, _t(a["dy"]), a["tps"])
    leaves = [t.clone().requires_grad_() for t in args[:7]]
    fb.fused_mlp_half_reference(*leaves, args[7], a["tps"]).backward(
        _t(a["dy"]))
    for got, leaf in zip(grads, leaves):
        # autograd does not round do and dh to bf16: within a few bf16 ulps
        assert _rel(got, leaf.grad) < 1e-2


def test_fused_wrappers_reject_other_devices():
    """On the CPU the wrappers take their plain versions, on the card they
    launch the kernels; any other device raises rather than falling back."""
    a = _mlp_inputs()
    args = [t.to("meta") for t in _port_mlp_args(a, "float32")]
    with pytest.raises(RuntimeError, match="no fused half-block kernel"):
        fb.fused_mlp_half_fwd(*args, a["tps"])
    with pytest.raises(RuntimeError, match="no fused half-block kernel"):
        fb.fused_mlp_half_bwd(*args, args[0], a["tps"])
    b = _attn_inputs()
    args = [t.to("meta") for t in _port_attn_args(b, "float32")]
    with pytest.raises(RuntimeError, match="no fused half-block kernel"):
        fb.fused_attn_half_fwd(*args, b["heads"], b["geom"])
    with pytest.raises(RuntimeError, match="no fused half-block kernel"):
        fb.fused_attn_half_bwd(*args, args[0], b["heads"], b["geom"])


# -- K4 ---------------------------------------------------------------------------

def _attn_inputs(B=2, H=10, W=9, C=16, heads=2, ws=4, seed=0):
    rng = np.random.RandomState(seed)
    N = ws * ws
    xw = _np(jmsa.window_partition(jnp.asarray(rng.randn(B, H, W, C),
                                               jnp.float32), ws)[0])
    return dict(
        xw=xw, gamma=rng.rand(C) + 0.5, beta=rng.randn(C) * 0.1,
        wqkv=rng.randn(C, 3 * C) * 0.3, bqkv=rng.randn(3 * C) * 0.3,
        rpe=rng.randn(heads, N, N), wproj=rng.randn(C, C) * 0.3,
        bproj=rng.randn(C) * 0.1,
        dp=np.array([0.0] + [1 / 0.7] * (B - 1), np.float32),  # sample 0 dropped
        dy=rng.randn(*xw.shape), heads=heads, geom=(H, W, ws))


_ATTN = ["xw", "gamma", "beta", "wqkv", "bqkv", "rpe", "wproj", "bproj"]


def _jax_attn(a, dtype, grads=True):
    jd = JDT[dtype]
    dpv = np.zeros((1, 128), np.float32)
    dpv[0, :len(a["dp"])] = a["dp"]
    vec = {"gamma", "beta", "bqkv", "bproj"}
    args = tuple(jnp.asarray(a[n], jnp.float32)[None] if n in vec else
                 jnp.asarray(a[n], jnp.float32 if n == "rpe" else jd)
                 for n in _ATTN)

    def f(*xs):
        return jfb.fused_attn_half(*xs, jnp.asarray(dpv), a["heads"],
                                   a["geom"])

    with pltpu.force_tpu_interpret_mode():
        if not grads:
            return f(*args), None
        y, vjp = jax.vjp(f, *args)
        return y, vjp(jnp.asarray(a["dy"], jd))


def _port_attn_args(a, dtype):
    td = TDT[dtype]
    return [_t(a[n], td if n in ("xw", "wqkv", "wproj") else torch.float32)
            for n in _ATTN] + [_t(a["dp"])]


@pytest.mark.parametrize("H,W", [(10, 9), (5, 13)])
def test_attn_half_forward_matches_jax(H, W):
    """Maps whose sides are not window multiples: boundary windows take the
    qkv bias row at every pad token, as the JAX kernel's valid mask."""
    a = _attn_inputs(H=H, W=W)
    jy, _ = _jax_attn(a, "bfloat16", grads=False)
    y = fb.fused_attn_half_fwd(*_port_attn_args(a, "bfloat16"), a["heads"],
                               a["geom"])
    assert y.dtype == torch.bfloat16 and y.shape == a["xw"].shape
    # the same roundings in the same places: within one bf16 output ulp
    np.testing.assert_allclose(_np(y.float()), _np(jy), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attn_half_grads_match_jax(dtype):
    """Every gradient of K4 (through the autograd Function) against the JAX
    kernel on a 6 x 7 map in 3 x 3 windows (a column of pad tokens, whose
    dqkv reaches dbqkv), with sample 0 dropped."""
    a = _attn_inputs(B=2, H=6, W=7, C=8, heads=2, ws=3, seed=2)
    jy, jg = _jax_attn(a, dtype)
    args = _port_attn_args(a, dtype)
    leaves = [t.requires_grad_() for t in args[:8]]
    y = fb.fused_attn_half(*leaves, args[8], a["heads"], a["geom"])
    y.backward(_t(a["dy"], TDT[dtype]))
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(y.detach().float()), _np(jy), atol=tol,
                               rtol=tol)
    for name, t, want in zip(_ATTN, leaves, jg):
        got = t.grad.float().numpy().reshape(np.shape(want))
        assert t.grad.dtype == t.dtype, name
        # float32: bf16 roundings of dqkv and dpo that sit on a boundary
        # may flip between the two summation orders (one ulp, 2^-8)
        assert _rel(got, want) < (4e-3 if dtype == "bfloat16" else 1e-4), name


def _attn_y(args, b_valid, b_pad, heads, geom):
    """K4's forward with the bias of valid tokens and of pad tokens as two
    inputs (the same values), so that autograd splits dbqkv between them."""
    xw, gamma, beta, wqkv, _, rpe, wproj, bproj, dp = args
    nW, N, C = xw.shape
    hd = C // heads
    ln, _, _ = fb._layernorm(xw, gamma, beta)
    qkv = torch.where(fb.valid_tokens(nW, N, geom), fb._bf16(ln) @ wqkv + b_valid,
                      b_pad)
    q, k, v = qkv.reshape(nW, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    p = torch.softmax((q * hd ** -0.5) @ k.transpose(-2, -1) + rpe, dim=-1)
    o = (p @ v).permute(0, 2, 1, 3).reshape(nW, N, C)
    scale = fb._row_scale(dp, nW, fb.window_geometry(geom)[0])[:, :, None]
    return xw + scale * (fb._bf16(o) @ wproj + bproj)


def test_attn_half_dbqkv_counts_pad_tokens():
    """dbqkv sums dqkv over every token: a pad token's q, k and v are the
    bias row itself, so its gradient reaches the bias.  K4's plain
    backward equals the valid tokens' share plus the pad tokens' share,
    and the pad share is not small."""
    a = _attn_inputs(B=2, H=6, W=7, C=8, heads=2, ws=3, seed=3)
    args = _port_attn_args(a, "float32")
    assert not fb.valid_tokens(12, 9, a["geom"]).all()
    b_valid = args[4].clone().requires_grad_()
    b_pad = args[4].clone().requires_grad_()
    y = _attn_y(args, b_valid, b_pad, a["heads"], a["geom"])
    torch.testing.assert_close(y, fb.fused_attn_half_reference(
        *args, a["heads"], a["geom"]))
    y.backward(_t(a["dy"]))
    dbqkv = fb.fused_attn_half_bwd_reference(*args, _t(a["dy"]), a["heads"],
                                             a["geom"])[4]
    # autograd does not round dpo to bf16 as the explicit backward does
    assert _rel(dbqkv, b_valid.grad + b_pad.grad) < 1e-2
    assert _rel(dbqkv, b_valid.grad) > 0.1


# -- the fused block, module and train step against JAX ---------------------------

def _block_sd(block_params):
    sd = state_dict_from_jax(
        {"backbone": {"stage2_module0": {"branch0_block0": block_params}}},
        {})
    pre = "backbone.stage2.0.branches.0.0."
    return {k[len(pre):]: v for k, v in sd.items()}


def test_block_fused_matches_jax(monkeypatch):
    """HRFormerBlock with IPE_FUSED_BLOCK=1: the port's fused path against
    the JAX block's ``_fused`` on the same parameters (float32 model),
    output and the gradients of x and of every parameter."""
    monkeypatch.setenv("IPE_FUSED_BLOCK", "1")
    dim, heads, ws = 16, 2, 4
    rng = np.random.RandomState(4)
    x = rng.randn(2, 10, 9, dim).astype(np.float32)
    probe = rng.randn(2, 10, 9, dim).astype(np.float32)
    jblock = jhr.HRFormerBlock(dim, heads, ws, use_pallas=True)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jblock.init)(
        jax.random.PRNGKey(5), jnp.asarray(x))["params"])
    params["norm1"]["scale"] = rng.rand(dim).astype(np.float32) + 0.5
    params["attn"]["rpe_table"] = rng.randn(*params["attn"]["rpe_table"]
                                            .shape).astype(np.float32)
    for layer in (params["attn"]["qkv"], params["attn"]["proj"],
                  params["mlp"]["fc1"], params["mlp"]["fc2"]):
        layer["kernel"] = layer["kernel"] * 15  # std 0.3: the halves matter

    def loss(p, xx):
        return jnp.sum(jblock.apply({"params": p}, xx, False) * probe)

    with jfb.interpret_mode():
        jy = jblock.apply({"params": params}, jnp.asarray(x), False)
        jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    tblock = hrformer.HRFormerBlock(dim, heads, ws, use_pallas=True)
    tblock.load_state_dict(_block_sd(params), strict=True)
    calls = _record_fused(monkeypatch)
    tx = _t(x).requires_grad_()
    y = tblock(tx)
    (y * _t(probe)).sum().backward()
    assert calls == [("attn", dim), ("mlp", dim)]
    # measured: 1.3e-4 (y), 1e-7 to 3.5e-4 (gradients); the unfused path
    # misses JAX's fused output by 2.8e-3
    assert _rel(y.detach(), jy) < 1e-3
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), atol=2e-2,
                               rtol=2e-2)
    assert _rel(tx.grad, jgx) < 1e-3
    want = _block_sd(jax.tree_util.tree_map(np.asarray, jgp))
    for name, p in tblock.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name
        assert _rel(p.grad, want[name]) < 1e-3, name


def _record_fused(monkeypatch):
    """Wrap the block's K4 and K5 entry points; returns the list of
    ("attn" | "mlp", width) they are called with."""
    calls = []
    real_attn, real_mlp = hrformer.fused_attn_half, hrformer.fused_mlp_half

    def attn(xw, *args):
        calls.append(("attn", xw.shape[-1]))
        return real_attn(xw, *args)

    def mlp(x2, *args):
        calls.append(("mlp", x2.shape[-1]))
        return real_mlp(x2, *args)

    monkeypatch.setattr(hrformer, "fused_attn_half", attn)
    monkeypatch.setattr(hrformer, "fused_mlp_half", mlp)
    return calls


def _boost_blocks(model):
    """Transformer weights of std ~0.2 and LayerNorm scales around 1, so
    that the blocks' halves, and the fused path's roundings, show in the
    features."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.uniform_(0.5, 1.5)
            elif isinstance(m, torch.nn.Linear) and ".branches." in name:
                m.weight.mul_(10.0)


@pytest.fixture(scope="module")
def tiny_backbone():
    tm = hrformer.HRFormer(**TINY, drop_path_rate=0.0, use_pallas=True).eval()
    init_weights(tm, seed=6)
    _boost_blocks(tm)
    sd = {f"backbone.{k}": v.numpy().copy() for k, v in tm.state_dict().items()}
    params, stats = convert_hrformer_backbone(sd)
    x = np.random.RandomState(7).randn(2, 64, 48, 3).astype(np.float32)
    return tm, {"params": params, "batch_stats": stats}, x


def _jax_features(tiny_backbone):
    """JAX's features, traced anew so that it reads IPE_FUSED_BLOCK now
    (unfused blocks take JAX's W-MSA kernel, interpreted too)."""
    _, variables, x = tiny_backbone
    jm = jhr.HRFormer(**TINY, drop_path_rate=0.0, use_pallas=True)
    with jfb.interpret_mode(), jwm.interpret_mode():
        return _np(jax.jit(lambda v, a: jm.apply(v, a, False))(
            variables, jnp.asarray(x)))


def _port_features(tm, x, flag, monkeypatch):
    monkeypatch.setenv("IPE_FUSED_BLOCK", flag)
    with torch.no_grad():
        return tm(_t(x)).numpy()


def _assert_features_close(out, want):
    """float32 model on both sides; a bf16 rounding that flips between the
    two summation orders moves an activation of size ~5 by up to ~2e-2.
    Measured: 2.6e-4 relative norm (the unfused path: 1.6e-3)."""
    assert _rel(out, want) < 1e-3
    np.testing.assert_allclose(out, want, atol=2e-2, rtol=2e-2)


def test_tiny_backbone_fused_matches_jax(tiny_backbone, monkeypatch):
    """Every block fused (IPE_FUSED_BLOCK=1), eval mode: the stride-4
    features of the port and of JAX from the same weights."""
    monkeypatch.setenv("IPE_FUSED_BLOCK", "1")
    tm, _, x = tiny_backbone
    want = _jax_features(tiny_backbone)
    calls = _record_fused(monkeypatch)
    out = _port_features(tm, x, "1", monkeypatch)
    assert calls == [("attn", 8), ("mlp", 8)] * 2 + [("attn", 16),
                                                     ("mlp", 16)] * 2
    assert out.shape == want.shape == (2, 16, 12, 8)
    _assert_features_close(out, want)


def test_auto_fuses_the_wide_blocks(tiny_backbone, monkeypatch):
    """IPE_FUSED_BLOCK=auto fuses the blocks of width >= IPE_FUSED_BLOCK_MIN_C
    (here 16: branch 1's two blocks, not branch 0's), as the JAX gate does:
    the port calls K4 and K5 for exactly those, and its features match
    JAX's under the same setting."""
    monkeypatch.setenv("IPE_FUSED_BLOCK_MIN_C", "16")
    tm, _, x = tiny_backbone
    calls = _record_fused(monkeypatch)
    out = _port_features(tm, x, "auto", monkeypatch)
    assert calls == [("attn", 16), ("mlp", 16)] * 2
    _assert_features_close(out, _jax_features(tiny_backbone))
    assert not hrformer._fused_blocks_enabled(8)
    assert hrformer._fused_blocks_enabled(16)
    monkeypatch.setenv("IPE_FUSED_BLOCK", "0")
    assert not hrformer._fused_blocks_enabled(624)


def test_use_pallas_false_never_fuses(monkeypatch):
    """cfg.model.use_pallas gates the fused path, as in the JAX block:
    build_model hands it to every block, and with it off no block calls
    K4 or K5 whatever IPE_FUSED_BLOCK says."""
    monkeypatch.setenv("IPE_FUSED_BLOCK", "1")
    monkeypatch.setitem(pose_estimator.BACKBONES, "tiny_fused",
                        lambda **kw: hrformer.HRFormer(drop_path_rate=0.0,
                                                       **TINY, **kw))
    calls = _record_fused(monkeypatch)
    x = torch.zeros(1, 64, 48, 3)
    for use_pallas in (True, False):
        cfg = _tiny_cfg(config.get_variant("hrformer_base"))
        cfg.model.use_pallas = use_pallas
        model = pose_estimator.build_model(cfg, device="cpu")
        blocks = [m for m in model.modules()
                  if isinstance(m, hrformer.HRFormerBlock)]
        assert len(blocks) == 4
        assert all(b.use_pallas is use_pallas for b in blocks)
        del calls[:]
        with torch.no_grad():
            model(x)
        assert len(calls) == (8 if use_pallas else 0)


def _tiny_cfg(cfg):
    cfg.model.backbone = "tiny_fused"
    cfg.model.hidden_dim = 16
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = (48, 64)
    cfg.data.heatmap_size = (12, 16)
    cfg.train.warmup_epochs = 0
    return cfg


def _batch(seed, B=2):
    rng = np.random.RandomState(seed)
    kpts = np.stack([rng.uniform(-4, 52, (B, 17)), rng.uniform(-4, 68, (B, 17))],
                    -1).astype(np.float32)
    vis = rng.choice([0, 1, 2], (B, 17), p=[0.1, 0.2, 0.7]).astype(np.float32)
    return {"image": rng.randn(B, 64, 48, 3).astype(np.float32),
            "keypoints": kpts, "visible": vis}


@pytest.fixture
def tiny_models(monkeypatch):
    """Port model and JAX params for the tiny backbone + fusion head, with
    the fused path forced on in both (JAX's build_model leaves use_pallas
    off on the CPU; the registered backbone turns it on)."""
    monkeypatch.setenv("IPE_FUSED_BLOCK", "1")
    monkeypatch.setitem(jpe.BACKBONES, "tiny_fused", lambda **kw: jhr.HRFormer(
        drop_path_rate=0.0, **TINY, **dict(kw, use_pallas=True)))
    monkeypatch.setitem(pose_estimator.BACKBONES, "tiny_fused",
                        lambda **kw: hrformer.HRFormer(drop_path_rate=0.0,
                                                       **TINY, **kw))
    cfg, jcfg = (_tiny_cfg(config.get_variant("hrformer_base")),
                 _tiny_cfg(get_variant("hrformer_base")))
    port = pose_estimator.build_model(cfg, device="cpu")
    rng = np.random.RandomState(8)
    with torch.no_grad():
        for final in (port.head.heatmap_branch[3], port.head.offset_branch[3]):
            final.weight.copy_(_t(rng.randn(*final.weight.shape) * 0.3))
    params, stats = convert_checkpoint(
        {k: v.numpy().copy() for k, v in port.state_dict().items()},
        head_type="fusion")
    return cfg, jcfg, {"params": params, "batch_stats": stats}


def test_train_step_fused_matches_jax(tiny_models):
    """One train step of the tiny model with every block fused
    (IPE_FUSED_BLOCK=1, drop-path 0): every loss term, grad_norm and the
    gradient of every parameter against the JAX step."""
    cfg, jcfg, variables = tiny_models
    model = jpe.build_model(jcfg)
    tx, _ = joptim.build_optimizer(jcfg, jcfg.train.steps_per_epoch or 1000)
    jstate = JTrainState.create(
        apply_fn=model.apply,
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]), tx=tx)
    batch = _batch(9)
    with jfb.interpret_mode():
        jstate, jmetrics = jax.jit(jstep.make_train_step(
            jcfg, jcfg.data.keypoint_schema))(
                jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                jax.random.PRNGKey(0))
    state = create_train_state(cfg, device="cpu", state_dict=state_dict_from_jax(
        variables["params"], variables["batch_stats"]))
    blocks = [m for m in state.model.modules()
              if isinstance(m, hrformer.HRFormerBlock)]
    assert len(blocks) == 4 and all(b.use_pallas for b in blocks)
    _, metrics = make_train_step(cfg)(
        state, {k: _t(v) for k, v in batch.items()}, None)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        # float32 model through bf16-rounded block operands: a rounding
        # that flips between summation orders moves a term by ~1e-6
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=1e-4, err_msg=k)
    j_grads = state_dict_from_jax(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, jstate.opt_state[0].mu), {})
    grad_norm = metrics["grad_norm"].item()
    for n, p in state.model.named_parameters():
        g = p.grad
        err = (g - j_grads[n]).norm().item()
        # as tests/test_torch_train.py: ReLU ties and bf16 roundings on a
        # boundary move single elements; the floor covers gradients that
        # are zero up to rounding (biases feeding a train-mode BatchNorm)
        assert err <= 5e-3 * j_grads[n].norm().item() + 1e-6 * grad_norm, (
            n, err, j_grads[n].norm().item())


def test_remat_through_fused_blocks(monkeypatch):
    """model.remat recomputes each module in the backward, its fused blocks
    through the same kernels with the same DropPath masks: features, every
    gradient and the BatchNorm statistics equal those without remat, and
    the fused blocks run a second time for the recomputation."""
    monkeypatch.setenv("IPE_FUSED_BLOCK", "1")
    rng = np.random.RandomState(12)
    x = _t(rng.randn(2, 64, 48, 3))
    probe = _t(rng.randn(2, 16, 12, 8))
    calls = _record_fused(monkeypatch)
    results = []
    sd = None
    for remat in (False, True):
        tm = hrformer.HRFormer(**TINY, drop_path_rate=0.3, remat=remat,
                               use_pallas=True).train()
        if sd is None:
            init_weights(tm, seed=13)
            _boost_blocks(tm)
            sd = {k: v.clone() for k, v in tm.state_dict().items()}
        tm.load_state_dict(sd)
        masks = torch.rand((tm.num_drop_paths, 2),
                           generator=torch.Generator().manual_seed(14)) < 0.7
        assert not masks.all() and masks.any()
        del calls[:]
        out = tm(x, masks)
        (out * probe).sum().backward()
        results.append((out.detach(), {n: p.grad for n, p in
                                       tm.named_parameters()},
                        dict(tm.named_buffers()), len(calls)))
    (o0, g0, b0, c0), (o1, g1, b1, c1) = results
    assert (c0, c1) == (8, 16)
    torch.testing.assert_close(o1, o0, atol=0, rtol=0)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-6, rtol=1e-5)
    for n in b0:
        torch.testing.assert_close(b1[n], b0[n], atol=0, rtol=0)


def test_drop_path_scales_reach_the_kernels(monkeypatch):
    """The fused block turns the caller's keep masks into the kernels'
    per-sample scales mask / (1 - rate): K4 takes keep[0], K5 keep[1]."""
    monkeypatch.setenv("IPE_FUSED_BLOCK", "1")
    seen = {}
    real_attn, real_mlp = hrformer.fused_attn_half, hrformer.fused_mlp_half
    monkeypatch.setattr(hrformer, "fused_attn_half", lambda *a: (
        seen.__setitem__("attn", a[8].clone()), real_attn(*a))[1])
    monkeypatch.setattr(hrformer, "fused_mlp_half", lambda *a: (
        seen.__setitem__("mlp", (a[7].clone(), a[8])), real_mlp(*a))[1])
    blk = hrformer.HRFormerBlock(8, 2, 3, drop_path_rate=0.25,
                                 use_pallas=True)
    keep = torch.tensor([[True, False, True], [False, True, True]])
    y = blk(torch.randn(3, 6, 7, 8), keep)
    assert y.shape == (3, 6, 7, 8)
    torch.testing.assert_close(seen["attn"], torch.tensor([1, 0, 1]) / 0.75)
    torch.testing.assert_close(seen["mlp"][0], torch.tensor([0, 1, 1]) / 0.75)
    assert seen["mlp"][1] == 6 * 9  # tokens per sample: 2 x 3 windows of 9
    # masked sample 1 of the attention half and sample 0 of the MLP half:
    # a sample dropped in both halves passes x through unchanged
    keep = torch.tensor([[True, False, True], [True, False, True]])
    x = torch.randn(3, 6, 7, 8)
    torch.testing.assert_close(blk(x, keep)[1], x[1])
