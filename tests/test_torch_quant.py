"""PyTorch port, int8 PTQ: ops/quant.py, the plain versions of K9 and K10
(kernels/quant.py), calibration and the int8 HRNet forward against the
JAX package, on the CPU.

Models: the tiny HRNet of tests/torch_tiny.py (base width 8, stage modules
1/1/1, 64x64) with the heatmap and the fusion head, seeded numpy weights on
``jax.eval_shape``'s tree (``torch_tiny.random_variables``).  One JAX
``quantize_model`` (its calibration jitted) and one jitted int8 apply per
model, shared by the file.

Tolerances, with their reasons:
* the int8 functions (quantization, requantize, the int8 conv and Dense
  with their epilogues) equal the JAX package's eager functions bit for
  bit; XLA's jitted epilogue contracts ``acc * s + b`` into one FMA, one
  float32 ulp off (``JIT_ULP_RTOL``);
* ``fold_batchnorm``'s a = w * rsqrt(v + eps) differs by an ulp between
  XLA's and torch's rsqrt (``RSQRT_RTOL``);
* the float calibration runs the same float32 model in another summation
  order: the recorded abs-max values agree to ``CALIB_RTOL``;
* the int8 forward on JAX's own qparams (carried across with
  ``weights.quant_state_from_jax``) against JAX's op-by-op int8 forward:
  the int8 layers agree bit for bit, the float32 bilinear resizes and the
  heads by ulps (measured 2e-7 of the maps' scale), and an int8 value on a
  .5 boundary could round the other way; every output agrees to cosine
  ``FORWARD_COS`` and within ``FORWARD_ATOL`` of its scale.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.config import get_config as jget_config
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.models import quantize as jquantize
from infantposeestimation_gaussianbias_tpu.ops import quant as J
from infantposeestimation_gaussianbias_tpu_torch import Config
from infantposeestimation_gaussianbias_tpu_torch.kernels import quant as qk
from infantposeestimation_gaussianbias_tpu_torch.models import (
    build_model, calibrate, quantize_model)
from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
    QConvNorm)
from infantposeestimation_gaussianbias_tpu_torch.ops import quant as P
from infantposeestimation_gaussianbias_tpu_torch import weights
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    quant_state_from_jax, state_dict_from_jax)
from tests import torch_tiny

JIT_ULP_RTOL = 2.4e-7
RSQRT_RTOL = 2.4e-7
CALIB_RTOL = 1e-5
FORWARD_COS = 0.9999
FORWARD_ATOL = 1e-4
HEADS = ("heatmap", "fusion")


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: several test processes share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- ops/quant: every function against the JAX package ----------------------

def test_quantize_weight_and_act_match_jax(rng):
    """Per-output-channel weights (the JAX HWIO / IO layouts against the
    port's OIHW / OI), per-tensor activations and requantize: int8 data and
    scales bit for bit."""
    w = (rng.randn(3, 3, 16, 24) * np.exp(rng.randn(24))).astype(np.float32)
    jq = J.quantize_weight(jnp.asarray(w))
    pq = P.quantize_weight(t(w.transpose(3, 2, 0, 1)))
    assert np.array_equal(np.asarray(jq["w_int8"]).transpose(3, 2, 0, 1),
                          pq["w_int8"].numpy())
    assert np.array_equal(np.asarray(jq["w_scale"]), pq["w_scale"].numpy())
    assert np.array_equal(P.conv_weight_layout(pq["w_int8"]).numpy(),
                          np.asarray(jq["w_int8"]).transpose(3, 0, 1, 2))
    wd = rng.randn(40, 12).astype(np.float32)
    jd, pd = J.quantize_weight(jnp.asarray(wd)), P.quantize_weight(t(wd.T))
    assert np.array_equal(np.asarray(jd["w_int8"]).T, pd["w_int8"].numpy())
    assert np.array_equal(np.asarray(jd["w_scale"]), pd["w_scale"].numpy())

    x = (rng.randn(2, 9, 11, 16) * 3).astype(np.float32)
    x[0, 0, 0, 0] = 1e4  # clamps to 127 under a smaller abs-max
    for absmax in (np.abs(x).max(), np.float32(5.3), np.float32(0.0)):
        ja = J.quantize_act(jnp.asarray(x), jnp.asarray(absmax))
        pa = P.quantize_act(t(x), t(absmax))
        assert np.array_equal(np.asarray(ja.data), pa.data.numpy())
        assert np.asarray(ja.scale) == pa.scale.numpy()
        assert np.array_equal(np.asarray(ja.dequantize()),
                              pa.dequantize().numpy())
    for scale in (0.0371, 1e-3, 0.5):
        jr = J.requantize(jnp.asarray(x), jnp.float32(scale))
        pr = P.requantize(t(x), torch.tensor(scale, dtype=torch.float32))
        assert np.array_equal(np.asarray(jr.data), pr.data.numpy())
        assert pr.data.dtype == torch.int8 and int(pr.data.min()) >= -127


def test_requantize_rounds_half_to_even():
    """Ties go to the even integer (jnp.round, torch.round), never away
    from zero, and the range is +-127."""
    y = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 300.0, -300.0])
    got = P.requantize(y, torch.tensor(1.0)).data.tolist()
    assert got == [0, 2, 2, 0, -2, -2, 126, 127, -127]
    want = np.asarray(J.requantize(jnp.asarray(y.numpy()),
                                   jnp.float32(1.0)).data).tolist()
    assert got == want


def test_fold_batchnorm_and_convert_match_jax(rng):
    """fold_batchnorm within an ulp (rsqrt); convert_convnorm's int8
    weights bit for bit in K9's layout, eff_scale within the ulp of a,
    eff_bias and out_scale; convert_dense entirely bit for bit."""
    C = 24
    bn = [rng.rand(C).astype(np.float32) + 0.5,
          rng.randn(C).astype(np.float32),
          (rng.randn(C) * 0.1).astype(np.float32),
          rng.rand(C).astype(np.float32) + 0.5]
    ja, jb = J.fold_batchnorm(*map(jnp.asarray, bn))
    pa, pb = P.fold_batchnorm(*map(t, bn))
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=RSQRT_RTOL,
                               atol=0)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=RSQRT_RTOL,
                               atol=1e-7)

    w = rng.randn(3, 3, 16, C).astype(np.float32)
    jc = J.convert_convnorm(
        {"conv": {"kernel": jnp.asarray(w)},
         "norm": {"bn": {"scale": bn[0], "bias": bn[1]}}},
        {"norm": {"bn": {"mean": bn[2], "var": bn[3]}}}, jnp.float32(7.5))
    pc = P.convert_convnorm(t(w.transpose(3, 2, 0, 1)), tuple(map(t, bn)),
                            t(np.float32(7.5)))
    assert np.array_equal(pc["w_int8"].numpy(),
                          np.asarray(jc["w_int8"]).transpose(3, 0, 1, 2))
    np.testing.assert_allclose(pc["eff_scale"].numpy(),
                               np.asarray(jc["eff_scale"]),
                               rtol=2 * RSQRT_RTOL, atol=0)
    np.testing.assert_allclose(pc["eff_bias"].numpy(),
                               np.asarray(jc["eff_bias"]), rtol=RSQRT_RTOL,
                               atol=1e-7)
    assert pc["out_scale"].numpy() == np.asarray(jc["out_scale"])
    with pytest.raises(ValueError, match="batchnorm"):
        P.convert_convnorm(t(w.transpose(3, 2, 0, 1)), None)

    wd = (rng.randn(156, 468) * 0.1).astype(np.float32)
    bias = rng.randn(468).astype(np.float32)
    jd = J.convert_dense({"kernel": jnp.asarray(wd), "bias": bias},
                         jnp.float32(4.2))
    pd = P.convert_dense(t(wd.T), t(bias), t(np.float32(4.2)))
    for k in ("w_int8", "w_scale", "bias", "in_scale"):
        want = np.asarray(jd[k])
        assert np.array_equal(pd[k].numpy(), want.T if k == "w_int8" else want)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("cin", [3, 16, 24])
def test_plain_qconv_matches_jax(rng, stride, k, cin):
    """K9's plain version (an exact float64 convolution of the int8
    values) and its epilogue against JAX's ``qconv_affine`` with symmetric
    padding k // 2, at every stride, kernel size, the stem's Cin = 3 and a
    Cin that is no multiple of 16: bit for bit eagerly, one FMA ulp jitted.
    Then the fused block tail (int8 residual, ReLU, requantize) against
    JAX's ``requantize(max(y + x.dequantize(), 0))``, bit for bit."""
    co = 24
    w = rng.randn(k, k, cin, co).astype(np.float32)
    qw = J.quantize_weight(jnp.asarray(w))
    a = rng.rand(co).astype(np.float32) + 0.5
    q = {"w_int8": qw["w_int8"], "eff_scale": qw["w_scale"] * a,
         "eff_bias": jnp.asarray(rng.randn(co).astype(np.float32))}
    xi = rng.randint(-127, 128, (2, 9, 11, cin)).astype(np.int8)
    xs = np.float32(0.0213)
    p = k // 2
    pad = ((p, p), (p, p))
    jy = J.qconv_affine(J.QTensor(jnp.asarray(xi), jnp.asarray(xs)), q,
                        strides=(stride, stride), padding=pad)
    jyj = jax.jit(lambda x, q: J.qconv_affine(
        J.QTensor(x, jnp.asarray(xs)), q, strides=(stride, stride),
        padding=pad))(jnp.asarray(xi), q)
    pq = {"w_int8": t(np.asarray(q["w_int8"]).transpose(3, 0, 1, 2)),
          "eff_scale": t(q["eff_scale"]), "eff_bias": t(q["eff_bias"])}
    py = P.qconv_affine(P.QTensor(t(xi), t(xs)), pq, stride)
    assert py.dtype == torch.float32
    assert np.array_equal(np.asarray(jy), py.numpy())
    np.testing.assert_allclose(py.numpy(), np.asarray(jyj),
                               rtol=JIT_ULP_RTOL, atol=1e-6)

    res = rng.randint(-127, 128, py.shape).astype(np.int8)
    rs, os_ = np.float32(0.013), np.float32(0.021)
    want = J.requantize(jnp.maximum(jy + J.QTensor(
        jnp.asarray(res), jnp.asarray(rs)).dequantize(), 0.0),
        jnp.asarray(os_))
    got = qk.qconv(t(xi), t(xs), pq["w_int8"], pq["eff_scale"],
                   pq["eff_bias"], stride, relu=True, out_scale=t(os_),
                   residual=t(res), res_scale=t(rs))
    assert got.dtype == torch.int8
    assert np.array_equal(np.asarray(want.data), got.numpy())
    f32_res = rng.randn(*py.shape).astype(np.float32)
    got = qk.qconv(t(xi), t(xs), pq["w_int8"], pq["eff_scale"],
                   pq["eff_bias"], stride, relu=True, residual=t(f32_res))
    assert np.array_equal(np.maximum(np.asarray(jy) + f32_res, 0),
                          got.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_qdense_matches_jax(rng, dtype):
    """K10's plain version against JAX's ``qdense`` at HRFormer-Base's
    branch-1 widths (K = 156, N = 468: no multiples of 8), a float32 or
    bf16 input, out in float32 (JAX's) or cast to bf16 as the JAX
    ``QDense(...).astype(dtype)``: bit for bit eagerly."""
    wd = (rng.randn(156, 468) * 0.1).astype(np.float32)
    jd = J.convert_dense({"kernel": jnp.asarray(wd),
                          "bias": rng.randn(468).astype(np.float32)},
                         jnp.float32(4.2))
    pd = {k: t(np.asarray(v).T if k == "w_int8" else np.asarray(v))
          for k, v in jd.items()}
    x = (rng.randn(3, 49, 156) * 2).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    px = t(x).to(getattr(torch, dtype))
    assert np.array_equal(np.asarray(jx, np.float32), px.float().numpy())
    jo = J.qdense(jx, jd)
    assert np.array_equal(np.asarray(jo), P.qdense(px, pd).numpy())
    got = qk.qdense(px, pd["w_int8"], pd["w_scale"], pd["bias"],
                    pd["in_scale"], torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 49, 468)
    assert np.array_equal(np.asarray(jo.astype(jnp.bfloat16), np.float32),
                          got.float().numpy())


def test_kernel_wrappers_route_by_device(rng):
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on any device but the CPU and CUDA raises."""
    before = (qk.CONV_LAUNCHES, qk.DENSE_LAUNCHES)
    x = t(rng.randint(-127, 128, (1, 4, 4, 16)).astype(np.int8))
    w = torch.zeros(8, 3, 3, 16, dtype=torch.int8)
    one, z = torch.tensor(1.0), torch.zeros(8)
    assert qk.qconv(x, one, w, z, z).shape == (1, 4, 4, 8)
    assert qk.qdense(torch.randn(5, 16), w.reshape(8, -1)[:, :16].contiguous(),
                     z, z, one).shape == (5, 8)
    assert (qk.CONV_LAUNCHES, qk.DENSE_LAUNCHES) == before
    with pytest.raises(RuntimeError, match="no int8 conv kernel"):
        qk.qconv(x.to("meta"), one, w, z, z)


# -- models: calibration and the int8 forward against JAX --------------------

@pytest.fixture(scope="module")
def models():
    """{head: (port cfg, JAX cfg, JAX model, float variables, JAX calib
    tree, JAX quantized variables (numpy), calibration batches)}: JAX
    ``calibrate``'s and ``quantize_model``'s steps, the calibrating
    forwards op by op (quicker than their compile at this size)."""
    with torch_tiny.registered():
        out = {}
        for seed, head in enumerate(HEADS):
            jcfg = torch_tiny.tiny_cfg(jget_config(), head)
            jmodel = jpe.build_model(jcfg)
            variables = torch_tiny.random_variables(jmodel, seed=30 + seed)
            batches = [torch_tiny.crops(40 + seed), torch_tiny.crops(50 + seed)]
            cmodel = jpe.build_model(jcfg, calibrate=True)
            calib = {}
            for b in batches:
                _, mutated = cmodel.apply(dict(variables, **(
                    {"calib": calib} if calib else {})), jnp.asarray(b),
                    False, mutable=["calib"])
                calib = mutated["calib"]
            calib = jax.tree_util.tree_map(np.asarray, dict(calib))
            # JAX quantize_model's own steps for an HRNet
            qvars = {"params": jquantize.strip_float_params(
                variables["params"], head), "qparams": jax.tree_util.tree_map(
                    np.asarray, J.convert_tree(variables["params"],
                                               variables["batch_stats"],
                                               calib))}
            out[head] = (torch_tiny.tiny_cfg(Config(), head), jcfg, jmodel,
                         variables, calib, qvars, batches)
        yield out


def _port_float_sd(variables):
    return state_dict_from_jax(variables["params"], variables["batch_stats"])


def _port_calib_key(path) -> str:
    """A JAX calib leaf's path -> the port's record key."""
    part, mod, leaf = path[0], tuple(path[1:-1]), path[-1]
    if leaf == "out_absmax":
        try:
            conv, _ = weights._convnorm_names(mod)
            return f"{part}.{conv}.out_absmax"
        except KeyError:
            pass
    return f"{weights._scale_owner(part, mod)}.{leaf}"


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v[0] if isinstance(v, tuple)
                                            else v)
    return out


@pytest.mark.parametrize("head", HEADS)
def test_calibration_matches_jax(models, head):
    """The port's calibration record against JAX's ``calibrate`` tree on
    the same float weights and batches: the same points (every ConvNorm,
    block, fused sum and the input) and values within CALIB_RTOL."""
    cfg, _, _, variables, jcal, _, batches = models[head]
    with torch_tiny.registered():
        got = calibrate(cfg, _port_float_sd(variables), batches, "cpu")
    want = {_port_calib_key(p): v for p, v in _flat(jcal).items()}
    assert set(got) == set(want)
    assert len(want) > 60
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=CALIB_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("head", HEADS)
def test_quantize_model_matches_jax(models, head):
    """The port's ``quantize_model`` loads into ``build_model(cfg,
    quant=True)`` strictly, as does JAX's quantized variables carried
    across; every int8 weight is equal, every scale within the
    calibration's and rsqrt's bounds."""
    cfg, _, _, variables, _, qvars, batches = models[head]
    with torch_tiny.registered():
        got = quantize_model(cfg, _port_float_sd(variables), batches, "cpu")
        model = build_model(cfg, "cpu", quant=True)
    want = quant_state_from_jax(qvars["params"], qvars["qparams"],
                                qvars.get("batch_stats"))
    model.load_state_dict(want, strict=True)
    model.load_state_dict(got, strict=True)
    assert set(got) == set(want)
    n_conv = sum(isinstance(m, QConvNorm) for m in model.modules())
    assert n_conv == sum(k.endswith(".w_int8") for k in got)
    # stem 2, layer1 13, transitions 2 + 1 + 1, exchange modules 18 + 31
    # + 48, the fusion head's 5
    assert n_conv == 116 + (5 if head == "fusion" else 0)
    for k, v in want.items():
        if v.dtype == torch.int8:
            assert torch.equal(got[k], v), k
        else:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                       rtol=max(CALIB_RTOL, 4 * RSQRT_RTOL),
                                       atol=1e-7, err_msg=k)


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


@pytest.mark.parametrize("head", HEADS)
def test_int8_forward_matches_jax(models, head):
    """The port's int8 forward on JAX's qparams (``quant_state_from_jax``)
    against JAX's int8 forward (op by op: under jit XLA contracts the
    epilogues' multiply-adds, which moves JAX's own outputs to a cosine of
    0.9997 from its eager ones), every output; the int8 model sits near
    the float one (JAX's own bound, cosine >= 0.995)."""
    cfg, jcfg, jmodel, variables, _, qvars, _ = models[head]
    x = torch_tiny.crops(60)
    with torch_tiny.registered():
        want = jpe.build_model(jcfg, quant=True).apply(
            jax.tree_util.tree_map(jnp.asarray, qvars), x, False)
        model = build_model(cfg, "cpu", quant=True)
    model.load_state_dict(quant_state_from_jax(
        qvars["params"], qvars["qparams"], qvars.get("batch_stats")),
        strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    keys = ("heatmaps", "offsets", "variances") if head == "fusion" else (
        "heatmaps",)
    for k in keys:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape
        assert _cos(g, w) >= FORWARD_COS, k
        assert np.abs(g - w).max() <= FORWARD_ATOL * np.abs(w).max(), k
    with torch.no_grad():
        flt = build_model(cfg, "cpu")
        flt.load_state_dict(_port_float_sd(variables), strict=True)
        flt = flt(torch.from_numpy(x))["heatmaps"]
    assert _cos(got["heatmaps"].numpy(), flt.numpy()) >= 0.995
