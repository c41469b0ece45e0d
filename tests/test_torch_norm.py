"""PyTorch port, ``cfg.model.norm``: GroupNorm (models/layers.py
``GroupNorm``, ``make_norm``) against the JAX package's
``Norm(kind="groupnorm")``, alone and in the tiny HRNet of
tests/torch_tiny.py (seeded numpy weights, no JAX init), forward and one
gradient; an unknown norm raises, as in JAX.

Tolerances: flax takes the group variance as E[x^2] - E[x]^2 and torch as
E[(x - mean)^2]; both in float32, they differ by the rounding of the
statistics (~1e-7 relative), which the network carries to its outputs as
~1e-6 of their scale.  The outputs are held to 1e-4 of each map's largest
magnitude, as tests/test_torch_hrnet.py holds the BatchNorm HRNet, and the
gradients as that file does: the head's tightly, the rest to 2e-2 (a
ReLU input within rounding of 0 takes the other side in one framework).
The network's gradient is taken over the head and the last stage's
module (every branch width, its GroupNorms and fuse layers): JAX
compiles that backward in under half the time of the whole network's.  The layer's own gradients
are held at every width to 1e-4 of their scale.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.config import get_config as jget_config
from infantposeestimation_gaussianbias_tpu.models import layers as jlayers
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu_torch import Config
from infantposeestimation_gaussianbias_tpu_torch.models import build_model
from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
    GroupNorm, make_norm)
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    state_dict_from_jax,
)

from tests import torch_tiny
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("C", [8, 64, 78, 156, 624])
def test_groupnorm_layer_matches_jax(C):
    """groups min(32, C) lowered until they divide C (78 -> 26), float32
    statistics, the output in the input's dtype."""
    rng = np.random.RandomState(C)
    x = (rng.randn(2, 5, 3, C) * 2 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    r = rng.randn(*x.shape).astype(np.float32)

    def loss(gn, xx):
        y = jlayers.Norm(kind="groupnorm").apply({"params": {"gn": gn}}, xx)
        return jnp.sum(y * r), y

    (_, ref), (j_gn, j_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            {"scale": scale, "bias": bias}, jnp.asarray(x))
    layer = GroupNorm(C)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(scale))
        layer.bias.copy_(torch.from_numpy(bias))
        half = layer(torch.from_numpy(x).to(torch.bfloat16))
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt)
    (out * torch.from_numpy(r)).sum().backward()
    assert C % layer.num_groups == 0 and layer.num_groups <= 32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    for got, want in ((xt.grad, j_x), (layer.weight.grad, j_gn["scale"]),
                      (layer.bias.grad, j_gn["bias"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 * np.abs(want).max(), rtol=1e-4)
    assert half.dtype == torch.bfloat16


def test_k7_refuses_groupnorm_blocks():
    """K7 folds BatchNorm statistics; a GroupNorm block raises."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels.residual_block import (
        pack_basic_block_params)
    from infantposeestimation_gaussianbias_tpu_torch.models.layers import (
        BasicBlock)

    with pytest.raises(ValueError, match="K7 folds BatchNorm"):
        pack_basic_block_params([BasicBlock(8, norm="groupnorm")])


def test_unknown_norm_raises():
    with pytest.raises(ValueError, match="Unknown norm 'layernorm'"):
        make_norm("layernorm", 8)
    cfg = Config()
    cfg.model.norm = "layernorm"
    with pytest.raises(ValueError, match="Unknown norm"):
        build_model(cfg, device="cpu")


def test_groupnorm_hrnet_matches_jax():
    """The tiny HRNet + heatmap head built with norm="groupnorm" on both
    sides from the same seeded weights: heatmaps, and the gradient of
    sum(heatmaps * R) with respect to every parameter of the head and of
    the last stage's module."""
    with torch_tiny.registered():
        jcfg = torch_tiny.tiny_cfg(jget_config(), "heatmap")
        cfg = torch_tiny.tiny_cfg(Config(), "heatmap")
        jcfg.model.norm = cfg.model.norm = "groupnorm"
        jmodel = jpe.build_model(jcfg)
        variables = torch_tiny.random_variables(jmodel, seed=4)
        assert "batch_stats" not in variables
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state_dict_from_jax(variables["params"], {}),
                              strict=True)
        crops = torch_tiny.crops(5)
        rmask = np.random.RandomState(6).randn(
            2, torch_tiny.HM, torch_tiny.HM, 17).astype(np.float32)
        params = variables["params"]
        backbone = params["backbone"]

        def loss(part, x):
            hm = jmodel.apply({"params": {"head": part["head"], "backbone": {
                **backbone, "stage4_module0": part["last"]}}}, x,
                False)["heatmaps"]
            return jnp.sum(hm * rmask), hm

        (_, ref), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            {"head": params["head"], "last": backbone["stage4_module0"]},
            jnp.asarray(crops))
    hm = model(torch.from_numpy(crops))["heatmaps"]
    ref = np.asarray(ref)
    np.testing.assert_allclose(hm.detach().numpy(), ref,
                               atol=1e-4 * np.abs(ref).max(), rtol=1e-4)
    (hm * torch.from_numpy(rmask)).sum().backward()
    j_grads = jax.tree_util.tree_map(np.asarray, j_grads)
    want = state_dict_from_jax({"head": j_grads["head"], "backbone": {
        "stage4_module0": j_grads["last"]}}, {})
    # 4 branches of 2 blocks of 2 norms, and the fuse layers' norms
    assert sum(isinstance(m, GroupNorm) and f"{n}.weight" in want
               for n, m in model.named_modules()) > 16
    params = dict(model.named_parameters())
    # the fuse layers into branches 1-3 feed no output
    grads = {n: torch.zeros_like(params[n]) if params[n].grad is None
             else params[n].grad for n in want}
    head = "head.final_layer.weight"
    assert (grads[head] - want[head]).norm() <= 1e-4 * want[head].norm()
    flat = torch.cat([grads[n].flatten() for n in sorted(want)])
    flat_want = torch.cat([want[n].flatten() for n in sorted(want)])
    assert (flat - flat_want).norm() <= 2e-2 * flat_want.norm()
