"""PyTorch port, tensor parallelism: the sharding table against the JAX
package, on the CPU.

The port's rule (parallel/tensor.py ``param_sharding_rules``) selects exactly the
tensors JAX's ``param_sharding_rules`` selects, mapped to the port's names
(weights.py), at model axis 2 and 4 (4 leaves hrformer_base's branch-0
qkv, proj and fc2, widths 234 and 78, replicated and cuts its fc1, 312),
in the float, the folded and the int8 trees of hrformer_base + fusion at
published widths and of the tiny HRNet + fusion of tests/torch_tiny.py.
The trees' shapes come from ``jax.eval_shape`` (no JAX init); the port's
layers are cut on a ProcessGrid with no process group (the cut itself
makes no collective); ``shard_params`` then holds out / m rows of each.
Tensor-parallel serving, int8 and the stream over a grid are
tests/test_torch_tp_serving.py; the step, tests/test_torch_train.py.
"""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.config import get_variant as jvariant
from infantposeestimation_gaussianbias_tpu.models import fold_variables
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.models import quantize_model
from infantposeestimation_gaussianbias_tpu.parallel import (
    create_mesh as jcreate_mesh, param_sharding_rules as jrules)
from infantposeestimation_gaussianbias_tpu_torch import get_variant, parallel
from infantposeestimation_gaussianbias_tpu_torch import weights
from infantposeestimation_gaussianbias_tpu_torch.models import pose_estimator
from infantposeestimation_gaussianbias_tpu_torch.weights import _param_entry

from tests import torch_tiny
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

def _fake_grid(model_axis: int):
    """A ProcessGrid of one data rank and ``model_axis`` model ranks, with
    no process group: enough for ``shard_params`` to cut."""
    return parallel.ProcessGrid(
        data=1, model=model_axis, rank=0, data_index=0, model_index=0,
        data_group=None, model_group=None, world_group=None,
        device=torch.device("cpu"))


def _jax_table(tree, model_axis: int) -> set:
    """The flax paths JAX's rule shards, as the port's names."""
    mesh = jcreate_mesh(8 // model_axis, model_axis)
    out = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = jrules(path, leaf, mesh, tensor_parallel=True).spec
        if not any(a is not None for a in spec):
            continue
        keys = [str(getattr(p, "key", p)) for p in path]
        assert keys[0] == "params", keys  # no qparams leaf is a kernel
        name, _ = _param_entry(keys[1], tuple(keys[2:]),
                               np.zeros((1,) * len(leaf.shape)))
        out.add(f"{keys[1]}.{name}")
    return out


@pytest.fixture(scope="module")
def trees():
    """{(model, mode): (JAX variable shapes, the port's model)} for
    hrformer_base + fusion at published widths and the tiny HRNet +
    fusion, float, folded and int8."""
    out = {}
    with torch_tiny.registered():
        for label, jcfg, cfg, hw in (
                ("hrformer_base", jvariant("hrformer_base"),
                 get_variant("hrformer_base"), 64),
                ("hrnet_tiny", torch_tiny.tiny_cfg(
                    torch_tiny.jget_config(), "fusion"),
                 torch_tiny.tiny_cfg(torch_tiny.Config(), "fusion"),
                 torch_tiny.SIZE)):
            jmodel = jpe.build_model(jcfg)
            x = jax.ShapeDtypeStruct((1, hw, hw, 3), jnp.float32)
            shapes = jax.eval_shape(lambda x: jmodel.init(
                jax.random.PRNGKey(0), x, False), x)
            jtrees = dict(
                float=shapes, folded=jax.eval_shape(fold_variables, shapes),
                int8=jax.eval_shape(
                    lambda v, x: quantize_model(jcfg, v, [x]), shapes, x))
            for mode, kw in (("float", {}), ("folded", dict(fold=True)),
                             ("int8", dict(quant=True))):
                out[label, mode] = (jtrees[mode], _uninitialised(cfg, kw))
    return out


def _uninitialised(cfg, kw):
    """``build_model(cfg, **kw)`` without the seeded init: the names and
    shapes are all the table needs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, "init_weights", lambda model, seed: model)
        return pose_estimator.build_model(cfg, device="cpu", **kw)


def _port_table(model, model_axis: int) -> set:
    """The names the port's rule selects at this model axis."""
    owners = {f"{n}.{k}": m for n, m in model.named_modules()
              for k, _ in m.named_parameters(recurse=False)}
    return {n for n, p in model.named_parameters()
            if parallel.param_sharding_rules(n, p, owners[n], model_axis,
                                             tensor_parallel=True) == 0}


@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("mode", ["float", "folded", "int8"])
@pytest.mark.parametrize("model", ["hrformer_base", "hrnet_tiny"])
def test_sharding_table_matches_jax(trees, model, mode, model_axis):
    """The port's rule selects exactly JAX's tensors: at model axis 4
    hrformer_base's branch-0 qkv (234) and proj and fc2 (78) stay whole
    and its fc1 (312) is cut; int8 leaves every QDense's buffers whole (no
    ``kernel`` in JAX's quantized tree), the tiny HRNet's shared convs
    too (QConvNorms)."""
    jtree, port = trees[model, mode]
    want = _jax_table(jtree, model_axis)
    assert _port_table(port, model_axis) == want
    if model == "hrformer_base":
        b0 = "backbone.stage2.0.branches.0.0."
        split = {f"{b0}{k}.weight" for k in ("attn.qkv", "attn.proj",
                                              "mlp.fc1", "mlp.fc2")}
        if mode == "int8":  # fc2 (312 in) is a QDense: int8 buffers
            split.discard(f"{b0}mlp.fc2.weight")
        if model_axis == 2:
            assert split <= want
        else:  # 234 and 78 do not divide by 4, 312 does
            assert split & want == {f"{b0}mlp.fc1.weight"}
    else:
        assert want == (set() if mode == "int8" else {
            "head.shared_layers.0.weight", "head.shared_layers.3.weight"})


@pytest.mark.parametrize("model,mode", [("hrformer_base", "float"),
                                        ("hrformer_base", "int8"),
                                        ("hrnet_tiny", "folded")])
def test_shard_params_cuts_the_table(trees, model, mode):
    """``shard_params`` at model axis 4 replaces each selected weight by
    its rows [j k, (j + 1) k) (here j = 0), lists it in its table, axis 0,
    and leaves every other tensor whole."""
    _, port = trees[model, mode]
    full = {n: p.detach().clone() for n, p in port.named_parameters()}
    cut = parallel.shard_params(copy.deepcopy(port), _fake_grid(4),
                                tensor_parallel=True)
    table = parallel.sharding_table(cut)
    assert set(table) == _port_table(port, 4) and table
    assert set(table.values()) == {0}
    for n, p in cut.named_parameters():
        want = full[n][:full[n].shape[0] // 4] if n in table else full[n]
        assert torch.equal(p.detach(), want), n


def test_no_grid_or_one_model_rank_cuts_nothing(trees):
    """Without a grid, without tensor_parallel or with one model rank the
    model is left whole (JAX's tensor_parallel without a mesh is a no-op
    too)."""
    _, port = trees["hrnet_tiny", "float"]
    for grid, tp in ((None, True), (_fake_grid(2), False),
                     (_fake_grid(1), True)):
        m = parallel.shard_params(copy.deepcopy(port), grid, tp)
        assert parallel.sharding_table(m) == {}
