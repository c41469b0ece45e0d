"""The tiny HRNet shared by the port's HRNet and analysis tests.

HRNet with base_channels 8 and stage modules (1, 1, 1) at 64x64, registered
as ``hrnet_tiny`` in both packages' ``BACKBONES`` (test-only) while
``tiny_models()`` is open.  Seeded numpy weights on the fusion model's
``jax.eval_shape`` tree (``random_variables``: no JAX init to compile)
give both heads' weights: the heatmap head's 1x1 ``final`` conv is drawn
from numpy, the backbone is the fusion model's.  Weights go JAX ->
``state_dict_from_jax`` -> the port (``port``).
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from infantposeestimation_gaussianbias_tpu.config import get_config as jget_config
from infantposeestimation_gaussianbias_tpu.models import hrnet as jhrnet
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu_torch import Config
from infantposeestimation_gaussianbias_tpu_torch.models import hrnet
from infantposeestimation_gaussianbias_tpu_torch.models import pose_estimator
from infantposeestimation_gaussianbias_tpu_torch.weights import (
    state_dict_from_jax,
)

TINY_C = 8
SIZE = 64
HM = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the test module that imports this
    fixture: the suite runs six workers on the machine's cores, and
    torch's default of a thread per core has them oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.array(x))


def tiny_cfg(cfg, head):
    cfg.model.backbone = "hrnet_tiny"
    cfg.model.head_type = head
    cfg.model.hrnet_stage_modules = (1, 1, 1)
    cfg.model.hidden_dim = 16
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = (SIZE, SIZE)
    cfg.data.heatmap_size = (HM, HM)
    cfg.train.warmup_epochs = 0
    return cfg


def sharpen(variables, seed):
    """Random BN statistics and stronger prediction convs (numpy copies):
    the default init's flat heatmaps put every peak in one place.  The
    offsets stay within a few pixels."""
    rng = np.random.RandomState(seed)
    v = jax.tree_util.tree_map(np.array, variables)
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["batch_stats"]):
        name = jax.tree_util.keystr(path)
        if name.endswith("['mean']"):
            leaf[...] = rng.randn(*leaf.shape) * 0.1
        elif name.endswith("['var']"):
            leaf[...] = rng.rand(*leaf.shape) * 0.5 + 0.75
    for final, scale in (("hm_final", 0.3), ("off_final", 3e-4)):
        k = v["params"]["head"][final]["kernel"]
        k[...] = rng.randn(*k.shape) * scale
    return v


@contextlib.contextmanager
def tiny_models():
    """{head: (port cfg, JAX cfg, JAX model, JAX variables as numpy)} with
    ``hrnet_tiny`` registered in both BACKBONES inside the block."""
    with registered():
        jcfg = tiny_cfg(jget_config(), "fusion")
        model = jpe.build_model(jcfg)
        variables = sharpen(random_variables(model, seed=0), seed=1)
        rng = np.random.RandomState(2)
        hm_vars = {
            "params": {"backbone": variables["params"]["backbone"],
                       "head": {"final": {
                           "kernel": (rng.randn(1, 1, TINY_C, 17) * 0.3)
                           .astype(np.float32),
                           "bias": (rng.randn(17) * 0.1).astype(np.float32)}}},
            "batch_stats": {"backbone": variables["batch_stats"]["backbone"]}}
        out = {}
        for head, v in (("fusion", variables), ("heatmap", hm_vars)):
            jc = tiny_cfg(jget_config(), head)
            out[head] = (tiny_cfg(Config(), head), jc, jpe.build_model(jc), v)
        yield out


def port(cfg, variables):
    model = pose_estimator.build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]),
                          strict=True)
    return model


def crops(seed, n=2):
    return np.random.RandomState(seed).randn(n, SIZE, SIZE, 3).astype(
        np.float32)


def random_variables(jmodel, seed, shape=(SIZE, SIZE)):
    """Seeded numpy weights for a JAX model's variable tree, without an
    init: the tree's shapes come from ``jax.eval_shape`` at input (H, W)
    ``shape`` (a trace, ~1 s, where a jitted init of the tiny HRNet
    compiles for ~16 s).  Kernels ~ N(0, 1/fan_in), BatchNorm scale
    1 +- 0.1, running variance in [0.75, 1.25), everything else
    N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *shape, 3)), False))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            x = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name.endswith("['scale']"):
            x = 1 + 0.1 * rng.randn(*s.shape)
        elif name.endswith("['var']"):
            x = rng.rand(*s.shape) * 0.5 + 0.75
        else:
            x = 0.1 * rng.randn(*s.shape)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@contextlib.contextmanager
def registered():
    """``hrnet_tiny`` in both packages' BACKBONES inside the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jpe.BACKBONES, "hrnet_tiny",
                   lambda **kw: jhrnet.HRNet(base_channels=TINY_C, **kw))
        mp.setitem(pose_estimator.BACKBONES, "hrnet_tiny",
                   lambda **kw: hrnet.HRNet(base_channels=TINY_C, **kw))
        yield
