"""PyTorch port, configuration and isolation: the port's own ``config`` and
``schemas`` against the JAX package's, and the port's independence of the
JAX package (its imports, and its entry points' device default)."""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu import config as jconfig
from infantposeestimation_gaussianbias_tpu import schemas as jschemas
from infantposeestimation_gaussianbias_tpu_torch import config, schemas

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "infantposeestimation_gaussianbias_tpu_torch"


@pytest.mark.parametrize("name", sorted(jconfig.VARIANTS))
def test_variants_match_jax(name):
    assert sorted(config.VARIANTS) == sorted(jconfig.VARIANTS)
    assert (config.to_dict(config.get_variant(name))
            == jconfig.to_dict(jconfig.get_variant(name)))


def test_default_config_matches_jax():
    assert config.to_dict(config.get_config()) == jconfig.to_dict(
        jconfig.get_config())


@pytest.mark.parametrize("name", ["coco17", "infant13"])
def test_schemas_match_jax(name):
    port, ref = schemas.get_schema(name), jschemas.get_schema(name)
    assert port.keypoint_names == ref.keypoint_names
    assert port.flip_pairs == ref.flip_pairs
    assert port.skeleton == ref.skeleton
    assert port.oks_sigmas == ref.oks_sigmas
    assert (port.upper_body, port.lower_body) == (ref.upper_body,
                                                  ref.lower_body)
    np.testing.assert_array_equal(port.flip_index(), ref.flip_index())
    np.testing.assert_array_equal(port.skeleton_array(), ref.skeleton_array())
    assert port.skeleton_array().dtype == ref.skeleton_array().dtype
    assert config.get_variant("preemie").data.num_keypoints == 13


@pytest.mark.parametrize("yaml_name", ["hrformer_base.yaml", "preemie.yaml",
                                       "default.yaml"])
def test_yaml_and_overrides_match_jax(yaml_name):
    overrides = ["train.lr=1e-3", "data.input_size=96,128",
                 "model.remat=true", "train.lr_milestones=3,5"]
    port = config.apply_overrides(
        config.load_yaml(str(REPO / "configs" / yaml_name)), overrides)
    ref = jconfig.apply_overrides(
        jconfig.load_yaml(str(REPO / "configs" / yaml_name)), overrides)
    assert config.to_dict(port) == jconfig.to_dict(ref)
    assert port.data.input_size == (96, 128) and port.model.remat is True


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO))
    for p in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]))
def test_port_imports_nothing_of_jax(path):
    """No module of the port, and not chip_smoke.py, imports jax, flax or
    the JAX package (its framework-neutral modules included)."""
    bad = [m for m in _imported_modules(REPO / path)
           if m.split(".")[0] in ("jax", "flax", "optax",
                                  "infantposeestimation_gaussianbias_tpu")]
    assert not bad, bad


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """Without a device argument the entry points run on CUDA; where there
    is no CUDA they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from infantposeestimation_gaussianbias_tpu_torch import (
        PoseInference, create_train_state)
    from infantposeestimation_gaussianbias_tpu_torch.analysis import (
        benchmark_model)
    from infantposeestimation_gaussianbias_tpu_torch.models import build_model
    from infantposeestimation_gaussianbias_tpu_torch.tools import (
        probe_wmsa_ablate)

    cfg = config.get_variant("hrformer_small")
    for make in (PoseInference, build_model, create_train_state,
                 benchmark_model):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg)
    monkeypatch.setenv("PROBE_SHAPE", "2,16,16,1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_wmsa_ablate.main()
