"""PyTorch port, configuration and isolation: the port's own ``config`` and
``schemas`` against the JAX package's, and the port's independence of the
JAX package (its imports, and its entry points' device default)."""

import ast
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu import config as jconfig
from infantposeestimation_gaussianbias_tpu import schemas as jschemas
from infantposeestimation_gaussianbias_tpu_torch import config, schemas

from tests import torch_grid

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
    for p in [*PORT.rglob("*.py"), REPO / "chip_smoke.py",
              REPO / "tests" / "torch_grid.py"]))
def test_port_imports_nothing_of_jax(path):
    """No module of the port, not chip_smoke.py, and not the process-grid
    tests' rank helper (which spawned ranks import) imports jax, flax or
    the JAX package (its framework-neutral modules included)."""
    bad = [m for m in _imported_modules(REPO / path)
           if m.split(".")[0] in ("jax", "flax", "optax",
                                  "infantposeestimation_gaussianbias_tpu")]
    assert not bad, bad


def test_entry_points_refuse_a_missing_card(monkeypatch, tmp_path):
    """Without a device argument the entry points run on CUDA; where there
    is no CUDA they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from infantposeestimation_gaussianbias_tpu_torch import (
        PoseInference, create_train_state)
    from infantposeestimation_gaussianbias_tpu_torch.analysis import (
        benchmark_model)
    from infantposeestimation_gaussianbias_tpu_torch.models import build_model
    from infantposeestimation_gaussianbias_tpu_torch.parallel import (
        ProcessGrid, run_grid)
    from infantposeestimation_gaussianbias_tpu_torch.tools import (
        probe_wmsa_ablate)

    from infantposeestimation_gaussianbias_tpu_torch import graft_entry
    from infantposeestimation_gaussianbias_tpu_torch.cli import infer, serve

    cfg = config.get_variant("hrformer_small")
    for make in (PoseInference, build_model, create_train_state,
                 benchmark_model):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--variant", "hrformer_small", "--port", "0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.main(["--variant", "hrformer_small", "--input", "x.jpg"])
    from infantposeestimation_gaussianbias_tpu_torch.cli import (
        train as cli_train, validate as cli_validate)

    logs = ["--set", f"log_dir={tmp_path}"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(["--variant", "hrformer_small", "--synthetic", "2",
                        "--epochs", "1", "--no-val"] + logs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_validate.main(["--variant", "hrformer_small"] + logs)
    monkeypatch.setenv("PROBE_SHAPE", "2,16,16,1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_wmsa_ablate.main()
    grid = ProcessGrid(data=2, model=1, rank=0, data_index=0, model_index=0,
                       data_group=None, model_group=None, world_group=None,
                       device=torch.device("cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PoseInference(cfg, mesh=grid)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_grid(torch_grid.raise_on, 1, 2, "gloo", args=(5,))


def test_backends_are_explicit():
    """nccl needs a card per rank: more ranks than cards raises before a
    process starts; a backend other than gloo or nccl raises."""
    from infantposeestimation_gaussianbias_tpu_torch.parallel import (
        check_backend, run_grid)

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="nccl needs a card per rank"):
        check_backend("nccl", cards + 1)
    with pytest.raises(RuntimeError, match="nccl needs a card per rank"):
        run_grid(torch_grid.raise_on, cards + 1, 1, "nccl", device="cpu",
                 args=(5,))
    with pytest.raises(ValueError, match="backend must be one of"):
        check_backend("mpi", 1)
    check_backend("gloo", cards + 4)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("path", ["env", "tcp"])
def test_initialize_multihost(path, monkeypatch):
    """A one-rank gloo group on this host, from torchrun's environment or
    from cfg.parallel's coordinator, process count and id."""
    import torch.distributed as dist
    from infantposeestimation_gaussianbias_tpu_torch.parallel import (
        initialize_multihost, maybe_initialize_multihost)

    port = _free_port()
    cfg = config.get_variant("hrformer_small")
    try:
        if path == "env":
            for k, v in (("MASTER_ADDR", "127.0.0.1"),
                         ("MASTER_PORT", str(port)), ("RANK", "0"),
                         ("WORLD_SIZE", "1")):
                monkeypatch.setenv(k, v)
            initialize_multihost("gloo")
        else:
            cfg.parallel.multihost = True
            cfg.parallel.coordinator = f"127.0.0.1:{port}"
            cfg.parallel.num_processes, cfg.parallel.process_id = 1, 0
            maybe_initialize_multihost(cfg, "gloo")
        assert dist.is_initialized()
        assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
        assert dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_initialize_multihost_refuses_what_it_cannot_run(monkeypatch):
    """The explicit arguments come all together or not at all; nccl counts
    every rank on this host (num_processes, or torchrun's WORLD_SIZE where
    LOCAL_WORLD_SIZE is unset) against the cards."""
    from infantposeestimation_gaussianbias_tpu_torch.parallel import (
        initialize_multihost)

    for args in (("127.0.0.1:1", None, None), (None, 2, 0),
                 ("127.0.0.1:1", 2, None)):
        with pytest.raises(ValueError, match="set together or not at all"):
            initialize_multihost("gloo", *args)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"{cards + 1} ranks"):
        initialize_multihost("nccl", "127.0.0.1:1", cards + 1, 0)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setenv("WORLD_SIZE", str(cards + 2))
    with pytest.raises(RuntimeError, match=f"{cards + 2} ranks"):
        initialize_multihost("nccl")


def test_tensor_parallel_is_refused():
    """The JAX package's tensor_parallel is not ported yet: asked for, it
    raises and names the roadmap item."""
    from infantposeestimation_gaussianbias_tpu_torch import (
        PoseInference, create_train_state)
    from infantposeestimation_gaussianbias_tpu_torch.parallel import (
        ProcessGrid)

    cfg = config.get_variant("hrformer_small")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        PoseInference(cfg, device="cpu", tensor_parallel=True)
    cfg.parallel.tensor_parallel = True
    grid = ProcessGrid(data=2, model=1, rank=0, data_index=0, model_index=0,
                       data_group=None, model_group=None, world_group=None,
                       device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        create_train_state(cfg, device="cpu", grid=grid)


def test_run_grid_fails_when_a_rank_raises():
    """A rank's exception fails the call, with the rank's message."""
    from infantposeestimation_gaussianbias_tpu_torch.parallel import run_grid

    assert run_grid(torch_grid.raise_on, 1, 2, "gloo", device="cpu",
                    args=(5,), timeout=120) == [0, 1]
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        run_grid(torch_grid.raise_on, 1, 2, "gloo", device="cpu",
                 args=(1,), timeout=120)


def test_serving_surfaces_run_without_jax(tmp_path):
    """With jax, flax and the JAX package unimportable, the serving and
    training slices' modules import and run on the CPU: the fold, the
    server's decode and micro-batcher, the CLIs' option parsing, the
    native decoder (or its absence), the prefetch stage, post-processing,
    the skeleton drawing and the graft entry's config; the loader over
    on-disk JPEGs (the native decode + warp, or cv2 where it is missing),
    device batches, the jitter, the evaluator, a checkpoint, the metrics
    file (JSONL alone where TensorBoard does not import) and the pipeline
    proof's data."""
    code = textwrap.dedent(f"""
        import io, os, sys
        sys.modules["jax"] = sys.modules["flax"] = None
        sys.modules["infantposeestimation_gaussianbias_tpu"] = None
        sys.modules["torch.utils.tensorboard"] = None
        import numpy as np
        import torch
        from infantposeestimation_gaussianbias_tpu_torch import (
            data, eval, graft_entry, native, postprocess, viz, weights)
        from infantposeestimation_gaussianbias_tpu_torch.cli import (
            common, infer, serve, train as cli_train,
            validate as cli_validate)
        from infantposeestimation_gaussianbias_tpu_torch.ops import (
            photometric)
        from infantposeestimation_gaussianbias_tpu_torch.tools import (
            analyze_dataset, convert_to_coco, pipeline_proof,
            probe_native_loader)
        from infantposeestimation_gaussianbias_tpu_torch.train import (
            checkpoint, logging, loop, optim, state)
        from infantposeestimation_gaussianbias_tpu_torch.models import (
            build_model, fold_state_dict)
        from infantposeestimation_gaussianbias_tpu_torch.ops import decode
        cfg = graft_entry.flagship_cfg("float32")
        cfg.model.hrnet_stage_modules = (1, 1, 1)
        sd = fold_state_dict(build_model(cfg, device="cpu").state_dict())
        assert not any(k.endswith("running_var") for k in sd)
        buf = io.BytesIO()
        np.save(buf, np.zeros((4, 5, 3), np.uint8))
        assert serve._decode_image(buf.getvalue(),
                                   "application/x-npy").shape == (4, 5, 3)
        native.available()
        got = list(data.prefetch_to_device(
            [{{"x": np.ones(3)}}], keys=("x",), device="cpu"))
        assert torch.equal(got[0]["x"], torch.ones(3, dtype=torch.float64))
        pts = torch.rand(2, 17, 2) * 10
        postprocess.nms_pose(pts, torch.rand(2, 17))
        decode.temporal_smooth(torch.rand(8, 17, 2), 5, "gaussian")
        viz.draw_skeleton(np.zeros((20, 20, 3), np.uint8),
                          pts[0].numpy(), np.ones(17))
        try:
            serve.main(["--int8", "--device", "cpu"])
        except NotImplementedError as e:
            assert "Queue 1 item 5" in str(e)
        else:
            raise AssertionError("--int8 must raise")
        root = "{tmp_path}"
        gt = data.synthetic_coco_dataset(num_images=4, image_dir=root)
        recs = data.build_records(data.CocoIndex(dataset=gt))
        cfg.data.input_size, cfg.data.heatmap_size = (64, 64), (16, 16)
        ds = data.PoseDataset(cfg, recs, root, True)
        batches = list(data.DataLoader(ds, 2, shuffle=True,
                                       num_threads=2).epoch(0))
        assert ds.decoded["native" if native.available() else "cv2"] == 4
        db = data.device_batch(batches[0], cfg.data.pixel_mean,
                               cfg.data.pixel_std, device="cpu")
        assert db["image"].shape == (2, 64, 64, 3)
        photometric.color_jitter_normalized(
            db["image"], cfg.data.pixel_mean, cfg.data.pixel_std,
            (0.2, 0.2, 0.2), torch.Generator().manual_seed(0))
        ev = eval.COCOEvaluator(cfg.data.keypoint_schema.oks_sigma_array(),
                                gt)
        ev.update(batches[0]["image_id"], np.zeros((2, 17, 2)),
                  np.ones((2, 17)))
        assert set(ev.evaluate()) >= {{"AP", "AR"}}
        cfg.train.steps_per_epoch = 2
        st = loop.create_train_state(cfg, device="cpu")
        checkpoint.CheckpointManager(root + "/ck").save(st, 0, {{"AP": 0.5}},
                                                        -np.inf)
        assert {{"latest", "best"}} <= set(os.listdir(root + "/ck"))
        logging.MetricsWriter(root + "/logs").write(1, {{"loss": 1.0}})
        assert os.listdir(root + "/logs") == ["metrics.jsonl"]
        pipeline_proof.build_synthetic_pose_dataset(2)
        loaded = [m for m in sys.modules if sys.modules[m] is not None
                  and m.split(".")[0] in ("jax", "flax")]
        assert not loaded, loaded
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")

