"""PyTorch port, tensor-parallel serving and the rest of the serving mesh
over a process grid, on the CPU against the JAX package.

One spawn of a 2 x 2 and one of a 1 x 2 grid of gloo CPU ranks
(tests/torch_grid.py ``tp_serve_rank``) on the tiny HRFormer + fusion of
tests/test_torch_grid_slice.py, folded, flip test off (as in JAX's
tensor-parallel serving test): tensor-parallel serving against the port's
one process and against JAX's ``PoseInference(mesh=create_mesh(4, 2),
tensor_parallel=True)`` on the same weights; int8 over the grid
(calibration and every int8 buffer equal to one process's, the tiny
HRNet's too); ``predict_stream`` over the grid; the server's
``GridLeader``/``follow`` broadcast.  The ranks run while this process
runs JAX's serving and its own.  The sharding table is
tests/test_torch_tensor_parallel.py.
"""
import copy
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu import inference as jinference
from infantposeestimation_gaussianbias_tpu.models import hrformer as jhr
from infantposeestimation_gaussianbias_tpu.models import pose_estimator as jpe
from infantposeestimation_gaussianbias_tpu.parallel import (
    create_mesh as jcreate_mesh)
from infantposeestimation_gaussianbias_tpu.tools.import_torch_checkpoint import (
    convert_checkpoint,
)
from infantposeestimation_gaussianbias_tpu_torch import PoseInference, parallel
from infantposeestimation_gaussianbias_tpu_torch.models import pose_estimator

from tests import torch_grid
from tests.test_torch_tensor_parallel import _fake_grid
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

# Tensor-parallel serving against one process of the port, float32: the
# assembled products are the same sums (a column block of a matmul, zeros
# added); only the BLAS blocking of the narrower products differs.
TP_RTOL = TP_ATOL = 1e-5
# Against JAX's tensor-parallel serving: JAX's own tolerance in
# tests/test_sharded_serving.py test_mesh_tensor_parallel_serving.
JAX_KPT_RTOL, JAX_KPT_ATOL, JAX_SCORE_TOL = 1e-4, 5e-3, 1e-4


def _frames_and_boxes():
    rng = np.random.RandomState(7)
    frames = rng.randint(0, 256, (5, 80, 100, 3)).astype(np.uint8)
    bboxes = np.array([[10, 5, 70, 75], [0, 0, 100, 80], [30, 20, 90, 60],
                       [5, 10, 95, 70], [20, 0, 80, 80]], np.float32)
    return frames, bboxes


def _stream():
    """Crop batches of the eval loader's contract; the last is ragged
    against the 2-rank data axis."""
    rng = np.random.RandomState(9)
    return [{"image_u8": rng.randint(0, 255, (n, 64, 48, 3))
             .astype(np.uint8),
             "center": (rng.rand(n, 2) * 40 + 20).astype(np.float32),
             "scale": (rng.rand(n, 2) * 40 + 40).astype(np.float32)}
            for n in (4, 3)]


def _hrnet_cfg():
    cfg = torch_grid.tiny_cfg("hrnet_tiny")
    cfg.model.head_type = "heatmap"
    cfg.model.hrnet_stage_modules = (1, 1, 1)
    cfg.data.input_size = (64, 64)
    cfg.data.heatmap_size = (16, 16)
    return cfg


@pytest.fixture(scope="module")
def setup():
    """The port's seeded tiny models (the HRFormer's BatchNorm statistics
    and prediction convs sharpened as in tests/test_torch_grid_slice.py),
    calibration crops, and the JAX side's registration."""
    from tests.test_torch_grid_slice import _seeded_state_dict

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jpe.BACKBONES, "hrformer_tiny", lambda **kw: jhr.HRFormer(
            drop_path_rate=0.0, **torch_grid.TINY, **kw))
        for name in ("tiny_hrformer", "tiny_hrformer_dp", "hrformer_tiny",
                     "hrnet_tiny"):
            mp.setitem(pose_estimator.BACKBONES, name, None)
        torch_grid.register_tiny()
        torch_grid.register_hrnet_tiny()
        sd = _seeded_state_dict(seed=1)
        hrnet_sd = pose_estimator.build_model(
            _hrnet_cfg(), device="cpu").state_dict()
        rng = np.random.RandomState(5)
        cfg = torch_grid.tiny_cfg("hrformer_tiny")
        cfg.eval.flip_test = False
        yield SimpleNamespace(
            cfg=cfg, sd=sd,
            hrnet_sd={k: v.clone() for k, v in hrnet_sd.items()},
            calib=rng.randn(6, 64, 48, 3).astype(np.float32),
            hrnet_calib=rng.randn(6, 64, 64, 3).astype(np.float32))


@pytest.fixture(scope="module", autouse=True)
def started(setup):
    """The 2 x 2 and the 1 x 2 grids, started with the module: they run
    while this process builds the sharding tables and runs JAX's
    serving."""
    args = (setup.sd, *_frames_and_boxes(), setup.calib, setup.hrnet_sd,
            setup.hrnet_calib, _stream())
    with ThreadPoolExecutor(2) as pool:
        yield {shape: pool.submit(
            parallel.run_grid, torch_grid.tp_serve_rank, *shape, "gloo",
            device="cpu", args=args, timeout=300)
            for shape in ((2, 2), (1, 2))}


@pytest.fixture(scope="module")
def ranks(started, jax_tp):
    """{(data, model): every rank's results} of the two grids."""
    return {shape: f.result() for shape, f in started.items()}


@pytest.fixture(scope="module")
def jax_tp(setup):
    """JAX's folded tensor-parallel serving over a 4 x 2 mesh of the 8
    CPU devices, on the port's weights (flip test off)."""
    params, stats = convert_checkpoint(
        {k: v.numpy().copy() for k, v in setup.sd.items()},
        head_type="fusion")
    jcfg = torch_grid.tiny_cfg("hrformer_tiny")
    jcfg.eval.flip_test = False
    variables = jax.tree_util.tree_map(
        jnp.asarray, {"params": params, "batch_stats": stats})
    jinf = jinference.PoseInference(
        jcfg, state=SimpleNamespace(apply_fn=jpe.build_model(jcfg).apply,
                                    variables=variables),
        mesh=jcreate_mesh(4, 2), tensor_parallel=True)
    return jinf.predict_batch(*_frames_and_boxes())


@pytest.fixture(scope="module")
def one(setup):
    """The port's one-process serving: float (folded), int8 HRFormer and
    int8 HRNet, each calibrated on the whole calibration crops."""
    frames, bboxes = _frames_and_boxes()
    fl = PoseInference(setup.cfg, state_dict=setup.sd, device="cpu")
    q = PoseInference(setup.cfg, state_dict=setup.sd, device="cpu",
                      quantize=True, calibration_crops=setup.calib)
    h = PoseInference(_hrnet_cfg(), state_dict=setup.hrnet_sd, device="cpu",
                      quantize=True, calibration_crops=setup.hrnet_calib)
    cut = parallel.shard_params(copy.deepcopy(q.model), _fake_grid(2), True)
    return SimpleNamespace(
        int8_table=parallel.sharding_table(cut),
        serve=fl.predict_batch(frames, bboxes),
        stream=list(fl.predict_stream(iter(_stream()))),
        int8=q.predict_batch(frames, bboxes), int8_sd=q.model.state_dict(),
        hrnet_int8=h.predict_batch(frames, bboxes),
        hrnet_int8_sd=h.model.state_dict())


def test_ranks_import_no_jax(ranks):
    assert all(r["jax_modules"] == [] for rs in ranks.values() for r in rs)


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
def test_tp_serving_matches_one_process_and_jax(setup, ranks, one, jax_tp,
                                                shape):
    """Every rank returns the whole trimmed batch: against the port's one
    process within TP_RTOL/TP_ATOL; against JAX's tensor-parallel serving within
    JAX's own test tolerance; every hrformer Dense and both shared convs
    are cut (the tiny widths all divide by 2)."""
    k_one, s_one = one.serve
    k_jax, s_jax = jax_tp
    for r in ranks[shape]:
        kpts, scores = r["serve"]
        assert kpts.shape == (5, 17, 2) and scores.shape == (5, 17)
        np.testing.assert_allclose(kpts, k_one, rtol=TP_RTOL, atol=TP_ATOL)
        np.testing.assert_allclose(scores, s_one, rtol=TP_RTOL, atol=TP_ATOL)
        np.testing.assert_allclose(kpts, k_jax, rtol=JAX_KPT_RTOL,
                                   atol=JAX_KPT_ATOL)
        np.testing.assert_allclose(scores, s_jax, rtol=JAX_SCORE_TOL,
                                   atol=JAX_SCORE_TOL)
        table = r["table"]
        assert len(table) == 4 * 2 * (2 + 3 + 4) + 2
        for n, dim in table.items():
            full = setup.sd[n].shape
            assert dim == 0 and r["shapes"][n] == (full[0] // 2, *full[1:])


def test_int8_over_the_grid_equals_one_process(ranks, one):
    """int8 over the 2 x 2 grid, each data rank calibrating on its rows of
    the crops: every int8 buffer and calibrated scale equal to one
    process's bit for bit (the HRFormer with its narrow float Linears cut
    over the model axis, the HRNet with nothing to cut), and the served
    keypoints within the float tolerance (the float layers' narrower
    products)."""
    for r in ranks[2, 2]:
        for key, ref in (("int8_sd", one.int8_sd),
                         ("hrnet_int8_sd", one.hrnet_int8_sd)):
            assert set(r[key]) == set(ref)
            for n, v in ref.items():
                np.testing.assert_array_equal(r[key][n], v.numpy(),
                                              err_msg=f"{key} {n}")
        assert r["int8_table"] == one.int8_table
        for key in ("int8", "hrnet_int8"):
            k, s = r[key]
            np.testing.assert_allclose(k, getattr(one, key)[0],
                                       rtol=TP_RTOL, atol=TP_ATOL)
            np.testing.assert_allclose(s, getattr(one, key)[1],
                                       rtol=TP_RTOL, atol=TP_ATOL)


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
def test_predict_stream_over_the_grid(ranks, one, shape):
    """predict_stream over the grid yields every batch in order, the
    ragged one trimmed, equal to one process's stream within TP_RTOL/TP_ATOL."""
    for r in ranks[shape]:
        assert [c.shape[0] for c, _ in r["stream"]] == [4, 3]
        for (c, s), (rc, rs) in zip(r["stream"], one.stream):
            np.testing.assert_allclose(c, rc, rtol=TP_RTOL, atol=TP_ATOL)
            np.testing.assert_allclose(s, rs, rtol=TP_RTOL, atol=TP_ATOL)


def test_server_leader_broadcasts_batches(ranks):
    """The server's GridLeader on rank 0 broadcasts each formed batch; the
    followers serve it with it and stop at its stop: rank 0's answers are
    those of predict_batch on the same rows."""
    k_all, s_all = ranks[2, 2][0]["serve"]
    for (k, s), n in zip(ranks[2, 2][0]["leader"], (3, 5)):
        np.testing.assert_allclose(k, k_all[:n], rtol=TP_RTOL, atol=TP_ATOL)
        np.testing.assert_allclose(s, s_all[:n], rtol=TP_RTOL, atol=TP_ATOL)
