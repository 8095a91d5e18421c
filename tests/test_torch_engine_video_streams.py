"""The port's multi-recording video loop against the JAX package's.

Reference: ``wtracker_tpu.sim.engine_video.run_video_live_sharded`` with
``mesh=None`` (the batched controller on one device) on the S=4 recordings
of ``tests/test_engine_video.py`` (128 frames of 300x360 each, its (108, 99)
camera, chunks of 6 cycles), YOLOv8 scale "n" at 64 px, float32, the weights
of ``tests/test_torch_engine_video.py``.  Positions must match exactly and
boxes to 1e-3 px; each stream must also match the port's own single-stream
``run_video_live`` (positions exactly, boxes to 1e-4 px), with the detector
batch in one piece and in two sub-batches.
"""

import numpy as np
import pytest
import torch

from tests.synthetic import TIMING_KWARGS
from tests.test_engine_video import _make_recordings
from tests.test_torch_engine_video import LOOP_KW, models  # noqa: F401 (fixture)
from wtracker_tpu.sim import engine as jax_engine
from wtracker_tpu.sim.config import ExperimentConfig as JaxExperimentConfig
from wtracker_tpu.sim.config import TimingConfig as JaxTimingConfig
from wtracker_tpu.sim.engine_live import LiveLoopConfig as JaxLiveLoopConfig
from wtracker_tpu.sim.engine_video import run_video_live_sharded as jax_run_video_live_sharded
from wtracker_tpu_torch.sim import engine
from wtracker_tpu_torch.sim.config import ExperimentConfig, TimingConfig
from wtracker_tpu_torch.sim.engine_live import LiveLoopConfig
from wtracker_tpu_torch.sim.engine_video import run_video_live, run_video_live_sharded

torch.set_num_threads(2)

S, FR, H, W = 4, 128, 300, 360
INIT = (180, 150)
CHUNK = 6


def _params(mod_engine, mod_exp, mod_timing):
    exp = mod_exp("vid", FR, 60, (H, W), 90, INIT)
    return mod_engine.EngineParams.from_timing(mod_timing(experiment_config=exp, **TIMING_KWARGS), (H, W))


def _source(fr):
    # exactly two parameters: a third would be taken for an ``out`` buffer
    return lambda start, count: fr[start : start + count]


def _sources(recs):
    return [_source(fr) for fr in recs]


@pytest.fixture(scope="module")
def recordings():
    return _make_recordings(S, FR)


@pytest.fixture(scope="module")
def jax_logs(recordings, models):
    """The JAX loop in one chunk.  Chunked, it races on the CPU: it hands
    its prefetch buffer to ``jnp.asarray`` (zero-copy on the CPU backend)
    and dispatches the chunk asynchronously, so under load the prefetch of
    the chunk after next can overwrite frames that the running chunk still
    reads.  Chunking does not change the logs; the port's runs below are
    chunked."""
    (jmodel, jvars, jpred), _ = models
    logs = jax_run_video_live_sharded(
        _params(jax_engine, JaxExperimentConfig, JaxTimingConfig), JaxLiveLoopConfig(**LOOP_KW),
        _sources(recordings), FR, jmodel, jvars, jpred, np.tile(INIT, (S, 1)), cycles_per_chunk=FR, mesh=None,
    )
    return np.asarray(logs.positions), np.asarray(logs.worm_bboxes)


@pytest.mark.parametrize("detect_chunks", [1, 2])
def test_streams_match_jax_and_solo_runs(recordings, models, jax_logs, detect_chunks):
    _, (tmodel, tpred) = models
    params = _params(engine, ExperimentConfig, TimingConfig)
    cfg = LiveLoopConfig(**LOOP_KW, detect_chunks=detect_chunks)
    logs = run_video_live_sharded(
        params, cfg, _sources(recordings), FR, tmodel, tpred, np.tile(INIT, (S, 1)),
        cycles_per_chunk=CHUNK, device="cpu",
    )
    pos, boxes = logs.positions.numpy(), logs.worm_bboxes.numpy()
    n_cycles = params.n_logged_cycles(FR)
    assert pos.shape == (n_cycles, S, params.cycle_n, 2) and boxes.shape == (n_cycles, S, params.cycle_n, 4)
    assert pos.dtype == np.int32 and boxes.dtype == np.float64 and np.isfinite(boxes).all()
    np.testing.assert_array_equal(pos, jax_logs[0])
    np.testing.assert_allclose(boxes, jax_logs[1], atol=1e-3)

    for s, source in enumerate(_sources(recordings)):
        solo = run_video_live(params, LiveLoopConfig(**LOOP_KW), source, FR, tmodel, tpred, INIT, cycles_per_chunk=CHUNK, device="cpu")
        np.testing.assert_array_equal(pos[:, s], solo.positions.numpy())
        np.testing.assert_allclose(boxes[:, s], solo.worm_bboxes.numpy(), atol=1e-4)


def test_streams_refuse_a_mesh_and_bad_positions(recordings, models):
    _, (tmodel, tpred) = models
    params = _params(engine, ExperimentConfig, TimingConfig)
    args = (params, LiveLoopConfig(**LOOP_KW), _sources(recordings), FR, tmodel, tpred)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        run_video_live_sharded(*args, np.tile(INIT, (S, 1)), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match=r"init_positions must be \(4, 2\)"):
        run_video_live_sharded(*args, np.tile(INIT, (S - 1, 1)), device="cpu")
