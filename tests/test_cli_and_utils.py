"""CLI end-to-end on a rendered image directory + aux utils (checkpoint,
metrics, viz)."""

import json
import os

import numpy as np
import pytest

from sfm_mvs_tpu.utils.synthetic import render_staircase_sequence


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    imgs, Rt, K = render_staircase_sequence(
        num_cameras=4, arc_degrees=18, image_size=(320, 240)
    )
    for i, g in enumerate(imgs):
        Image.fromarray((g * 255).astype(np.uint8)).save(d / f"img_{i:03d}.png")
    return str(d), Rt, K


@pytest.mark.slow
def test_cli_end_to_end(tmp_path, image_dir, monkeypatch):
    d, Rt, K = image_dir
    from sfm_mvs_tpu import cli
    from sfm_mvs_tpu.utils import cache

    monkeypatch.setattr(cache, "enable", lambda: None)  # tests keep it off

    out = str(tmp_path / "out")
    rc = cli.main(
        [
            "--image-dir", d, "--out", out,
            "--fx", str(K[0, 0]), "--fy", str(K[1, 1]),
            "--cx", str(K[0, 2]), "--cy", str(K[1, 2]),
            "--downscale", "1", "--max-features", "1024",
            "--contrast-threshold", "0.015", "--lowe-ratio", "0.75",
            "--max-cameras", "8", "--max-points", "16384",
            "--ba", "--ba-cadence", "2", "--ba-iterations", "5",
            "--checkpoint-every", "2",
        ]
    )
    assert rc == 0
    assert os.path.exists(f"{out}/sparse.ply")
    assert os.path.exists(f"{out}/pose.csv")
    assert os.path.exists(f"{out}/cameras.ply")
    assert os.path.exists(f"{out}/reproj_error.png")
    assert os.path.exists(f"{out}/metrics.jsonl")
    recs = [json.loads(l) for l in open(f"{out}/metrics.jsonl")]
    assert any(r["event"] == "frame" for r in recs)
    assert any(r["event"] == "ba" for r in recs)
    vals = np.loadtxt(f"{out}/pose.csv")
    assert len(vals) == 9 + 4 * 12
    # checkpoints were written
    assert os.listdir(f"{out}/checkpoints")


def test_cli_stops_before_reconstruction_without_decoder(
    tmp_path, image_dir, monkeypatch, capsys
):
    """No native decoder and no PIL: exit 2 with the build error, before
    any reconstruction work."""
    from sfm_mvs_tpu import cli, native
    from sfm_mvs_tpu.models import incremental

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "build_error", lambda: "make failed (rc 2): no g++")
    monkeypatch.setattr(cli, "_importable", lambda *m: False)
    monkeypatch.setattr(incremental, "IncrementalSfM", None)  # must not be used
    rc = cli.main(["--image-dir", image_dir[0], "--out", str(tmp_path / "o")])
    assert rc == 2
    err = capsys.readouterr().err
    assert "make failed (rc 2): no g++" in err and "PIL" in err
    assert not (tmp_path / "o").exists()


def test_checkpoint_roundtrip(tmp_path, image_dir):
    d, Rt, K = image_dir
    import jax.numpy as jnp

    from sfm_mvs_tpu.models import map_store
    from sfm_mvs_tpu.models.incremental import PipelineState
    from sfm_mvs_tpu.ops.sift import Features
    from sfm_mvs_tpu.utils import checkpoint as ckpt
    from sfm_mvs_tpu.utils.config import MapConfig

    state = map_store.init_map(jnp.asarray(K), MapConfig(max_cameras=4, max_points=64))
    state, _ = map_store.append_camera(state, jnp.ones((3, 4)))
    feats = Features(
        xy=jnp.ones((8, 2)), scale=jnp.ones(8), angle=jnp.zeros(8),
        response=jnp.ones(8), desc=jnp.ones((8, 128)), valid=jnp.ones(8, bool),
    )
    p = PipelineState(map=state, prev_feats=feats, prev_track=jnp.full((8,), 3))
    path = str(tmp_path / "ck" / "frame_00005.npz")
    ckpt.save_pipeline(path, p, 5)
    p2, frame = ckpt.load_pipeline(path)
    assert frame == 5
    np.testing.assert_allclose(np.asarray(p2.map.poses), np.asarray(p.map.poses))
    np.testing.assert_allclose(np.asarray(p2.prev_track), 3)
    assert ckpt.latest_checkpoint(str(tmp_path / "ck")) == path


def test_metrics_logger(tmp_path):
    from sfm_mvs_tpu.utils.metrics import MetricsLogger

    log = MetricsLogger(str(tmp_path / "m.jsonl"))
    log.log(event="frame", frame=1, reproj_error=0.5, wall_s=0.1)
    log.log(event="frame", frame=2, reproj_error=0.7, wall_s=0.3)
    log.log(event="ba", frame=2, final_cost=0.01)
    s = log.summary()
    assert s["frames"] == 2
    assert abs(s["mean_reproj_error"] - 0.6) < 1e-9
    lines = open(tmp_path / "m.jsonl").read().splitlines()
    assert len(lines) == 3


def test_viz_artifacts(tmp_path):
    from sfm_mvs_tpu.utils import viz

    img = np.zeros((40, 60), dtype=np.float32)
    out = viz.draw_points(img, [(10, 20), (59, 39)])
    assert out.shape == (40, 60, 3)
    assert (out[20, 10] == [255, 40, 40]).all()
    poses = [np.hstack([np.eye(3), np.zeros((3, 1))])]
    viz.save_camera_frusta_ply(str(tmp_path / "c.ply"), poses)
    txt = open(tmp_path / "c.ply").read()
    assert "element vertex 5" in txt and "element edge 8" in txt
    viz.save_error_plot(str(tmp_path / "e.png"), [0.5, 0.4, 0.3])
    assert os.path.exists(tmp_path / "e.png")
