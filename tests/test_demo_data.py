"""Integration regression on the bundled Oxford demo data (the fidelity
gate of SURVEY.md §7.8): the 50-ref + 41-query clouds + GT pickles shipped
with the reference at `evaluate/global_eval/demo_data/`.

Two tiers:
  * pipeline tier (untrained weights, N=1024): load -> fixed-size
    normalize -> forward -> 256-d descriptors -> cross-sequence recall
    curve, all shapes/metrics well-formed.  (The reference checkpoints'
    weight blobs are missing upstream, `models/.MISSING_LARGE_BLOBS`, so
    reference-weight parity is impossible; PARITY.md.)
  * trained tier (`models/demo_stage{2,3}.npz`, the committed 3-stage demo
    curriculum checkpoints from `scripts/train_demo_curriculum.py`):
    asserts concrete floors — cross-sequence recall and partial-overlap
    keypoint repeatability — so a kernel change that silently degrades the
    model FAILS CI.  Floors sit one-noise-step below the checkpoint's
    measured scores (recall@25 86.7%, repeat@512 0.485 on the CPU backend;
    the same protocol as `evaluation_retrieval.py:129-169`).
"""

import glob
import os

import jax
import numpy as np
import pytest

DEMO = "/root/reference/evaluate/global_eval/demo_data"
MODELS = os.path.join(os.path.dirname(__file__), "..", "models")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(DEMO), reason="demo data not available"
)


@pytest.fixture(scope="module")
def demo_sets(tmp_path_factory):
    from dh3d_tpu import config as cfglib
    from dh3d_tpu.data import GlobalTestDataset
    from dh3d_tpu.eval import extract_global, load_sets_from_dir
    from dh3d_tpu.nn import DH3D

    N = 1024  # keep CPU runtime sane; full 8192 is the card's job
    cfg = cfglib.get_config("global_config")
    cfg.num_points = N
    model = DH3D(cfg)
    pts = np.zeros((1, N, 3), np.float32)
    variables = jax.jit(lambda k, p: model.init(k, p, train=False))(
        jax.random.PRNGKey(0), pts)

    out = str(tmp_path_factory.mktemp("desc"))
    for gt in ["global_ref_demo.pickle", "global_query_demo.pickle"]:
        ds = GlobalTestDataset(DEMO, os.path.join(DEMO, gt), numpts=N)
        extract_global(cfg, variables, ds, out, batch_size=4, model=model)

    ref = load_sets_from_dir(os.path.join(DEMO, "global_ref_demo.pickle"), out)
    query = load_sets_from_dir(
        os.path.join(DEMO, "global_query_demo.pickle"), out)
    return ref, query


def test_demo_extraction_counts(demo_sets):
    ref, query = demo_sets
    assert sorted(ref) == sorted(query)
    assert sum(len(s["desc"]) for s in ref.values()) == 100
    assert sum(len(s["desc"]) for s in query.values()) == 41
    for s in ref.values():
        assert s["desc"].shape[1] == 256
        np.testing.assert_allclose(
            np.linalg.norm(s["desc"], axis=1), 1.0, atol=1e-3)


def test_demo_recall_pipeline(demo_sets):
    from dh3d_tpu.eval import average_recalls, evaluate_sequences

    ref, query = demo_sets
    results = evaluate_sequences(ref, query, max_num_nn=25)
    assert len(results) == 2  # 2 seqs x 2 seqs minus the 2 self pairs
    avg, one_percent = average_recalls(results)
    assert avg.shape == (25,)
    assert np.all(np.diff(avg) >= -1e-9)  # recall curve is nondecreasing
    assert 0.0 <= one_percent <= 1.0
    # untrained network should still beat empty retrieval at rank 25
    assert avg[-1] > 0.0


# ---------------------------------------------------------------------------
# Trained tier: concrete regression floors on the committed checkpoints.
# ---------------------------------------------------------------------------

trained = pytest.mark.skipif(
    not os.path.isfile(os.path.join(MODELS, "demo_stage3.npz")),
    reason="committed demo checkpoints not present",
)


def _eval_cfg(cfg):
    """Eval-time overrides shared by every CLI (`evaluate/*_extract.py`)."""
    cfg.sampled_kpnum = -1
    cfg.input_R = False
    cfg.morton_presorted = False  # eval clouds are not host-presorted
    return cfg


@trained
def test_trained_recall_floor(tmp_path):
    """Cross-sequence retrieval with the committed stage-3 weights must hold
    the measured floor (86.7% @25 / 43.3% @1 at commit time; protocol of
    `evaluation_retrieval.py:129-169`, GT = UTM < 25 m)."""
    from dh3d_tpu.data import GlobalTestDataset
    from dh3d_tpu.eval import (
        average_recalls,
        evaluate_sequences,
        extract_global,
        load_sets_from_dir,
    )
    from dh3d_tpu.nn import DH3D
    from dh3d_tpu.train import resolve_model

    cfg, variables = resolve_model(os.path.join(MODELS, "demo_stage3"))
    _eval_cfg(cfg)
    model = DH3D(cfg)
    out = str(tmp_path)
    for gt in ["global_ref_demo.pickle", "global_query_demo.pickle"]:
        ds = GlobalTestDataset(DEMO, os.path.join(DEMO, gt),
                               numpts=cfg.num_points)
        extract_global(cfg, variables, ds, out, batch_size=4, model=model)

    ref = load_sets_from_dir(
        os.path.join(DEMO, "global_ref_demo.pickle"), out)
    query = load_sets_from_dir(
        os.path.join(DEMO, "global_query_demo.pickle"), out)
    avg, _ = average_recalls(evaluate_sequences(ref, query, max_num_nn=25))
    # one query step on this set is 1/30 = 3.3pp; floors allow one step
    assert avg[24] >= 0.83, f"recall@25 regressed: {avg[24]:.3f}"
    assert avg[0] >= 0.35, f"recall@1 regressed: {avg[0]:.3f}"


@trained
def test_trained_repeatability_floor():
    """Partial-overlap keypoint repeatability with the committed stage-2
    detector must hold the floor (0.485 @512 measured at commit time;
    protocol = half-space crops + GT pose, `make_partial_overlap_pairs`)."""
    from dh3d_tpu.data.io import load_single_pcfile
    from dh3d_tpu.eval.extract import make_forward
    from dh3d_tpu.eval.repeatability import (
        make_partial_overlap_pairs,
        repeatability_curve_pairs,
    )
    from dh3d_tpu.nn import DH3D
    from dh3d_tpu.train import resolve_model

    cfg, variables = resolve_model(os.path.join(MODELS, "demo_stage2"))
    assert cfg.detection, "stage-2 checkpoint must carry the detector"
    _eval_cfg(cfg)
    cfg.extract_global = False
    fwd = make_forward(cfg, variables, DH3D(cfg))

    def extract_fn(cloud):
        outs = fwd(np.asarray(cloud, np.float32)[None])
        return (np.asarray(outs["xyz"][0]),
                np.asarray(outs["attention"][0]).reshape(-1))

    files = sorted(glob.glob(os.path.join(DEMO, "*", "*.bin")))[:10]
    rng = np.random.RandomState(0)
    clouds = []
    for f in files:
        pts = load_single_pcfile(f)
        sel = rng.choice(len(pts), 8192, replace=len(pts) < 8192)
        clouds.append(pts[sel].astype(np.float32))
    pairs = make_partial_overlap_pairs(clouds, numpts=8192, seed=1)
    curve = repeatability_curve_pairs(extract_fn, pairs, ks=(512,))
    assert curve[512] >= 0.45, f"repeatability@512 regressed: {curve[512]:.3f}"
