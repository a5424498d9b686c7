"""Data parallelism of the port (`fastposecnn_tpu_torch/parallel/mesh.py`)
part by part, over 2 gloo ranks on the CPU (one thread each), against one
process on the concatenated global batch:

- the launcher: ranks, world and backend; a failing rank's traceback
  raised in the caller while its peer waits in a collective; a deadline
  that ends hung ranks; `make_mesh` lays out tensor parallelism and
  refuses a tp that does not divide the ranks;
- global BatchNorm: output, input and parameter gradients (the ranks'
  shares summed), running statistics on every rank;
- every loss of `losses` on a split where rank 0 has no foreground, no
  matched instance and a zero sample weight (a local denominator would
  show): the ranks' shares sum to the global loss, the has-data flags are
  global, the gradients are the global loss's;
- the adaptive RANSAC loop on a batch whose first rank converges in round
  1 and whose second needs many: both ranks run the global rounds, with
  injected pairs and with pairs drawn for the global batch;
- the loaders: the ranks' padded batches concatenate to one process's
  padded batch bit for bit, the short last batch included.

Tolerance: atol 2e-4 / rtol 1e-4 (sums in another order); rounds, vote
outputs and batches exact.
"""

import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from fastposecnn_tpu_torch.data import loader as tloader
from fastposecnn_tpu_torch.data import nocs as tnocs
from fastposecnn_tpu_torch.data import nocs_writer as twriter
from fastposecnn_tpu_torch.data import synthetic as tsyn
from fastposecnn_tpu_torch.parallel import mesh
from torch_cleanup import tmp_path  # noqa: F401  (removed after each test)

ATOL, RTOL = 2e-4, 1e-4
RANKS = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def launch(fn, *args, deadline_s=120.0, **kwargs):
    return mesh.launch(fn, RANKS, args, backend="gloo", threads=1, deadline_s=deadline_s,
                       **kwargs)


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=ATOL, rtol=RTOL, err_msg=what)


def test_launch_runs_ranks_in_one_group(tmp_path):
    assert launch(R.rank_and_world, store_dir=str(tmp_path)) == [(0, 2, "gloo"), (1, 2, "gloo")]
    assert list(tmp_path.iterdir()) == []  # the store's directory is removed


def test_a_failing_rank_ends_every_rank_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed:(.|\n)*fails on purpose"):
        launch(R.fail_on_rank, 1)


def test_a_deadline_ends_hung_ranks():
    with pytest.raises(TimeoutError, match="did not finish within 6"):
        launch(R.wait_forever, deadline_s=6.0)


def test_make_mesh_refuses_tensor_parallelism():
    """`make_mesh` lays out tensor parallelism and refuses what JAX's
    asserts against: dp x tp other than the ranks."""
    assert mesh.make_mesh(2).shape == {"dp": 2, "tp": 1}
    assert mesh.make_mesh(4, tp=2).shape == {"dp": 2, "tp": 2}
    with pytest.raises(ValueError, match="dp=1 x tp=2 is not the 3 ranks"):
        mesh.make_mesh(3, tp=2)
    assert not mesh.active() and mesh.world_size() == 1  # no group in the test process


def test_global_batch_norm_equals_one_batch_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(1.5, 2.0, size=(4, 8, 5, 6)).astype(np.float32)
    w, b = rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    want = R.batch_norm(x, w, b, cot)  # one process, the whole batch
    ranks = launch(R.batch_norm, x, w, b, cot)
    close(np.concatenate([r["y"] for r in ranks]), want["y"], "output")
    close(np.concatenate([r["dx"] for r in ranks]), want["dx"], "input gradient")
    close(sum(r["dw"] for r in ranks), want["dw"], "weight gradient")
    close(sum(r["db"] for r in ranks), want["db"], "bias gradient")
    for r in ranks:
        close(r["running_mean"], want["running_mean"], "running mean")
        close(r["running_var"], want["running_var"], "running var")
        np.testing.assert_array_equal(r["running_var"], ranks[0]["running_var"])


# Instances per sample: rank 0 holds samples 0 and 1, rank 1 samples 2 and 3.
SPLITS = {"rank0_empty": (0, 0, 2, 2), "uneven": (0, 1, 2, 2)}


def uneven_loss_inputs(instances, b=4, g=3, c=3, h=16, w=16, seed=1):
    """`instances[s]` GT instances in sample s (a sample without any has no
    foreground); sample 1 has a zero weight."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    gt = np.zeros((b, h, w), np.int32)
    inst = np.zeros((b, g, h, w), f32)
    valid = np.zeros((b, g), bool)
    for s in range(b):
        for k in range(instances[s]):
            y0, x0 = rng.integers(0, h - 6), rng.integers(0, w - 6)
            inst[s, k, y0:y0 + 5, x0:x0 + 5] = 1.0
            inst[s, k] *= 1.0 - inst[s, :k].sum(0)  # disjoint
            gt[s][inst[s, k] > 0] = k % (c - 1) + 1
            valid[s, k] = True
    quat = rng.normal(size=(b, g, 4)).astype(f32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return dict(
        mask_logits=rng.normal(size=(b, c, h, w)).astype(f32), gt_mask=gt,
        sample_weight=np.array([1, 0, 1, 1], f32),
        field_quaternion=rng.normal(size=(b, 4 * (c - 1), h, w)).astype(f32),
        field_xy=rng.normal(size=(b, 2 * (c - 1), h, w)).astype(f32),
        field_z=rng.normal(size=(b, c - 1, h, w)).astype(f32),
        field_scales=rng.normal(size=(b, 3 * (c - 1), h, w)).astype(f32),
        dense_gt=rng.normal(size=(b, h, w, c - 1)).astype(f32),
        pred_cat=gt,
        m_gt_quaternion=quat, m_pred_quaternion=np.roll(quat, 1, axis=-1),
        m_symmetric_ids=(rng.random((b, g)) < 0.5).astype(np.int32), m_valid=valid,
        m_gt_xy=rng.uniform(0, w, (b, g, 2)).astype(f32),
        m_pred_xy=rng.uniform(0, w, (b, g, 2)).astype(f32),
        m_gt_z=rng.uniform(0.5, 2, (b, g)).astype(f32),
        m_pred_z=rng.uniform(0.5, 2, (b, g)).astype(f32),
        m_gt_scales=rng.uniform(0.1, 1, (b, g, 3)).astype(f32),
        m_pred_scales=rng.uniform(0.1, 1, (b, g, 3)).astype(f32),
        agg_instance_masks=inst, agg_valid=valid,
        agg_symmetric_ids=(rng.random((b, g)) < 0.5).astype(np.int32),
        agg_quaternion=quat, agg_xy=rng.uniform(0, w, (b, g, 2)).astype(f32),
        agg_z=rng.uniform(0.5, 2, (b, g)).astype(f32),
        agg_scales=rng.uniform(0.1, 1, (b, g, 3)).astype(f32))


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_losses_on_an_uneven_split_are_the_global_ones(split):
    inputs = uneven_loss_inputs(SPLITS[split])
    want = R.loss_terms(inputs)
    ranks = launch(R.loss_terms, inputs)
    if split == "rank0_empty":  # its has-data flags are the global ones
        assert all(ranks[0][f"matched_{k}"] == 0.0 for k in ("quaternion", "xy", "z", "scales"))
    for key, value in want.items():
        if key.startswith("grad_"):
            close(np.concatenate([r[key] for r in ranks]), value, key)
        elif key.endswith("_has"):
            assert value == 1.0 and all(r[key] == value for r in ranks), key
        else:
            close(sum(r[key] for r in ranks), value, key)


def vote_slots(m=8, p=96, seed=3):
    """Slots 0-3 (rank 0): every ray through the centre (confident after
    one round). Slots 4-7 (rank 1): 90% random rays (many rounds)."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(20, 40, size=(m, 1, 2))
    pts = np.floor(centre + rng.uniform(-15, 15, size=(m, p, 2))).astype(np.float32)
    d = centre - pts
    rand = np.zeros((m, p), bool)
    rand[4:] = rng.random((4, p)) < 0.9
    d[rand] = rng.normal(size=(int(rand.sum()), 2))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return (pts, dirs, np.full(m, 200.0, np.float32), np.ones(m, bool),
            np.ones((m, p), bool))


@pytest.mark.parametrize("injected", [True, False])
def test_adaptive_loop_runs_the_global_rounds(injected):
    h = 32
    slots = vote_slots()
    m, p = slots[0].shape[:2]
    pairs = (np.random.default_rng(4).integers(0, p, size=(20, m, h, 2))
             if injected else None)
    want = R.adaptive_vote(*slots, h, pairs, 5)
    first_alone = R.adaptive_vote(*(a[:4] for a in slots), h,
                                  None if pairs is None else pairs[:, :4], 5)
    assert first_alone[2] == 1 < want[2] <= 20
    ranks = launch(R.adaptive_vote, *slots, h, pairs, 5)
    assert [r[2] for r in ranks] == [want[2]] * RANKS
    np.testing.assert_array_equal(np.concatenate([r[0] for r in ranks]), want[0])
    np.testing.assert_array_equal(np.concatenate([r[1] for r in ranks]), want[1])


def padded(batch, size, hw, g):
    if batch is None:
        batch = tloader.empty_batch(*hw, g)
    batch, _ = tloader.pad_batch(batch, size)
    return batch


def assert_batches_equal(got, want):
    for key in ("image", "mask", "sample_valid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in want["agg"]:
        np.testing.assert_array_equal(got["agg"][key], want["agg"][key], err_msg=key)


def test_ranks_load_their_rows_of_the_same_batches(tmp_path):
    hw, g, bsz = (64, 64), 4, 4
    twriter.write_synthetic_nocs(tmp_path / "train", 6, 0, tsyn.SceneConfig(
        height=64, width=64, num_classes=3, max_instances=g))
    ds = tnocs.NOCSDataset(tmp_path / "train", dataset_name="CAMERA",
                           selected_classes=("bg", "bottle", "bowl"), max_instances=g,
                           augmentation="train")

    def epoch(shard):
        return list(tloader.PrefetchLoader(ds, bsz, shuffle=True, num_workers=1,
                                           shard=shard))

    whole = [padded(b, bsz, hw, g) for b in epoch((0, 1))]
    parts = [[padded(b, bsz // RANKS, hw, g) for b in epoch((r, RANKS))] for r in range(RANKS)]
    assert len(whole) == 2 and whole[1]["sample_valid"].sum() == 2  # a short last batch
    for i, want in enumerate(whole):
        ranks = [parts[r][i] for r in range(RANKS)]
        got = {k: np.concatenate([b[k] for b in ranks]) for k in ("image", "mask",
                                                                 "sample_valid")}
        got["agg"] = {k: np.concatenate([b["agg"][k] for b in ranks]) for k in want["agg"]}
        assert_batches_equal(got, want)
    # the evaluation order: iterate_batches
    plain = list(tloader.iterate_batches(ds, bsz))
    for r in range(RANKS):
        rows = list(tloader.iterate_batches(ds, bsz, shard=(r, RANKS)))
        np.testing.assert_array_equal(rows[0]["image"], plain[0]["image"][2 * r:2 * r + 2])
    assert list(tloader.iterate_batches(ds, bsz, shard=(1, RANKS)))[1] is None
    with pytest.raises(ValueError, match="does not split over 3"):
        tloader.PrefetchLoader(ds, bsz, shard=(0, 3))
