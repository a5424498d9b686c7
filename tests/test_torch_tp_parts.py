"""Tensor parallelism of the port (`fastposecnn_tpu_torch/parallel/tp.py`,
`mesh.shard_state_tp`, `gather_state_tp`) and the multi-host helpers of
`parallel/mesh.py`, part by part, on gloo ranks on the CPU (one thread
each), against one process and against the JAX package's layouts:

- a `TPConv2d` at tp 2 over two ranks (a 3x3 convolution with stride 2
  and no bias, and a 1x1 one with a bias, as the encoder's and the FPN's
  laterals): its output, input gradient (all-reduced over the tp group),
  gathered weight gradient and bias gradient against `nn.Conv2d` in one
  process (atol 1e-5, rtol 1e-5);
- over (dp 1, tp 2), from a full checkpoint of the network with random
  weights and moments: the global gradient norm of the sharded
  parameters against one process's (rtol 1e-6); the train loop's
  checkpoint (gathered on rank 0) bit-equal to the file one process
  writes of the same state; a resume from it (loaded on rank 0 and
  sharded) bit-equal to the state it was written from;
- `make_mesh` and `make_multislice_mesh`: shapes, errors, and the
  rank-to-coordinate map of JAX's `devices.reshape` (the counterparts of
  `tests/test_train.py:313-317`);
- `shard_batch_multihost` over two ranks: the ranks' local rows in rank
  order are the global batch, a short rank raises on every rank; in one
  process it equals `shard_batch` (`tests/test_train.py:295-311`);
- `dryrun_multichip(4)` runs over (dp 2, tp 2) and reports its
  tp-sharded tensors;
- `device.full_float32()` takes cuDNN's deterministic heuristics in a tp
  group and its timed algorithms over dp ranks alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from fastposecnn_tpu_torch import config as TC
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.weights import init_random_
from fastposecnn_tpu_torch.device import body_deterministic, tp_flags
from fastposecnn_tpu_torch.parallel import dryrun, mesh
from fastposecnn_tpu_torch.train import checkpoint as ckpt
from fastposecnn_tpu_torch.train import optim as TO
from fastposecnn_tpu_torch.train import task as TT

CONV_TOL = dict(atol=1e-5, rtol=1e-5)
# (weight shape, bias, stride, padding, input shape)
CONVS = {"3x3_stride2": ((8, 6, 3, 3), False, 2, 1, (2, 6, 9, 10)),
         "1x1_bias": ((16, 4, 1, 1), True, 1, 0, (2, 4, 5, 7))}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def conv_inputs(name):
    shape, bias, stride, padding, x_shape = CONVS[name]
    rng = np.random.default_rng(len(name))
    f = np.float32
    weight = rng.normal(size=shape).astype(f)
    b = rng.normal(size=shape[0]).astype(f) if bias else None
    x = rng.normal(size=x_shape).astype(f)
    y_shape = torch.nn.functional.conv2d(torch.from_numpy(x), torch.from_numpy(weight),
                                         stride=stride, padding=padding).shape
    cot = rng.normal(size=tuple(y_shape)).astype(f)
    return weight, b, x, cot, stride, padding


def one_process_conv(weight, bias, x, cot, stride, padding):
    w = torch.from_numpy(weight).requires_grad_(True)
    b = None if bias is None else torch.from_numpy(bias).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = torch.nn.functional.conv2d(xt, w, b, stride=stride, padding=padding)
    (y * torch.from_numpy(cot)).sum().backward()
    return dict(y=y.detach().numpy(), dx=xt.grad.numpy(), dw=w.grad.numpy(),
                db=None if b is None else b.grad.numpy())


def random_state(hp):
    """A train state of the network with random weights and moments, at a
    step and counts other than the start's."""
    net = init_random_(PoseRegressorNet(hp.num_classes), 5)
    opt = TT.make_optimizer(hp, net)
    state = TT.create_train_state(net, opt)
    gen = torch.Generator().manual_seed(6)
    o = state.opt_state
    noise = {part: {k: torch.randn(v.shape, generator=gen) * scale + base
                    for k, v in getattr(o, part).items()}
             for part, scale, base in (("mu", 1e-3, 0.0), ("nu", 1e-6, 1e-6),
                                       ("slow", 1e-2, 0.0))}
    noise["slow"] = {k: v + o.slow[k] for k, v in noise["slow"].items()}
    opt_state = dataclasses.replace(o, **noise, count=7, lookahead_step=7, hyper_count=7,
                                    lr_scale=0.25)
    return dataclasses.replace(state, opt_state=opt_state, step=7, skipped_updates=1)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """One launch over (dp 1, tp 2) for the convolutions and the state."""
    import shutil

    root = tmp_path_factory.mktemp("tp_parts")
    hp = TC.head_training(SELECTED_CLASSES=("bg", "bottle", "bowl"))
    state = random_state(hp)
    ckpt.save_checkpoint(root / "one", state.step, state, hp)
    want_norm = float(TO.global_norm([p.detach() for p in state.net.parameters()]))
    del state
    layout = mesh.make_mesh(2, tp=2)
    try:
        convs = {}
        for i, name in enumerate(sorted(CONVS)):  # the state parts with the first
            inputs = conv_inputs(name)
            args = (inputs, str(root), hp.to_json()) if i == 0 else (inputs,)
            convs[name] = (inputs, mesh.launch(R.tp_parts, 2, args, backend="gloo",
                                               threads=1, deadline_s=300.0, layout=layout))
        files = {d: next((root / d).glob("step_*.pt")) for d in ("one", "tp")}
        payloads = {d: torch.load(f, weights_only=False) for d, f in files.items()}
        shutil.rmtree(root)
        yield dict(convs=convs, ranks=convs[sorted(CONVS)[0]][1], payloads=payloads,
                   want_norm=want_norm, names=[f.name for f in files.values()])
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("name", sorted(CONVS))
def test_tp_conv_matches_one_process_conv(tp_run, name):
    inputs, ranks = tp_run["convs"][name]
    want = one_process_conv(*inputs)
    cout = inputs[0].shape[0]
    for r in ranks:
        got = r["conv"]
        assert got["local"] == (cout // 2, *inputs[0].shape[1:])
        for key in ("y", "dx", "dw", "db"):
            if want[key] is None:
                assert got[key] is None
                continue
            np.testing.assert_allclose(got[key], want[key], err_msg=f"rank {r['coords']} {key}",
                                       **CONV_TOL)


def test_tp_global_norm_of_a_sharded_state(tp_run):
    for r in tp_run["ranks"]:
        assert r["sharded"] == 59  # min_channels 128: layer2-4 and the FPN's
        np.testing.assert_allclose(r["norm"], tp_run["want_norm"], rtol=1e-6)


def test_tp_checkpoint_is_the_one_process_file_and_resumes(tp_run):
    one, two = tp_run["payloads"]["one"], tp_run["payloads"]["tp"]
    assert tp_run["names"][0] == tp_run["names"][1] == "step_00000007.pt"
    assert set(one) == set(two)
    for key in ("format", "step", "skipped_updates", "hparams_json"):
        assert one[key] == two[key], key
    assert one["state_dict"].keys() == two["state_dict"].keys()
    for name, value in one["state_dict"].items():
        assert torch.equal(two["state_dict"][name], value), name
    for part, value in one["opt_state"].items():
        if isinstance(value, dict):
            assert value.keys() == two["opt_state"][part].keys()
            for name, t in value.items():
                assert torch.equal(two["opt_state"][part][name], t), f"{part} {name}"
        else:
            assert two["opt_state"][part] == value, part
    assert all(r["resumed_equal"] for r in tp_run["ranks"])


def test_meshes_lay_ranks_out_as_jax_does():
    import jax

    from fastposecnn_tpu.parallel import make_mesh, make_multislice_mesh

    assert mesh.make_mesh(4, tp=2).shape == {"dp": 2, "tp": 2}
    multi = mesh.make_multislice_mesh(2, 4, tp=2)
    assert multi.shape == {"slice": 2, "dp": 2, "tp": 2} == dict(
        make_multislice_mesh(2, 4, tp=2).shape)
    assert (multi.size, multi.data_ranks) == (8, 4)
    for port, jax_mesh in ((multi, make_multislice_mesh(2, 4, tp=2)),
                           (mesh.make_mesh(4, tp=2), make_mesh(4, tp=2)),
                           (mesh.make_mesh(8, tp=4), make_mesh(8, tp=4))):
        ids = np.vectorize(lambda d: d.id)(jax_mesh.devices)
        for coords, r in np.ndenumerate(ids):
            assert port.coords(int(r)) == coords
        # the batch splits over the data axes: a tp group shares its rows
        for group in port.tp_groups():
            assert len({port.coords(r)[:-1] for r in group}) == 1
        for group in port.dp_groups():
            assert [port.coords(r)[:-1] for r in group] == sorted(
                {c[:-1] for c in np.ndindex(*ids.shape)})
    assert len(jax.devices()) >= 8
    for bad in (lambda: mesh.make_mesh(3, tp=2), lambda: mesh.make_mesh(4, tp=3),
                lambda: mesh.make_mesh(2, tp=0), lambda: mesh.make_multislice_mesh(2, 3, tp=2)):
        with pytest.raises(ValueError):
            bad()


def test_shard_batch_multihost_assembles_the_global_batch():
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(6, 4)).astype(np.float32),
             "y": np.arange(6, dtype=np.int64)}
    for key, value in mesh.shard_batch_multihost(batch).items():  # one process
        np.testing.assert_array_equal(value, mesh.shard_batch(batch)[key])
    ranks = mesh.launch(R.multihost, 2, (batch,), backend="gloo", threads=1, deadline_s=60.0)
    for key in batch:
        np.testing.assert_array_equal(np.concatenate([got[key] for got, _ in ranks]),
                                      batch[key])
    assert all("other sizes: [[3, 3], [1, 1]]" in error for _, error in ranks)


@pytest.mark.parametrize("tp", [1, 2])
def test_full_float32_in_a_tp_group_takes_deterministic_heuristics(tp):
    # The ranks of a tp group compute the replicated parts of the network
    # alike only if cuDNN gives them the same algorithms: its heuristics'
    # deterministic ones, not each rank's own timing. Data-parallel ranks
    # keep the timed algorithms (their all-reduced updates are equal anyway).
    ranks = mesh.launch(R.float32_flags, 2, (), backend="gloo", threads=1, deadline_s=60.0,
                        layout=mesh.make_mesh(2, tp=tp))
    for before, inside, after in ranks:
        timed = (True, body_deterministic(before[0], before[3]))
        assert inside == (False, False, *(tp_flags() if tp == 2 else timed))
        assert tp_flags() == (False, True) and after == before


def test_dryrun_multichip_over_dp_and_tp(capsys):
    dryrun.dryrun_multichip(4)
    assert ("dryrun_multichip(4): ok" in (out := capsys.readouterr().out)
            and "mesh={'dp': 2, 'tp': 2}, 59 tp-sharded param tensors" in out)
