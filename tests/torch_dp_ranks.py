"""The rank bodies of the port's data-parallel tests (`test_torch_dp_*.py`).

`parallel.mesh.launch` spawns each rank as a fresh process that imports
its function by name, so these live in a module that imports neither JAX
nor the JAX package (the test modules import both, which a rank would pay
for at every start). Every function takes global arrays, runs this rank's
rows, and returns numpy values.
"""

import hashlib

import numpy as np
import torch

from fastposecnn_tpu_torch import config as TC
from fastposecnn_tpu_torch import losses as L
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.resnet import BatchNorm
from fastposecnn_tpu_torch.models.weights import init_random_
from fastposecnn_tpu_torch.ops import voting as V
from fastposecnn_tpu_torch.parallel import mesh
from fastposecnn_tpu_torch.train import task as TT


def np_(t):
    return t.detach().cpu().numpy()


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(np_(t)).tobytes())
    return h.hexdigest()


# -----------------------------------------------------------------------------
# The launcher


def fail_on_rank(bad_rank: int):
    """`bad_rank` raises; the others wait in an all-reduce it never joins."""
    if mesh.rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    mesh.global_sum(torch.ones(1))
    return mesh.rank()


def wait_forever():
    """Every rank sleeps past any deadline."""
    import time

    time.sleep(3600)


def rank_and_world():
    return mesh.rank(), mesh.world_size(), mesh.backend()


# -----------------------------------------------------------------------------
# Parts


def batch_norm(x, weight, bias, cotangent):
    """Global BatchNorm on this rank's rows: (output rows, input-gradient
    rows, weight and bias gradients (this rank's shares), running mean and
    variance)."""
    bn = BatchNorm(x.shape[1], eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    xl = torch.from_numpy(mesh.rank_rows(x).copy()).requires_grad_(True)
    y = bn(xl)
    (y * torch.from_numpy(mesh.rank_rows(cotangent).copy())).sum().backward()
    return dict(y=np_(y), dx=np_(xl.grad), dw=np_(bn.weight.grad), db=np_(bn.bias.grad),
                running_mean=np_(bn.running_mean), running_var=np_(bn.running_var))


def loss_terms(inputs):
    """Each loss of `losses` on this rank's rows of `inputs` (global arrays):
    its value (this rank's share), its has_data flag where it has one, and
    the gradient of the summed values with respect to this rank's logits
    and dense fields."""
    rows = {k: (mesh.rank_rows(v) if isinstance(v, np.ndarray) else v)
            for k, v in inputs.items()}
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in rows.items()
         if isinstance(v, np.ndarray)}
    logits = t["mask_logits"].clone().requires_grad_(True)
    fields = {k: t[f"field_{k}"].clone().requires_grad_(True)
              for k in ("quaternion", "xy", "z", "scales")}
    matched = {k[len("m_"):]: v for k, v in t.items() if k.startswith("m_")}
    matched["valid"] = matched["valid"].bool()
    agg = {k[len("agg_"):]: v for k, v in t.items() if k.startswith("agg_")}
    agg["valid"] = agg["valid"].bool()
    gt = t["gt_mask"]
    sw = t["sample_weight"]
    out = {
        "ce": L.cross_entropy(logits, gt),
        "ce_weighted": L.cross_entropy(logits, gt, sample_weight=sw),
        "focal": L.focal_loss(logits, gt),
        "focal_weighted": L.focal_loss(logits, gt, sample_weight=sw),
    }
    mse, out["mse_has"] = L.masked_mse(fields["z"].permute(0, 2, 3, 1), t["dense_gt"],
                                       t["pred_cat"])
    out["mse"] = mse
    for name in ("quaternion", "xy", "z", "scales"):
        value, has = L.MATCHED_LOSSES[name](matched)
        out[f"matched_{name}"], out[f"matched_{name}_has"] = value, has
    dense, dense_logs = L.dense_supervision(
        dict(fields), gt, agg, {"quaternion": 1.0, "xy": 1.0, "z": 1.0, "scales": 1.0},
        sample_weight=sw)
    out["dense"] = dense
    total = sum(v for k, v in out.items() if not k.endswith("_has"))
    total.backward()
    res = {k: float(v.detach()) for k, v in out.items()}
    res["grad_logits"] = np_(logits.grad)
    res.update({f"grad_{k}": np_(f.grad) for k, f in fields.items()})
    return res


def adaptive_vote(pts, dirs, npts, active, pt_valid, round_hyp_num, pairs, seed):
    """The adaptive RANSAC loop on this rank's slots, with the global
    batch's pairs (`pairs` [R, M, H, 2], sliced here), or, when None,
    drawn from a generator of `seed` for the global batch. Returns
    (centers, win ratio, rounds)."""
    r = mesh.rank_rows
    gen = torch.Generator().manual_seed(seed)
    centers, ratio, _, rounds = V.ransac_vote_centers_adaptive(
        *(torch.from_numpy(r(a).copy()) for a in (pts, dirs, npts, active, pt_valid)),
        round_hyp_num, max_iter=20,
        pairs=None if pairs is None else torch.from_numpy(r(pairs, 1).copy()),
        generator=gen)
    return np_(centers), np_(ratio), rounds


# -----------------------------------------------------------------------------
# The train and eval steps


def state_tensors(state):
    """The network's parameters and buffers and the optimizer's tensors, by
    name (the ranks' optimizer dicts may hold them in other orders)."""
    o = state.opt_state
    return ([*state.net.state_dict().values()]
            + [d[k] for d in (o.mu, o.nu, o.slow) for k in sorted(d)])


def shard_report(state):
    """Each tensor of this rank's state by name: (its shape, whether it is
    a tp shard, a digest of its bytes); the optimizer's as 'mu/<name>' and
    so on."""
    from fastposecnn_tpu_torch.parallel.tp import sharded_names

    sharded = sharded_names(state.net)
    o = state.opt_state
    tensors = {**state.net.state_dict(),
               **{f"{part}/{k}": v for part in ("mu", "nu", "slow")
                  for k, v in getattr(o, part).items()}}
    return {k: (tuple(v.shape), k.split("/")[-1] in sharded, digest([v]))
            for k, v in tensors.items()}


def train_step(hp_json, state_dict, opt_state, step, batch, keep, draws, inv_k,
               eval_draws=None, min_channels=128):
    """One train step of the port on this rank's rows of the global `batch`
    with the global batch's dropout masks and vote draws (None: drawn from
    the step's generators), from rank 0's state: the other ranks start from
    other weights and an empty optimizer, and `shard_state_tp` (over the
    group's layout, with `min_channels`; `replicate` when tp = 1) must make
    them rank 0's. Then, with `eval_draws`, one eval step. Rank 0 returns
    its logs, state, gradients and eval results (the state and gradients
    gathered over its tp group); every rank a digest of its own state and
    of the gathered one, and, with tp > 1, `shard_report` of its state
    before the step."""
    from fastposecnn_tpu_torch.parallel import tp

    hp = TC.HParams.from_json(hp_json)
    net = PoseRegressorNet(hp.num_classes)
    opt = TT.make_optimizer(hp, net)
    if mesh.rank() == 0:
        net.load_state_dict(state_dict)
        state = TT.TrainState(net, opt_state, step)
    else:
        init_random_(net, 100 + mesh.rank())
        state = TT.create_train_state(net, opt)
    state = mesh.shard_state_tp(state, mesh.layout(), min_channels)
    report = shard_report(state) if mesh.tp_size() > 1 else None
    pcfg = TC.pipeline_config_from(hp)
    step_fn = TT.make_train_step(state.net, opt, hp, pcfg, inv_k, "cpu")
    state, logs = step_fn(state, mesh.shard_batch(batch), dropout_keep=keep, draws=draws)
    grads = {n: None if p.grad is None else (tp.gather(p.grad) if tp.is_sharded(p) else p.grad)
             for n, p in state.net.named_parameters()}
    whole = mesh.gather_state_tp(state)
    out = dict(digest=digest(state_tensors(state)), whole_digest=digest(state_tensors(whole)),
               rounds=float(logs.get("pose/vote_rounds", torch.tensor(0.0))),
               coords=(mesh.dp_rank(), mesh.tp_rank()), shards=report)
    if eval_draws is not None:
        from fastposecnn_tpu_torch import metrics as M

        elogs, bank, eout = TT.make_eval_step(state.net, hp, pcfg, inv_k, "cpu")(
            state, mesh.shard_batch(batch), M.init_pose_metric_bank(), draws=eval_draws)
        agg = eout["aggregated"]
        out["eval"] = dict(logs={k: float(v) for k, v in elogs.items()},
                           bank={k: {f: float(x) for f, x in s.items()}
                                 for k, s in bank.items()},
                           rounds=agg["vote_rounds"],
                           **{k: np_(agg[k]) for k in ("xy", "win_ratio", "valid")})
    out["logs"] = {k: float(v) for k, v in logs.items()}
    if mesh.rank() == 0:
        o = whole.opt_state
        out.update(
            state_dict={k: np_(v) for k, v in whole.net.state_dict().items()},
            step=whole.step, skipped=whole.skipped_updates,
            counts=(o.count, o.lookahead_step, o.hyper_count, o.lr_scale),
            mu={k: np_(v) for k, v in o.mu.items()},
            nu={k: np_(v) for k, v in o.nu.items()},
            slow={k: np_(v) for k, v in o.slow.items()},
            grads={n: None if g is None else np_(g) for n, g in grads.items()})
    return out


# -----------------------------------------------------------------------------
# Tensor parallelism


def tp_conv(conv, device="cpu"):
    """A `TPConv2d` over this rank's tp group of the convolution `conv`
    (weight, bias, input, output cotangent, stride, padding as numpy) on
    the whole input on `device`: its output, input gradient, gathered
    weight gradient and bias gradient, and its weight's shape. On a card,
    in float32 with TF32 off (`device.full_float32()`)."""
    import contextlib

    from fastposecnn_tpu_torch.device import full_float32
    from fastposecnn_tpu_torch.parallel import tp

    dev = mesh.use_rank_device(device)
    weight, bias, x, cot, stride, padding = conv
    full = torch.nn.Conv2d(weight.shape[1], weight.shape[0], weight.shape[2:],
                           stride=stride, padding=padding, bias=bias is not None)
    with torch.no_grad():
        full.weight.copy_(torch.from_numpy(weight))
        if bias is not None:
            full.bias.copy_(torch.from_numpy(bias))
    m = tp.TPConv2d(full.to(dev), mesh.tp_size(), mesh.tp_rank())
    xt = torch.from_numpy(x).to(dev).requires_grad_(True)
    with full_float32() if dev.type == "cuda" else contextlib.nullcontext():
        y = m(xt)
        (y * torch.from_numpy(cot).to(dev)).sum().backward()
    return dict(y=np_(y), dx=np_(xt.grad), dw=np_(tp.gather(m.weight.grad)),
                local=tuple(m.weight.shape), db=None if bias is None else np_(m.bias.grad),
                device=str(y.device))


def tp_parts(conv, ckpt_dir=None, hp_json=None):
    """Over a (dp 1, tp 2) layout: (1) `tp_conv` of `conv` on the CPU;
    (2) the full checkpoint `ckpt_dir/one`
    loaded on rank 0 and `shard_state_tp`'d: its global gradient norm of
    the sharded parameters, and its checkpoint written by the train loop
    (rank 0, gathered over the tp group) to `ckpt_dir/tp`; (3) that
    checkpoint resumed as the loop resumes (loaded on rank 0 into other
    weights, `shard_state_tp`): whether every tensor, count and step
    equals the first state's. Without `ckpt_dir`, (1) alone."""
    from pathlib import Path

    from fastposecnn_tpu_torch.parallel import tp
    from fastposecnn_tpu_torch.train import checkpoint as ckpt
    from fastposecnn_tpu_torch.train import loop
    from fastposecnn_tpu_torch.train import optim as TO

    out = dict(coords=(mesh.dp_rank(), mesh.tp_rank()), conv=tp_conv(conv))
    if ckpt_dir is None:
        return out

    hp = TC.HParams.from_json(hp_json)
    layout, lead = mesh.layout(), mesh.rank() == 0

    def loaded(path, seed):
        net = init_random_(PoseRegressorNet(hp.num_classes), seed)
        opt = TT.make_optimizer(hp, net)
        state = TT.create_train_state(net, opt)
        if lead:
            state, _ = ckpt.load_any_checkpoint(path, state, hp, optimizer=opt)
        return mesh.shard_state_tp(state, layout)

    state = loaded(Path(ckpt_dir) / "one", 200 + mesh.rank())
    params = [p.detach() for p in state.net.parameters()]
    out["norm"] = float(TO.global_norm(params, [tp.is_sharded(p) for p in
                                                state.net.parameters()]))
    out["sharded"] = len(tp.sharded_names(state.net))
    loop._save(Path(ckpt_dir) / "tp", state, hp, lead)
    resumed = loaded(Path(ckpt_dir) / "tp", 300 + mesh.rank())
    same = [torch.equal(a, b) for a, b in zip(state_tensors(resumed), state_tensors(state),
                                                strict=True)]
    o, r = state.opt_state, resumed.opt_state
    out["resumed_equal"] = (all(same) and len(same) > 0
                            and (o.count, o.lookahead_step, o.hyper_count, o.lr_scale,
                                 state.step) ==
                            (r.count, r.lookahead_step, r.hyper_count, r.lr_scale,
                             resumed.step))
    return out


def multihost(global_batch):
    """`shard_batch_multihost` of this rank's rows as it supplies them, then
    of a local batch one row short on rank 1 (the error, on every rank)."""
    local = mesh.shard_batch(global_batch)
    got = mesh.shard_batch_multihost(local)
    short = {k: v[:1] if mesh.rank() == 1 else v for k, v in local.items()}
    try:
        mesh.shard_batch_multihost(short)
        error = None
    except ValueError as e:
        error = str(e)
    return got, error


def float32_flags():
    """(cuDNN TF32, matmul TF32, cuDNN benchmark, cuDNN deterministic) on this
    rank before `device.full_float32()`, inside it and after it."""
    from fastposecnn_tpu_torch.device import full_float32

    def flags():
        b = torch.backends
        return (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark,
                b.cudnn.deterministic)

    before = flags()
    with full_float32():
        inside = flags()
    return before, inside, flags()


def tp_conv_bf16(conv):
    """`tp_conv` with the convolution in bf16 (`models.conv.Conv2d`), on the
    CPU: the output (bf16, as float32), the gradients, and the output's
    dtype."""
    from fastposecnn_tpu_torch.models.conv import Conv2d
    from fastposecnn_tpu_torch.parallel import tp

    weight, bias, x, cot, stride, padding = conv
    full = Conv2d(weight.shape[1], weight.shape[0], weight.shape[2:], stride=stride,
                  padding=padding, bias=bias is not None, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        full.weight.copy_(torch.from_numpy(weight))
        if bias is not None:
            full.bias.copy_(torch.from_numpy(bias))
    m = tp.TPConv2d(full, mesh.tp_size(), mesh.tp_rank())
    xt = torch.from_numpy(x).requires_grad_(True)
    y = m(xt)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    return dict(coords=(mesh.dp_rank(), mesh.tp_rank()), y=np_(y.float()), dx=np_(xt.grad),
                dw=np_(tp.gather(m.weight.grad)), db=None if bias is None else np_(m.bias.grad),
                local=tuple(m.weight.shape), dtype=str(y.dtype))
