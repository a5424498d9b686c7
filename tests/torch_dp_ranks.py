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


def train_step(hp_json, state_dict, opt_state, step, batch, keep, draws, inv_k,
               eval_draws=None):
    """One train step of the port on this rank's rows of the global `batch`
    with the global batch's dropout masks and vote draws (None: drawn from
    the step's generators), from rank 0's state: the other ranks start from
    other weights and an empty optimizer, and `replicate` must make them
    rank 0's. Then, with `eval_draws`, one eval step. Rank 0 returns its
    logs, state, gradients and eval results; every rank a digest of its
    state."""
    hp = TC.HParams.from_json(hp_json)
    net = PoseRegressorNet(hp.num_classes)
    opt = TT.make_optimizer(hp, net)
    if mesh.rank() == 0:
        net.load_state_dict(state_dict)
        state = TT.TrainState(net, opt_state, step)
    else:
        init_random_(net, 100 + mesh.rank())
        state = TT.create_train_state(net, opt)
    state = mesh.replicate(state)
    pcfg = TC.pipeline_config_from(hp)
    step_fn = TT.make_train_step(net, opt, hp, pcfg, inv_k, "cpu")
    state, logs = step_fn(state, mesh.shard_batch(batch), dropout_keep=keep, draws=draws)
    out = dict(digest=digest(state_tensors(state)), rounds=float(logs.get(
        "pose/vote_rounds", torch.tensor(0.0))))
    if eval_draws is not None:
        from fastposecnn_tpu_torch import metrics as M

        elogs, bank, eout = TT.make_eval_step(net, hp, pcfg, inv_k, "cpu")(
            state, mesh.shard_batch(batch), M.init_pose_metric_bank(), draws=eval_draws)
        agg = eout["aggregated"]
        out["eval"] = dict(logs={k: float(v) for k, v in elogs.items()},
                           bank={k: {f: float(x) for f, x in s.items()}
                                 for k, s in bank.items()},
                           rounds=agg["vote_rounds"],
                           **{k: np_(agg[k]) for k in ("xy", "win_ratio", "valid")})
    if mesh.rank() == 0:
        o = state.opt_state
        out.update(
            logs={k: float(v) for k, v in logs.items()},
            state_dict={k: np_(v) for k, v in state.net.state_dict().items()},
            step=state.step, skipped=state.skipped_updates,
            counts=(o.count, o.lookahead_step, o.hyper_count, o.lr_scale),
            mu={k: np_(v) for k, v in o.mu.items()},
            nu={k: np_(v) for k, v in o.nu.items()},
            slow={k: np_(v) for k, v in o.slow.items()},
            grads={n: None if p.grad is None else np_(p.grad)
                   for n, p in state.net.named_parameters()})
    return out
