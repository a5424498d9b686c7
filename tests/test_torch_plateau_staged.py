"""Port parity for the staged plateau defaults (`fastposecnn_tpu_torch/
config.py::staged_plateau_defaults`, `STAGED_PLATEAU_*`) through the port's
`train/optim.py::plateau_update`: the five cases of
`tests/test_plateau_staged.py`, each replaying the recorded demo traces
(`evidence/rot_demo/DEMO_S{1,2}.csv`) or a flat trace, with the port's
lr_scale trajectory equal to the JAX one at every epoch. Tolerance: exact.
"""

import csv
import dataclasses
import pathlib

import jax.numpy as jnp
import pytest

from fastposecnn_tpu import config as JC
from fastposecnn_tpu.train import optim as joptim
from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch.train import optim

EVIDENCE = pathlib.Path(__file__).resolve().parents[1] / "evidence/rot_demo"


def _val_loss_trace(name):
    path = EVIDENCE / f"{name}.csv"
    if not path.exists():
        pytest.skip(f"recorded trace {path} not committed")
    with open(path) as f:
        return [float(r["val_loss"]) for r in csv.DictReader(f)]


def _replay(trace, patience, factor, min_scale=1e-4):
    """The port's lr_scale after each epoch, held equal to the JAX one."""
    state, jstate = optim.plateau_init(), joptim.plateau_init()
    scales = []
    for v in trace:
        state = optim.plateau_update(state, v, patience=patience, factor=factor,
                                     min_scale=min_scale)
        jstate = joptim.plateau_update(jstate, jnp.asarray(v), patience=patience,
                                       factor=factor, min_scale=min_scale)
        assert state.scale == float(jstate.scale), (len(scales), state, jstate)
        assert state.bad_epochs == int(jstate.bad_epochs)
        scales.append(state.scale)
    return scales


def test_constants_match_the_jax_package():
    assert (C.STAGED_PLATEAU_PATIENCE, C.STAGED_PLATEAU_FACTOR) == (
        JC.STAGED_PLATEAU_PATIENCE, JC.STAGED_PLATEAU_FACTOR) == (50, 0.5)


@pytest.mark.parametrize("name", ["DEMO_S1", "DEMO_S2"])
def test_staged_defaults_survive_recorded_noise(name):
    """lr_scale stays at 1.0 through both recorded runs (both were still
    improving at their last epoch)."""
    scales = _replay(_val_loss_trace(name), C.STAGED_PLATEAU_PATIENCE,
                     C.STAGED_PLATEAU_FACTOR)
    assert scales[-1] == pytest.approx(1.0)


def test_reference_defaults_collapse_on_staged_trace():
    """The reference's patience 2 / factor 0.25 reach the 1e-4 floor before
    epoch 100 of the recorded stage-2 trace: why the staged defaults exist."""
    hp = C.HParams()
    scales = _replay(_val_loss_trace("DEMO_S2"), hp.PLATEAU_PATIENCE, hp.PLATEAU_FACTOR)
    floor_epoch = next(i for i, s in enumerate(scales)
                       if s <= hp.PLATEAU_MIN_SCALE + 1e-12)
    assert floor_epoch < 100


def test_staged_defaults_eventually_decay_on_true_plateau():
    trace = [1.0] + [1.0] * (C.STAGED_PLATEAU_PATIENCE + 2)
    scales = _replay(trace, C.STAGED_PLATEAU_PATIENCE, C.STAGED_PLATEAU_FACTOR)
    assert scales[-1] == pytest.approx(C.STAGED_PLATEAU_FACTOR)


@pytest.mark.parametrize("patience_explicit", [False, True])
@pytest.mark.parametrize("factor_explicit", [False, True])
def test_cli_default_swap_respects_explicit_flags(patience_explicit, factor_explicit):
    hp = C.HParams(PLATEAU_PATIENCE=7, PLATEAU_FACTOR=0.3)
    got = C.staged_plateau_defaults(hp, patience_explicit=patience_explicit,
                                    factor_explicit=factor_explicit)
    want = JC.staged_plateau_defaults(
        dataclasses.replace(JC.HParams(), PLATEAU_PATIENCE=7, PLATEAU_FACTOR=0.3),
        patience_explicit=patience_explicit, factor_explicit=factor_explicit)
    assert (got.PLATEAU_PATIENCE, got.PLATEAU_FACTOR) == (want.PLATEAU_PATIENCE,
                                                          want.PLATEAU_FACTOR)
    assert got.PLATEAU_PATIENCE == (7 if patience_explicit else C.STAGED_PLATEAU_PATIENCE)
    assert got.PLATEAU_FACTOR == (0.3 if factor_explicit else C.STAGED_PLATEAU_FACTOR)
