"""Spans, counters and captures that the benchmark's own files wrap around
the port's calls, and the faults a check must catch.

`capture_pipeline(module, sink, key, spans)` wraps the `run_pipeline`
that `module` calls (the server's or the train step's) so that every call
leaves its output, the post-network stages' logits, categorical data and
aggregated payload, in `sink[key()]`, and times it as the span
"post_network" when `spans` is given. `kernel_bounds(record)` wraps the
calls of K1 (connected components) and K2 (inlier counts) to add up the
least time of each call on its own inputs. `time_vote(spans)` times the
voting stage as the span "vote".

Faults (`--fault`), each planted where the answer is produced:
  count           K2's best count of every slot raised by one;
  state_unchanged the optimizer's update left unapplied;
  half_batch      the step fed the first half of its batch (the loss's
                  mean then taken over the rest).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

import counts
from harness import Spans, TraceRecord, patched


@contextlib.contextmanager
def capture_pipeline(module, sink: Dict, key: Callable[[], object],
                     spans: Optional[Spans] = None):
    def wrap(original):
        def run_pipeline(*args, **kwargs):
            began = spans.start() if spans is not None else None
            out = original(*args, **kwargs)
            if spans is not None:
                spans.stop("post_network", began)
            sink[key()] = out
            return out
        return run_pipeline

    with patched(module, "run_pipeline", wrap):
        yield


@contextlib.contextmanager
def time_network(net: torch.nn.Module, spans: Spans):
    began = []
    pre = net.register_forward_pre_hook(lambda *_: began.append(spans.start()))
    post = net.register_forward_hook(lambda *_: spans.stop("network", began.pop()))
    try:
        yield
    finally:
        pre.remove()
        post.remove()


@contextlib.contextmanager
def time_vote(spans: Spans):
    from fastposecnn_tpu_torch import pipeline

    def wrap(original):
        def stage_hough_voting(*args, **kwargs):
            with spans.span("vote"):
                return original(*args, **kwargs)
        return stage_hough_voting

    with patched(pipeline, "stage_hough_voting", wrap):
        yield


@contextlib.contextmanager
def kernel_bounds(record: TraceRecord):
    """Adds K1's and K2's least times (seconds) of every call in the block
    to `record.k1_bound_s` and `record.k2_bound_s`, from the shapes and
    the inputs of each call. K2's inputs are only held in the block; their
    valid cells are counted after it, so the count adds no device work to a
    profiled window inside it."""
    from fastposecnn_tpu_torch.ops import aggregation, voting

    cells = []

    def wrap_k1(original):
        def label_components_deferred(fg, *args, **kwargs):
            record.k1_bound_s += counts.k1_bound_s(fg.numel())
            return original(fg, *args, **kwargs)
        return label_components_deferred

    def wrap_k2(original):
        def vote_counts(hyps, pts, dirs, pvalid, inlier_thresh, active=None, impl=None):
            m, h = hyps.shape[:2]
            p = pts.shape[1]
            nbytes = 4 * (m * h * 2 + 2 * m * p * 2 + m * p + m + m * h)
            cells.append((pvalid, active, h, nbytes))
            return original(hyps, pts, dirs, pvalid, inlier_thresh, active=active, impl=impl)
        return vote_counts

    with patched(aggregation, "label_components_deferred", wrap_k1), \
            patched(voting, "vote_counts", wrap_k2):
        yield
    for pvalid, active, h, nbytes in cells:
        c = counts.k2_cells(pvalid, active, h)
        record.k2_bound_s += counts.k2_bound_s(float(c.item()), nbytes)


@contextlib.contextmanager
def fault(name: Optional[str]):
    """Plant the fault `name` (None: none) in the port for the block."""
    if name is None:
        yield
        return
    if name == "count":
        from fastposecnn_tpu_torch.ops import voting

        def wrap(original):
            def vote_counts(*args, **kwargs):
                c = original(*args, **kwargs)
                return c + (c == c.amax(dim=-1, keepdim=True)).float()
            return vote_counts

        with patched(voting, "vote_counts", wrap):
            yield
    elif name == "state_unchanged":
        from fastposecnn_tpu_torch.train import optim

        with patched(optim, "apply_updates", lambda original: (lambda params, updates: None)):
            yield
    elif name == "half_batch":
        yield  # the train driver halves its feed
    else:
        raise ValueError(f"unknown fault {name!r}")
