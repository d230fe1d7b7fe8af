"""A proposer for the port's fused-round tests: a plain function run
whole as a round's proposal loop (``make_fused_round`` takes only a
:class:`~dynesty_tpu_torch.internal.fused.Proposer`)."""

import torch

from dynesty_tpu_torch.internal.fused import Proposer


class WholeRound(Proposer):
    """``fn(gen, live, live_blob, axes_args, scale, loglstar) -> (qu, qv,
    qlogl, qblob, qnc, stats, lane_stats)`` run whole in the loop,
    eagerly, with the arguments ``begin`` was given; the round reads its
    gate on the host before the loop (``gate_read`` False) and is never
    captured."""

    def __init__(self, fn):
        self.fn, self.args, self.out = fn, None, None

    def prepare(self, live, axes_args):
        return None

    def begin(self, gen, live, live_blob, axes_args, scale, loglstar, gate):
        self.args = (gen, live, live_blob, axes_args, scale, loglstar)

    def loop(self, gen):
        self.out = self.fn(*self.args)
        return False

    def finish(self, axes_args):
        qu, qv, qlogl, qblob, qnc, stats, lane_stats = self.out
        return (torch.cat([qu, qv, qlogl[:, None]], dim=1), qblob, qnc,
                stats, lane_stats)
