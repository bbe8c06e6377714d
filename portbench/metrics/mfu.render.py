"""The whole unit's share of the card's bf16 peak: the model flops of the
traced units (aggregators, feature-net convolutions, motion MLP; a
backward at twice its forward), counted from the cell's shapes by
workcount.py, over the traced window's seconds times 989 TFLOP/s."""

from portbench.metrics._common import mfu_pct


def read(ctx, res, summary):
  return mfu_pct(res, summary)
