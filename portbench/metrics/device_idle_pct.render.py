"""The share of the traced window in which no operation ran on the card:
one less the union of the device intervals over the window."""

from portbench.metrics._common import idle_pct


def read(ctx, res, summary):
  return idle_pct(summary)
