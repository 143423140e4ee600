"""idle_pct.train: the share of the traced window in which no kernel, copy
or fill ran on the card, in percent."""
from window_trace import idle_pct


def read(run):
    return idle_pct(run.trace)
