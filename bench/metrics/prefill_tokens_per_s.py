"""prefill_tokens_per_s: every prompt token of every request of the
window, over the window's time (from the first request's start to the
last one's end)."""


def read(run):
    return sum(i["tokens"] for i in run.items) / run.window_s
