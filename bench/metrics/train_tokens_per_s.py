"""train_tokens_per_s: every token of every step of the window, over the
window's time (from the first step's start to the last step's end)."""


def read(run):
    return sum(i["tokens"] for i in run.items) / run.window_s
