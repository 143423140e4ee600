"""setup_s: seconds from the start of the process to the start of the
window - imports, the card's start, the weights, building the kernels
where the checkout has none yet, and the warm-up."""


def read(run):
    return run.setup_s
