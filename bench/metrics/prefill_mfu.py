"""prefill_mfu: the model FLOPs of the window's prefills over the
window's time, as a share of the card's dense bf16 peak.

A prompt of S tokens: 2 FLOPs a weight of the layers' projections and
FFN a token, the head once (the last position's logits), and causal
attention: the scores and p . v over the S (S + 1) / 2 live (query, key)
pairs, 4 x heads x head_dim FLOPs a pair, a layer.  The embedding is a
lookup.  The sizes come from the configuration's file."""

PEAK_FLOPS = 989e12
BASIS = "989 TFLOP/s dense bf16 (H100 SXM data sheet)"


def prompt_flops(sh: dict, s: int) -> int:
    d, f, nl = sh["d_model"], sh["d_ff"], sh["n_layers"]
    q, kv = sh["n_heads"] * sh["head_dim"], sh["kv_heads"] * sh["head_dim"]
    vocab = -(-sh["vocab"] // 256) * 256
    weights = 2 * d * q + 2 * d * kv + 3 * d * f
    return 2 * s * nl * weights + 2 * d * vocab + nl * 2 * q * s * (s + 1)


def read(run):
    if run.trace is None or not run.on_card:
        return None
    flops = sum(i["rows"] * prompt_flops(run.shapes, i["seq_len"])
                for i in run.items)
    return 100.0 * flops / run.window_s / PEAK_FLOPS
