"""train_mfu: the model FLOPs of the window's training steps over the
window's time, as a share of the card's dense bf16 peak.

A step's FLOPs: 6 N a token (N every parameter, the embedding and the
head included) plus causal attention's 6 S d a token a layer (the scores
and p . v over the S / 2 keys a token sees on average, two FLOPs a
multiply-add, times 3 for the forward and the backward), d = heads x
head_dim.  The sizes come from the configuration's file."""

PEAK_FLOPS = 989e12
BASIS = "989 TFLOP/s dense bf16 (H100 SXM data sheet)"


def n_params(sh: dict) -> int:
    d, f, nl = sh["d_model"], sh["d_ff"], sh["n_layers"]
    q, kv = sh["n_heads"] * sh["head_dim"], sh["kv_heads"] * sh["head_dim"]
    vocab = -(-sh["vocab"] // 256) * 256
    per_layer = 2 * d * q + 2 * d * kv + 3 * d * f + 2 * d
    return 2 * vocab * d + d + nl * per_layer


def step_flops(sh: dict, rows: int, seq_len: int) -> int:
    tokens = rows * seq_len
    d_attn = sh["n_heads"] * sh["head_dim"]
    return (6 * n_params(sh) * tokens
            + 6 * seq_len * d_attn * tokens * sh["n_layers"])


def read(run):
    if run.trace is None or not run.on_card:
        return None
    flops = sum(step_flops(run.shapes, i["rows"], i["seq_len"])
                for i in run.items)
    return 100.0 * flops / run.window_s / PEAK_FLOPS
