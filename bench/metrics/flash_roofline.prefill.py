"""flash_roofline.prefill: the least time the card could take for the
window's attention-kernel calls over the device time of the kernel
(`flash_bf16_kernel` / `flash_f32_kernel` in the trace), in percent.

One call per layer of a prompt, (B x heads, S, head_dim) causal: q, k, v
read once and the output written once over HBM, 4 x BH x head_dim FLOPs
a live (row, key) pair, S (S + 1) / 2 of them, at the card's rate for the
type (bf16 on the tensor cores; float32 as three TF32 products); the
bound is the larger of the two times."""

PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
HBM_BYTES = 3.35e12
KERNELS = ("flash_bf16_kernel", "flash_f32_kernel")
BASIS = ("989 TFLOP/s dense bf16 and 3.35 TB/s HBM "
         "(H100 SXM data sheet)")


def call_bound_s(bh: int, s: int, hd: int, dtype: str) -> float:
    flops = 4 * bh * hd * (s * (s + 1) // 2)
    if dtype == "bfloat16":
        return max(flops / PEAK_BF16, 4 * bh * s * hd * 2 / HBM_BYTES)
    return max(3 * flops / PEAK_TF32, 4 * bh * s * hd * 4 / HBM_BYTES)


def read(run):
    if run.trace is None:
        return None
    spent = sum(t for name, t in run.trace["kernels"].items()
                if any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    sh = run.shapes
    bound = sum(sh["n_layers"] * call_bound_s(
        i["rows"] * sh["n_heads"], i["seq_len"], sh["head_dim"],
        sh["param_dtype"]) for i in run.items)
    return 100.0 * bound / spent
