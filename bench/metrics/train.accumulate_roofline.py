"""The gradient accumulation passes' share of their roofline.

Their least bytes a step, for N parameters (``cost.dense_lm_params``) and
``accum_steps`` micro-batches: zero the fp32 buffers (write 4 N), add each
micro-batch's gradient (read it in the parameters' dtype, read and write
the buffer: 10 N in bf16) and divide the sum (read and write: 8 N); for
the traced steps, at HBM bandwidth, over the device time of the ops
launched inside the program's ``train.accumulate`` spans. Source: the
device trace. None when the trace holds no such op (no accumulation).
"""


def read(ctx):
    f = ctx.facts
    model, accum = f["model"], f["traffic"]["accum_steps"]
    took = ctx.digest.time_s(lambda op: "train.accumulate" in op.spans)
    if took <= 0:
        return None
    per_param = 4 + accum * (ctx.cost.ITEMSIZE[model["dtype"]] + 4 + 4) + 8
    moved = ctx.cost.dense_lm_params(model) * per_param * f["traced_steps"]
    return 100.0 * moved / ctx.peaks.HBM_BYTES_PER_S / took
