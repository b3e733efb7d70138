"""AdamW's share of its roofline.

AdamW's least bytes a step (read the parameters, their gradients in the
parameters' dtype and both fp32 moments; write the parameters and the
moments) for the traced steps, at HBM bandwidth, over the device time of
the ops launched inside the program's ``train.optimizer`` spans. Source:
the device trace. None when the trace holds no such span.
"""


def read(ctx):
    f = ctx.facts
    model = f["model"]
    took = ctx.digest.time_s(lambda op: "train.optimizer" in op.spans)
    if took <= 0:
        return None
    n = ctx.cost.dense_lm_params(model)
    moved = ctx.cost.adamw_bytes(n, model["dtype"], "float32") * f["traced_steps"]
    return 100.0 * moved / ctx.peaks.HBM_BYTES_PER_S / took
