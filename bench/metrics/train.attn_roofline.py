"""The flash attention kernels' share of their roofline.

Each launch of the forward kernel (``flash_kernel``, ``flash_mma_kernel``)
and of the backward (``flash_bwd_wgmma_kernel``, ``flash_bwd_f32_kernel``)
is priced at the least time of one micro-batch's causal attention
(``cost.flash`` with the row statistics, ``cost.flash_bwd``); their sum
over the device time of every kernel whose name holds ``flash`` (the
backward's preparation and dQ kernels among them). Source: the device
trace. None when no flash kernel ran.
"""


def read(ctx):
    f, c = ctx.facts, ctx.cost
    model, traffic = f["model"], f["traffic"]
    ops = ctx.digest.ops
    fwd = sum(1 for op in ops if "flash_kernel" in op.name or "flash_mma_kernel" in op.name)
    bwd = sum(1 for op in ops
              if "flash_bwd_wgmma_kernel" in op.name or "flash_bwd_f32_kernel" in op.name)
    took = ctx.digest.time_s(lambda op: "flash" in op.name)
    if took <= 0 or fwd + bwd == 0:
        return None
    shape = (traffic["micro_batch"], model["n_heads"], model["n_kv_heads"], traffic["seq"],
             traffic["seq"], model["head_dim"], True, None, model["dtype"])
    one_f, one_b = c.flash(*shape, lse=True), c.flash_bwd(*shape)
    least = (fwd * ctx.peaks.least_seconds(one_f.ops, model["dtype"], one_f.bytes)
             + bwd * ctx.peaks.least_seconds(one_b.ops, model["dtype"], one_b.bytes))
    return 100.0 * least / took
