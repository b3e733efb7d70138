"""Driver of traffic kind ``multiply``: one closed-loop caller of the port's
``backend.matmul`` over a pool of operand pairs resident on the device.

Set-up draws the pool from the seed on the device (a few large normal
draws in the traffic's dtype) and warms the route with as many multiplies
as the window will hold products at once. The window calls
``repro_torch.core.backend.matmul(a, b, backend)`` on pair i mod pool and
synchronises each product; it closes at the first completion after
``--seconds``. ``multiply_tflops`` counts the multiplies completed times
the standard 2MKN over the window's seconds. A reservoir drawn from the
seed keeps ``samples`` of the window's products; after the window (and,
when traced, a few profiled multiplies more, twice: ``trace.traced``) the
plain reference
(``reference/matmul.py``, float64) judges each kept product by its
relative Frobenius error and its largest element error over the
reference's rms.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness import cost, spec
from harness.runner import Outcome, Run
from harness.trace import traced
from reference import matmul as ref


def backend_of(config: dict):
    from repro_torch.core.backend import MatmulBackend

    b = config["backend"]
    return MatmulBackend(kind=b["kind"], depth=b["depth"], min_dim=b["min_dim"],
                         precision=b.get("precision"))


def operands(config: dict, traffic: dict, seed: int, device) -> tuple:
    """The pool: (pool, M, K) and (pool, K, N) in the traffic's dtype."""
    dtype = getattr(torch, traffic["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(spec.derive(seed, "operands"))
    m, k, n, pool = config["m"], config["k"], config["n"], traffic["pool"]
    a = torch.randn((pool, m, k), generator=gen, device=device, dtype=dtype)
    b = torch.randn((pool, k, n), generator=gen, device=device, dtype=dtype)
    return a, b


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(relative Frobenius error, largest element error / rms of ``want``)."""
    diff = got.double() - want
    norm = float(torch.linalg.vector_norm(want))
    rms = norm / want.numel() ** 0.5
    return float(torch.linalg.vector_norm(diff)) / norm, float(diff.abs().max()) / rms


def judge(a: torch.Tensor, b: torch.Tensor, kept: dict) -> list:
    """(Frobenius, element) errors of each kept product, one reference
    product per operand pair."""
    by_pair: dict = {}
    for pair, prod in kept.values():
        by_pair.setdefault(pair, []).append(prod)
    out = []
    for pair, prods in by_pair.items():
        want = ref.product(a[pair], b[pair])
        out += [errors(prod, want) for prod in prods]
        del want
    return out


def run(run: Run) -> Outcome:
    from repro_torch.core.backend import matmul
    from repro_torch.obs import tracer as obs

    cfg, traffic = run.cell.config, run.cell.traffic
    backend = backend_of(cfg)
    a, b = operands(cfg, traffic, run.seed, run.device)
    pool, k = traffic["pool"], traffic["samples"]

    # Warm-up: the route, and the allocator's blocks for k held products.
    held = [matmul(a[i % pool], b[i % pool], backend) for i in range(k + 1)]
    run.sync()
    del held
    rng = np.random.default_rng(spec.derive(run.seed, "sample") % 2**63)

    run.window_opens()
    kept: dict = {}  # slot -> (pair, product): a uniform sample of the window's products
    count, t0 = 0, time.perf_counter()
    while True:
        pair = count % pool
        c = matmul(a[pair], b[pair], backend)
        run.sync()
        slot = count if count < k else int(rng.integers(0, count + 1))
        if slot < k:
            kept[slot] = (pair, c)
        del c
        count += 1
        t = time.perf_counter()
        if t - t0 >= run.seconds:
            break
    window_s = t - t0
    work = cost.standard_multiply_flops(cfg["m"], cfg["k"], cfg["n"])
    e2e = {"multiply_tflops": count * work / window_s / 1e12}
    facts = {"window_s": window_s, "multiplies": count, "dtype": traffic["dtype"],
             "window_mallocs": run.device_mallocs() - run.mallocs}

    dg = None
    if run.trace:
        def body():
            for i in range(traffic["trace_multiplies"]):
                with torch.profiler.record_function("bench.multiply"):
                    c = matmul(a[i % pool], b[i % pool], backend)
                run.sync()
                del c

        obs.configure(enabled=True, profiler_annotations=True)
        try:
            dg = traced(body, run.cuda, shapes=True)
        finally:
            obs.configure(enabled=False, profiler_annotations=False)
            obs.reset_tracing()
        facts["traced_multiplies"] = traffic["trace_multiplies"]
    peak = torch.cuda.max_memory_allocated(run.device) if run.cuda else 0

    t_ref = time.perf_counter()
    errs = judge(a, b, kept)
    facts["reference_s"] = time.perf_counter() - t_ref
    del kept
    lim = run.cell.limits
    held = {name: i for name, i in (("rel_fro", 0), ("max_over_rms", 1)) if name in lim}
    checks = {name: (max(e[i] for e in errs), lim[name]) for name, i in held.items()}
    failed = sum(1 for e in errs if not all(e[i] <= lim[name] for name, i in held.items()))
    return Outcome(end_to_end=e2e, attempted=count, failed=failed, checks=checks,
                   memory_peak_bytes=peak, digest=dg, facts=facts)
