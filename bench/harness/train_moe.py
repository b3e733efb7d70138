"""Driver of traffic kind ``train_moe``: the port's training step on an
OLMoE-style MoE decoder (``reference/moe_lm.py``), as one chip's share of
expert parallelism, driven step after step by one loop.

The same run as kind ``train`` (``harness/train.py``, whose feed, readings
and comparison it shares): set-up builds the port's ``TrainState`` with
``init_train_state``, loads the weights the benchmark draws from the seed
(``moe_lm.make_weights``), builds ``make_train_step(..., accum_steps=)`` and
drives that state through the first ``first_steps`` steps; the window runs
further steps on fresh rows of tokens and closes at the first step to end
after ``--seconds``; ``train_tokens_per_s`` is the tokens of the steps
completed over the window's seconds. After the window the program's state
is freed and the plain reference follows the same first steps from the
same weights and rows.

The layer's configuration comes whole from the configuration file's
``model`` (the port's ``ModelConfig`` is built before anything else, so a
port that lacks one of its fields fails at once). When traced, each traced
pass starts from zeroed counters, and ``facts["moe_counts"]`` holds the
port's ``moe.*`` counters of the last (full) pass: the tokens routed, the
assignments to held experts (the rows the expert products computed) and
to experts held elsewhere, and each held expert's load.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, Optional

import torch

from harness import spec
from harness.runner import Outcome, Run
from harness.trace import traced
from harness.train import compare, feed, leaf_norms, micro_batches, still_leaves
from reference import moe_lm


def model_config(model: dict):
    """The port's ``ModelConfig`` of the configuration's ``model`` sizes:
    dropless routing over the experts this chip holds."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(
        name=model["name"], family="moe", n_layers=model["n_layers"], d_model=model["d_model"],
        n_heads=model["n_heads"], n_kv_heads=model["n_kv_heads"], d_ff=0, vocab=model["vocab"],
        block_pattern=("attn",) * model["remat_every"], head_dim=model["head_dim"],
        act=model["act"], glu=True, rope_theta=model["rope_theta"], norm_eps=model["norm_eps"],
        tie_embeddings=False, dtype=model["dtype"], remat=model["remat"],
        n_experts=model["n_experts"], top_k=model["top_k"], d_expert=model["d_expert"],
        router_aux_coef=model["router_aux_coef"], qk_norm=model["qk_norm"],
        norm_topk_prob=model["norm_topk_prob"], moe_dropless=True,
        experts_held=model["experts_held"], expert_first=model["expert_first"])


def weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(spec.derive(seed, "weights"))
    return moe_lm.make_weights(model, gen, getattr(torch, model["dtype"]))


@torch.no_grad()
def change_norms(current: Dict[str, torch.Tensor], model: dict, seed: int,
                 device) -> Dict[str, float]:
    """Each leaf's ||p - p0||, with p0 drawn again from the seed."""
    start = weights(model, seed, device)
    out = {n: float(torch.linalg.vector_norm(current[n].float() - start[n].float())) for n in start}
    del start
    return out


def reference_readings(model: dict, traffic: dict, seed: int, device, fp8: bool = False,
                       half_batch: bool = False, capacity: Optional[float] = None) -> dict:
    """The plain reference's first steps from the seed's weights and rows:
    each step's loss, each leaf's first gradient norm and change norm.
    ``fp8`` runs the control; ``half_batch`` weights the second half of each
    micro-batch's tokens zero and ``capacity`` drops the assignments past
    that capacity factor (planted faults; ``drop_share`` is then the share of
    the held assignments dropped)."""
    opt = traffic["optimizer"]
    trainer = moe_lm.Trainer(model, opt, weights(model, seed, device), fp8=fp8, capacity=capacity)
    losses, grad1 = [], {}
    for step in range(1, traffic["first_steps"] + 1):
        micro = micro_batches(feed(traffic, model["vocab"], seed, step, device),
                              traffic["accum_steps"])
        if half_batch:
            for mb in micro:
                mask = torch.ones(mb["tokens"].shape, device=device)
                mask[..., mask.shape[-1] // 2:] = 0.0
                mb["mask"] = mask
        losses.append(trainer.step(micro))
        if step == 1:
            grad1 = leaf_norms(trainer.m, 1.0 / (1.0 - opt["b1"]))
    out = {"loss": losses, "grad1": grad1, "change": change_norms(trainer.w, model, seed, device)}
    if capacity is not None:
        out["drop_share"] = trainer.net.dropped / max(trainer.net.held, 1)
    del trainer
    gc.collect()
    return out


def program_first_steps(model: dict, traffic: dict, seed: int, device) -> tuple:
    """The port's state loaded with the seed's weights, its step, and the
    readings of its first steps: (state, step_fn, readings)."""
    cfg = model_config(model)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_step import init_train_state, make_train_step

    opt_cfg = AdamWConfig(**traffic["optimizer"])
    marks = [("start", time.perf_counter())]
    gen = torch.Generator(device=device)
    gen.manual_seed(spec.derive(seed, "program"))
    state = init_train_state(cfg, opt_cfg, gen)
    marks.append(("init_train_state", time.perf_counter()))
    mine = weights(model, seed, device)
    named = dict(state.params.named_parameters())
    if {n: (p.shape, p.dtype) for n, p in named.items()} != {
            n: (t.shape, t.dtype) for n, t in mine.items()}:
        raise SystemExit("the program's parameters are not the configuration's leaves")
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(mine[n])
    del mine, named
    marks.append(("weights", time.perf_counter()))
    step_fn = make_train_step(cfg, opt_cfg, accum_steps=traffic["accum_steps"])

    got = {"loss": []}
    for step in range(1, traffic["first_steps"] + 1):
        state, met = step_fn(state, feed(traffic, model["vocab"], seed, step, device))
        got["loss"].append(float(met["loss"]))
        marks.append((f"step {step}", time.perf_counter()))
        if step == 1:
            got["grad1"] = leaf_norms(state.opt.m, 1.0 / (1.0 - opt_cfg.b1))
    got["change"] = change_norms(dict(state.params.named_parameters()), model, seed, device)
    marks.append(("change norms", time.perf_counter()))
    got["setup_phases"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    return state, step_fn, got


def moe_counts() -> Dict[str, float]:
    """The port's ``moe.*`` counters."""
    from repro_torch.obs import metrics

    counters = metrics.get_metrics().snapshot()["counters"]
    return {n: v for n, v in counters.items() if n.startswith("moe.")}


def run(run: Run) -> Outcome:
    model, traffic = run.cell.config["model"], run.cell.traffic
    dev = run.device
    state, step_fn, got = program_first_steps(model, traffic, run.seed, dev)
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import tracer as obs

    run.sync()

    run.window_opens()
    tokens = traffic["micro_batch"] * traffic["accum_steps"] * traffic["seq"]
    step, count, bad, ends, t0 = traffic["first_steps"], 0, 0, [], time.perf_counter()
    while True:
        step += 1
        state, met = step_fn(state, feed(traffic, model["vocab"], run.seed, step, dev))
        bad += not math.isfinite(float(met["loss"]))
        count += 1
        t = time.perf_counter()
        ends.append(t)
        if t - t0 >= run.seconds:
            break
    window_s = t - t0
    facts = {"window_s": window_s, "steps": count, "model": model, "traffic": traffic,
             "window_mallocs": run.device_mallocs() - run.mallocs,
             "step_s": [b - a for a, b in zip([t0] + ends, ends)],
             "setup_phases": got.pop("setup_phases")}

    dg = None
    if run.trace:
        def body():
            nonlocal step, bad, state
            obs_metrics.get_metrics().reset()
            for _ in range(traffic["trace_steps"]):
                step += 1
                batch = feed(traffic, model["vocab"], run.seed, step, dev)
                with torch.profiler.record_function("bench.step"):
                    state, met = step_fn(state, batch)
                bad += not math.isfinite(float(met["loss"]))

        obs.configure(enabled=True, profiler_annotations=True)
        try:
            dg = traced(body, run.cuda, shapes=False)
            facts["moe_counts"] = moe_counts()
        finally:
            obs.configure(enabled=False, profiler_annotations=False)
            obs.reset_tracing()
            obs_metrics.get_metrics().reset()
        facts["traced_steps"] = traffic["trace_steps"]
        print(f"moe counts of the traced steps: {facts['moe_counts']}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if run.cuda else 0

    del state, step_fn, met
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = reference_readings(model, traffic, run.seed, dev)
    facts["reference_s"] = time.perf_counter() - t_ref
    gaps = compare(got, want)
    print(f"leaves left out of the change: {sorted(still_leaves(want))}", file=sys.stderr)
    lim = run.cell.limits
    checks = {name: (value, lim[name]) for name, value in gaps.items()}
    return Outcome(end_to_end={"train_tokens_per_s": count * tokens / window_s},
                   attempted=count, failed=bad, checks=checks, memory_peak_bytes=peak,
                   digest=dg, facts=facts)
