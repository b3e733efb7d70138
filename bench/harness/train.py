"""Driver of traffic kind ``train``: the port's training step on a dense
decoder LM, driven step after step by one loop.

Set-up builds one :class:`TrainState` with the port's ``init_train_state``
and loads into it the weights the benchmark draws from the seed
(``reference/dense_lm.py:make_weights``, a few large draws on the device),
builds the step with ``make_train_step(..., accum_steps=)`` and drives that
same state through the first ``first_steps`` steps by the window's own call
and feed. Those steps are the comparison's: it reads each step's loss, the
norm of each leaf's first gradient as AdamW got it (from its first moment
after step 1: m / (1 - b1)), and the norm of each leaf's change after the
last of them (the weights drawn again from the seed give the start). The
window then runs further steps on the same state, each on fresh rows of
tokens drawn from the seed (``feed``), reading each step's loss as a
trainer logging it would; it closes at the first step to end after
``--seconds``. ``train_tokens_per_s`` is the tokens of the steps completed
over the window's seconds.

After the window (and, when traced, a step or two more, twice:
``trace.traced``), the program's state is freed
and the plain reference follows the same first steps from the same weights
and rows; the worst gap over steps and leaves of each number is compared
with its limit.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List

import torch

from harness import spec
from harness.runner import Outcome, Run
from harness.trace import traced
from reference import dense_lm


def model_config(model: dict):
    """The port's ``ModelConfig`` of the configuration's ``model`` sizes."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(
        name=model["name"], family="dense", n_layers=model["n_layers"], d_model=model["d_model"],
        n_heads=model["n_heads"], n_kv_heads=model["n_kv_heads"], d_ff=model["d_ff"],
        vocab=model["vocab"], block_pattern=("attn",) * model["remat_every"],
        head_dim=model["head_dim"], act=model["act"], glu=model["glu"],
        rope_theta=model["rope_theta"], norm_eps=model["norm_eps"],
        tie_embeddings=model["tie_embeddings"], dtype=model["dtype"], remat=model["remat"])


def feed(traffic: dict, vocab: int, seed: int, step: int, device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch: (micro_batch x accum_steps, seq) tokens and
    their next tokens as labels, fresh rows drawn from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(spec.derive(seed, "tokens", step))
    rows = traffic["micro_batch"] * traffic["accum_steps"]
    ids = torch.randint(0, vocab, (rows, traffic["seq"] + 1), generator=gen, device=device)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def micro_batches(batch: Dict[str, torch.Tensor], accum: int) -> List[Dict[str, torch.Tensor]]:
    rows = batch["tokens"].shape[0] // accum
    return [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()} for i in range(accum)]


def weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(spec.derive(seed, "weights"))
    return dense_lm.make_weights(model, gen, getattr(torch, model["dtype"]))


def leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float())) * scale for n, t in tensors.items()}


@torch.no_grad()
def change_norms(current: Dict[str, torch.Tensor], model: dict, seed: int,
                 device) -> Dict[str, float]:
    """Each leaf's ||p - p0||, with p0 drawn again from the seed."""
    start = weights(model, seed, device)
    out = {n: float(torch.linalg.vector_norm(current[n].float() - start[n].float())) for n in start}
    del start
    return out


def worst_gap(got: Dict[str, float], want: Dict[str, float], skip=frozenset()) -> float:
    """The largest |got - want| over leaves, against the larger of the
    reference's norm of the leaf and of the median leaf."""
    names = [n for n in want if n not in skip]
    median = sorted(want[n] for n in names)[len(names) // 2]
    return max(abs(got[n] - want[n]) / max(want[n], median) for n in names)


def reference_readings(model: dict, traffic: dict, seed: int, device, fp8: bool = False,
                       half_batch: bool = False) -> dict:
    """The plain reference's first steps from the seed's weights and rows:
    each step's loss, each leaf's first gradient norm and change norm.
    ``fp8`` runs the control; ``half_batch`` weights the second half of each
    micro-batch's tokens zero (a planted fault)."""
    opt = traffic["optimizer"]
    trainer = dense_lm.Trainer(model, opt, weights(model, seed, device), fp8=fp8)
    losses, grad1 = [], {}
    for step in range(1, traffic["first_steps"] + 1):
        batch = feed(traffic, model["vocab"], seed, step, device)
        micro = micro_batches(batch, traffic["accum_steps"])
        if half_batch:
            for mb in micro:
                mask = torch.ones(mb["tokens"].shape, device=device)
                mask[..., mask.shape[-1] // 2:] = 0.0
                mb["mask"] = mask
        losses.append(trainer.step(micro))
        if step == 1:
            grad1 = leaf_norms(trainer.m, 1.0 / (1.0 - opt["b1"]))
    change = change_norms(trainer.w, model, seed, device)
    del trainer
    gc.collect()
    return {"loss": losses, "grad1": grad1, "change": change}


def still_leaves(want: dict) -> frozenset:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: they move by round-off alone."""
    g = want["grad1"]
    median = sorted(g.values())[len(g) // 2]
    return frozenset(n for n, v in g.items() if v < 1e-3 * median)


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The numbers compared: the worst relative loss gap over the steps, and
    the worst leaf's gap of first-gradient and of change norms, the change
    without :func:`still_leaves`."""
    return {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])),
        "grad1": worst_gap(got["grad1"], want["grad1"]),
        "change": worst_gap(got["change"], want["change"], still_leaves(want)),
    }


def program_first_steps(model: dict, traffic: dict, seed: int, device) -> tuple:
    """The port's state loaded with the seed's weights, its step, and the
    readings of its first steps: (state, step_fn, readings)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_step import init_train_state, make_train_step

    cfg, opt_cfg = model_config(model), AdamWConfig(**traffic["optimizer"])
    marks = [("start", time.perf_counter())]
    gen = torch.Generator(device=device)
    gen.manual_seed(spec.derive(seed, "program"))
    state = init_train_state(cfg, opt_cfg, gen)
    marks.append(("init_train_state", time.perf_counter()))
    mine = weights(model, seed, device)
    named = dict(state.params.named_parameters())
    if {n: p.shape for n, p in named.items()} != {n: t.shape for n, t in mine.items()}:
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


def run(run: Run) -> Outcome:
    from repro_torch.obs import tracer as obs

    model, traffic = run.cell.config["model"], run.cell.traffic
    dev = run.device
    state, step_fn, got = program_first_steps(model, traffic, run.seed, dev)
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
            for _ in range(traffic["trace_steps"]):
                step += 1
                batch = feed(traffic, model["vocab"], run.seed, step, dev)
                with torch.profiler.record_function("bench.step"):
                    state, met = step_fn(state, batch)
                bad += not math.isfinite(float(met["loss"]))

        obs.configure(enabled=True, profiler_annotations=True)
        try:
            dg = traced(body, run.cuda, shapes=False)
        finally:
            obs.configure(enabled=False, profiler_annotations=False)
            obs.reset_tracing()
        facts["traced_steps"] = traffic["trace_steps"]
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
