"""The comparison that decides ``correct`` fails a broken program: each
fault a cell can have is planted under the timed path, the rest of a run is
driven on the CPU at a tiny size, and ``correct`` comes out false. The
controls (the reference one precision below, in the program's place) fail
the real cells' limits at a test size."""
import pytest
import torch

from conftest import LM, MM, TRAFFIC


def test_multiply_answer_altered(run_tiny, monkeypatch):
    import repro_torch.core.backend as backend

    orig = backend._matmul_routed

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        q = out.shape[0] // 4
        out[:q, :q] = -out[:q, :q]  # one block of the answer, negated where it is made
        return out

    monkeypatch.setattr(backend, "_matmul_routed", altered)
    for workload in ("t.mm.fp32", "t.mm.bf16"):
        out = run_tiny(workload)
        assert out["correct"] is False and out["failed"] > 0


def test_multiply_half_the_leaf_batch_left_out(run_tiny, monkeypatch):
    import repro_torch.core.backend as backend

    orig = backend.strassen_matmul

    def halved(a, b, **kwargs):
        def leaf(x, y):
            out = torch.bmm(x, y)
            out[out.shape[0] // 2:] = 0  # the second half of the leaf products left out
            return out
        return orig(a, b, leaf_fn=leaf, **{k: v for k, v in kwargs.items() if k != "leaf_fn"})

    monkeypatch.setattr(backend, "strassen_matmul", halved)
    for workload in ("t.mm.fp32", "t.mm.bf16"):
        assert run_tiny(workload)["correct"] is False


@pytest.mark.parametrize("workload", ["t.tr.acc2", "t.tr.b2"])
def test_train_state_unchanged(run_tiny, monkeypatch, workload):
    import repro_torch.training.train_step as ts

    def unchanged(params, grads, state, cfg):
        return params, state, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}

    monkeypatch.setattr(ts, "apply_updates", unchanged)
    out = run_tiny(workload)
    assert out["correct"] is False
    assert out["checks"]["change"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["t.tr.acc2", "t.tr.b2"])
def test_train_half_the_batch_left_out(run_tiny, monkeypatch, workload):
    import repro_torch.training.train_step as ts

    orig = ts.M.loss_fn

    def half(params, batch, cfg):
        mask = torch.ones(batch["tokens"].shape)
        mask[: max(mask.shape[0] // 2, 1), mask.shape[1] // 2:] = 0.0
        return orig(params, {**batch, "mask": mask}, cfg)

    monkeypatch.setattr(ts.M, "loss_fn", half)
    assert run_tiny(workload)["correct"] is False


@pytest.mark.parametrize("traffic,limits", [("mm.fp32", "t.mm.fp32"), ("mm.bf16", "t.mm.bf16")])
def test_multiply_control_fails(traffic, limits):
    from conftest import LIMITS
    from harness import multiply
    from reference import matmul as ref

    size = {**MM, "m": 256, "k": 256, "n": 256}
    a, b = multiply.operands(size, TRAFFIC[traffic], 2**31 + 11, "cpu")
    errs = multiply.judge(a, b, {p: (p, ref.control(a[p], b[p])) for p in range(a.shape[0])})
    assert all(fro > LIMITS[limits]["rel_fro"] for fro, _ in errs)


def test_train_control_moves_the_loss():
    from harness import train

    model = {**LM["model"], "dtype": "bfloat16"}
    want = train.reference_readings(model, TRAFFIC["tr.b2"], 2**31 + 13, "cpu")
    low = train.reference_readings(model, TRAFFIC["tr.b2"], 2**31 + 13, "cpu", fp8=True)
    same = train.reference_readings(model, TRAFFIC["tr.b2"], 2**31 + 13, "cpu")
    assert train.compare(same, want) == {"loss": 0.0, "grad1": 0.0, "change": 0.0}
    assert train.compare(low, want)["loss"] > 0.0
