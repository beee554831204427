"""The harness end to end at a tiny size on the CPU (`run.execute` past its
look for a card), its refusal without a card, the faults and the control
that must come out as not correct, and the trace arithmetic the readers
share. Tests marked `cuda` run the same on the card and skip without one."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import load_by_path, run, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SEED = 2**31 + 17
# the CPU stream runs BP's generic loop with float32 messages: the reference follows it there
STARRO_CPU = {"params": {"tile": 256, "pool": 5}, "settings": {"em_batch": 2, "bp_msg_dtype": "float32"}}
MORPHO_CPU = {"params": {"cells": 400, "pool": 2}}


def card():
    import torch

    return torch.cuda.is_available()


def test_run_exits_nonzero_without_a_card_and_prints_no_result():
    if card():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "starro-bin1.interior", "--seed", "1",
                           "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "needs 1 CUDA device" in proc.stderr


def test_starro_cell_is_correct_on_the_cpu():
    # the Starro cells are not in BENCHMARK.json yet (PERF.md): a run reports
    # what it lists for them, set-up, and judges its outputs all the same
    res = run.execute("starro-bin1.interior", SEED, 0.5, False, device="cpu", overrides=STARRO_CPU)
    assert res["correct"] and res["failed"] == 0 and res["judged"] > 0
    assert "setup_s" in res["metrics"] and res["attempted"] > 0


def test_starro_section_cell_traced_on_the_cpu_reads_its_span():
    ov = {"params": {"tile": 256, "section": [400, 400], "pool": 5}, "settings": STARRO_CPU["settings"]}
    res = run.execute("starro-bin1.section", SEED, 0.5, True, device="cpu", overrides=ov)
    assert res["correct"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_starro_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    import spateo_tpu_torch.segmentation.starro as starro

    threshold = starro._starro_threshold_mask

    def altered(scores, mk):
        mask = threshold(scores, mk).clone()
        mask[: mask.shape[0] // 4] = ~mask[: mask.shape[0] // 4]
        return mask

    monkeypatch.setattr(starro, "_starro_threshold_mask", altered)
    res = run.execute("starro-bin1.interior", SEED, 0.5, False, device="cpu", overrides=STARRO_CPU)
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"]["mask_mismatch_share"]["value"] > res["checks"]["mask_mismatch_share"]["limit"]


def test_starro_control_in_the_programs_place_is_not_correct():
    # the control stores BP's messages in float8, the reference in the
    # configuration's bfloat16
    ov = {"params": STARRO_CPU["params"], "settings": {"em_batch": 2}}
    res = run.execute("starro-bin1.interior", SEED, 0.5, False, device="cpu", program="control", overrides=ov)
    assert not res["correct"]
    assert res["checks"]["score_mean_gap"]["value"] > res["checks"]["score_mean_gap"]["limit"]


def test_morpho_cell_is_correct_on_the_cpu():
    res = run.execute("morpho-pair.20k", SEED, 0.5, False, device="cpu", overrides=MORPHO_CPU)
    assert res["correct"] and res["judged"] == 2
    assert set(res["metrics"]) == {"morpho_pairs_min", "setup_s"}


def test_morpho_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from spateo_tpu_torch.alignment.methods import morpho

    em = morpho._morpho_em

    def altered(*args, **kwargs):
        s, R, t, RnA = em(*args, **kwargs)
        return s, R, t + 0.01, RnA + 0.01

    monkeypatch.setattr(morpho, "_morpho_em", altered)
    res = run.execute("morpho-pair.20k", SEED, 0.5, False, device="cpu", overrides=MORPHO_CPU)
    assert not res["correct"]
    assert res["checks"]["rigid_coord_gap"]["value"] > res["checks"]["rigid_coord_gap"]["limit"]


def test_morpho_error_shared_with_the_reference_is_not_correct(monkeypatch):
    # the reference is a frozen copy of the program's math: an error in both
    # leaves the gaps between them small and shows against the planted truth
    import torch

    from spateo_tpu_torch.alignment.methods import morpho

    ref = load_by_path("reference/morpho-pair.py")
    em, ref_em = morpho._morpho_em, ref.em

    def turn(x):
        c, s = np.cos(0.2), np.sin(0.2)
        return x @ torch.tensor([[c, -s], [s, c]], dtype=x.dtype, device=x.device).T

    def altered(*args, **kwargs):
        s, R, t, RnA = em(*args, **kwargs)
        return s, R, t, turn(RnA)

    def ref_altered(*args, **kwargs):
        XAHat, R, t, RnA, sigma2 = ref_em(*args, **kwargs)
        return XAHat, R, t, turn(RnA), sigma2

    monkeypatch.setattr(morpho, "_morpho_em", altered)
    monkeypatch.setattr(ref, "em", ref_altered)
    res = run.execute("morpho-pair.20k", SEED, 0.5, False, device="cpu", overrides=MORPHO_CPU)
    checks = res["checks"]
    assert checks["rigid_coord_gap"]["value"] <= checks["rigid_coord_gap"]["limit"]
    assert checks["planted_rigid_gap"]["value"] > checks["planted_rigid_gap"]["limit"]
    assert not res["correct"]


@pytest.mark.cuda
def test_cells_on_the_card_at_a_small_size_and_their_controls():
    if not card():
        pytest.skip("needs a CUDA device")
    res = run.execute("starro-bin1.interior", SEED, 1.0, True, overrides={"params": {"tile": 512, "pool": 5}})
    assert res["correct"] and res["device"]["busy_s"] > 0
    ctl = run.execute("starro-bin1.interior", SEED, 1.0, False, program="control",
                      overrides={"params": {"tile": 512, "pool": 5}})
    assert not ctl["correct"]
    res = run.execute("morpho-pair.20k", SEED, 1.0, True, overrides={"params": {"cells": 5000, "pool": 2}})
    assert res["correct"] and {"morpho.em_ms", "morpho.estep_ms_per_pair"} <= set(res["metrics"])
    ctl = run.execute("morpho-pair.20k", SEED, 1.0, False, program="control",
                      overrides={"params": {"cells": 5000, "pool": 2}})
    assert not ctl["correct"]


# -- the trace arithmetic, on a made-up span -----------------------------------
def made_up_span():
    span = trace.Span(start_ns=0, end_ns=100, units=2)
    span.device = [
        ("void bp_step_kernel<bf16>", 7, 10, 30),
        ("elementwise", 7, 25, 40),
        ("Memcpy HtoD (Pinned -> Device)", 9, 35, 55),  # 5 of its 20 under a kernel
        ("Memcpy DtoH (Device -> Pinned)", 11, 70, 80),  # under none
        ("void bp_step_kernel<bf16>", 7, 60, 65),
    ]
    span.host = [("outer", 0, 100), ("aten::item", 40, 58), ("aten::add", 81, 95)]
    span.counters = {"bp_step.launches": 2}
    span.extra = {"computed_tiles": [(64, 64)], "msg_dtype": "bfloat16"}
    return span


def test_trace_arithmetic():
    span = made_up_span()
    assert trace.union([(5, 10), (8, 12), (20, 25)], 0, 22) == [[5, 12], [20, 22]]
    assert trace.busy_ns(span) == 30 + 15 + 5 + 10 - 0  # [10,55), [60,65), [70,80)
    assert trace.idle_share(span) == pytest.approx(1 - 60 / 100)
    assert trace.copy_hidden(span) == (30, 5)
    gaps = trace.idle_gaps(span)
    assert gaps == {"outer": 10 + 5, "aten::item": 5, "aten::add": 20}
    b = trace.breakdown(span)
    assert b["device_ops"][0] == ["void bp_step_kernel<bf16>", 25e-9]
    assert span.kernel_count(("bp_step_kernel",)) == 2


def test_readers_on_a_made_up_span():
    span = made_up_span()
    hidden = load_by_path("metrics/starro.copy_hidden_share.py").read(span)
    assert hidden == pytest.approx(5 / 30)
    roof = load_by_path("metrics/starro.bp_roofline.py")
    nbytes = 2 * 64 * 64 * 24
    assert roof.read(span) == pytest.approx(100 * nbytes / 3.35e12 / 25e-9)
    span.counters["bp_step.launches"] = 3  # one launch more than the trace holds: records lost
    assert roof.read(span) is None
    assert load_by_path("metrics/starro.kernels_per_mpix.py").read(span) is None
    span = made_up_span()
    assert load_by_path("metrics/starro.kernels_per_mpix.py").read(span) == pytest.approx(3 / (64 * 64 / 1e6))
    assert load_by_path("metrics/morpho.estep_ms_per_pair.py").read(span) is None  # no E-step kernel
    span.extra["phases"] = [{"start": 0.0, "preem_done": 0.25, "em_dispatched": 1.25}] * 3
    assert load_by_path("metrics/morpho.pre_em_ms.py").read(span) == pytest.approx(250.0)
    assert load_by_path("metrics/morpho.em_ms.py").read(span) == pytest.approx(1000.0)


def test_metrics_of_a_cell_follow_benchmark_json():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        e2e = {m["name"] for m in run.metrics_of(spec, w["name"], False)}
        layer = {m["name"] for m in run.metrics_of(spec, w["name"], True)}
        assert "setup_s" in e2e and len(e2e) == 2
        assert layer and all(m.startswith(w["config"].split("-")[0]) for m in layer)
