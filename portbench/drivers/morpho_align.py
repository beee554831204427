"""Drives `spateo_tpu_torch.alignment.morpho_alignment.morpho_align` through a
window: a closed loop of one client aligning the moving section of each
pair onto its fixed one, the pool's pairs in turn, each call followed by a
wait for the card (the next call starts with nothing of this one queued).

The window opens when the first pair starts and closes when the first pair
that returns `seconds` or more later returns; the rate is the pairs over
that time. A traced run profiles the window's second and third pairs, ends
its window with them, and keeps every pair's stage marks (`Morpho_pairwise._phase_times`, which the
program takes with a synchronise at each mark) by wrapping
`Morpho_pairwise.run` for the run.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from portbench import load_by_path, trace

#: Pairs judged a run unless the workload names its own `judged`, each a
#: different pair of the pool, drawn from the seed among the window's first
#: `len(pool)` pairs.
JUDGED_PAIRS = 2


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device: str, program: str = "port"):
        self.config, self.workload, self.seed, self.device = config, workload, int(seed), device
        self.settings = dict(config["settings"])
        self.program = program
        self.reference = load_by_path(f"reference/{config['reference']}.py")
        self.traffic = load_by_path(f"traffic/{workload['generator']}.py")
        self.kept = {}  # window position -> (pool index, outputs)

    def setup(self):
        params = self.workload["params"]
        self.raw = [self.traffic.make_pair(params, self.seed, i, self.device) for i in range(int(params["pool"]))]
        if self.program == "port":
            import spateo_tpu_torch as stt

            key = self.settings["rep_layer"]
            self.pairs = [(self.traffic.adata(stt, p["fixed"], p["fixed_pcs"], key),
                           self.traffic.adata(stt, p["moving"], p["moving_pcs"], key)) for p in self.raw]
        if self.program == "port":
            self._align(0)  # warm-up: one pair of the cell's shapes
        self._sync()

    def _sync(self):
        import torch

        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()

    def _align(self, i: int) -> dict:
        """Align pair i of the pool; its outputs on the host."""
        if self.program == "control":
            p = self.raw[i]
            return self.reference.align((p["fixed"], p["fixed_pcs"]), (p["moving"], p["moving_pcs"]), self.settings,
                                        self.device, tf32=True)
        from spateo_tpu_torch.alignment.morpho_alignment import morpho_align

        key = self.settings["key_added"]
        out, pis = morpho_align(list(self.pairs[i]), device=self.device, **self.settings)
        del pis
        moving = out[1]
        vf = moving.uns[self.settings["vecfld_key_added"]]
        return {"rigid": np.asarray(moving.obsm[f"{key}_rigid"]), "nonrigid": np.asarray(moving.obsm[f"{key}_nonrigid"]),
                "aligned": np.asarray(moving.obsm[key]), "R": np.asarray(vf["optimal_R"])}

    def _counters(self) -> dict:
        from spateo_tpu_torch.ops.estep_cuda import colnorm, rowred
        from spateo_tpu_torch.ops.inlier_cuda import inlier_fit

        return {"colnorm.launches": colnorm.launches, "rowred.launches": rowred.launches,
                "inlier_fit.launches": inlier_fit.launches}

    @contextlib.contextmanager
    def _phase_marks(self, marks: list):
        """Keep each Morpho_pairwise.run's stage marks in `marks`."""
        from spateo_tpu_torch.alignment.methods import morpho

        run = morpho.Morpho_pairwise.run

        def wrapped(solver):
            try:
                return run(solver)
            finally:
                marks.append(dict(getattr(solver, "_phase_times", None) or {}))

        morpho.Morpho_pairwise.run = wrapped
        try:
            yield marks
        finally:
            morpho.Morpho_pairwise.run = run

    def window(self, seconds: float, traced: bool = False) -> dict:
        P = len(self.raw)
        rng = np.random.default_rng([self.seed, 2])
        pick = set(rng.choice(P, min(int(self.workload.get("judged", JUDGED_PAIRS)), P), replace=False).tolist())
        marks, span = [], None
        with contextlib.ExitStack() as outer:
            if traced and self.program == "port":
                outer.enter_context(self._phase_marks(marks))
            stack = contextlib.ExitStack()
            k, t_first, t_last = 0, None, None
            while True:
                if traced and k == 1:
                    span = trace.Span(units=2, extra={"phases": marks})
                    before = self._counters()
                    stack.enter_context(trace.capture(span))
                t_s = time.perf_counter()
                t_first = t_s if t_first is None else t_first
                out = self._align(k % P)
                self._sync()
                t_last = time.perf_counter()
                if k in pick:
                    self.kept[k] = (k % P, out)
                if traced and k == 2:
                    stack.close()
                    span.counters = {n: v - before[n] for n, v in self._counters().items()}
                k += 1
                if k >= 3 and (traced or t_last - t_first >= seconds):
                    break  # a traced run's window ends with its span
            stack.close()
        return {"e2e": {"morpho_pairs_min": k / (t_last - t_first) * 60.0}, "attempted": k,
                "window_s": t_last - t_first, "span": span}

    def release(self):
        import torch

        self.pairs = None
        if str(self.device).startswith("cuda"):
            torch.cuda.empty_cache()

    def judge(self):
        """[(name, value, limit)]: the worst judged pair's gaps to the
        reference, and how far its rigid and non-rigid coordinates miss the
        moving cells' places before the planted rotation and shift."""
        ref = self.reference
        limits = dict(ref.LIMITS, **{k: float(v) for k, v in self.config["planted_limits"].items()})
        worst = {k: 0.0 for k in limits}
        failed = 0
        for _, (i, got) in sorted(self.kept.items()):
            p = self.raw[i]
            want = ref.align((p["fixed"], p["fixed_pcs"]), (p["moving"], p["moving_pcs"]), self.settings, self.device)
            extent = float(np.ptp(p["fixed"], axis=0).max())
            gap = lambda a, b: float(np.abs(a - b).max()) / extent
            # the root mean square miss: a rigid miss grows towards the section's edges
            miss = lambda a: float(np.sqrt(np.mean((a - p["truth"]) ** 2))) / extent
            gaps = {
                "rigid_coord_gap": gap(got["rigid"], want["rigid"]),
                "nonrigid_coord_gap": gap(got["nonrigid"], want["nonrigid"]),
                "rotation_gap": float(np.abs(got["R"] - want["R"]).max()),
                "planted_rigid_gap": miss(got["rigid"]),
                "planted_nonrigid_gap": miss(got["nonrigid"]),
            }
            gaps = {k: (v if np.isfinite(v) else float("inf")) for k, v in gaps.items()}
            failed += any(v > limits[k] for k, v in gaps.items())
            for k, v in gaps.items():
                worst[k] = max(worst[k], v)
            self._sync()
        return [(k, worst[k], limits[k]) for k in worst], failed, len(self.kept)
