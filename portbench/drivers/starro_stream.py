"""Drives `spateo_tpu_torch.segmentation.starro.starro_em_bp_stream` through
a window.

The stream takes host rasters and yields each tile's (scores, mask) in
order, a chunk of up to `em_batch` same-shape tiles at a time, each chunk
once the next one has been computed. The window opens when the first chunk
of the measured stream has been yielded (the pipeline is then full) and
closes at the end of the first chunk that ends `seconds` later after a
whole number of tile rows: the rate is the pixels of the chunks yielded in
between over that time, so a stall anywhere in the window counts.

A traced run profiles the two chunks that follow the window's first, and
its window ends with them. Of the work the stream does while they are
yielded, the computing is of the two chunks after them (the stream yields a
chunk after it has computed the next); the span's `extra` names those
tiles' shapes.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

from portbench import load_by_path, trace

#: Each run judges this many tiles unless the workload names its own
#: `judged`, drawn from the seed among the first `JUDGE_CHUNKS` chunks of
#: the window (a window holds more).
JUDGED_TILES = 6
JUDGE_CHUNKS = 8
#: The longest window the chunk plan covers, in tiles.
MAX_TILES = 50_000


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int, device: str, program: str = "port"):
        self.config, self.workload, self.seed, self.device = config, workload, int(seed), device
        self.settings = dict(config["settings"])
        self.program = program
        self.reference = load_by_path(f"reference/{config['reference']}.py")
        self.tiles = None
        self.judged = {}  # tile index -> (mask, scores)

    # -- set-up -------------------------------------------------------------
    def setup(self):
        rasters = load_by_path(f"traffic/{self.workload['generator']}.py")
        self.tiles = rasters.Tiles(self.workload["params"], self.seed, self.device)
        shapes = [self.tiles.shape(i) for i in range(MAX_TILES)]
        self.chunk_sizes = rasters.chunks(shapes, int(self.settings["em_batch"]))
        # warm up one chunk of each (shape, size) that a pass over the traffic forms
        seen, warm, i = set(), [], 0
        span = max(len(self.tiles.shapes_per_pass()), int(self.settings["em_batch"]))
        for n in self.chunk_sizes:
            if i >= span:
                break
            key = (self.tiles.shape(i), n)
            if key not in seen:
                seen.add(key)
                warm += [self.tiles.get(i + j) for j in range(n)]
            i += n
        for _ in self._stream(iter(warm)):
            pass
        self._sync()

    def _stream(self, tiles):
        if self.program == "control":
            return self.reference.control_stream(tiles, self.settings, self.device)
        from spateo_tpu_torch.segmentation.starro import starro_em_bp_stream

        return starro_em_bp_stream(tiles, device=self.device, **self.settings)

    def _sync(self):
        import torch

        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()

    def _counters(self) -> dict:
        from spateo_tpu_torch.ops.bp_cuda import bp_step

        return {"bp_step.launches": bp_step.launches, "bp_step.delta_launches": bp_step.delta_launches}

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float, traced: bool = False) -> dict:
        sizes = self.chunk_sizes
        ends = np.cumsum(sizes)  # tile count at the end of each chunk
        row = self.tiles.row_tiles()
        period = 1 if row == 1 else 2  # chunks a row of a section: its full tiles, then its edge tile
        rng = np.random.default_rng([self.seed, 1])
        # a traced window ends after its third chunk: judge among those
        last = min(JUDGE_CHUNKS, 3) if traced else JUDGE_CHUNKS
        candidates = np.arange(ends[0], ends[last])
        n = min(int(self.workload.get("judged", JUDGED_TILES)), len(candidates))
        pick = set(rng.choice(candidates, n, replace=False).tolist())
        span, stack = None, contextlib.ExitStack()
        t0 = t_end = None
        c = 0  # chunks yielded
        pixels = 0
        counted = 0
        attempted = 0
        chunk_s = []
        stream = self._stream(self.tiles.stream())
        try:
            for i, (scores, mask) in enumerate(stream):
                if i in pick:
                    self.judged[i] = (mask, scores)
                if i + 1 < ends[c]:
                    continue
                now = time.perf_counter()
                if c == 0:
                    t0 = now
                else:
                    chunk_s.append(now - t_end if t_end is not None else now - t0)
                    counted += 1
                    pixels += sum(int(np.prod(self.tiles.shape(j))) for j in range(ends[c - 1], ends[c]))
                    attempted += sizes[c]
                    t_end = now
                if traced and c == 1:
                    span = trace.Span(units=2, extra={
                        "computed_tiles": [self.tiles.shape(j) for j in range(ends[2], ends[4])],
                        "msg_dtype": self.settings["bp_msg_dtype"]})
                    before = self._counters()
                    stack.enter_context(trace.capture(span))
                if traced and c == 3 and span is not None:
                    stack.close()
                    span.counters = {k: v - before[k] for k, v in self._counters().items()}
                c += 1
                if traced and c > 3:
                    break  # a traced run's window ends with its span
                if counted and now - t0 >= seconds and counted % period == 0 and c > 3:
                    break
        finally:
            stack.close()
            stream.close()
        self._sync()
        window_s = t_end - t0
        print("portbench: seconds a chunk " + " ".join(f"{x:.3f}" for x in chunk_s), file=sys.stderr)
        return {
            "e2e": {"starro_mpix_s": pixels / 1e6 / window_s},
            "attempted": attempted,
            "window_s": window_s,
            "span": span,
        }

    def release(self):
        """Drop the program's state; the judged tiles' outputs go to the host."""
        import torch

        self.judged = {i: (np.asarray(m, bool), None if s is None else s.float().cpu().numpy())
                       for i, (m, s) in self.judged.items()}
        if str(self.device).startswith("cuda"):
            torch.cuda.empty_cache()

    # -- correctness ---------------------------------------------------------
    def judge(self):
        """[(name, value, limit)]: the worst judged tile's mask mismatch and
        mean score gap against the reference, each with its limit."""
        import torch

        ref = self.reference
        worst = {"mask_mismatch_share": 0.0, "score_mean_gap": 0.0}
        failed = 0
        for i, (mask, scores) in sorted(self.judged.items()):
            raster = self.tiles.get(i)
            r_mask, r_scores = ref.mask_and_scores(raster, self.settings, self.device)
            got = {"mask_mismatch_share": ref.mismatch_share(mask, r_mask),
                   "score_mean_gap": ref.score_gap(scores, r_scores)}
            failed += any(v > ref.LIMITS[k] for k, v in got.items())
            for k, v in got.items():
                worst[k] = max(worst[k], v)
            if str(self.device).startswith("cuda"):
                torch.cuda.empty_cache()
        checks = [(k, worst[k], ref.LIMITS[k]) for k in worst]
        return checks, failed, len(self.judged)
