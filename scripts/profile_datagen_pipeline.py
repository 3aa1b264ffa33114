"""Where the 2D datagen pipeline's wall time goes on the card.

Runs ``sim.pipeline.pipeline_2d`` at the shape of chip_smoke's phase 9 (a):
synthetic icons 0-3 x grippers 0-31 x the 9,000-pose grid x 200 steps, one
wave an icon, npz shards written to a temporary directory. Prints, for each
wave, on one clock (seconds from the pipeline's start; the kernel's interval
from CUDA events placed against an event recorded at that start):

- when the host's bake ended, its launch interval and its wait for the
  wave's results;
- the kernel's interval on the card;

and the pipeline's own count of drains that ended while the next wave's
kernel still ran, and the card's idle seconds between kernels.

Then the same run with the npz writes left out, and one under
``torch.profiler``: the CUDA runtime calls with the most host time (a
blocking call shows there), and the share of the window in which the card
ran a kernel.

With ``--stream_trap`` the results are instead copied by ``.cpu()`` when
a wave is drained, on the stream that by then holds the next wave's kernel
(the order ``sim/datagen.py`` avoids), to show what the same figures read
when each drain waits for the next kernel.

    python scripts/profile_datagen_pipeline.py [--out F.json] [--trace T.json]
        [--stream_trap]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dgdm_tpu_torch.geom.contour import extract_contours, synthetic_icon  # noqa: E402
from dgdm_tpu_torch.sim import datagen, pipeline, rollout2d  # noqa: E402


class _Timeline:
    """Wraps the pipeline's launch and fetch to stamp each wave."""

    def __init__(self):
        self.waves: list = []
        self._launch = datagen.profile_pairs_2d
        self._fetch = datagen.fetch_pairs_2d
        self._make = datagen.stack_scenes

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.ref = torch.cuda.Event(enable_timing=True)
        self.ref.record()

        def stack(scenes):
            self.bake_end = time.perf_counter() - self.t0
            return self._make(scenes)

        def launch(*a, **k):
            t = time.perf_counter() - self.t0
            res = self._launch(*a, **k)
            self.waves.append({"bake_end": self.bake_end, "res": res,
                               "launch": (t, time.perf_counter() - self.t0)})
            return res

        def fetch(res):
            w = next(w for w in self.waves if w["res"] is res)
            t = time.perf_counter() - self.t0
            out = self._fetch(res)
            w["wait"] = (t, time.perf_counter() - self.t0)
            return out

        datagen.stack_scenes, datagen.profile_pairs_2d = stack, launch
        datagen.fetch_pairs_2d = fetch
        return self

    def __exit__(self, *exc):
        datagen.stack_scenes = self._make
        datagen.profile_pairs_2d = self._launch
        datagen.fetch_pairs_2d = self._fetch
        torch.cuda.synchronize()
        for w in self.waves:
            start, end = w.pop("res")["launch"]
            w["kernel"] = (self.ref.elapsed_time(start.event) / 1e3,
                           self.ref.elapsed_time(end.event) / 1e3)
        return False


def _stream_trap() -> None:
    """Results stay on the card until ``fetch`` copies them with ``.cpu()``."""
    datagen.download_async = lambda tensors: (dict(tensors), None)

    def fetch(res, keys):
        return [res[k][:, :res["n"]].cpu().numpy() for k in keys]

    datagen.fetch = fetch


def _run(objects, save_dir):
    with _Timeline() as tl:
        out = pipeline.pipeline_2d(objects, list(range(32)),
                                   save_dir=save_dir, device="cuda")
    return out, tl.waves


def _print(label, out, waves):
    print(f"{label}: wall {out['seconds']:.3f}s, kernel {out['kernel_s']:.3f}"
          f", bake {out['bake_s']:.3f}, wait {out['wait_s']:.3f}, write "
          f"{out['write_s']:.3f}, card idle between kernels "
          f"{out['gap_s']:.3f}, drains under the next kernel "
          f"{out['drains_under_kernel']} of {out['waves'] - 1}", flush=True)
    for i, w in enumerate(waves):
        print("  wave %d: bake end %.3f launch %.3f-%.3f kernel %.3f-%.3f "
              "wait %s" % (i, w["bake_end"], *w["launch"], *w["kernel"],
            "%.3f-%.3f" % w["wait"] if "wait" in w else "-"), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--trace", default="")
    ap.add_argument("--stream_trap", action="store_true")
    args = ap.parse_args(argv)
    if args.stream_trap:
        _stream_trap()
    objects = [(i, extract_contours(synthetic_icon(i))) for i in range(4)]
    rollout2d.LIBRARY.get()
    report = {"device": torch.cuda.get_device_name(0),
              "stream_trap": args.stream_trap}
    with tempfile.TemporaryDirectory() as tmp:
        pipeline.pipeline_2d(objects[:1], list(range(32)), device="cuda")
        for label, save in (("with writes", os.path.join(tmp, "a")),
                            ("without writes", None),
                            ("with writes again", os.path.join(tmp, "b"))):
            out, waves = _run(objects, save)
            _print(label, out, waves)
            report[label] = {"summary": out, "waves": waves}
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            out = pipeline.pipeline_2d(objects, list(range(32)),
                                       save_dir=os.path.join(tmp, "c"),
                                       device="cuda")
    table = prof.key_averages().table(sort_by="self_cpu_time_total",
                                      row_limit=25)
    print(table, flush=True)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    print(f"profiled run: wall {out['seconds']:.3f}s, card events "
          f"{busy:.3f}s", flush=True)
    report["profiled"] = {"summary": out, "card_event_s": busy}
    if args.trace:
        prof.export_chrome_trace(args.trace)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
