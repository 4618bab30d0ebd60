"""One run of one benchmark cell on one NVIDIA card.

    python3 -m splatbench.run --workload replica-map --seed 1234 \\
        --seconds 45 --trace 0

From the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration (``configs/<name>.json``) and a traffic mix
(``mixes/<name>.json``, which names the program's entry it drives,
``entries/<entry>.py``); the
run builds the inputs from ``--seed``, runs the entry's set-up, times
``--seconds`` of back-to-back work on the host clock, and checks what the
timed path produced against the plain reference (``reference.py``), each
number against its limit (``limits/<cell>.json``).  With ``--trace 1`` it
then profiles a short stretch and reports the per-layer metrics
(``metrics/<name>.py``) instead of the end-to-end ones
(``endtoend/<name>.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), then ``checks``, each number compared beside its limit;
the same numbers are the last lines of standard error.  Without a CUDA
card, or with JAX or the JAX package loaded, it prints no result and
exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "diff_gaussian_rasterization_tpu")
CACHE = ".splatbench_cache"


def forbidden_modules(modules=None):
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (the port's own name only begins with the latter's)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def pin_caches(root: Path):
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths, so a second run in a checkout finds what the first built
    (the program's CUDA kernels build into its own package folder)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / CACHE / sub)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def note(msg: str):
    print(f"[splatbench +{time.perf_counter() - T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def power_limit():
    """The card's power limit (W) from nvidia-smi, None where it cannot
    say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def check(readings: dict, limits: dict):
    """``(correct, failed, checks)``: each reading beside its limit; a
    reading without a limit, or not finite, fails."""
    checks, failed = {}, 0
    for name, value in readings.items():
        lim = limits.get(name)
        ok = lim is not None and math.isfinite(value) and value <= lim
        failed += not ok
        checks[name] = {"value": value, "limit": lim}
    return failed == 0 and bool(checks), failed, checks


def open_cell(name: str, seed: int, root: Path, device="cuda", faults=None,
              overrides=None):
    """The cell's parts and its entry, inputs built from ``seed`` and the
    kernels ready: ``(bench, mix, limits, entry)``.  ``faults`` replaces
    program entries ({"map_step": fn, "track_frame": fn}) and
    ``overrides`` updates the configuration and mix (the tests' small
    sizes)."""
    import torch

    from . import cells, entry
    bench = cells.benchmark(root)
    cell = cells.workload(bench, name)
    cfg, mix = cells.config(cell["config"]), cells.mix(cell["traffic"])
    if overrides:
        _deep_update(cfg, overrides.get("config", {}))
        _deep_update(mix, overrides.get("mix", {}))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry.build_kernels(device)
    note(f"kernels ready; building {name} (seed {seed})")
    made = cells.entry(mix["entry"])(cfg, mix, seed, device)
    made.faults = dict(faults or {})
    return bench, mix, cells.limits(name), made


def window(entry, seconds: float):
    """Units of work back to back until ``seconds`` have passed (or the
    entry runs out), the device synchronized at the end: ``(units,
    seconds taken)``."""
    import torch
    t0 = time.perf_counter()
    units = 0
    while time.perf_counter() - t0 < seconds and not entry.exhausted:
        entry.step()
        units += 1
    if entry.dev.type == "cuda":
        torch.cuda.synchronize()
    return units, time.perf_counter() - t0


def run_cell(name: str, seed: int, seconds: float, trace: int, root: Path,
             device="cuda", faults=None, overrides=None):
    """Run one cell (arguments as :func:`open_cell`'s); returns the
    result's dict."""
    import torch

    from . import cells
    from . import trace as tr

    bench, mix, limits, entry = open_cell(name, seed, root, device, faults,
                                          overrides)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    entry.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    note(f"set-up done ({setup_s:.3f} s); window of {seconds} s")

    units, window_s = window(entry, seconds)
    note(f"window: {units} {entry.unit} in {window_s:.3f} s")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    entry.after_window()
    latencies = [d[3] for d in entry.done[:units]] \
        if hasattr(entry, "done") else None

    ctx = dict(units=units, window_s=window_s, setup_s=setup_s,
               latencies=latencies, host_s=window_s / max(units, 1))
    metrics, breakdown, dev_extra = {}, None, {}
    if trace:
        if not cuda:
            raise RuntimeError("--trace 1 reads the card's profile")
        n = mix["trace_units"]
        ctx["waits"], sites = tr.host_waits(entry.step, mix["wait_units"])
        note(f"host waits a unit {ctx['waits']}: {sites}")
        prof = tr.profile(entry.step, n, mix["entry"])
        ctx["prof"] = prof
        ctx["work"] = entry.work()
        for m in bench["per_layer"]:
            if not cells.reports(m, name, bench):
                continue
            v = cells.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        top = sorted(prof.kernels.items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [[k, v] for k, v in top],
                     "idle_gaps": [[k, v] for k, v in prof.gaps[:10]]}
        dev_extra = dict(busy_s=prof.busy_s, window_s=prof.window_s)
    else:
        for m in bench["end_to_end"]:
            if cells.reports(m, name, bench):
                v = cells.endtoend_reader(m["name"]).read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    entry.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    note("checking against the reference")
    readings = entry.readings()
    correct, failed, checks = check(readings, limits)
    device_info = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        count=1, memory_peak_bytes=peak, **dev_extra)
    if cuda:
        device_info["power_limit_w"] = power_limit()
    out = dict(correct=correct, attempted=units, failed=failed,
               metrics=metrics, device=device_info)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def _deep_update(d: dict, o: dict):
    for k, v in o.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            _deep_update(d[k], v)
        else:
            d[k] = v


def main(argv=None) -> int:
    args = parse_args(argv)
    root = Path.cwd()
    pin_caches(root)
    import torch
    from . import cells
    chips = cells.workload(cells.benchmark(root), args.workload)["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"splatbench: the cell needs {chips} CUDA card(s); this "
              f"machine has {have}: no result", file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, args.trace, root)
    bad = forbidden_modules()
    if bad:
        print(f"splatbench: loaded {', '.join(bad)}: no result",
              file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
