"""The port's profiling tools (``examples/prof*.py``) on the CPU at a small
size, and what they share (``utils/profiling.py``, ``scenes.bench_scene``'s
room, ``binning``'s stages).

Each tool's ``main([... "--cpu"])`` prints its JSON result lines with
finite, positive host times (device times are null off the card).  The
scenes are the JAX root scripts' draws bit for bit: ``kind="room"`` is
``prof.py``'s ``make_scene(kind="room")`` and ``kind="uniform"`` is
``bench.py``'s ``make_scene``.  ``prof.py``'s own uniform cloud draws
``bench.py``'s distributions in another order (scales and opacities
before the rotations), so it shares only the means with the bench scene
(held here too).  ``prof_bin``'s last prefix pipeline gives the table,
ranges and inverse permutation of ``bin_gaussians`` + the gather, bit for
bit; ``prof``'s core forward + backward gives ``core_bwd_reference``'s
rows; ``prof_jvp``'s tangents are ``jax.jacfwd`` of the JAX package's
``lie.apply_twist`` at the identity (rtol 1e-6); ``prof_ab`` parses its
overrides as the JAX tool's own loop does and refuses the TPU-only
fields.  Without CUDA every tool raises unless the CPU is named.  The
per-op table's reading of device events is held on stand-in events.
"""

import ast
import json
import math
import re
import tempfile
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.models import lie as jax_lie
from diff_gaussian_rasterization_tpu_torch.config import TPU_ONLY_FIELDS
from diff_gaussian_rasterization_tpu_torch.examples import (
    bench, prof, prof_ab, prof_bin, prof_jvp, prof_trace, prof_track)
from diff_gaussian_rasterization_tpu_torch.ops import blend
from diff_gaussian_rasterization_tpu_torch.ops.kernels.render import (
    ROW_COLUMNS, core_bwd_reference, core_fwd_reference)
from diff_gaussian_rasterization_tpu_torch.ops.rasterize import prepare
from diff_gaussian_rasterization_tpu_torch.scenes import bench_scene
from diff_gaussian_rasterization_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
P, H, W = 2048, 48, 64
SIZE = ["--gaussians", str(P), "--height", str(H), "--width", str(W),
        "--samples", "1", "--inner", "2"]
CPU = torch.device("cpu")

# tool, its arguments besides SIZE and --cpu, its stages
TOOLS = {
    "prof": (prof, [], list(prof.STAGES)),
    "prof_room": (prof, ["--scene", "room"], list(prof.STAGES)),
    "prof_bin": (prof_bin, [], [s for s, _ in prof_bin.STAGES]),
    "prof_jvp": (prof_jvp, [], ["forward", "jvp6_light", "jvp6_full"]),
    "prof_trace": (prof_trace, [], [None]),
    "prof_track": (prof_track, ["--inner", "1", "--gaussians", "512"],
                   [None]),
    "prof_ab": (prof_ab, ["tile_h=16", "tile_w=16"],
                ["baseline", "override"]),
}


def positive(x):
    return isinstance(x, float) and math.isfinite(x) and x > 0


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_prints_its_lines(name, capsys, tmp_path):
    mod, extra, stages = TOOLS[name]
    argv = SIZE + extra + ["--cpu"]
    if mod in (prof_trace, prof_track):
        argv = [str(tmp_path)] + argv
    ret = mod.main(argv)
    lines = ret if isinstance(ret, list) else [ret]
    printed = [json.loads(x) for x in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == lines
    tool = mod.__name__.rsplit(".", 1)[-1]
    for line, stage in zip(lines, stages, strict=True):
        assert line["tool"] == tool and "error" not in line
        assert line.get("stage", line.get("config")) == stage
        assert positive(line["host_ms"]), line
        assert all(positive(x) for x in line["samples_ms"])
        # off the card: device times not measured, no card fields
        assert line["device_ms"] is None and line["idle_share"] is None
        assert line["device"] == "cpu" and "card" not in line
    if mod is prof:
        n = lines[0]["instances"]
        assert 0 < n <= lines[0]["max_instances"]
        assert lines[0]["max_instances"] == bench.instance_budget(n)
        assert lines[0]["scene"] == (extra[1] if extra else "uniform")
    if mod is prof_bin:
        assert lines[0]["diff_host_ms"] is None
        by = {x["stage"]: x for x in lines}
        for stage, before in prof_bin.STAGES[1:]:
            np.testing.assert_allclose(
                by[stage]["diff_host_ms"],
                by[stage]["host_ms"] - by[before]["host_ms"])
    if mod is prof_jvp:
        for line in lines[1:]:
            np.testing.assert_allclose(
                line["ratio_host"], line["host_ms"] / lines[0]["host_ms"])
    if mod in (prof_trace, prof_track):
        assert Path(lines[0]["trace"]) == tmp_path / f"{tool}.json"
        assert json.loads(Path(lines[0]["trace"]).read_text())
        assert lines[0]["ops"] == [] and lines[0]["host_syncs"] is None
        # the program's records a step: host times, stream times null
        table = lines[0]["spans"]
        top = "render" if mod is prof_trace else "track.frame"
        assert table["spans"][top]["calls"] == 1.0
        for s in table["spans"].values():
            assert positive(s["host_ms"]) and s["host_self_ms"] >= 0
            assert s["stream_ms"] is None and s["stream_self_ms"] is None
        assert table["counters"]["render.slots"] > 0
    if mod is prof_ab:
        assert lines[1]["overrides"] == {"tile_h": 16, "tile_w": 16}
        assert (lines[0]["tile"], lines[1]["tile"]) == ("32x32", "16x16")
        # A, B, B, A: two turns of each
        assert len(lines[0]["samples_ms"]) == len(lines[1]["samples_ms"]) \
            == 2
        for line in lines:
            assert line["instances"] <= line["max_instances"] == \
                bench.instance_budget(line["instances"])
        np.testing.assert_allclose(lines[1]["delta_host_ms"],
                                   lines[1]["host_ms"] - lines[0]["host_ms"])


def root_function(script, name, **ns):
    """A function of a JAX root script, run alone at this file's size: the
    scripts set up paths, caches and their environment when imported."""
    path = ROOT / script
    fn = next(n for n in ast.parse(path.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = dict(np=np, jnp=jnp, P=P, H=H, W=W, **ns)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"),
         ns)
    return ns[name]


@pytest.mark.parametrize("mod, script", [(prof_trace, "prof_trace.py"),
                                         (prof_track, "prof_track.py")])
def test_trace_tool_defaults(mod, script):
    # the table's rows are the JAX tool's (its one slice of the sorted
    # rows), and the trace goes to the temporary directory, not the checkout
    text = (ROOT / script).read_text()
    rows = re.findall(r"key=lambda kv: -kv\[1\]\)(?:\s+for name, d in "
                      r"rows)?\[:(\d+)\]", text)
    assert [int(n) for n in rows] == [mod.TOP]
    assert mod.parse_args([]).outdir == tempfile.gettempdir()


@pytest.mark.parametrize("kind, script", [("room", "prof.py"),
                                          ("uniform", "bench.py")])
def test_scene_matches_the_jax_draws(kind, script):
    make = root_function(script, "make_scene")
    want = make(kind=kind) if script == "prof.py" else make()
    means, kw = bench_scene(p=P, height=H, width=W, device="cpu", kind=kind)
    assert set(want) == set(kw) | {"means3D"}
    for k, v in want.items():
        got = means if k == "means3D" else kw[k]
        np.testing.assert_array_equal(got.numpy(), np.asarray(v), err_msg=k)


def test_prof_uniform_cloud_shares_only_the_means():
    want = root_function("prof.py", "make_scene")(kind="uniform")
    means, kw = bench_scene(p=P, height=H, width=W, device="cpu")
    np.testing.assert_array_equal(means.numpy(), np.asarray(want["means3D"]))
    assert not np.array_equal(kw["scales"].numpy(),
                              np.asarray(want["scales"]))


def test_bench_scene_refuses_other_kinds():
    with pytest.raises(ValueError, match="kind"):
        bench_scene(p=8, height=4, width=4, device="cpu", kind="box")


def small_scene():
    args = bench.parse_args(SIZE + ["--cpu"])
    return bench.scene(args, CPU)


def test_prof_bin_last_stage_is_bin_gaussians_and_gather():
    means, kw, cam, cfg = small_scene()
    with torch.no_grad():
        o = prof_bin.pipelines(kw, cam, cfg)["s6 +gather"](means)
        _, binn, feat, _ = prepare(means, cam, cfg, cfg.max_instances,
                                   kw["gt_depth"], **prof.prep_kwargs(kw))
    for got, want in ((o["table"], feat[binn.gauss_id]),
                      (o["tile_start"], binn.tile_start),
                      (o["tile_stop"], binn.tile_stop),
                      (o["inv"], binn.inv), (o["g_s"], binn.gauss_id)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert o["last"] is o["table"]


def test_prof_bin_packed_sort_keeps_the_tiles():
    """s3b's packed key sorts by tile exactly and by depth quantized: the
    same multiset of (tile, Gaussian) pairs, the tile ids in order."""
    means, kw, cam, cfg = small_scene()
    fns = prof_bin.pipelines(kw, cam, cfg)
    with torch.no_grad():
        a, b = fns["s3 +sort (2 stable)"](means), fns[
            "s3b +sort (packed key)"](means)
    assert torch.equal(a["tile_s"], b["tile_s"])
    pairs = lambda o: sorted(zip(o["tile_s"].tolist(), o["g_s"].tolist()))
    assert pairs(a) == pairs(b)


def test_prof_core_rows_match_core_bwd_reference():
    means, kw, cam, cfg = small_scene()
    with torch.no_grad():
        table, binn, gt_tiles, core_kw = prof.front(means, kw, cam, cfg)
        ts, tp = binn.tile_start, binn.tile_stop
        rows = prof.core_bwd_rows(table, ts, tp, gt_tiles, core_kw)
        out = core_fwd_reference(table, ts, tp, gt_tiles, **core_kw)
        one, zero = torch.ones_like(out.depth), torch.zeros_like(out.depth)
        # prof.py:151-165: d color, depth, weight, median = 1; var, T = 0
        pix = blend.bwd_pixel_inputs(
            gt_tiles, out.color, out.depth, out.weight, out.var, out.t_final,
            torch.ones_like(out.color), one, one, zero, one, zero)
        want = core_bwd_reference(table, ts, tp, pix, **core_kw)
    assert rows.shape == (cfg.max_instances, 12)
    assert torch.equal(rows, want)
    # every column reached but the variance's, whose cotangent is 0
    reached = rows.abs().sum(0).gt(0).tolist()
    assert reached == [c != "depth_var" for c in ROW_COLUMNS]


def test_prof_jvp_tangents_match_jax():
    view = jnp.eye(4, dtype=jnp.float32)
    tw = jax.jacfwd(lambda xi: jax_lie.apply_twist(view, xi))(
        jnp.zeros((6,), jnp.float32))
    want = np.asarray(jnp.moveaxis(tw, -1, 0))
    got = prof_jvp.twist_tangents(torch.eye(4)).numpy()
    assert got.shape == (6, 4, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def jax_ab_overrides(items):
    """The JAX tool's own parse (``prof_ab.py``'s ``main``, its first two
    statements) of ``items`` as its command line."""
    path = ROOT / "prof_ab.py"
    main = next(n for n in ast.parse(path.read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    assert isinstance(main.body[1], ast.For)
    ns = dict(sys=types.SimpleNamespace(argv=["prof_ab.py", *items]))
    exec(compile(ast.Module(body=main.body[:2], type_ignores=[]), str(path),
                 "exec"), ns)
    return ns["over"]


@pytest.mark.parametrize("items", [
    ["opacity_cull=false", "normalize_quaternions=TRUE"],
    ["tile_h=16", "tile_w=8", "chunk=007"],
    ["alpha_min=0.05", "bin_margin_px=-2", "t_terminate=1e-3"],
    ["ref_depth_var=False", "instance_multiplier=4", "lowpass=0"],
])
def test_prof_ab_parses_as_the_jax_tool(items):
    want = jax_ab_overrides(items)
    got = prof_ab.parse_overrides(items)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


@pytest.mark.parametrize("field", TPU_ONLY_FIELDS)
def test_prof_ab_refuses_tpu_only_fields(field, capsys):
    with pytest.raises(ValueError, match=f"{field} is a TPU-only field"):
        prof_ab.main([f"{field}=true", "tile_h=16"] + SIZE + ["--cpu"])
    assert capsys.readouterr().out == ""


def test_prof_ab_refuses_unknown_fields():
    with pytest.raises(ValueError, match="no field 'tiles'"):
        prof_ab.parse_overrides(["tiles=4"])


@pytest.mark.parametrize("name", [n for n in TOOLS if n != "prof_room"])
def test_tool_raises_without_cuda(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, extra, _ = TOOLS[name]
    with pytest.raises(RuntimeError, match="--cpu"):
        mod.main(SIZE + extra)
    assert capsys.readouterr().out == ""


class _Event:
    def __init__(self, key, count, us, device="CUDA", annotation=False):
        self.key, self.count, self.self_device_time_total = key, count, us
        self.device_type = f"DeviceType.{device}"
        self.is_user_annotation = annotation


class _Profile:
    def __init__(self, events):
        self.events = events

    def key_averages(self):
        return self.events


def test_op_table_reads_the_cards_events():
    """Three steps' events: the table keeps the card's kernels and copies
    (not the host's operators, not annotations, not zero times), a step's
    ms and launches each, the longest first; the port's kernels by name
    and template arguments."""
    prof_ = _Profile([
        _Event("void (anonymous namespace)::render_fwd_kernel<4, false, "
               "false>(float const*, int const*, int const*)", 3, 480.0),
        _Event("void (anonymous namespace)::segment_sum_rows_kernel<12>("
               "float const*, int const*, int const*)", 3, 30.0),
        _Event("void (anonymous namespace)::segment_sum_rows_kernel<2>("
               "float const*, int const*, int const*)", 3, 12.0),
        _Event("Memcpy DtoD (Device -> Device)", 6, 60.0),
        _Event("aten::add", 90, 900.0, device="CPU"),
        _Event("Optimizer.step#Adam.step", 3, 500.0, annotation=True),
        _Event("void at::native::fill_kernel<float>()", 3, 0.0),
    ])
    events = profiling.device_events(prof_)
    assert [e.key[:12] for e in events] == [
        "void (anonym", "void (anonym", "void (anonym", "Memcpy DtoD "]
    rows, total = profiling.op_table(events, 3)
    assert [r["ms"] for r in rows] == [0.16, 0.02, 0.01, 0.004]
    assert [r["launches"] for r in rows] == [1.0, 2.0, 1.0, 1.0]
    np.testing.assert_allclose(total, 0.194)
    assert profiling.port_kernels(rows) == {
        "render_fwd_kernel<4, false, false>": {"ms": 0.16, "launches": 1.0},
        "segment_sum_rows_kernel<12>": {"ms": 0.01, "launches": 1.0},
        "segment_sum_rows_kernel<2>": {"ms": 0.004, "launches": 1.0}}
    profiling.require_device_events(events, "cuda")
    profiling.require_device_events([], "cpu")
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        profiling.require_device_events([], "cuda")
