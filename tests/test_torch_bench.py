"""The port's benchmark drivers (``examples/bench.py``, ``bench_tracking.py``,
``bench_mapping.py``) on the CPU at a small size, and the mesh's device.

Each driver's ``main([... "--cpu"])`` prints one JSON line with the JAX
driver's metric name and unit, the samples and its guard's fields.
``bench``'s step (the loss over four outputs and its gradients w.r.t. the
means and the view matrix) is held against ``jax.grad`` of the same loss
through the JAX package's ``rasterize`` (XLA backend) on the JAX driver's
own draws: the loss at rtol 1e-5, the gradients at ``test_torch_grad.py``'s
rtol 5e-4 with its atol 2e-5 scaled by each column's largest value (the
bench loss's gradients reach ~250), and per column no further from the
port's float64 gradient than twice the JAX package's float32 one;
``bench_mapping``'s first two losses against two
JAX ``map_step``s on the same model at ``test_torch_mapping.py``'s (rtol
1e-5 for step 0, 1e-4 for step 1); ``bench --ranks 2``'s tile-sharded,
shard-binned step against the single-device step (outputs bit-equal,
gradients within 2e-6 of each column's largest value).  Without CUDA,
``make_mesh``, ``spawn``/``start`` and the drivers raise unless the CPU is
named.  A card's line finds its name and power limit in nvidia-smi's rows
by the card's UUID.
"""

import ast
import json
import multiprocessing
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_gaussian_rasterization_tpu.camera import Camera as JaxCamera
from diff_gaussian_rasterization_tpu.config import RasterConfig as JaxConfig
from diff_gaussian_rasterization_tpu.models import slam as jslam
from diff_gaussian_rasterization_tpu.models.gaussians import (
    DensifyState as JaxDensifyState)
from diff_gaussian_rasterization_tpu.ops.rasterize import (
    count_instances as jax_count_instances, rasterize as jax_rasterize)
from diff_gaussian_rasterization_tpu_torch.examples import (
    bench, bench_mapping, bench_tracking)
from diff_gaussian_rasterization_tpu_torch.parallel import mesh as pmesh

import torch_dist_cases as cases
from test_torch_mapping import jax_bench_make_model

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
P, H, W = 2048, 48, 64
SIZE = ["--gaussians", str(P), "--height", str(H), "--width", str(W),
        "--samples", "2", "--inner", "2"]
SAMPLE_KEYS = ("samples_ms", "mean_ms", "median_ms", "min_ms", "max_ms",
               "spread")

# driver, extra flags, (metric, unit), the guard's fields
DRIVERS = {
    "bench": (bench, [], ("fwd_bwd_rasterizations_per_sec_1200x680",
                          "renders/s"), ("ms_per_fwd_bwd", "instances",
                                         "max_instances")),
    "bench_ranks2": (bench, ["--ranks", "2", "--backend", "gloo"],
                     ("fwd_bwd_rasterizations_per_sec_1200x680",
                      "renders/s"), ("ms_per_fwd_bwd", "rank_median_ms")),
    "bench_tracking": (bench_tracking, [],
                       ("tracking_steps_per_sec_1200x680",
                        "tracked frames/s"),
                       ("ms_per_tracked_frame", "pose_err_before",
                        "pose_err_after")),
    "bench_mapping": (bench_mapping, [],
                      ("mapping_steps_per_sec_1200x680_500k",
                       "map steps/s"),
                      ("ms_per_map_step", "loss_step0", "loss_step1")),
}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_prints_the_jax_metric_line(name, capsys):
    mod, extra, (metric, unit), fields = DRIVERS[name]
    line = mod.main(SIZE + extra + ["--cpu"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == line
    assert (line["metric"], line["unit"]) == (metric, unit)
    assert line["value"] > 0 and np.isfinite(line["value"])
    assert all(k in line for k in SAMPLE_KEYS + fields), sorted(line)
    assert len(line["samples_ms"]) == 2 and "error" not in line
    assert line["min_ms"] <= line["median_ms"] <= line["max_ms"]
    # the JAX drivers' rate: every timed step over every timed second
    np.testing.assert_allclose(line["mean_ms"], np.mean(line["samples_ms"]))
    np.testing.assert_allclose(line["value"], 1e3 / line["mean_ms"])
    assert line[fields[0]] == line["mean_ms"]
    assert line["device"] == "cpu" and "card" not in line
    assert (line["gaussians"], line["res"]) == (P, f"{W}x{H}")
    if name == "bench_tracking":
        assert line["pose_err_after"] < line["pose_err_before"]
        assert (line["method"], line["iters"], line["pyramid"],
                line["coarse_iters"], line["freeze_binning"],
                line["line_search"]) == ("gn", 2, 2, 3, True, False)
    if name == "bench_mapping":
        assert line["loss_step1"] < line["loss_step0"]
    if name.startswith("bench_ranks"):
        assert line["devices"] == 2 and len(line["rank_median_ms"]) == 2
        assert line["ranks_from"] == "--ranks"
    elif name == "bench":
        assert line["devices"] == 1 and line["ranks_from"] == "cpu"
        assert line["instances"] <= line["max_instances"]


def jax_bench_make_scene():
    """The root ``bench.py``'s ``make_scene`` at this file's size, run
    alone: the module itself sets up a compile cache and reads its
    environment when imported."""
    path = ROOT / "bench.py"
    fn = next(n for n in ast.parse(path.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "make_scene")
    ns = dict(np=np, jnp=jnp, P=P, H=H, W=W)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"),
         ns)
    return ns["make_scene"]()


# test_torch_grad.py's atol (2e-5) taken relative to each column's largest
# gradient: its small scenes' gradients are of order 1, while this loss
# sums four outputs over 3,072 pixels and the gradients reach ~250.  Both
# packages' float32 sums then carry ~1e-5 of that (the JAX package's own
# float32 gradient is up to 1.4e-5 of its column's largest value from the
# float64 one), beyond 2e-5 + 5e-4 |g| on entries near 0.
BENCH_ATOL = 2e-5


def test_bench_step_matches_jax():
    scene = jax_bench_make_scene()
    cfg = JaxConfig(tile_h=32, tile_w=32)
    jcam = lambda v: JaxCamera(viewmatrix=v, tanfovx=0.82, tanfovy=0.47,
                               height=H, width=W)
    view = jnp.eye(4, dtype=jnp.float32)
    kw = {k: v for k, v in scene.items() if k != "means3D"}
    n_inst = int(jax_count_instances(
        scene["means3D"], jcam(view), cfg, opacities=kw["opacities"],
        scales=kw["scales"], rotations=kw["rotations"],
        colors_precomp=kw["colors_precomp"]))
    budget = int(-(-n_inst * 1.1 // 1024) * 1024)

    def loss(means, v):   # bench.py:255-259
        out = jax_rasterize(means, jcam(v), cfg, backend="xla",
                            max_instances=budget, **kw)
        return (jnp.sum(out.color) + 0.3 * jnp.sum(out.depth)
                + 0.1 * jnp.sum(out.depth_median)
                + 0.1 * jnp.sum(out.opacity_map))

    lj, (gmj, gvj) = jax.value_and_grad(loss, argnums=(0, 1))(
        scene["means3D"], view)

    args = bench.parse_args(SIZE + ["--cpu"])
    means, tkw, cam, tcfg = bench.scene(args, torch.device("cpu"))
    for k, v in scene.items():   # the same draws
        got = means if k == "means3D" else tkw[k]
        np.testing.assert_array_equal(got.numpy(), np.asarray(v), err_msg=k)
    assert tcfg.max_instances == budget
    lt, out, gm, gv = bench.fwd_bwd(means, cam.viewmatrix, cam, tcfg, tkw)
    assert bench.guard((lt, out, gm, gv)) == ""
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    # the port's own path in float64, the referee of float32 rounding
    f64 = lambda x: x.double() if x.is_floating_point() else x
    _, _, gm64, gv64 = bench.fwd_bwd(
        means.double(), cam.viewmatrix.double(),
        cam.replace(viewmatrix=cam.viewmatrix.double()), tcfg,
        {k: f64(v) for k, v in tkw.items()})
    for name, got, want, ref in (("means3D", gm, gmj, gm64),
                                 ("view", gv, gvj, gv64)):
        got, want, ref = got.numpy(), np.asarray(want), ref.numpy()
        col = np.abs(want).max(axis=0)
        assert col.max() > 0, name
        err = np.abs(got - want)
        tol = BENCH_ATOL * col + 5e-4 * np.abs(want)
        assert np.all(err <= tol), (name, err.max(), np.argmax(err - tol))
        # per column, no further from float64 than the JAX package's
        # float32 (twice its error, or 1e-5 of the column's largest value)
        e_port = np.abs(got - ref).max(axis=0)
        e_jax = np.abs(want - ref).max(axis=0)
        assert np.all(e_port <= np.maximum(
            2 * e_jax, 1e-5 * np.abs(ref).max(axis=0))), (name, e_port, e_jax)


def test_bench_mapping_losses_match_jax():
    line = bench_mapping.main(SIZE + ["--cpu"])
    model = jax_bench_make_model()(seed=0, p=P)
    cfg = JaxConfig(tile_h=32, tile_w=32)
    cam = JaxCamera(viewmatrix=jnp.eye(4, dtype=jnp.float32), tanfovx=0.82,
                    tanfovy=0.47, height=H, width=W)
    gt = jslam.render_model(model, cam, cfg)
    cfg = cfg.replace(max_instances=int(
        -(-int(gt.num_rendered) * 1.1 // 1024) * 1024))
    assert line["max_instances"] == cfg.max_instances
    rgbs = jnp.clip(gt.color * 0.9 + 0.05, 0, 1)[None]
    mcfg = jslam.MappingConfig()
    opt_state = jslam.make_map_optimizer(mcfg).init(
        jslam.model_params(model))
    dstate = JaxDensifyState.zero(model.capacity)
    args = (cam.viewmatrix[None], rgbs, gt.depth[0][None],
            jnp.ones((1,), jnp.float32), cfg, mcfg, H, W, cam.tanfovx,
            cam.tanfovy, 1)
    m1, o1, d1, loss0, _ = jslam.map_step(model, opt_state, dstate, *args)
    _, _, _, loss1, _ = jslam.map_step(m1, o1, d1, *args)
    np.testing.assert_allclose(line["loss_step0"], float(loss0), rtol=1e-5)
    np.testing.assert_allclose(line["loss_step1"], float(loss1), rtol=1e-4)
    assert float(loss1) < float(loss0)


def test_bench_ranks_match_single_device():
    """Two gloo ranks, tile-sharded with sharded binning as ``bench --ranks
    2`` runs: both ranks bit-identical, and the loss and every output
    bit-equal to the single-device step's.  The gradients are not: each
    band sums its own instances' rows before the all-reduce adds the
    bands, so a Gaussian on two bands sums in another order (a few ulps,
    ~3e-7 of the column's largest value here); they are held at 2e-6 of
    it, the bench-scale column term of ``chip_smoke.py``'s row rule."""
    argv = SIZE + ["--cpu"]
    ranks = pmesh.spawn(cases.bench_cases, 2, (argv,), backend="gloo",
                        device_type="cpu", timeout=240, threads=1)
    args = bench.parse_args(argv)
    means, kw, cam, cfg = bench.scene(args, torch.device("cpu"))
    loss, out, gm, gv = bench.fwd_bwd(means, cam.viewmatrix, cam, cfg, kw)
    want = dict(loss=loss, g_means=gm, g_view=gv, **cases._fields(out))
    assert ranks[0].keys() == ranks[1].keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
        got, v = ranks[0][k], v.numpy()
        if k.startswith("g_"):
            col = np.abs(v).max(axis=0)
            assert np.all(np.abs(got - v) <= 2e-6 * col), k
        else:
            np.testing.assert_array_equal(got, v, err_msg=k)


SMI = ("GPU-0a1b, NVIDIA H100 80GB HBM3, 700.00 W\n"
       "GPU-2c3d, NVIDIA H100 80GB HBM3, 500.00 W\n")


@pytest.mark.parametrize("uuid, name, want", [
    ("2c3d", "NVIDIA H100 80GB HBM3", "500.00 W"),   # the second row
    ("0A1B", "NVIDIA H100 80GB HBM3", "700.00 W"),
    (None, "NVIDIA H100 80GB HBM3", ValueError),      # two limits
    ("ffff", "NVIDIA A100", ValueError),              # no row
])
def test_card_fields_pick_the_cards_row(uuid, name, want):
    """The card's row is found by its UUID, never by the torch index,
    which ``CUDA_VISIBLE_DEVICES`` renumbers; rows that disagree or none
    raise rather than leave the power limit unsaid."""
    if want is ValueError:
        with pytest.raises(ValueError):
            bench.card_fields(SMI, uuid, name)
        return
    assert bench.card_fields(SMI, uuid, name) == {
        "card": "NVIDIA H100 80GB HBM3", "power_limit": want}
    one = SMI.splitlines()[0]
    assert bench.card_fields(one, None, "NVIDIA H100 80GB HBM3")[
        "power_limit"] == "700.00 W"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _never_run(rank, world):
    raise AssertionError("a rank started")


@pytest.mark.parametrize("call", ["make_mesh", "make_mesh_cuda", "spawn",
                                  "start"])
def test_mesh_defaults_to_cuda(call, no_cuda):
    before = multiprocessing.active_children()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if call == "make_mesh":
            pmesh.make_mesh()
        elif call == "make_mesh_cuda":
            pmesh.make_mesh((1,), ("tile",), device="cuda")
        else:
            getattr(pmesh, call)(_never_run, 2, backend="gloo")
    assert multiprocessing.active_children() == before


@pytest.mark.parametrize("mod", [bench, bench_tracking, bench_mapping],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_driver_raises_without_cuda(mod, no_cuda, capsys):
    with pytest.raises(RuntimeError, match="--cpu"):
        mod.main(SIZE)
    assert capsys.readouterr().out == ""
