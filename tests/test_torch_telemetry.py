"""The training loop's account of itself (``touchgs_torch/utils/
telemetry.py``) on the CPU: ``Trainer.events`` after a run, its count of
reads against the schedule, the step's stage marks in order, the spans'
exclusive accounting and their ``torch.profiler`` ranges.  The card's
side (stage events inside the CUDA graph, capture milliseconds) is in
``tests/test_torch_cuda.py``.  Imports neither JAX nor the JAX package.
"""
import numpy as np
import pytest
import torch

from touchgs_torch.config import (DensifyConfig, ModelConfig,
                                  RasterizeConfig, TrainConfig)
from touchgs_torch.data.cameras import Cameras
from touchgs_torch.data.scene import Scene
from touchgs_torch.train.trainer import Trainer
from touchgs_torch.utils import telemetry

W, H, N_VIEWS, N_SEED = 64, 48, 3, 300


def _look_at_c2w(eye) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)          # towards the origin
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:, 0], c2w[:, 1], c2w[:, 2], c2w[:, 3] = right, up, -fwd, eye
    return c2w


def _scene() -> Scene:
    rng = np.random.default_rng(0)
    c2w = np.stack([_look_at_c2w((2.0 * np.cos(t), 0.6, 2.0 * np.sin(t)))
                    for t in np.linspace(0.4, 1.4, N_VIEWS)])
    f = np.full(N_VIEWS, 60.0, np.float32)
    cams = Cameras(fx=f, fy=f.copy(), cx=np.full(N_VIEWS, W / 2, np.float32),
                   cy=np.full(N_VIEWS, H / 2, np.float32), c2w=c2w, width=W,
                   height=H)
    return Scene(
        cameras=cams,
        images=rng.uniform(0, 1, (N_VIEWS, H, W, 3)).astype(np.float32),
        depths=rng.uniform(1.5, 3.0, (N_VIEWS, H, W)).astype(np.float32),
        uncertainties=rng.uniform(0, 1, (N_VIEWS, H, W)).astype(np.float32),
        i_train=np.arange(N_VIEWS), i_eval=np.array([], int),
        seed_points=rng.uniform(-0.5, 0.5, (N_SEED, 3)).astype(np.float32),
        seed_colors=rng.uniform(0, 1, (N_SEED, 3)).astype(np.float32),
        scale_factor=1.0, transform=np.eye(4)[:3], name="telemetry")


def _cfg(**kw) -> TrainConfig:
    """The kernel path (its plain versions on the CPU), SH 0; refines at
    steps 2, 4 and 6, a growth 512 → 1024 at the first (300 live > half
    of 512), log points every 3 steps."""
    return TrainConfig(
        model=ModelConfig(max_gaussians=1024, sh_degree=0,
                          rasterize=RasterizeConfig(use_pallas=True)),
        densify=DensifyConfig(warmup_steps=2, refine_every=2,
                              stop_refine_at=100),
        init_capacity=512, grow_trigger_fraction=0.5, log_every=3, seed=0,
        **kw)


@pytest.fixture(scope="module")
def run7():
    """A CPU trainer after 7 steps (0–6) of ``_cfg``."""
    torch.set_num_threads(1)
    trainer = Trainer(_scene(), _cfg(), device="cpu")
    log = []
    trainer.run(7, log_fn=log.append)
    return trainer, log


def test_cpu_run_account_is_numbers(run7):
    trainer, _ = run7
    ev = trainer.events
    assert set(telemetry.new_events()) <= set(ev)
    for k, v in ev.items():
        assert type(v) in (int, float), (k, v)
    assert (ev["grow"], ev["refine"], ev["reset_opacity"], ev["capture"]) \
        == (1, 3, 0, 0)
    for name in ("fetch", "dispatch", "read", "refine", "grow", "log"):
        assert ev[f"host_{name}_ms"] > 0, name
    assert ev["host_reset_ms"] == ev["host_ckpt_ms"] == 0.0
    # the CPU runs the plain step: no capture, no replay, no stage sample
    assert ev["capture_ms"] == 0.0 and ev["stage_samples"] == 0
    assert all(ev[f"stage_{s}_ms"] == 0.0 for s in telemetry.STAGES)


def test_host_reads_follow_the_schedule(run7):
    trainer, log = run7
    cfg = trainer.cfg
    # a log point reads every metric and the guard's window max of
    # lossy_tiles (steps 0, 3 and 6)
    per_log = len([k for k in log[0] if k not in (
        "step", "lossy_tiles_window_max", "iters_per_sec")]) + 1
    assert [m["step"] for m in log] == [0, 3, 6] and per_log == 8
    # a refine (steps 2, 4, 6): the drain; the growth trigger's live count
    # while the capacity can grow (step 2 only: it grows to the maximum);
    # in ``densify.refine`` the live count, and per split sample the
    # nonzero of the children and the mask of their slots
    per_refine = 1 + 1 + 2 * cfg.densify.split_samples
    want = 3 * per_log + 3 * per_refine + 1
    assert trainer.events["host_reads"] == want, trainer.events


def test_step_marks_its_stages_in_order():
    trainer = Trainer(_scene(), _cfg(), device="cpu")
    marks = []
    with telemetry.marks_to(marks.append):
        trainer.train_step(trainer.state, *trainer._batch(0), 0,
                           trainer.view_index(0))
    # the nested raster_bwd closes inside the backward, where the
    # compositing's gradient reaches the per-Gaussian rows
    assert marks == ["start", "shade", "bin", "composite", "loss",
                     "raster_bwd", "backward", "adam", "stats"]
    assert [m for m in marks if m not in telemetry.NESTED] == [
        "start", *telemetry.STAGES]
    # without a hook a mark does nothing
    telemetry.mark("shade")
    assert len(marks) == 9


def test_spans_are_exclusive_and_timers_inclusive(monkeypatch):
    clock = iter(range(0, 10**9, 10**6))     # 1 ms a reading
    monkeypatch.setattr(telemetry.time, "perf_counter_ns",
                        lambda: next(clock))
    ev = {}
    with telemetry.span(ev, "dispatch"):          # reads 0 ... 5
        with telemetry.span(ev, "read"):          # 1, 2
            telemetry.count_read()
        with telemetry.timer(ev, "capture_ms", "capture"):   # 3, 4
            telemetry.count_read(n=2)
    assert ev == {"host_read_ms": 1.0, "capture_ms": 1.0,
                  "host_dispatch_ms": 4.0, "host_reads": 3}
    telemetry.count_read()                        # outside any span
    assert ev["host_reads"] == 3
    telemetry.count_read(ev)
    assert ev["host_reads"] == 4


class _FakeEvent:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def test_stage_events_pair_consecutive_marks():
    st = telemetry.StageEvents()
    st.marks = [(n, _FakeEvent(t)) for n, t in (
        ("start", 0.0), ("shade", 0.5), ("composite", 2.0), ("shade", 2.25),
        ("stats", 3.0))]
    assert st.ms() == {"shade": 0.75, "composite": 1.5, "stats": 0.75}
    ev = telemetry.new_events()
    telemetry.add_stages(ev, st.ms())
    telemetry.add_stages(ev, {})                  # nothing replayed
    assert ev["stage_samples"] == 1 and ev["stage_shade_ms"] == 0.75
    assert telemetry.StageEvents().ms() == {}


def test_nested_stage_leaves_the_stages_and_their_sum_alone():
    """``raster_bwd``, marked inside the backward, is timed from the loss
    mark and splits nothing: the stages, ``stage_backward_ms`` (loss to
    backward) and the sum of every ``stage_*_ms`` read as without it; the
    nested time goes to ``nested_raster_bwd_ms``."""
    times = (("start", 0.0), ("shade", 0.5), ("bin", 0.75),
             ("composite", 1.75), ("loss", 2.0), ("backward", 6.5),
             ("adam", 7.0), ("stats", 7.25))
    plain, nested = telemetry.StageEvents(), telemetry.StageEvents()
    plain.marks = [(n, _FakeEvent(t)) for n, t in times]
    nested.marks = (plain.marks[:5] + [("raster_bwd", _FakeEvent(4.25))]
                    + plain.marks[5:])
    assert nested.ms() == plain.ms()
    assert nested.ms()["backward"] == 4.5
    assert nested.nested_ms() == {"raster_bwd": 2.25}
    assert plain.nested_ms() == {}
    ev_plain, ev_nested = telemetry.new_events(), telemetry.new_events()
    telemetry.add_stages(ev_plain, plain.ms())
    telemetry.add_stages(ev_nested, {**nested.ms(), **nested.nested_ms()})

    def stage_sum(ev):
        return sum(v for k, v in ev.items()
                   if k.startswith("stage_") and k.endswith("_ms"))

    assert stage_sum(ev_nested) == stage_sum(ev_plain) == 7.25
    assert ev_nested["stage_backward_ms"] == ev_plain["stage_backward_ms"]
    assert ev_nested["nested_raster_bwd_ms"] == 2.25
    assert ev_plain["nested_raster_bwd_ms"] == 0.0
    assert ev_nested["stage_samples"] == 1


def test_tile_counters_equal_a_count_of_the_lists(monkeypatch):
    """At each log point the account adds the last step's lists: their
    entries (slots that hold a Gaussian), their slots (n_tiles × k_tile)
    and one sample, as a direct count of K1's lists of those steps reads;
    the host's reads are those of the schedule alone."""
    from touchgs_torch.ops import rasterize_cuda as rc

    torch.set_num_threads(1)
    lists = []
    plain = rc.slot_rows

    def counted(attrs, *args, **kw):
        gidx, rows = plain(attrs, *args, **kw)
        n = attrs.shape[0] - rc.plain.DEAD_SPREAD
        lists.append((int((gidx < n).sum()), gidx.numel()))
        return gidx, rows

    monkeypatch.setattr(rc, "slot_rows", counted)
    trainer = Trainer(_scene(), _cfg(), device="cpu")
    log = []
    trainer.run(7, log_fn=log.append)
    ev = trainer.events
    logged = [m["step"] for m in log]
    assert logged == [0, 3, 6] and len(lists) == 7
    assert ev["tile_samples"] == 3
    assert ev["tile_entries"] == sum(lists[s][0] for s in logged)
    assert ev["tile_slots"] == sum(lists[s][1] for s in logged)
    assert 0 < ev["tile_entries"] < ev["tile_slots"]
    assert type(ev["tile_entries"]) is int and type(ev["tile_slots"]) is int


def test_spans_open_profiler_ranges_only_under_the_profiler(monkeypatch):
    """Under ``torch.profiler`` the spans are ``touchgs.*`` host ranges, and
    not user annotations, which the trace would also lay on the device's
    track; without the profiler no range is opened."""
    from torch.profiler import ProfilerActivity, profile

    torch.set_num_threads(1)
    trainer = Trainer(_scene(), _cfg(), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run(3)
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("touchgs.")]
    assert {f"touchgs.{s}" for s in ("fetch", "dispatch", "read", "grow",
                                     "refine", "log")} <= {
        e.name() for e in ranges}
    assert not any(e.is_user_annotation() for e in ranges)

    opened = []
    real = torch._C._profiler._RecordFunctionFast
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: opened.append(name) or real(name))
    trainer.run(5)
    assert trainer.events["refine"] == 2 and not opened
