"""The port's background prefetch, preemption guard and metric logging
(rcdms_tpu_torch/data/prefetch.py, utils/preemption.py, utils/logging.py):
the JAX package's tests of the same modules (tests/test_prefetch_
preemption.py), ported, and a SIGTERM to a training CLI in a subprocess,
which saves a `preempted` checkpoint at the step boundary and exits 0."""

import itertools
import json
import logging
import os
import signal
import subprocess
import sys
import time

import pytest

from rcdms_tpu_torch.data.prefetch import (
    PrefetchIterator,
    required_feeder_depth,
)
from rcdms_tpu_torch.io.checkpoint import latest_step, restore_checkpoint
from rcdms_tpu_torch.utils.logging import (
    MetricLogger,
    ProfileWindow,
    StepTimer,
    profile_trace,
)
from rcdms_tpu_torch.utils.preemption import PreemptionGuard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_prefetch_preserves_order_and_values():
    it = PrefetchIterator(iter(range(100)), depth=2)
    assert list(it) == list(range(100))


def test_prefetch_propagates_errors():
    def gen():
        yield 1
        raise RuntimeError("boom")

    it = PrefetchIterator(gen(), depth=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetch_overlaps_production():
    """The producer runs ahead while the consumer is busy."""
    times = []

    def gen():
        for i in range(3):
            times.append(time.perf_counter())
            yield i

    it = PrefetchIterator(gen(), depth=2)
    time.sleep(0.3)  # consumer busy; the producer fills the queue
    assert len(times) >= 2
    assert list(it) == [0, 1, 2]


def test_prefetch_close_unblocks_blocked_producer():
    it = PrefetchIterator(itertools.count(), depth=1)
    assert next(it) == 0  # the producer now blocks refilling the queue
    it.close()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()
    it.close()  # idempotent
    with pytest.raises(StopIteration):
        next(it)


def test_required_feeder_depth():
    # consumer-held + queued + in-flight pack
    assert required_feeder_depth(1) == 3
    assert required_feeder_depth(2) == 4


def test_preemption_guard_flag_and_signal():
    guard = PreemptionGuard.install(signals=())
    assert not guard.should_stop
    guard.trigger()
    assert guard.should_stop
    guard.uninstall()

    guard = PreemptionGuard.install(signals=(signal.SIGUSR1,))
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.time() + 5
        while not guard.should_stop and time.time() < deadline:
            time.sleep(0.01)
        assert guard.should_stop
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGUSR1) == signal.SIG_DFL


def test_should_stop_global_single_process():
    guard = PreemptionGuard()
    assert not guard.should_stop_global()
    guard.trigger()
    assert guard.should_stop_global()


# ---- logging -------------------------------------------------------------


def test_metric_logger_writes_jsonl_and_skips_missing_trackers(
        tmp_path, monkeypatch, caplog):
    # the trackers' packages are missing: their imports fail
    for name in ("wandb", "comet_ml"):
        monkeypatch.setitem(sys.modules, name, None)
    with caplog.at_level(logging.WARNING):
        log = MetricLogger(str(tmp_path), report_to=("wandb", "comet_ml"),
                           run_config={"lr": 1e-5})
    assert "wandb requested but unavailable" in caplog.text
    assert "comet_ml requested but unavailable" in caplog.text
    log.log(0, {"loss": 1.5, "step_time": 2})
    log.log(5, {"loss": 0.25})
    log.close()
    lines = [json.loads(x) for x in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["loss"]) for r in lines] == [(0, 1.5), (5, 0.25)]
    assert lines[0]["step_time"] == 2.0 and "wall_time" in lines[0]


def test_step_timer_splits_data_and_step_time():
    timer = StepTimer()
    time.sleep(0.02)
    timer.data_loaded()
    time.sleep(0.02)
    step, data = timer.step_done()
    assert 0.02 <= data < step


def _traced_work():
    import torch

    torch.ones(64, 64) @ torch.ones(64, 64)


def test_profile_window_writes_a_trace_over_its_steps(tmp_path):
    window = ProfileWindow(str(tmp_path / "a"), start_step=1, num_steps=2)
    for step in range(5):
        window.tick(step)
        assert window.active == (step in (1, 2))
        _traced_work()
    window.close()
    assert os.listdir(tmp_path / "a") == ["steps_1-3.pt.trace.json"]
    trace = json.loads((tmp_path / "a" / "steps_1-3.pt.trace.json")
                       .read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_profile_window_closes_a_trace_when_the_loop_ends_inside(tmp_path):
    window = ProfileWindow(str(tmp_path), start_step=0, num_steps=10)
    for step in range(3):  # the loop ends (or is preempted) at step 3
        window.tick(step)
        _traced_work()
    assert window.active
    window.close()
    assert not window.active
    assert os.listdir(tmp_path) == ["steps_0-3.pt.trace.json"]
    off = ProfileWindow(None, 0, 1)
    off.tick(0)
    off.close()
    assert not off.active


def test_profile_trace_context(tmp_path):
    with profile_trace(str(tmp_path)):
        _traced_work()
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".pt.trace.json")
    with profile_trace(None):
        _traced_work()


# ---- SIGTERM to a training CLI -------------------------------------------

_WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from rcdms_tpu_torch.cli import train_stage2
from rcdms_tpu_torch.configs import DatasetConfig
from rcdms_tpu_torch.data.datasets import SyntheticStoryDataset
# many steps; the parent sends SIGTERM long before they finish
args = train_stage2.parse_args([
    "--synthetic", "--device", "cpu", "--output-dir", sys.argv[1],
    "--max-train-steps", "100000", "--batch-size", "1",
    "--checkpointing-steps", "100000", "--log-every", "1",
    "--report-to", "none", "--dtype", "float32"])
train_stage2.run(args, SyntheticStoryDataset(
    cfg=DatasetConfig(image_size=32, clip_size=28), num_items=2))
print("EXITED-CLEANLY", flush=True)
"""


def test_sigterm_saves_a_preempted_checkpoint_and_exits_cleanly(tmp_path):
    out = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _WORKER, out],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=env, text=True)
    try:
        deadline = time.time() + 120
        for line in proc.stdout:  # the first logged step, then preempt
            if line.startswith("step "):
                break
            assert time.time() < deadline, "no training step in time"
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, rest[-2000:]
    assert "preempted: checkpoint saved at step" in rest
    assert "EXITED-CLEANLY" in rest
    step = latest_step(out)
    assert step is not None and f"saved at step {step}" in rest
    state, meta, got = restore_checkpoint(out)
    assert got == step and meta == {"last_global_step": step,
                                     "preempted": True}
    assert state["step"] == step
