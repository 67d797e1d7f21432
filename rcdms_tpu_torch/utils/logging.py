"""Metrics and tracing, the port's counterpart of
`rcdms_tpu/utils/logging.py`: step timing, a scalar logger (JSONL always;
TensorBoard, Weights & Biases and Comet where asked for and installed),
the training CLIs' `torch.profiler` trace windows written as Chrome
traces, and the port's own spans (`span`).

A trace holds the host's operators, and the card's kernels when CUDA is
available (`torch.profiler.ProfilerActivity.CUDA`); open the JSON in
Perfetto or `chrome://tracing`.

`span(name)` marks a region of the program as a profiler range
"rcdms.<name>", which any `torch.profiler` recording the calling thread
holds (a training CLI's `--profile` window, `tools.profile_call`, a
benchmark's traced run), on the clock of the card's kernels; elsewhere
it is a shared no-op. Counters are plain attributes of the object that
owns them (`StoryServer.served`, an op's `.launches`)."""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

logger = logging.getLogger("rcdms_tpu_torch")


def setup_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S", level=level)


@dataclass
class MetricLogger:
    """Appends JSONL scalars ({step, wall_time, **scalars}) to
    `<log_dir>/metrics.jsonl` and mirrors them to the trackers of
    `report_to` (any of "tensorboard", "wandb", "comet_ml"; other names
    are ignored). A tracker whose package is missing, or that fails to
    start, logs a warning and is skipped; JSONL is always written.
    `run_config` is handed to the tracker's run as its hyperparameters."""

    log_dir: str
    report_to: tuple = ("tensorboard",)
    run_config: Optional[Dict] = None
    project: str = "text2image"
    _file: object = field(default=None, repr=False)
    _tb: object = field(default=None, repr=False)
    _wandb: object = field(default=None, repr=False)
    _comet: object = field(default=None, repr=False)

    def __post_init__(self):
        os.makedirs(self.log_dir, exist_ok=True)
        self._file = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        if "tensorboard" in self.report_to:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(self.log_dir)
            except Exception as e:  # the tensorboard package is missing
                logger.warning("tensorboard requested but unavailable: %s",
                               e)
        if "wandb" in self.report_to:
            try:
                import wandb  # type: ignore

                self._wandb = wandb.init(project=self.project,
                                         dir=self.log_dir,
                                         config=self.run_config or {})
            except Exception as e:  # package missing / no credentials
                logger.warning("wandb requested but unavailable: %s", e)
        if "comet_ml" in self.report_to:
            try:
                import comet_ml  # type: ignore

                self._comet = comet_ml.Experiment(project_name=self.project)
                if self.run_config:
                    self._comet.log_parameters(self.run_config)
            except Exception as e:
                logger.warning("comet_ml requested but unavailable: %s", e)

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        values = {k: float(v) for k, v in scalars.items()}
        self._file.write(json.dumps({"step": step, "wall_time": time.time(),
                                     **values}) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(values, step=step)
        if self._comet is not None:
            self._comet.log_metrics(values, step=step)

    def close(self):
        self._file.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._comet is not None:
            self._comet.end()


class StepTimer:
    """Wall-clock seconds of a step and of its data loading (from the end
    of the previous step to `data_loaded`)."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self.data_time = 0.0
        self.step_time = 0.0

    def data_loaded(self):
        self.data_time = time.perf_counter() - self._t0

    def step_done(self):
        now = time.perf_counter()
        self.step_time = now - self._t0
        self._t0 = now
        return self.step_time, self.data_time


SPAN = "rcdms."
# True where a profiler records the calling thread: one C call, which the
# hottest spans' sites make before they build a span
recording = torch.autograd._profiler_enabled


class _NoSpan:
    """The context `span` returns where no profiler records the thread."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str, args: Optional[Dict[str, object]] = None):
    """A profiler range "rcdms.<name>" around a `with` block, where a
    profiler records the calling thread; else `NO_SPAN`. `args` (str, int
    or float values) are recorded with the range where the profiler
    records shapes (`record_shapes=True`). The range is a function-scope
    record (`_RecordFunctionFast`), not a `record_function` user
    annotation: the profiler gives a kernel the device range of the
    innermost user annotation open at its launch only, so a user
    annotation here would take the kernels out of an enclosing one's."""
    if not recording():
        return NO_SPAN
    if args is None:
        return torch._C._profiler._RecordFunctionFast(SPAN + name)
    return torch._C._profiler._RecordFunctionFast(SPAN + name, (), args)


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, trace_dir: str, name: str) -> str:
    """Stop `prof` and write its Chrome trace; returns the file's path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


class ProfileWindow:
    """A `torch.profiler` trace over the steps [start_step, start_step +
    num_steps), written to `trace_dir` as `steps_<a>-<b>.pt.trace.json`.
    `close()` writes a trace still open when the loop ends inside the
    window (the last step, or a preemption), so the file is always
    there. Nothing happens when `trace_dir` is None."""

    def __init__(self, trace_dir, start_step: int, num_steps: int):
        self.dir = trace_dir
        self.start = start_step
        self.end = start_step + num_steps
        self._prof = None
        self._first = None
        self._last = None
        self.path = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def tick(self, step: int) -> None:
        """Called at the start of each step."""
        if self.dir is None:
            return
        if step == self.start and not self.active:
            self._prof = _start_profiler()
            self._first = step
        elif step >= self.end and self.active:
            self._finish(step)
        if self.active:
            self._last = step

    def _finish(self, end: int) -> None:
        self.path = _stop_profiler(self._prof, self.dir,
                                   f"steps_{self._first}-{end}")
        self._prof = None

    def close(self) -> None:
        if self.active:
            self._finish(self._last + 1)
