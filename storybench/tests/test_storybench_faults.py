"""A run with the timed path broken underneath comes out not correct, once
for each fault these cells can have: a sampling step that returns its
state unchanged, half of the batch left out (the other half copied in its
place), and an answer altered where it is produced. (One chip: there is
no exchange between chips to leave out.) Each drives the rest of a run at
a tiny size on the CPU, past the harness's look for a card. The served
cell compares frames alone, which the prior's step reaches only through
the fusion's unseen stack: at the tiny size its fault reads under the
limit there, so that fault is held in the offline cell, which compares
the stage-1 embeddings themselves."""

import pytest
import torch

from rcdms_tpu_torch.core.schedulers import DDIMSchedule, UnCLIPSchedule
from rcdms_tpu_torch.sample.pipeline import StoryInputs, StoryNoise, \
    StoryPipeline

from storybench import run
from storybench.tests import tiny

CPU = torch.device("cpu")
CELLS = {"flintstones-offline-b4": ("offline-b4", {}),
         "pororosv-served-steady": ("served-steady",
                                    dict(rate_per_s=6.0, lead_s=0.5))}


def _half_batch(real):
    def generate(self, inputs, cond_cache=None, generator=None,
                 noise=None):
        b = inputs.frame_known.shape[0]
        if b == 1:
            return real(self, inputs, cond_cache, generator, noise)
        h, f = (b + 1) // 2, inputs.frame_known.shape[1]
        half = StoryNoise(noise.prior_init[:h], noise.prior_steps[:, :h],
                          noise.vae[:h * f], noise.story_init[:h])
        frames, embeds = real(self, StoryInputs(*(t[:h] for t in inputs)),
                              cond_cache, generator, half)
        idx = torch.arange(b) % h
        return frames[idx], embeds[idx]
    return generate


def _altered(real):
    def generate(self, *a, **kw):
        frames, embeds = real(self, *a, **kw)
        frames = frames.clone()
        frames[:, 2] = 1.0 - frames[:, 2]
        return frames, embeds
    return generate


FAULTS = {
    "story_step_unchanged": lambda mp: mp.setattr(
        DDIMSchedule, "step", lambda self, out, t, prev, sample, **kw:
        sample),
    "prior_step_unchanged": lambda mp: mp.setattr(
        UnCLIPSchedule, "step", lambda self, out, t, prev, sample, noise:
        sample),
    "half_batch": lambda mp: mp.setattr(
        StoryPipeline, "generate", _half_batch(StoryPipeline.generate)),
    "answer_altered": lambda mp: mp.setattr(
        StoryPipeline, "generate", _altered(StoryPipeline.generate)),
}


CASES = [(w, f) for w in sorted(CELLS) for f in sorted(FAULTS)
         if not (f == "prior_step_unchanged" and "served" in w)]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_path_is_not_correct(workload, fault, monkeypatch):
    name, kw = CELLS[workload]
    cfg = tiny.config()
    mix = tiny.mix(name, **kw)
    FAULTS[fault](monkeypatch)
    rec = run.measure(cfg, mix, 31, 1.0, 0, CPU)
    monkeypatch.undo()
    ok, shown, _ = run.check(cfg, mix, 31, rec, CPU, workload)
    assert not ok, shown
