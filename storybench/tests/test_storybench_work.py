"""The yardstick's arithmetic: a story's FLOPs against FlopCounterMode on
the reference, and the attention and feed-forward work by hand."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from storybench import check, traffic, work
from storybench.reference import pipeline as ref_pipeline
from storybench.tests import tiny


def test_story_flops_equal_the_flop_counter_on_the_reference():
    cfg, mix = tiny.config(), tiny.mix("offline-b4")
    cpu = torch.device("cpu")
    model = check.reference_model(cfg, 1, cpu)
    s = traffic.story(cfg, mix, 1, 0, cpu)
    n = traffic.noise(cfg, s["noise_seed"], cpu)
    with FlopCounterMode(display=False) as counter:
        ref_pipeline.generate(model, cfg, s["inputs"], n, cfg["prior_steps"],
                              cfg["guidance_scale"])
    assert sum(work.story_flops(cfg, 1, cached=False).values()) == \
        counter.get_total_flops()


def test_story_flops_grow_with_the_batch_and_the_cache_saves_towers():
    cfg = tiny.config()
    one, four = work.story_flops(cfg, 1), work.story_flops(cfg, 4)
    assert all(abs(four[k] - 4 * one[k]) < 1e-6 * four[k] for k in one)
    cold = work.story_flops(cfg, 1, cached=False)
    assert cold["text"] == 2 * one["text"] and cold["unet"] == one["unet"]


def test_attention_work_by_hand():
    # 10 maps of 64 queries and 32 keys, 2 heads of 40
    w = work.attention((2, 5, 64, 80), (2, 5, 32, 80), 2, 2)
    assert w["flops"] == 2 * 2 * 10 * 2 * 64 * 32 * 40
    assert w["exps"] == 10 * 2 * 64 * 32
    assert w["nbytes"] == (2 * 10 * 64 * 80 + 2 * 10 * 32 * 80) * 2
    masked = work.attention((1, 8, 16), (1, 8, 16), 1, 4, mask_bytes=256)
    assert masked["nbytes"] == (2 * 8 * 16 + 2 * 8 * 16) * 4 + 256


def test_ff_work_by_hand():
    w = work.ff(rows=100, c=320, up=2560, inner=1280, itemsize=2)
    assert w["flops"] == 2 * 100 * 320 * 2560 + 2 * 100 * 1280 * 320
    weights = 2560 * 320 + 2560 + 320 * 1280 + 320
    assert w["nbytes"] == (2 * 100 * 320 + weights) * 2


def test_bound_and_share():
    assert work.bound_s(flops=989e12) == 1.0
    assert work.bound_s(nbytes=3.35e12) == 1.0
    assert work.bound_s(exps=work.PEAK_EXPS, flops=1.0) == 1.0
    calls = [dict(flops=989e9, exps=0.0, nbytes=0.0, itemsize=2)]
    assert abs(work.share(calls, 0.002) - 50.0) < 1e-9
    assert work.share([], 1.0) is None and work.share(calls, 0.0) is None
