"""chip_smoke.py's contract where there is no card: it exits nonzero and
prints no result, and its request builder makes protocol-shaped inputs."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from rcdms_tpu_torch.sample.pipeline import full_configs  # noqa: E402


def test_no_card_exits_nonzero_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_story_request_is_protocol_shaped():
    """Frame 0 known, the rest black; captions BOS ... EOS with EOS
    padding; the uncond rows BOS EOS...; CLIP-preprocessed mask images."""
    cfg = full_configs()
    req = chip_smoke.story_request(cfg, seed=1, pixels=64,
                                   dev=torch.device("cpu"))
    f, t = cfg.prior.num_frames, cfg.prior.num_text_tokens
    eos = cfg.text_s1.eos_token_id
    assert req.frame_known.tolist() == [[True] + [False] * (f - 1)]
    assert req.tokens_s1.shape == (1, f, t)
    assert (req.tokens_s1[..., 0] == eos - 1).all()
    assert (req.tokens_s1[..., -1] == eos).all()
    assert (req.tokens_s1_u[..., 1:] == eos).all()
    assert req.source_pixels.shape == (1, f, 64, 64, 3)
    assert (req.source_pixels[0, 1:] == -1).all()
    white = chip_smoke.clip_constant(1.0, cfg.vision.image_size,
                                     torch.device("cpu"))
    assert torch.equal(req.mask_clip[0, 0], white)
