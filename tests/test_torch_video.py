"""The port's `utils/video.py` against the JAX package's
(`rcdms_tpu/utils/video.py`) on the CPU.

* `save_videos_grid`: the GIFs of both functions on the same seeded
  stories (values outside [0, 1] included, so the clipping shows), for
  b = 1, 3 and 5 stories at n_rows 2 and 4: the same bytes, and the frames
  read back with Pillow equal pixel for pixel, with the same durations and
  loop; without Pillow the port's raises an ImportError naming it.
* `ddim_inversion` within 1e-5 (of the latents' largest |value|) of the
  JAX function, on an analytic epsilon and on a tiny story UNet's (its
  weights carried across by rcdms_tpu_torch/io/bridge.py, its
  conditioning fixed). Both update in fp32 from the schedule's fp32
  alphas_cumprod; the UNets differ by their sums' order.
"""

import functools
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from rcdms_tpu.configs import StoryUNetConfig as JUNetConfig
from rcdms_tpu.core.schedulers import DDIMSchedule as JDDIMSchedule
from rcdms_tpu.models.unet3d import StoryUNet as JUNet
from rcdms_tpu.utils import video as jvideo
from rcdms_tpu_torch.core.schedulers import DDIMSchedule
from rcdms_tpu_torch.io import bridge
from rcdms_tpu_torch.models.unet3d import StoryUNet
from rcdms_tpu_torch.utils import video
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
    port_config,
)
from tests.test_torch_training import _draw

INVERSION_TOL = 1e-5


def _gif(path):
    with Image.open(path) as im:
        frames = [np.asarray(f.convert("RGB")) for f in
                  ImageSequence.Iterator(im)]
        durations = []
        for i in range(im.n_frames):
            im.seek(i)
            durations.append(im.info.get("duration"))
        return frames, durations, im.info.get("loop")


@pytest.mark.parametrize("n_rows", [2, 4])
@pytest.mark.parametrize("b", [1, 3, 5])
def test_save_videos_grid_equals_jax(tmp_path, b, n_rows):
    rng = np.random.default_rng(b * 10 + n_rows)
    videos = rng.uniform(-0.2, 1.2, (b, 3, 8, 6, 3)).astype(np.float32)
    ours, theirs = str(tmp_path / "port.gif"), str(tmp_path / "jax.gif")
    video.save_videos_grid(torch.from_numpy(videos), ours, n_rows=n_rows,
                           fps=4)
    jvideo.save_videos_grid(videos, theirs, n_rows=n_rows, fps=4)
    with open(ours, "rb") as a, open(theirs, "rb") as c:
        assert a.read() == c.read()
    got, want = _gif(ours), _gif(theirs)
    assert len(got[0]) == len(want[0]) == 3
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    cols = min(n_rows, b)
    assert got[0][0].shape == ((b + cols - 1) // cols * 8, cols * 6, 3)
    assert got[1:] == want[1:] and got[1] == [250] * 3 and got[2] == 0


def test_save_videos_grid_without_pillow_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        video.save_videos_grid(np.zeros((1, 2, 4, 4, 3)),
                               str(tmp_path / "x.gif"))


def _close(got: torch.Tensor, want, tol=INVERSION_TOL):
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert got.dtype == torch.float32 and err <= tol, err


def test_ddim_inversion_analytic_equals_jax():
    """epsilon = 0.1 x + sin(t / 100), 10 steps."""
    lat = np.random.default_rng(0).standard_normal((1, 5, 4, 4, 4)).astype(
        np.float32)
    want = jvideo.ddim_inversion(
        lambda x, t: 0.1 * x + jnp.sin(t / 100.0),
        JDDIMSchedule.stage2_inference(), jnp.asarray(lat), num_steps=10)
    got = video.ddim_inversion(
        lambda x, t: 0.1 * x + math.sin(t / 100.0),
        DDIMSchedule.stage2_inference(), torch.from_numpy(lat),
        num_steps=10)
    _close(got, want)


def test_ddim_inversion_story_unet_equals_jax():
    """A tiny story UNet's epsilon (seeded weights, the temporal output
    projections live), the side input and context fixed, 4 steps."""
    cfg = JUNetConfig.tiny()
    b, f, hw, t = 1, 5, 8, 6
    rng = np.random.default_rng(1)
    junet = JUNet(cfg)
    x9 = jnp.zeros((b, f, hw, hw, cfg.in_channels))
    ctx0 = jnp.zeros((b, f, t, cfg.cross_attention_dim))
    shapes = jax.eval_shape(junet.init, jax.random.PRNGKey(0), x9,
                            jnp.zeros((b,), jnp.int32), ctx0)
    params = jax.tree_util.tree_map_with_path(
        functools.partial(_draw, rng), shapes)
    side = rng.standard_normal((b, f, hw, hw, cfg.in_channels - 4)).astype(
        np.float32)
    ctx = rng.standard_normal((b, f, t, cfg.cross_attention_dim)).astype(
        np.float32)
    lat = rng.standard_normal((b, f, hw, hw, 4)).astype(np.float32)

    def jeps(x, ts):
        return junet.apply(params, jnp.concatenate([x, side], -1),
                           jnp.full((b,), ts, jnp.int32), ctx)

    want = jvideo.ddim_inversion(jeps, JDDIMSchedule.stage2_inference(),
                                 jnp.asarray(lat), num_steps=4)

    unet = StoryUNet(port_config(cfg)).eval()
    bridge.load_state_dict(unet, bridge.unet_state_dict(params,
                                                        port_config(cfg)))
    tside, tctx = torch.from_numpy(side), torch.from_numpy(ctx)

    def peps(x, ts):
        return unet(torch.cat([x, tside], -1),
                    torch.full((b,), ts, dtype=torch.int64), tctx)

    got = video.ddim_inversion(peps, DDIMSchedule.stage2_inference(),
                               torch.from_numpy(lat), num_steps=4)
    _close(got, want)
