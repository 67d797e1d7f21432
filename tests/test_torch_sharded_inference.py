"""Sharded single-story inference in the port (`--shard-story`) on the CPU:
gloo ranks (`torch.multiprocessing`, spawned, one torch thread each, a
`FileStore` rendezvous under the test's temporary directory) against one
process.

One pool of 8 processes runs the worlds in turn, 2 (cfg 2), 4 (cfg 2 x
space 2) and 8 (cfg 2 x space 4), each a process group of its own
(`_rank_main`), while the references run here:

* the tiny fp32 pipeline (UNet channels (64, 128), 32 px, so the latent
  rows split at every level), seeded and perturbed weights: `generate`,
  `generate_stage1_autoreg`, a batch of 2 stories, encoder propagation
  k = 2 and DDIM eta 0.5 (step noise kept by rows) equal the one-process
  port within atol 5e-5, rtol 1e-5 (the JAX
  test's tolerance, `tests/test_sharded_inference.py`), and every rank
  holds the same whole story; at world 4 the frames equal the JAX
  package's unsharded story (`tests/test_torch_pipeline.py`'s self_test
  weights and noise) within its FRAME_TOL;
* module cases at worlds 2 and 4, each a layer split over every rank
  against the whole-tensor layer: the 3x3 conv, the UNet's and the VAE's
  stride-2 downsamples, the upsample, GroupNorm, the spatial transformer
  (K/V gathered), the VAE's mid attention and the int8 conv (its scale a
  MAX over the ranks);
* a 256-query attention site split two ways still routes to kernel A;
* `evaluate --shard-story --device cpu` on 2 ranks writes the one-process
  run's PNGs and metrics, from rank 0 alone;
* rows that do not split raise, with the world size and the level.

Here, in this process: `mesh_shape` against the JAX `inference_mesh` for
1-8 devices, the router's whole query count, and a one-rank mesh (a
one-rank gloo group) equal to no mesh bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from rcdms_tpu_torch.cli import evaluate as pevaluate
from rcdms_tpu_torch.core import spatial
from rcdms_tpu_torch.core.attention import Attention, SpatialTransformer
from rcdms_tpu_torch.core.layers import (
    Conv,
    FrameConv,
    GroupNorm,
    init_like_flax_,
)
from rcdms_tpu_torch.core.resnet import Downsample, Upsample
from rcdms_tpu_torch.models.vae import VAEAttnBlock, encoder_downsample
from rcdms_tpu_torch.ops import attention as attention_ops
from rcdms_tpu_torch.ops import quant
from rcdms_tpu_torch.sample.eval import decode_png
from rcdms_tpu_torch.sample.pipeline import (
    StoryNoise,
    StoryPipeline,
    tiny_configs,
    tiny_inputs,
)
from rcdms_tpu_torch.train import distributed, sharding
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
)

WORLDS = (2, 4, 8)
MODULE_WORLDS = (2, 4)
JAX_WORLD = 4
POOL = max(WORLDS)
JOIN_S = 300  # seconds the pool may take for every world's jobs
STEPS = 2
UNET_CHANNELS = (64, 128)  # tests/test_torch_pipeline.py's self_test's
TOL = dict(atol=5e-5, rtol=1e-5)
JOBS = ("generate", "autoreg", "batch2", "k2", "eta")
CLI_ARGS = ["--synthetic", "--device", "cpu", "--num-stories", "2",
            "--num-inference-steps", "2"]


def _pipeline(mesh=None, **options) -> StoryPipeline:
    """The tiny pipeline with tests/test_torch_pipeline.py's weights:
    flax-like init from seed 0, each parameter perturbed by 0.05 randn."""
    pipe = StoryPipeline(tiny_configs(unet_channels=UNET_CHANNELS),
                         num_steps=STEPS, mesh=mesh, **options)
    g = torch.Generator().manual_seed(0)
    init_like_flax_(pipe, g)
    with torch.no_grad():
        for p in pipe.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return pipe.eval()


def _story(configs, seed: int, pixels: int = 32):
    """`tiny_inputs` with seeded random source pixels in [-1, 1]."""
    inputs = tiny_inputs(configs, seed)
    shape = inputs.source_pixels.shape[:2] + (pixels, pixels, 3)
    px = np.random.RandomState(seed).uniform(-1, 1, shape)
    return inputs._replace(source_pixels=torch.from_numpy(
        px.astype(np.float32)))


def _batch(configs):
    """Stories 1 and 2 stacked along b."""
    a, b = _story(configs, 1), _story(configs, 2)
    return type(a)(*(torch.cat([x, y]) for x, y in zip(a, b)))


def _noise(pipe, *seeds) -> StoryNoise:
    return StoryNoise.cat(StoryNoise.draw(
        pipe, 1, torch.Generator().manual_seed(s), 32) for s in seeds)


def _jax_noise(pipe) -> StoryNoise:
    """self_test's draws (RandomState(42): prior init, prior steps, VAE,
    story init) for one tiny story."""
    f, d = 5, pipe.configs.prior.embedding_dim
    rng = np.random.RandomState(42)
    shapes = ((1, f, d), (STEPS, 1, f, d), (f, 16, 16, 4), (1, f, 16, 16, 4))
    return StoryNoise(*(torch.from_numpy(rng.randn(*s).astype(np.float32))
                        for s in shapes))


def _white(configs) -> torch.Tensor:
    c = configs.vision.image_size
    return torch.full((c, c, 3), 0.75)


def _story_jobs(mesh) -> dict:
    """The pipeline outputs every world is compared on: name -> tensors
    (k2: encoder propagation k = 2; eta: DDIM eta 0.5, a step noise a
    step)."""
    pipe = _pipeline(mesh)
    k2 = _pipeline(mesh, encoder_propagation=2)
    eta = _pipeline(mesh, eta=0.5)
    configs = pipe.configs
    story = _story(configs, 1)
    return {
        "generate": pipe.generate(story, noise=_noise(pipe, 11)),
        "autoreg": (pipe.generate_stage1_autoreg(
            story, _white(configs),
            generator=torch.Generator().manual_seed(13)),),
        "batch2": pipe.generate(_batch(configs),
                                noise=_noise(pipe, 21, 22)),
        "k2": k2.generate(story, noise=_noise(k2, 11)),
        "eta": eta.generate(story, noise=_noise(eta, 11)),
    }


def _module_cases() -> dict:
    """name -> (function of a feature map and args, the whole input (rows
    at dim -3), args), seeded from numpy (inputs) and a torch generator
    (weights, perturbed so that no bias stays zero)."""
    g = torch.Generator().manual_seed(5)
    rs = np.random.RandomState(0)

    def built(m):
        init_like_flax_(m, g)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=g))
        return m.eval()

    def x(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))

    vae_down = built(Conv(8, 8, 3, stride=2, padding=0))
    int8 = built(FrameConv(64, 64, 3, padding=1))

    def int8_conv(h):
        quant.set_quant_mode("int8")
        try:
            return int8(h)
        finally:
            quant.set_quant_mode(None)

    return {
        "conv3x3": (built(Conv(8, 8, 3, padding=1)), x(2, 16, 8, 8), ()),
        "unet_downsample": (built(Downsample(8)), x(1, 2, 16, 8, 8), ()),
        "vae_downsample": (lambda h: encoder_downsample(vae_down, h),
                           x(2, 16, 8, 8), ()),
        "upsample": (built(Upsample(8)), x(1, 2, 16, 8, 8), ()),
        "group_norm": (built(GroupNorm(4, 16)), x(1, 2, 16, 8, 16), ()),
        "spatial_transformer": (
            built(SpatialTransformer(32, 2, 16, 24, norm_groups=8)),
            x(1, 2, 16, 8, 32), (x(1, 2, 7, 24),)),
        "vae_attention": (built(VAEAttnBlock(16, 4)), x(2, 16, 8, 16), ()),
        "int8_conv": (int8_conv, x(1, 2, 16, 4, 64), ()),
    }


def _attention_site(queries: int):
    """A seeded self-attention (2 heads of 16) and its (1, queries, 32)
    token input."""
    g = torch.Generator().manual_seed(9)
    attn = Attention(32, 2, 16)
    init_like_flax_(attn, g)
    x = torch.from_numpy(np.random.RandomState(queries).randn(
        1, queries, 32).astype(np.float32))
    return attn.eval(), x


def _routed_split(group, queries: int):
    """(output gathered whole, local query counts that reached
    `flash_attention`) of the site split over `group`."""
    attn, x = _attention_site(queries)
    routed = []
    real = attention_ops.flash_attention

    def record(q, *a, **kw):
        routed.append(q.shape[-2])
        return real(q, *a, **kw)

    attention_ops.flash_attention = record
    try:
        with spatial.spatial(group):
            y = attn(spatial.local_rows(x, 1, group))
    finally:
        attention_ops.flash_attention = real
    return spatial.gather_rows(y, 1, group), routed


def _rank_jobs(world: int, rank: int, root: str) -> dict:
    out = {}
    mesh = sharding.inference_mesh()
    out["mesh"] = tuple(mesh[:4])
    with torch.no_grad():
        out["story"] = _story_jobs(mesh)
        if world == JAX_WORLD:
            pipe = _pipeline(mesh)
            out["jax"] = pipe.generate(tiny_inputs(pipe.configs, 0),
                                       noise=_jax_noise(pipe))
            try:
                pipe.generate(_story(pipe.configs, 1, pixels=36),
                              noise=_noise(pipe, 11))
            except ValueError as e:
                out["rows_error"] = str(e)
        if world in MODULE_WORLDS:
            out["modules"] = {}
            for name, (fn, x, args) in _module_cases().items():
                rows = x.dim() - 3
                with spatial.spatial(mesh.all):
                    y = fn(spatial.local_rows(x, rows, mesh.all), *args)
                out["modules"][name] = spatial.gather_rows(y, rows,
                                                           mesh.all)
        if world == 2:
            out["routed"] = {q: _routed_split(mesh.all, q)
                             for q in (256, 128)}
    if world == 2:
        pevaluate.main(CLI_ARGS + ["--shard-story", "--output-dir",
                                   os.path.join(root, f"cli{rank}")])
    return out


def _rank_main(index: int, root: str) -> None:
    """Pool process `index`: rank `index` of each world it belongs to, in
    turn, each world a process group of its own."""
    torch.set_num_threads(1)
    for world in WORLDS:
        if index >= world:
            continue
        distributed.maybe_initialize(
            "cpu", init_method=f"file://{os.path.join(root, f'store{world}')}",
            world_size=world, rank=index)
        try:
            torch.save(_rank_jobs(world, index, root),
                       os.path.join(root, f"w{world}_r{index}.pt"))
        finally:
            distributed.shutdown()


class Pool:
    """The pool's processes, joined (once) when a test reads them."""

    def __init__(self, root):
        self.root = str(root)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main, args=(i, self.root))
                      for i in range(POOL)]
        for p in self.procs:
            p.start()
        self._joined = False
        self._loaded = {}

    def result(self, world: int, rank: int = 0) -> dict:
        if not self._joined:
            for p in self.procs:
                p.join(JOIN_S)
            self._joined = True
        alive = [p.pid for p in self.procs if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
        assert not alive, f"ranks {alive} did not finish in {JOIN_S} s"
        codes = [p.exitcode for p in self.procs]
        assert codes == [0] * POOL, f"pool exit codes {codes}"
        if (world, rank) not in self._loaded:
            self._loaded[world, rank] = torch.load(
                os.path.join(self.root, f"w{world}_r{rank}.pt"),
                weights_only=False)
        return self._loaded[world, rank]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    pool = Pool(tmp_path_factory.mktemp("pool"))
    yield pool
    for p in pool.procs:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def one_process():
    """The one-process port's outputs of `_story_jobs` (no mesh)."""
    with torch.no_grad():
        return _story_jobs(None)


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, **TOL)


# ---- here, in this process --------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax_inference_mesh(n):
    """At the JAX mesh's default 'frame' axis (the one its callers use)."""
    import jax

    from rcdms_tpu.train.sharding import inference_mesh as jax_mesh

    want = jax_mesh(jax.devices()[:n]).shape
    assert sharding.mesh_shape(n) == (
        want["cfg"], want["frame"], want["space"])
    if n in (1, 2, 4, 8):
        assert sharding.mesh_shape(n)[::2] == {
            1: (1, 1), 2: (2, 1), 4: (2, 2), 8: (2, 4)}[n]


def test_unsplit_rows_raise():
    four = spatial.RowGroup(None, 4, 0)
    spatial.check_rows(64, 4, four, "the UNet's latent rows")
    spatial.check_rows(20, 1, four, "rows")  # no stride: odd blocks
    for rows, levels in ((36, 2), (24, 3), (30, 1)):
        with pytest.raises(ValueError, match="level"):
            spatial.check_rows(rows, levels, four, "rows")


def test_router_takes_the_whole_query_count(monkeypatch):
    routed = []
    monkeypatch.setattr(attention_ops, "flash_attention",
                        lambda *a, **kw: routed.append(a) or a[0])
    q, kv = torch.zeros(1, 128, 32), torch.zeros(1, 256, 32)
    attention_ops.multihead_attention(q, kv, kv, 2, row_sum="rounded",
                                      queries=256)
    assert len(routed) == 1
    attention_ops.multihead_attention(q, kv, kv, 2, row_sum="rounded")
    assert len(routed) == 1


def test_one_rank_mesh_equals_no_mesh_bit_for_bit(tmp_path):
    assert not distributed.active()
    plain = _pipeline()
    configs = plain.configs
    with torch.no_grad():
        want = plain.generate(_story(configs, 1), noise=_noise(plain, 11))
        distributed.maybe_initialize(
            "cpu", init_method=f"file://{tmp_path / 'store'}",
            world_size=1, rank=0)
        try:
            mesh = sharding.inference_mesh()
            assert tuple(mesh[:4]) == (1, 1, 0, 0)
            meshed = _pipeline(mesh)
            sharding.check_replicated(meshed, mesh.all)
            got = meshed.generate(_story(configs, 1),
                                  noise=_noise(meshed, 11))
        finally:
            distributed.shutdown()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---- the pool --------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("job", JOBS)
def test_sharded_story_equals_one_process(pool, one_process, world, job):
    got = pool.result(world)
    assert got["mesh"][:2] == sharding.mesh_shape(world)[::2]
    _close(got["story"][job], one_process[job])


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_whole_story(pool, world):
    want = pool.result(world, 0)["story"]
    for r in range(1, world):
        got = pool.result(world, r)["story"]
        for job in JOBS:
            for g, w in zip(got[job], want[job]):
                assert torch.equal(g, w), (r, job)


def test_world4_equals_the_jax_story(pool, tmp_path_factory):
    """The world-4 frames against the JAX package's unsharded story on the
    same weights and noise (tests/test_torch_pipeline.py)."""
    from tests import test_torch_pipeline as tp

    port, inputs, params, jpipe, a = tp.build_story(
        str(tmp_path_factory.mktemp("selftest") / "ref.npz"))
    mine = _pipeline()
    want_sd = port.state_dict()
    assert all(torch.equal(t, want_sd[k])
               for k, t in mine.state_dict().items())
    for g, w in zip(_jax_noise(mine), tp.self_test_noise(port, a)):
        assert (g is w is None) or torch.equal(g, w)
    frames, embeds = pool.result(JAX_WORLD)["jax"]
    np.testing.assert_allclose(embeds.numpy(), a["reference_prior_embeds"],
                               **tp.SAMPLER_TOL)
    np.testing.assert_allclose(frames.numpy(),
                               tp.jax_frames(port, params, jpipe, a),
                               **tp.FRAME_TOL)


@pytest.mark.parametrize("world", MODULE_WORLDS)
@pytest.mark.parametrize("name", list(_module_cases()))
def test_split_module_equals_whole(pool, world, name):
    fn, x, args = _module_cases()[name]
    with torch.no_grad():
        want = fn(x, *args)
    got = pool.result(world)["modules"][name]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, **TOL)


def test_split_256_query_site_takes_kernel_a(pool):
    """Split two ways, a 256-query site reaches `flash_attention` with its
    128 local queries on each rank (a 128-query site, 64 local, does not),
    and both equal the whole site."""
    routed = {r: pool.result(2, r)["routed"] for r in range(2)}
    for r in range(2):
        assert routed[r][256][1] == [128]
        assert routed[r][128][1] == []
    for queries in (256, 128):
        attn, x = _attention_site(queries)
        with torch.no_grad():
            torch.testing.assert_close(routed[0][queries][0], attn(x),
                                       **TOL)


def test_rows_that_do_not_split_raise(pool):
    got = pool.result(JAX_WORLD)
    assert "level 0" in got["rows_error"]
    assert "world size 4" in got["rows_error"]


def test_evaluate_shard_story_writes_the_one_process_run(pool, tmp_path):
    pool.result(2)
    one = tmp_path / "one"
    pevaluate.main(CLI_ARGS + ["--output-dir", str(one)])
    sharded = os.path.join(pool.root, "cli0")
    assert not os.path.exists(os.path.join(pool.root, "cli1"))
    assert sorted(os.listdir(sharded)) == sorted(os.listdir(one))

    def metrics(d):
        with open(os.path.join(d, "metrics_0.jsonl")) as fh:
            return [json.loads(line) for line in fh]

    got, want = metrics(sharded), metrics(one)
    assert [m.keys() for m in got] == [m.keys() for m in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(list(g.values()), list(w.values()),
                                   rtol=1e-4)
    pngs = [n for n in os.listdir(one) if n.endswith(".png")]
    assert pngs
    for name in pngs:
        images = []
        for d in (sharded, one):
            with open(os.path.join(d, name), "rb") as fh:
                images.append(decode_png(fh.read()).astype(int))
        assert np.abs(images[0] - images[1]).max() <= 1, name
