"""The collective recorder (`rcdms_tpu_torch/core/spatial.py::recording`)
and the audit of the port's sharded paths
(`rcdms_tpu_torch/tools/comm_audit.py`) on the CPU.

A pool of 4 spawned gloo processes (one torch thread each, a `FileStore`
rendezvous under the test's temporary directory) runs the tiny pipeline
and the tiny stage-2 trainer for real, each mesh a process group of its
own, inside `recording()`:

* `generate` (32 px, 2 steps, a warm CondCache) on 2 ranks (cfg 2), on 4
  (cfg 2 x space 2) and on 4 at a 'frame' axis of 2 (cfg 2 x frame 2),
  and on 2 ranks without a CondCache;
* one training step with its logged loss's mean over 2 ranks, with
  ZeRO-2 and replicated (`--no-zero2`);
* on 2 ranks, the same `generate` outside `recording()`, and with the
  recorder's hook replaced by the direct collective call that the sharded
  path made before the recorder existed.

Each rank's record equals the dry run's record for that rank
(`comm_audit.audit_full` / `audit_train`: rank r of N on the meta device,
no process group) collective for collective: site, kind, dtype, bytes,
group size and step-loop flag. The frames of the three unrecorded and
recorded runs are equal bit for bit. Here, in this process: the port's
`pad_waste` against the JAX `frame_pad_waste` for a frame axis of 1-8,
the three variants against the JAX `VARIANTS` through `mesh_shape` and
the JAX `inference_mesh`, the summary's step scaling, and the audit's
main in each mode at tiny size.

The pool is this module's own: `tests/test_torch_sharded_inference.py`'s
pool runs its meshes in turn, and these jobs in it lengthened that module
from 154 s to 258 s on an 8-core CPU, where this module takes about 80 s
beside it."""

import importlib
import io
import os
import sys
from contextlib import redirect_stdout

import pytest
import torch
import torch.multiprocessing as mp

from rcdms_tpu_torch.core import spatial
from rcdms_tpu_torch.core.spatial import Collective
from rcdms_tpu_torch.tools import comm_audit as ca
from rcdms_tpu_torch.train import distributed, sharding
from tests.test_torch_configs import one_torch_thread  # noqa: F401

STEPS = 2
PIXELS = 32
# (world, frame, CondCache) of each generate the pool runs, in turn
MESHES = ((2, 1, True), (4, 1, True), (4, 2, True), (2, 1, False))
TRAIN_WORLD = 2
POOL = 4
JOIN_S = 240


def _tag(world, frame, cache) -> str:
    return f"w{world}f{frame}{'' if cache else 'nocache'}"


def _rank_pipeline(mesh):
    from rcdms_tpu_torch.sample.pipeline import build_pipeline, tiny_configs

    return build_pipeline(tiny_configs(), "cpu", torch.float32, seed=0,
                          num_steps=STEPS, mesh=mesh)


def _generate(pipe, cache: bool):
    """The dry run's request (`comm_audit.story_inputs`) with seeded
    values: frame 0 known, random pixels and clip images."""
    inputs, cache_args = ca.story_inputs(pipe.configs, PIXELS, "cpu")
    g = torch.Generator().manual_seed(3)
    inputs = inputs._replace(
        source_pixels=torch.rand(inputs.source_pixels.shape, generator=g),
        source_clip=torch.randn(inputs.source_clip.shape, generator=g),
        frame_known=torch.arange(inputs.frame_known.shape[1])[None] < 1)
    cond = pipe.precompute_cond_cache(*cache_args) if cache else None
    return pipe.generate(inputs, cond,
                         generator=torch.Generator().manual_seed(11))


def _rank_jobs(world: int, frame: int, cache: bool) -> dict:
    out = {}
    with torch.no_grad():
        pipe = _rank_pipeline(sharding.inference_mesh(frame))
        with spatial.recording() as record:
            frames, _ = _generate(pipe, cache)
        out["record"] = [tuple(c) for c in record]
        if (world, frame, cache) == MESHES[0]:
            out["recorded"] = frames
            out["unrecorded"] = _generate(pipe, cache)[0]
            real = spatial.collective
            spatial.collective = lambda site, kind, x, group, issue: issue()
            try:
                out["direct"] = _generate(pipe, cache)[0]
            finally:
                spatial.collective = real
    return out


def _train_jobs() -> dict:
    out = {}
    for variant in ca.GRAD_VARIANTS:
        rig = ca.build_train("cpu", variant == "zero2", tiny=True)
        with spatial.recording() as record:
            ca.train_step(rig)
        out[variant] = [tuple(c) for c in record]
    return out


def _rank_main(index: int, root: str) -> None:
    torch.set_num_threads(1)
    jobs = [(_tag(*m), m) for m in MESHES]
    jobs.append(("train", (TRAIN_WORLD, 1, None)))
    for tag, (world, frame, cache) in jobs:
        if index >= world:
            continue
        distributed.maybe_initialize(
            "cpu", init_method=f"file://{os.path.join(root, 'store' + tag)}",
            world_size=world, rank=index)
        try:
            got = (_train_jobs() if tag == "train"
                   else _rank_jobs(world, frame, cache))
            torch.save(got, os.path.join(root, f"{tag}_r{index}.pt"))
        finally:
            distributed.shutdown()


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("comm_pool"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(i, root))
             for i in range(POOL)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        alive = [p.pid for p in procs if p.is_alive()]
        assert not alive, f"ranks {alive} did not finish in {JOIN_S} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * POOL, f"pool exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()

    def result(tag, rank):
        return torch.load(os.path.join(root, f"{tag}_r{rank}.pt"),
                          weights_only=False)
    return result


@pytest.fixture(scope="module")
def dry_pipeline():
    return ca.build_pipeline(STEPS, tiny=True)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: _tag(*m))
def test_dry_record_equals_each_gloo_ranks(pool, dry_pipeline, mesh):
    world, frame, cache = mesh
    for rank in range(world):
        got = [Collective(*c) for c in pool(_tag(*mesh), rank)["record"]]
        want = ca.audit_full(dry_pipeline, world, frame, rank, cache)
        assert got, "the sharded story issued no collective"
        assert got == want, f"rank {rank}"


@pytest.mark.parametrize("variant", ca.GRAD_VARIANTS)
def test_dry_train_record_equals_each_gloo_ranks(pool, variant):
    for rank in range(TRAIN_WORLD):
        got = [Collective(*c) for c in pool("train", rank)[variant]]
        want = ca.audit_train(TRAIN_WORLD, rank, variant == "zero2",
                              tiny=True)
        assert got == want, f"rank {rank}"
    kinds = {c.kind for c in want}
    assert kinds == ({"all_reduce", "all_gather"} if variant == "zero2"
                     else {"all_reduce"})


def test_recording_leaves_the_story_bit_for_bit(pool):
    """Outside `recording()`, inside it, and with the collectives called
    directly (the path before the recorder): the same frames."""
    got = pool(_tag(*MESHES[0]), 0)
    assert torch.equal(got["recorded"], got["unrecorded"])
    assert torch.equal(got["recorded"], got["direct"])


def test_records_mark_the_step_loops(pool):
    """The samplers' collectives are in the loop (the UNet's halos, K/V
    gathers and GroupNorm sums on cfg 2 x space 2, the prior's frames
    traded for tokens over its branch's 2 ranks), the towers' and the
    final gathers outside."""
    record = [Collective(*c) for c in pool(_tag(4, 1, True), 0)["record"]]
    loop = {c.kind for c in record if c.in_loop}
    assert loop == {"all_gather", "all_reduce", "all_to_all"}
    assert any(not c.in_loop for c in record)
    assert {c.group for c in record} <= {2, 4}


# ---- here, in this process --------------------------------------------------

@pytest.fixture(scope="module")
def jaudit():
    """The JAX tool (it sets JAX's platform to the CPU and 8 CPU devices,
    as tests/conftest.py does)."""
    path = list(sys.path)
    try:
        return importlib.import_module("tools.comm_audit")
    finally:
        sys.path[:] = path


@pytest.mark.parametrize("frame", range(1, 9))
def test_pad_waste_equals_the_jax_frame_pad_waste(jaudit, frame):
    assert ca.pad_waste(frame) == jaudit.frame_pad_waste(frame)


@pytest.mark.parametrize("name", list(ca.VARIANTS))
def test_variants_equal_the_jax_variants(jaudit, name):
    import jax

    from rcdms_tpu.train.sharding import inference_mesh as jax_mesh

    assert ca.VARIANTS == jaudit.VARIANTS
    assert ca.WORLD == jaudit.N_DEV
    frame = ca.VARIANTS[name]["frame"]
    jmesh = jax_mesh(jax.devices()[:ca.WORLD], frame=frame)
    assert tuple(jmesh.shape.values()) == sharding.mesh_shape(ca.WORLD,
                                                              frame)
    assert sharding.mesh_shape(ca.WORLD, frame)[0] == \
        ca.VARIANTS[name]["cfg"]


def test_summary_scales_the_loop_to_the_model_steps():
    record = [Collective("halo", "all_gather", "float32", 8, 2, True)] * 4 \
        + [Collective("gather", "all_gather", "float32", 3, 2, False),
           Collective("all_to_all", "all_to_all", "bfloat16", 5, 2, True),
           Collective("all_to_all", "all_to_all", "bfloat16", 5, 2, True)]
    got = ca.summarize(record, steps=2, model_steps=20)
    assert got == {"all_gather": dict(count=41, bytes=323, in_loop=40),
                   "all_to_all": dict(count=20, bytes=100, in_loop=20)}
    assert ca.summarize(record, key="site")["halo"] == dict(
        count=4, bytes=32, in_loop=4)
    with pytest.raises(ValueError):
        ca.summarize(record[:3], steps=2, model_steps=20)


def test_dry_run_joins_no_group_and_restores_the_process():
    from rcdms_tpu_torch.ops import impl

    assert not distributed.active()
    with ca.dry_run(3, 4) as record:
        assert distributed.rank_and_size() == (3, 4)
        assert distributed.active()
        mesh = sharding.inference_mesh(1)
        assert tuple(mesh[:6]) == (2, 1, 2, 1, 0, 1)
        assert mesh.space_group.handle is None
        x = torch.ones(3)
        assert spatial.all_reduce_sum(x, mesh.all).equal(x)
    assert record == [Collective("all_reduce_sum", "all_reduce", "float32",
                                 12, 4, False)]
    assert not distributed.active()
    assert distributed.rank_and_size() == (0, 1)
    assert impl.attention_impl() == "auto"


@pytest.mark.parametrize("mode", [[], ["--full"], ["--full",
                                                   "--no-cond-cache"],
                                  ["--train", "--grad-variants",
                                   "zero2"]],
                         ids=["sampler", "full", "full_nocache", "train"])
def test_main_runs_each_mode(mode, tmp_path):
    out = tmp_path / "audit.json"
    with redirect_stdout(io.StringIO()):
        got = ca.main(["--tiny", "--variants", "frame4"] + mode
                      + ["--out", str(out)])
    assert out.exists()
    (name, results), = got.items()
    for variant, res in results.items():
        ranks = res["ranks"]
        assert len(ranks) == ca.WORLD
        if name != "train_audit":
            assert res["pad_waste"] == ca.pad_waste(4)
            # 5 frames over a frame axis of 4: blocks 2, 2, 1, 0
            assert ranks[0]["kinds"]["all_to_all"]["bytes"] > \
                ranks[2]["kinds"]["all_to_all"]["bytes"]
        for row in ranks:
            assert all(v["count"] > 0 for v in row["kinds"].values())
