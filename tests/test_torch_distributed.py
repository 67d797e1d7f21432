"""Data-parallel training in the port on the CPU: two gloo processes
(`torch.multiprocessing`, spawned, one torch thread each, a `FileStore`
under the test's temporary directory) against one process.

* the training CLIs (`cli/train_stage{1,2}.py::run`, tiny towers,
  synthetic stories, fp32, --batch-size 2 global) on 2 ranks equal one
  process at batch 2 on the two ranks' rows (`_one_process`): the logged
  losses and the step-2 masters within 1e-5 relative, with ZeRO-2, with
  --no-zero2 and with ZeRO-2 under --accumulate-steps 2; ZeRO-2 equals
  --no-zero2 within 1e-6;
* a rank's noise is its rows of the global draw (`TrainNoise.draw`, the
  stage-2 encode's posterior noise);
* checkpoints move between 2 ranks and 1 process with equal tensors, and
  2 ranks resume one process's checkpoint as one process does;
* a SIGTERM to one rank stops both at the same step, with one checkpoint;
  each rank writes its profile window into a directory of its own;
* `zero2_axis` cuts the axis the JAX package's `_zero2_spec_for` cuts;
* `maybe_initialize` prefers its arguments to torchrun's environment; a
  one-rank group trains bit for bit as no group; a global batch the world
  does not divide exits with the JAX CLIs' message.

The two ranks run every job in one pair of processes, started once for
the module (`ranks`) while the one-process references run here.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from rcdms_tpu_torch.cli import common
from rcdms_tpu_torch.cli import train_stage1 as ptrain1
from rcdms_tpu_torch.cli import train_stage2 as ptrain2
from rcdms_tpu_torch.io.checkpoint import restore_checkpoint
from rcdms_tpu_torch.train import distributed, sharding
from rcdms_tpu_torch.train.loop import TrainNoise, train_step
from rcdms_tpu_torch.utils.preemption import PreemptionGuard
from tests.test_torch_configs import (  # noqa: F401 (autouse fixture)
    one_torch_thread,
)

WORLD = 2
STEPS = 2
JOIN_S = 300  # seconds the two ranks may take for all their jobs
PORT = {1: ptrain1, 2: ptrain2}
MODES = {"zero2": (), "replicated": ("--no-zero2",),
         "accumulate": ("--accumulate-steps", "2")}
TOL = 1e-5
SEED = 42  # the training CLIs' default --seed


def _argv(out: str, *extra) -> list:
    return ["--synthetic", "--device", "cpu", "--max-train-steps",
            str(STEPS), "--batch-size", str(WORLD), "--log-every", "1",
            "--report-to", "none", "--no-prefetch", "--warmup-steps", "0",
            "--learning-rate", "1e-4", "--dtype", "float32",
            "--output-dir", out, *extra]


def _run_cli(stage: int, out: str, *extra, dataset=None):
    mod = PORT[stage]
    args = mod.parse_args(_argv(out, *extra))
    return mod.run(args, dataset or common.train_dataset(args))


class _SigtermAt:
    """The synthetic dataset, whose batch iterator sends SIGTERM to its
    own process as it yields batch `at` (0-based) on rank `rank`."""

    def __init__(self, rank: int, at: int):
        from rcdms_tpu_torch.data.datasets import SyntheticStoryDataset

        self.inner = SyntheticStoryDataset()
        self.cfg = self.inner.cfg
        self.rank, self.at = rank, at

    def batches(self, *a, **k):
        for i, batch in enumerate(self.inner.batches(*a, **k)):
            if i == self.at and distributed.rank_and_size()[0] == self.rank:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def _rank_jobs(rank: int, root: str) -> None:
    """Every job of the two ranks, in order; each writes under `root`."""
    for stage in (1, 2):
        for mode, extra in MODES.items():
            if stage == 2 and mode == "accumulate":
                continue
            _run_cli(stage, os.path.join(root, f"s{stage}_{mode}"), *extra)
    # the one-process checkpoint: each rank's cuts, then a resume to step 3
    state = _build(1)[0]
    state.load_state_dicts(restore_checkpoint(os.path.join(root, "one"))[0])
    torch.save(state.state_dicts(), os.path.join(root, f"cuts{rank}.pt"))
    _run_cli(1, os.path.join(root, "resumed"), "--max-train-steps", "3",
             "--resume-from-checkpoint", os.path.join(root, "one"))
    # the noise a rank keeps
    gen = torch.Generator().manual_seed(7)
    noise = TrainNoise.draw(gen, (1, 5, 8), (1, 5, 1), (1, 5), 1000, "cpu")
    torch.save(noise, os.path.join(root, f"noise{rank}.pt"))
    latents = _encode_rows(rank)
    torch.save(latents, os.path.join(root, f"latents{rank}.pt"))
    # a SIGTERM to rank 1 as it reads its second batch
    out = os.path.join(root, "sigterm")
    res = _run_cli(1, out, "--max-train-steps", "50", dataset=_SigtermAt(
        rank=1, at=1))
    with open(os.path.join(root, f"sigterm{rank}.json"), "w") as fh:
        json.dump({"step": res.step}, fh)
    # a profile window: one trace directory a rank
    _run_cli(1, os.path.join(root, "profiled"), "--max-train-steps", "1",
             "--profile-dir", os.path.join(root, "traces"),
             "--profile-start", "0", "--profile-steps", "1")
    # a global batch the world does not divide
    try:
        _run_cli(1, os.path.join(root, "odd"), "--batch-size", "3")
    except SystemExit as e:
        with open(os.path.join(root, f"odd{rank}.txt"), "w") as fh:
            fh.write(str(e))


def _rank_main(rank: int, store: str, root: str) -> None:
    torch.set_num_threads(1)
    distributed.maybe_initialize("cpu", init_method=f"file://{store}",
                                 world_size=WORLD, rank=rank)
    try:
        _rank_jobs(rank, root)
    finally:
        distributed.shutdown()


def _build(stage: int, *extra):
    """(state, towers, dataset) as the CLI builds them under --synthetic
    (ZeRO-2 cuts under a process group)."""
    mod = PORT[stage]
    args = mod.parse_args(_argv("unused", *extra))
    dataset = common.train_dataset(args)
    configs = mod._apply_flags(args, mod.default_configs(args, dataset.cfg))
    state, towers = mod.build_state(args, configs, torch.device("cpu"))
    return state, towers, dataset


def _stage2_parts():
    """The tiny stage-2 towers of `--synthetic` and the dataset's rows of
    its first global batch (one story of each shard)."""
    _, towers, dataset = _build(2)
    return towers, _global_batch(dataset, 1)[0]


def _encode_rows(rank: int) -> torch.Tensor:
    """Rank `rank`'s encode of its row of the first global batch."""
    towers, raw = _stage2_parts()
    mine = {k: v[rank:rank + 1] for k, v in raw.items()}
    gen = torch.Generator().manual_seed(11)
    return ptrain2.encode(towers, common.batch_to_device(mine, "cpu"),
                          gen).latents


def _global_batch(dataset, steps: int) -> list:
    """The global batches of `steps` steps: at each, the ranks' rows
    (shard r of WORLD, one story each) concatenated in rank order."""
    shards = [dataset.batches(1, seed=SEED, shard_id=r, num_shards=WORLD)
              for r in range(WORLD)]
    out = []
    for _ in range(steps):
        rows = [next(s) for s in shards]
        out.append({k: np.concatenate([r[k] for r in rows])
                    for k in rows[0]})
    return out


class Ranks:
    """The two rank processes, joined (once) when a test reads them."""

    def __init__(self, root):
        self.root = str(root)
        ctx = mp.get_context("spawn")
        store = os.path.join(self.root, "store")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, store, self.root))
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()
        self._joined = False

    def path(self, *parts) -> str:
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
        assert codes == [0] * WORLD, f"rank exit codes {codes}"
        return os.path.join(self.root, *parts)


def _one_process(stage: int, steps: int, *extra, start=None):
    """Losses and state of one process at batch WORLD on the ranks'
    concatenated rows: the CLI's build, each step's generators, `encode`,
    `train_step`. `start` = (state dicts, step) resumes there, the data
    from its first batch again (the CLIs' iterator restarts)."""
    mod = PORT[stage]
    state, towers, dataset = _build(stage, *extra)
    first = 0
    if start is not None:
        state.load_state_dicts(start[0])
        first = start[1]
    losses = []
    for i, raw in zip(range(first, steps), _global_batch(dataset, steps)):
        encode_gen, step_gen = common.step_generators(SEED, i, "cpu")
        batch = mod.encode(towers, common.batch_to_device(raw, "cpu"),
                           encode_gen)
        losses.append(train_step(state, batch, generator=step_gen).item())
    return losses, state


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, references):
    """One process's stage-1 checkpoint, which the ranks restore, then the
    ranks started on every job."""
    from rcdms_tpu_torch.io.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("ranks")
    _, state = references(1, "zero2")
    save_checkpoint(str(root / "one"), STEPS, state.state_dicts())
    ranks = Ranks(root)
    yield ranks
    for p in ranks.procs:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def references():
    """One process's losses and state by (stage, mode), built once; one
    process has no optimizer state to cut, so --no-zero2 reads ZeRO-2's."""
    memo = {}

    def get(stage, mode):
        mode = "zero2" if mode == "replicated" else mode
        if (stage, mode) not in memo:
            memo[stage, mode] = _one_process(stage, STEPS, *MODES[mode])
        return memo[stage, mode]
    return get


def _rel(got, want) -> float:
    """max |got - want| / max |want| over the tensors of two dicts of one
    set of names (over the floats of two lists)."""
    if isinstance(want, list):
        got, want = torch.tensor(got), torch.tensor(want)
        return float((got - want).abs().max() / want.abs().max())
    assert set(got) == set(want)
    diff = max(float((got[n] - want[n]).abs().max()) for n in want)
    return diff / max(float(t.abs().max()) for t in want.values())


def _logged_losses(out: str) -> list:
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return [json.loads(x)["loss"] for x in fh.read().splitlines()]


CASES = [(1, "zero2"), (1, "replicated"), (1, "accumulate"),
         (2, "zero2"), (2, "replicated")]


@pytest.mark.parametrize("stage,mode", CASES)
def test_two_ranks_equal_one_process(stage, mode, ranks, references):
    losses, state = references(stage, mode)
    out = ranks.path(f"s{stage}_{mode}")
    got, meta, step = restore_checkpoint(out)
    assert (step, meta) == (STEPS, {"last_global_step": STEPS})
    assert got["step"] == state.step == STEPS
    assert got["count"] == state.opt_state.count
    assert _rel(_logged_losses(out), losses) <= TOL
    want = state.state_dicts()
    for key in ("params", "mu", "nu"):
        assert _rel(got[key], want[key]) <= TOL, key


@pytest.mark.parametrize("stage", [1, 2])
def test_zero2_equals_replicated_at_two_ranks(stage, ranks):
    a = restore_checkpoint(ranks.path(f"s{stage}_zero2"))[0]
    b = restore_checkpoint(ranks.path(f"s{stage}_replicated"))[0]
    assert _rel(_logged_losses(ranks.path(f"s{stage}_zero2")),
                _logged_losses(ranks.path(f"s{stage}_replicated"))) <= 1e-6
    for key in ("params", "mu", "nu"):
        assert _rel(a[key], b[key]) <= 1e-6, key


def test_checkpoint_of_two_ranks_restores_in_one_process(ranks):
    """The 2 ranks' step-2 checkpoint (ZeRO-2) loads into one process's
    state bit for bit, and that state trains on as one process's own."""
    saved, _, _ = restore_checkpoint(ranks.path("s1_zero2"))
    state = _build(1)[0]
    state.load_state_dicts(saved)
    mine = state.state_dicts()
    for key in ("params", "mu", "nu"):
        for n, t in saved[key].items():
            assert torch.equal(mine[key][n], t), (key, n)
    assert (mine["count"], mine["step"]) == (STEPS, STEPS)


def test_checkpoint_of_one_process_restores_in_two_ranks(ranks, tmp_path):
    """Each rank keeps its ZeRO-2 cut of one process's moments and the
    whole masters, bit for bit; the cuts tile the tensors."""
    saved, _, _ = restore_checkpoint(ranks.path("one"))
    cuts = [torch.load(ranks.path(f"cuts{r}.pt"), weights_only=True)
            for r in range(WORLD)]
    for n, t in saved["params"].items():
        for c in cuts:
            assert torch.equal(c["params"][n], t), n
    cut_any = False
    for key in ("mu", "nu"):
        for n, t in saved[key].items():
            axis = sharding.zero2_axis(t.shape, WORLD)
            if axis is None:
                parts = [c[key][n] for c in cuts]
                assert all(torch.equal(p, t) for p in parts), (key, n)
                continue
            cut_any = True
            whole = torch.cat([c[key][n] for c in cuts], dim=axis)
            assert torch.equal(whole, t), (key, n)
            assert cuts[0][key][n].shape[axis] * WORLD == t.shape[axis]
    assert cut_any


def test_two_ranks_resume_like_one_process(ranks):
    """2 ranks resumed from one process's step-2 checkpoint reach step 3
    as one process resumed from it does (the data from its start)."""
    saved, _, _ = restore_checkpoint(ranks.path("one"))
    losses, state = _one_process(1, 3, start=(saved, STEPS))
    out = ranks.path("resumed")
    got, meta, step = restore_checkpoint(out)
    assert (step, meta["last_global_step"]) == (3, 3)
    assert _rel(_logged_losses(out), losses) <= TOL
    want = state.state_dicts()
    for key in ("params", "mu", "nu"):
        assert _rel(got[key], want[key]) <= TOL, key


def test_a_rank_keeps_its_rows_of_the_global_noise(ranks):
    gen = torch.Generator().manual_seed(7)
    whole = TrainNoise.draw(gen, (WORLD, 5, 8), (WORLD, 5, 1), (WORLD, 5),
                            1000, "cpu")
    for r in range(WORLD):
        got = torch.load(ranks.path(f"noise{r}.pt"), weights_only=False)
        for g, w in zip(got, whole):
            assert torch.equal(g, w[r:r + 1])


def test_a_rank_keeps_its_rows_of_the_encode_noise(ranks):
    """A rank's stage-2 encode of its story samples both posteriors on
    its rows of the global draws: it equals that story's rows of one
    process's encode of the global batch."""
    towers, raw = _stage2_parts()
    gen = torch.Generator().manual_seed(11)
    whole = ptrain2.encode(towers, common.batch_to_device(raw, "cpu"),
                           gen).latents
    for r in range(WORLD):
        got = torch.load(ranks.path(f"latents{r}.pt"), weights_only=True)
        torch.testing.assert_close(got, whole[r:r + 1], rtol=1e-6,
                                   atol=1e-6)


def test_sigterm_to_one_rank_stops_both_at_one_step(ranks):
    steps = []
    for r in range(WORLD):
        with open(ranks.path(f"sigterm{r}.json")) as fh:
            steps.append(json.load(fh)["step"])
    assert steps == [2, 2]
    out = ranks.path("sigterm")
    ckpts = sorted(n for n in os.listdir(out) if n.isdigit())
    assert ckpts == ["2"]
    _, meta, _ = restore_checkpoint(out)
    assert meta == {"last_global_step": 2, "preempted": True}


def test_global_batch_must_divide_by_the_world(ranks):
    for r in range(WORLD):
        with open(ranks.path(f"odd{r}.txt")) as fh:
            assert fh.read() == ("--batch-size 3 must be divisible by the "
                                 "data-parallel device count 2")


def test_each_rank_writes_its_own_profile(ranks):
    for r in range(WORLD):
        assert os.listdir(ranks.path("traces", f"rank{r}")) == [
            "steps_0-1.pt.trace.json"]
    assert sorted(os.listdir(ranks.path("traces"))) == ["rank0", "rank1"]


SHAPES = [(), (7,), (8,), (3, 5), (6, 4), (4, 6), (320, 320, 3, 3),
          (3, 3, 4, 320), (1, 77, 768), (5, 1, 1), (0, 8), (9, 9, 2)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_zero2_axis_matches_jax(shape):
    from rcdms_tpu.train.sharding import _zero2_spec_for

    for world in (1, 2, 3, 4, 8):
        spec = tuple(_zero2_spec_for(shape, world))
        want = spec.index("data") if "data" in spec else None
        assert sharding.zero2_axis(shape, world) == want, world


# ---- in this process: the group's set-up and a one-rank group ------------


def _recorded_init(monkeypatch):
    """init_process_group replaced by a recorder (no group is made)."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    return calls


def test_maybe_initialize_prefers_arguments_to_the_environment(monkeypatch):
    for k, v in dict(RANK="3", WORLD_SIZE="4", LOCAL_RANK="3",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="29500").items():
        monkeypatch.setenv(k, v)
    calls = _recorded_init(monkeypatch)
    assert distributed.maybe_initialize("cpu")
    assert calls[-1] == (("gloo",), dict(init_method="env://", world_size=4,
                                         rank=3))
    assert distributed.maybe_initialize(
        "cpu", init_method="file:///x", world_size=2, rank=1)
    assert calls[-1] == (("gloo",), dict(init_method="file:///x",
                                         world_size=2, rank=1))


def test_maybe_initialize_without_a_world_does_nothing(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    calls = _recorded_init(monkeypatch)
    assert not distributed.maybe_initialize("cpu")
    assert calls == []
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK"):
        distributed.maybe_initialize("cpu")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="MASTER_ADDR and MASTER_PORT"):
        distributed.maybe_initialize("cpu")


def test_a_failed_init_raises(monkeypatch):
    import torch.distributed as dist

    def fail(*a, **k):
        raise RuntimeError("connection refused")

    _recorded_init(monkeypatch)
    monkeypatch.setattr(dist, "init_process_group", fail)
    with pytest.raises(RuntimeError, match="connection refused"):
        distributed.maybe_initialize("cpu", init_method="file:///x",
                                     world_size=2, rank=0)


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, left afterwards."""
    distributed.maybe_initialize("cpu", init_method=f"file://{tmp_path}/s",
                                 world_size=1, rank=0)
    try:
        yield
    finally:
        distributed.shutdown()


def test_local_batch_size_divides_by_the_process_count(monkeypatch):
    monkeypatch.setattr(distributed, "rank_and_size", lambda: (1, 3))
    assert sharding.local_batch_size(6) == 2
    with pytest.raises(ValueError, match="global batch size 4 must be "
                       "divisible by the process count 3"):
        sharding.local_batch_size(4)


def test_one_rank_group_trains_bit_for_bit_as_no_group(tmp_path):
    """Stage 1 through the CLI's `run`, 2 steps with ZeRO-2 and
    accumulation, under a one-rank group and with none: the same losses
    and checkpoint, bit for bit."""
    extra = ("--accumulate-steps", "2", "--max-train-steps", "4")
    _run_cli(1, str(tmp_path / "alone"), *extra)
    distributed.maybe_initialize("cpu", init_method=f"file://{tmp_path}/s",
                                 world_size=1, rank=0)
    try:
        _run_cli(1, str(tmp_path / "group"), *extra)
    finally:
        distributed.shutdown()
    assert _logged_losses(str(tmp_path / "group")) == _logged_losses(
        str(tmp_path / "alone"))
    a = restore_checkpoint(str(tmp_path / "alone"))[0]
    b = restore_checkpoint(str(tmp_path / "group"))[0]
    for key in ("params", "mu", "nu", "acc"):
        for n, t in a[key].items():
            assert torch.equal(b[key][n].view(torch.int32),
                               t.view(torch.int32)), (key, n)


def test_should_stop_global_under_a_group(one_rank):
    guard = PreemptionGuard()
    assert not guard.should_stop_global()
    guard.trigger()
    assert guard.should_stop_global()

