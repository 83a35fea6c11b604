"""Checkpoints, the fault-tolerant runner and ``launch.train`` of the port
(``repro_torch.checkpoint``, ``repro_torch.ft``,
``repro_torch.launch.train``) against the JAX package's, on the CPU.

The port's own versions of ``tests/test_ft_checkpoint_data.py``'s checks
(roundtrip and prune, a missing checkpoint raising, recovery bitwise
identical, several failures, the straggler watchdog), then the two
packages' checkpoints read by each other bitwise (the reference's
layout: a leaf per file in its flatten order, ``blocks`` stacked), and
the CLI's JSON line against the JAX launcher's. The CLI's first loss is
held within ``FIRST_LOSS_TOL`` of the reference's: the two packages draw
their weights from different generators (``torch.Generator`` and
``jax.random``), so only the loss at initialisation, about ln(vocab) plus
the logits' small variance, is comparable.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import models as jm
from repro import optim as jopt
from repro.launch import train as jlaunch
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as jinit_state
from repro_torch import checkpoint as ckpt
from repro_torch import models as tm
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.ft import FailureInjector, RunnerConfig, TrainingRunner
from repro_torch.launch.train import build
from repro_torch.optim import OptConfig
from repro_torch.optim import adamw as topt_adamw
from repro_torch.train import TrainConfig, init_train_state, make_train_step

CFG = get_arch("llama3.2-1b").reduced()
RUN = tm.RunConfig(remat="none")
TCFG = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=50))
#: |first_loss - reference's| at reduced llama3.2-1b (ln 256 = 5.545).
FIRST_LOSS_TOL = 0.05


def _runner(tmp, steps=10, **kw):
    data = SyntheticLM(DataConfig(seed=7, seq_len=16, global_batch=4,
                                  vocab=CFG.vocab))
    lm = tm.init_lm(CFG, torch.Generator().manual_seed(0), "cpu")
    state = init_train_state(CFG, lm, TCFG)
    step = make_train_step(CFG, RUN, TCFG)
    return TrainingRunner(step, data, state, tmp,
                          RunnerConfig(total_steps=steps, ckpt_every=3), **kw)


def _tensors(tree):
    """(path, tensor) of a port state, parameters by name."""
    for k, v in tree.items():
        if isinstance(v, torch.nn.Module):
            v = dict(v.named_parameters())
        if isinstance(v, dict):
            for p, t in _tensors(v):
                yield f"{k}/{p}", t
        else:
            yield k, v


def test_recovery_bitwise_identical(tmp_path):
    out1 = _runner(str(tmp_path / "a")).run()
    out2 = _runner(str(tmp_path / "b"),
                   injector=FailureInjector(fail_at=(7,))).run()
    assert out2["restarts"] == 1
    a, b = dict(_tensors(out1["state"])), dict(_tensors(out2["state"]))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    replayed = {m["step"]: m["loss"] for m in out2["metrics"]}
    assert [m["loss"] for m in out1["metrics"]] == \
        [replayed[s] for s in range(10)]


def test_multiple_failures(tmp_path):
    out = _runner(str(tmp_path / "c"),
                  injector=FailureInjector(fail_at=(2, 5, 8))).run()
    assert out["restarts"] == 3
    assert len(out["metrics"]) >= 10


def test_straggler_watchdog(tmp_path):
    """Deterministic unit test of the EWMA watchdog (wall-clock-free)."""
    r = _runner(str(tmp_path / "d"), steps=1)
    for step in range(10):
        r._watch(step, 0.1)
    r._watch(10, 0.5)              # > 3× EWMA → flagged
    assert 10 in r.straggler_steps
    r._watch(11, 0.12)             # recovered → not flagged
    assert 11 not in r.straggler_steps


def test_checkpoint_roundtrip_and_prune(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "n": {"b": torch.ones(4)}}
    d = str(tmp_path / "ck")
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(d, s, tree, extra={"step": s}, keep_last=2)
    assert ckpt.latest_step(d) == 5
    kept = [f for f in os.listdir(d) if f.startswith("step_")]
    assert len(kept) == 2
    restored, extra, step = ckpt.restore(d, tree)
    assert extra["step"] == 5 and step == 5
    assert restored["w"] is not tree["w"]
    assert torch.equal(restored["w"], tree["w"])
    assert torch.equal(restored["n"]["b"], tree["n"]["b"])


def test_checkpoint_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nope"), {"a": torch.zeros(1)})


def test_checkpoint_refuses_bf16_and_a_wrong_tree(tmp_path):
    d = str(tmp_path / "ck")
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(d, 0, {"a": torch.zeros(2, dtype=torch.bfloat16)})
    ckpt.save(d, 1, {"a": torch.zeros(2), "b": torch.zeros(3)})
    with pytest.raises(ValueError):
        ckpt.restore(d, {"a": torch.zeros(2)})
    with pytest.raises(ValueError):
        ckpt.restore(d, {"a": torch.zeros(2), "b": torch.zeros(4)})


def _jax_state(name, compression=None):
    jcfg = jconfigs.get_arch(name).reduced()
    jtc = JTrainConfig(opt=jopt.OptConfig(), grad_compression=compression)
    jstate = jinit_state(jcfg, jm.init_lm(jcfg, jax.random.PRNGKey(3)), jtc)
    # a state with every leaf distinct: moments and step as after training
    rng = np.random.default_rng(11)
    jstate = jax.tree.map(
        lambda a: jnp.asarray(rng.integers(1, 9, a.shape).astype(a.dtype))
        if a.dtype == jnp.int32 else
        a + jnp.asarray(rng.normal(0, 1, a.shape).astype(a.dtype)), jstate)
    return get_arch(name).reduced(), jstate


@pytest.mark.parametrize("name,compression", [("llama3.2-1b", None),
                                              ("zamba2-2.7b", "int8_ef"),
                                              ("musicgen-large", None)])
def test_checkpoints_cross_between_packages(tmp_path, name, compression):
    """A checkpoint the JAX package wrote restores into the port, and one
    the port wrote restores into the JAX package: bitwise both ways, with
    the reference's file layout."""
    cfg, jstate = _jax_state(name, compression)
    np_state = jax.tree.map(np.asarray, jstate)
    want = tm.train_state_from_jax(cfg, np_state, "cpu")

    jckpt.save(str(tmp_path / "j"), 4, jstate, extra={"step": 4})
    tcfg = TrainConfig(grad_compression=compression)
    like = init_train_state(cfg, tm.init_lm(cfg, device="cpu"), tcfg)
    got, extra, step = ckpt.restore(str(tmp_path / "j"), like)
    assert extra == {"step": 4} and step == 4
    assert isinstance(got["params"], tm.LM) and got["params"] is not \
        like["params"]
    assert all(p.requires_grad for p in got["params"].parameters())
    g, w = dict(_tensors(got)), dict(_tensors(want))
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k

    ckpt.save(str(tmp_path / "t"), 5, want, extra={"step": 5})
    with open(tmp_path / "t" / "step_00000005" / "manifest.json") as f:
        ours = json.load(f)
    with open(tmp_path / "j" / "step_00000004" / "manifest.json") as f:
        theirs = json.load(f)
    assert ours["leaves"] == theirs["leaves"]
    back, extra, _ = jckpt.restore(str(tmp_path / "t"), jstate)
    assert extra == {"step": 5}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_launch_train_cli_matches_reference(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.train --device cpu --steps 4`` prints
    the reference launcher's keys; its first loss is the reference's
    within ``FIRST_LOSS_TOL``."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(os.path.dirname(__file__), "..", "src"),
                os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "4", "--ckpt", str(tmp_path / "t")],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    monkeypatch.setattr(sys, "argv", ["train", "--steps", "4", "--ckpt",
                                      str(tmp_path / "j")])
    jlaunch.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(want) <= set(got) and got["device"] == "cpu"
    for k in ("arch", "steps", "restarts", "stragglers"):
        assert got[k] == want[k], k
    assert abs(got["first_loss"] - want["first_loss"]) <= FIRST_LOSS_TOL
    assert np.isfinite(got["last_loss"])
    assert ckpt.latest_step(str(tmp_path / "t")) == 3


def test_launch_train_refuses_a_mesh(monkeypatch):
    """A mesh the world cannot hold is refused (with no process group and
    no ``torchrun`` environment the world is this process alone)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="world"):
        build("llama3.2-1b", "reduced", "2x2", seq_len=8, global_batch=2,
              lr=1e-3, steps=2, microbatches=1, compression=None,
              data_kind="synthetic", seed=0, device="cpu")


class _Once:
    """A data source's batches, each made once (the sDTW filter's plain
    version on the CPU takes about a second a batch); both runs of a test
    read the same ones."""

    def __init__(self, data):
        self.data, self.made = data, {}

    def batch_at(self, step, shard=0, num_shards=1):
        key = (step, shard, num_shards)
        if key not in self.made:
            self.made[key] = self.data.batch_at(step, shard, num_shards)
        return self.made[key]


@pytest.fixture
def one_thread():
    """The filter's plain scan is thousands of tiny ops: under several
    test workers their intra-op threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_launch_train_fault_tolerance_tsa(tmp_path, one_thread):
    """``--data tsa`` with an injected failure resumes to the same
    parameters as an uninterrupted run, the filter on the CPU."""
    outs, data = [], None
    for fail in ((), (2,)):
        cfg, tsa, state, step = build(
            "llama3.2-1b", "reduced", "1x1", seq_len=32, global_batch=2,
            lr=1e-3, steps=3, microbatches=1, compression=None,
            data_kind="tsa", seed=1, device="cpu")
        assert tsa.device.type == "cpu"
        data = data or _Once(tsa)
        runner = TrainingRunner(
            step, data, state, str(tmp_path / f"f{len(fail)}"),
            RunnerConfig(total_steps=3, ckpt_every=2),
            injector=FailureInjector(fail))
        outs.append(runner.run())
    assert outs[1]["restarts"] == 1 and len(data.made) == 3
    for (n, a), (_, b) in zip(outs[0]["state"]["params"].named_parameters(),
                              outs[1]["state"]["params"].named_parameters()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# The train step as a transaction: a failure inside the AdamW update.
# ---------------------------------------------------------------------------

class _FailInside:
    """Raise ``exc`` once, from ``fn``'s ``call``-th call (0-based) within
    step ``at``; the runner's ``delay_hook`` tells it the step."""

    def __init__(self, fn, at: int, call: int, exc):
        self.fn, self.at, self.call, self.exc = fn, at, call, exc
        self.step, self.calls, self.fired = None, 0, False

    def hook(self, step):
        self.step, self.calls = step, 0
        return 0.0

    def __call__(self, *a, **kw):
        if self.step == self.at and not self.fired:
            self.calls += 1
            if self.calls > self.call:
                self.fired = True
                raise self.exc
        return self.fn(*a, **kw)


def _states_equal(a, b):
    a, b = dict(_tensors(a)), dict(_tensors(b))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _jax_runner_steps(tmp, steps, fail_at, ckpt_every):
    """The JAX runner's (restarts, logged steps) with a FailureInjector."""
    from repro import ft as jft
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.train import make_train_step as jmake_step
    jcfg = jconfigs.get_arch("llama3.2-1b").reduced()
    jtc = JTrainConfig(opt=jopt.OptConfig(lr=1e-3, warmup_steps=2,
                                          total_steps=50))
    state = jinit_state(jcfg, jm.init_lm(jcfg, jax.random.PRNGKey(0)), jtc)
    out = jft.TrainingRunner(
        jax.jit(jmake_step(jcfg, jm.RunConfig(remat="none"), jtc)),
        JSyntheticLM(JDataConfig(seed=7, seq_len=16, global_batch=4,
                                 vocab=jcfg.vocab)), state, tmp,
        jft.RunnerConfig(total_steps=steps, ckpt_every=ckpt_every),
        injector=jft.FailureInjector(fail_at)).run()
    return out["restarts"], [m["step"] for m in out["metrics"]]


def test_allocation_failure_before_the_first_write_restarts_as_reference(
        tmp_path, monkeypatch):
    """An OOM at the update's workspace (before its first write), with no
    checkpoint: the state is the last good one and the runner starts again
    at step 0, as the JAX runner does after a failure at that step —
    bitwise the port's run with a FailureInjector there."""
    monkeypatch.setattr(topt_adamw, "GROUP_ELEMENTS", 1 << 12)
    fail = _FailInside(topt_adamw.Workspace.get, at=2, call=0,
                       exc=torch.OutOfMemoryError("injected at the "
                                                  "workspace"))
    monkeypatch.setattr(topt_adamw.Workspace, "get",
                        lambda self, *a: fail(self, *a))
    got = _runner(str(tmp_path / "a"), steps=4, delay_hook=fail.hook).run()
    monkeypatch.undo()
    monkeypatch.setattr(topt_adamw, "GROUP_ELEMENTS", 1 << 12)
    want = _runner(str(tmp_path / "b"), steps=4,
                   injector=FailureInjector(fail_at=(2,))).run()
    assert fail.fired and got["restarts"] == want["restarts"] == 1
    _states_equal(got["state"], want["state"])
    steps = [m["step"] for m in got["metrics"]]
    assert steps == [m["step"] for m in want["metrics"]] == [0, 1, 0, 1, 2, 3]
    assert (1, steps) == _jax_runner_steps(str(tmp_path / "j"), 4, (2,),
                                           ckpt_every=10)


def _torn_runner(tmp, monkeypatch, steps, ckpt_every):
    """A runner whose update raises after its first piece has written, at
    step 7."""
    monkeypatch.setattr(topt_adamw, "GROUP_ELEMENTS", 1 << 12)
    fail = _FailInside(topt_adamw._views, at=7, call=4,
                       exc=RuntimeError("injected after the first write"))
    monkeypatch.setattr(topt_adamw, "_views", fail)
    data = SyntheticLM(DataConfig(seed=7, seq_len=16, global_batch=4,
                                  vocab=CFG.vocab))
    lm = tm.init_lm(CFG, torch.Generator().manual_seed(0), "cpu")
    r = TrainingRunner(make_train_step(CFG, RUN, TCFG), data,
                       init_train_state(CFG, lm, TCFG), tmp,
                       RunnerConfig(total_steps=steps, ckpt_every=ckpt_every),
                       delay_hook=fail.hook)
    return r, fail


def test_torn_update_restores_the_checkpoint(tmp_path, monkeypatch):
    """A raise after the update's first piece has written, with a
    checkpoint: the runner restores it (new tensors) and replays — bitwise
    the uninterrupted run and the run with a FailureInjector there."""
    r, fail = _torn_runner(str(tmp_path / "a"), monkeypatch, 10, 3)
    got = r.run()
    monkeypatch.undo()
    monkeypatch.setattr(topt_adamw, "GROUP_ELEMENTS", 1 << 12)
    assert fail.fired and got["restarts"] == 1
    want = _runner(str(tmp_path / "b"),
                   injector=FailureInjector(fail_at=(7,))).run()
    _states_equal(got["state"], want["state"])
    _states_equal(got["state"], _runner(str(tmp_path / "c")).run()["state"])


def test_torn_update_without_a_checkpoint_is_not_continued(tmp_path,
                                                           monkeypatch):
    """The same raise before any checkpoint: the runner raises and says
    the state is torn (it does not continue from a half-updated state)."""
    r, fail = _torn_runner(str(tmp_path / "a"), monkeypatch, 10, 100)
    with pytest.raises(RuntimeError, match="torn") as err:
        r.run()
    assert fail.fired and isinstance(err.value.__cause__,
                                     topt_adamw.TornStateError)
    assert [m["step"] for m in r.metrics_log] == list(range(7))


def test_a_failure_on_one_rank_fails_the_step_on_every_rank(tmp_path):
    """Two gloo ranks step one (1, 2)-sharded state, and rank 1 alone
    fails at step 2, at its update's workspace, while rank 0 finishes the
    step (``tests/_torch_sharded_lm_check.py``'s ``check_runner``). The
    ranks agree on the outcome: with a checkpoint both restore it and
    replay, bitwise the uninterrupted run; with none the state is mixed
    and both raise "torn"; when both fail there, both start again at step
    0, as the reference's runner does."""
    from _torch_sharded_lm_check import run_ranks
    ranks = run_ranks({}, tmp_path, 2, runner=True)
    for r, got in enumerate(ranks):
        assert int(got["clean/restarts"]) == 0, r
        assert int(got["ckpt/restarts"]) == 1, r
        assert got["ckpt/steps"].tolist() == [0, 1, 2, 3], r
        for k in got:
            if k.startswith("clean/state/"):
                np.testing.assert_array_equal(
                    got["ckpt/state/" + k[len("clean/state/"):]], got[k],
                    err_msg=f"rank {r} {k}")
        assert "torn" in str(got["none/error"]), r
        assert str(got["none/cause"]) == "TornStateError", r
        assert got["none/steps"].tolist() == [0, 1], r
        assert "both/error" not in got, r
        assert int(got["both/restarts"]) == 1, r
        assert got["both/steps"].tolist() == [0, 1, 0, 1, 2, 3], r
